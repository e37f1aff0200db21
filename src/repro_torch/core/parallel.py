"""Process-parallel evaluation of independent DES trials.

What-if sweeps and the scheduler's candidate evaluations are
embarrassingly parallel: every trial is an independent simulation of a
variant graph, and the pipeline only *compares* their results.  This
module fans such trials across worker processes while keeping the
outcome bit-identical to the serial loop:

- **fork-shared compiled arrays**: workers are forked, so the parent's
  version-keyed compiled caches (``compile_sim`` arrays, analytic
  passes, resource maps) are inherited copy-on-write — no per-trial
  recompile and no serialization of the graph.  Callers should warm the
  caches (e.g. evaluate the baseline) before fanning out.
- **deterministic order**: results are returned in trial order no
  matter which worker finishes first, so downstream argmin/tie-break
  logic sees exactly the serial sequence.
- **crash containment**: a worker dying (OOM kill, hard crash) breaks
  the pool — the survivors' results are kept and every missing trial is
  re-evaluated serially in order, with a :class:`RuntimeWarning`; a
  sweep never hangs on a dead worker and never silently drops a trial.

On platforms without ``fork`` (or with ``workers<=1``) everything runs
serially in-process; there is no behavioural difference, only wall
time.  The trial callable is shipped to workers through the pool
initializer (inherited through fork, never pickled), so closures over
graphs and schedulers are fine; trial *inputs* and *results* cross the
process boundary and must pickle (indices, floats, small tuples).
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Iterable, Optional

try:  # pragma: no cover - stdlib, but keep the numpy-free core lane honest
    import multiprocessing as _mp
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool
except ImportError:  # pragma: no cover
    _mp = None
    ProcessPoolExecutor = None  # type: ignore[assignment]

    class BrokenProcessPool(Exception):  # type: ignore[no-redef]
        """Stand-in so the except clause below still parses."""


_TRIAL_FN: Optional[Callable] = None


def _init_worker(fn: Callable) -> None:
    global _TRIAL_FN
    _TRIAL_FN = fn


def _run_trial(payload):
    i, item = payload
    return i, _TRIAL_FN(item)


def cpu_count() -> int:
    """Usable cores (affinity-aware where the platform exposes it)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def effective_workers(workers: Optional[int]) -> int:
    """How many processes a ``workers=`` request actually yields: 1
    (serial) unless a count > 1 is requested and ``fork`` pools exist."""
    if not workers or workers <= 1:
        return 1
    if _mp is None or ProcessPoolExecutor is None:
        return 1
    if "fork" not in _mp.get_all_start_methods():
        return 1
    return int(workers)


def trial_map(fn: Callable, items: Iterable, workers: Optional[int] = None,
              *, label: str = "trials") -> list:
    """``[fn(x) for x in items]`` fanned across forked workers.

    Results come back in ``items`` order regardless of completion
    order.  Any pool failure (worker crash, broken pipe) degrades to
    serial evaluation of the missing trials with a warning — identical
    results, just slower.  ``workers`` <= 1, a single item, or a
    platform without fork short-circuits to the plain serial loop.
    """
    items = list(items)
    w = min(effective_workers(workers), len(items))
    if w <= 1:
        return [fn(it) for it in items]
    results: list = [None] * len(items)
    done = [False] * len(items)
    try:
        ctx = _mp.get_context("fork")
        with ProcessPoolExecutor(max_workers=w, mp_context=ctx,
                                 initializer=_init_worker,
                                 initargs=(fn,)) as pool:
            futures = [pool.submit(_run_trial, (i, it))
                       for i, it in enumerate(items)]
            for fut in futures:
                i, r = fut.result()
                results[i] = r
                done[i] = True
    except (BrokenProcessPool, OSError, RuntimeError) as exc:
        warnings.warn(
            f"parallel {label}: worker pool failed ({exc!r}); "
            f"re-running the incomplete trials serially",
            RuntimeWarning, stacklevel=2)
    for i, ok in enumerate(done):
        if not ok:
            results[i] = fn(items[i])
    return results


def speedup_workers(n_trials: int, workers: Optional[int]) -> float:
    """Ideal-speedup bound for diagnostics: ``min(workers, n_trials)``
    capped by the machine's cores (a 4-worker sweep on 1 core is 1x)."""
    w = min(effective_workers(workers), max(1, n_trials))
    return float(min(w, cpu_count()))


__all__ = ["trial_map", "effective_workers", "cpu_count",
           "speedup_workers"]
