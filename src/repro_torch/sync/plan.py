"""SyncPlan: MXDAG-driven gradient-sync planning (the paper → the cluster),
the port of the JAX package's ``repro.sync.plan``.

``step_mxdag`` builds the Fig. 6 MXDAG for one training step of an
assigned arch at production scale: BP/FP compute MXTasks per layer (sized
from the card's peak) and push/pull network MXTasks for each layer's
gradient reduce-scatter + param all-gather (sized from grad bytes over the
data-parallel link).  ``plan_sync`` then schedules it with the Principle-1
scheduler and compares against the barrier (coflow-like all-at-the-end)
schedule, choosing ``bucketed`` (per-layer collectives inside the backward,
overlappable) only when the MXDAG analysis predicts a win: the paper's
"pipelines applied only when they shrink execution time".

The production scale is 256 H100s with ``tp=8``: tensor parallelism fills
one NVLink domain (a DGX H100 node), so the data-parallel sync crosses
nodes, and ``_per_layer_times`` charges it to ``hw.dp_link_bw`` (400 Gb/s
InfiniBand a GPU) where the JAX package charges ICI.  ``plan.order`` is
reported, not enforced: the realized mechanism, ``repro_torch.sync.
overlap``, issues each layer's collective as its backward finishes, as
XLA orders the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.core import MXDAGScheduler, simulate
from repro_torch.core.builders import ddl
from repro_torch.launch.roofline import H100, Hardware


@dataclasses.dataclass
class SyncPlan:
    mode: str                      # "bucketed" | "barrier"
    order: list[str]               # push priority order (layer names)
    predicted_bucketed: float      # MXDAG-scheduled makespan (s)
    predicted_barrier: float       # single-barrier makespan (s)
    mxdag_size: int

    @property
    def predicted_speedup(self) -> float:
        return self.predicted_barrier / max(self.predicted_bucketed, 1e-12)


def _per_layer_times(cfg: ArchConfig, shape: ShapeConfig, chips: int,
                     tp: int, hw: Hardware) -> tuple[float, float, float]:
    """(fp_s, bp_s, sync_s) per layer per step at the assigned scale."""
    n_layer = cfg.param_counts()["active"] / max(cfg.n_layers, 1)
    tokens = shape.global_batch * shape.seq_len
    dp = max(chips // tp, 1)
    fp = 2.0 * n_layer * tokens / (chips * hw.peak_flops)
    bp = 2.0 * fp
    # grad RS + param AG: 2 × layer grad bytes (bf16) across dp, between
    # nodes
    layer_bytes = (cfg.param_counts()["total"] / max(cfg.n_layers, 1)) \
        * 2.0 / tp
    sync = 2.0 * layer_bytes * (dp - 1) / dp / hw.dp_link_bw
    return fp, bp, sync


def step_mxdag(cfg: ArchConfig, shape: ShapeConfig, *, chips: int = 256,
               tp: int = 8, n_layers: Optional[int] = None,
               unit_frac: Optional[float] = None, hw: Hardware = H100):
    """Fig. 6 MXDAG for one step (push=grad RS, pull=param AG).
    ``unit_frac`` makes tasks pipelineable (chunked collectives)."""
    L = n_layers or cfg.n_layers
    fp, bp, sync = _per_layer_times(cfg, shape, chips, tp, hw)
    return ddl(L, bp=bp, fp=fp, push=sync / 2, pull=sync / 2,
               unit_frac=unit_frac)


def plan_sync(cfg: ArchConfig, shape: ShapeConfig, *, chips: int = 256,
              tp: int = 8, run: Optional[RunConfig] = None,
              hw: Hardware = H100) -> SyncPlan:
    L = cfg.n_layers
    g = step_mxdag(cfg, shape, chips=chips, tp=tp, hw=hw)
    sched = MXDAGScheduler(try_pipelining=False).schedule(g)
    bucketed = sched.simulate().makespan

    # barrier baseline: all pushes/pulls grouped as one coflow each —
    # gradient sync happens strictly after the full backward
    fp, bp, sync = _per_layer_times(cfg, shape, chips, tp, hw)
    gb = ddl(1, bp=bp * L, fp=fp * L, push=sync * L / 2, pull=sync * L / 2)
    barrier = simulate(gb).makespan

    prio = {k: v for k, v in sched.priorities.items()
            if k.startswith("push")}
    order = sorted(prio, key=lambda k: prio[k])
    mode = "bucketed" if bucketed < barrier - 1e-12 else "barrier"
    return SyncPlan(mode=mode, order=order,
                    predicted_bucketed=bucketed,
                    predicted_barrier=barrier,
                    mxdag_size=len(g))
