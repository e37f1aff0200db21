"""Compiled analytic layer: the scheduler's forward/reverse passes on
flat arrays.

:meth:`MXDAG.evaluate` / :meth:`MXDAG.with_slack` /
:meth:`MXDAG.critical_path` key every intermediate by task-name strings
and allocate one ``NodeTiming`` per task.  At Graphene scale (tens of
thousands of vertices) those dict-per-task passes dominate
``MXDAGScheduler.schedule()`` — exactly the per-DAG overhead DAGPS /
Graphene-style schedulers need to keep negligible.  This module compiles
one graph into integer-interned flat arrays once per graph version and
runs the *same* recursions as level-batched vectorized passes:

- :class:`CompiledAnalytic` — insertion-order task ids, lexicographic
  ``name_rank`` (reproducing every name-ordered tie-break on ints),
  per-task ``size`` / ``effective_unit`` scalars, predecessor and
  successor CSR with per-edge effective-pipelining flags, and a
  longest-path *level* partition of the topological order (every node's
  predecessors live in strictly lower levels, so one level is one
  vectorized step).  Cached on the graph as ``_analytic_cache`` keyed by
  the graph version; :func:`repro_torch.core.arraysim._compile` reuses the
  same interning, so the scheduler's analytic passes and its DES runs
  share one compile.
- :func:`analyze` — forward (``ready`` / ``first_out`` / ``completion``)
  plus reverse (``latest_completion`` ⇒ slack) passes over the arrays,
  returning an :class:`AnalyticTiming` of flat per-task vectors.
- :func:`critical_path` — the same longest-path walk-back as the dict
  implementation, on interned ids.

Bit-exactness: every arithmetic step is the same IEEE-754 operation the
dict implementation performs (``max``/``min`` are exact, and each
``+``/``-``/``/`` maps one-to-one), so the results are *bit-equal* —
not merely close — to ``MXDAG.evaluate``/``with_slack``/
``critical_path`` on every graph; the golden equivalence tests assert
``==``, not ``approx``.  NumPy is optional and import-guarded (the core
CI lane runs pure-stdlib): without it the same compiled arrays are
walked by scalar loops that mirror the dict recursion exactly.
"""
from __future__ import annotations

import math
from typing import Optional

try:
    import numpy as np
except ImportError:                      # pure-stdlib core lane
    np = None

from repro_torch.core.task import TaskKind


class CompiledAnalytic:
    """Flat-array form of one MXDAG (analytic-pass substrate)."""

    __slots__ = (
        "n", "names", "idx", "name_rank", "size", "eunit", "nu",
        "is_compute", "job",
        # pred/succ adjacency: per-node tuples (stdlib fallback + shared
        # with the arraysim compile) and the matching pipelined flags
        "pred_lists", "pred_pipe", "succ_lists", "succ_pipe",
        "any_pipe", "sinks", "order", "lvl_ptr",
        # NumPy mirrors (None when NumPy is absent): CSR aligned to the
        # level order so one level is one reduceat
        "np_ready", "size_a", "eunit_a", "order_a",
        "pred_ptr_a", "pred_flat_a", "pred_pipe_a",
        # reverse pass: nodes with successors, sorted by descending
        # level, with succ CSR aligned to that order
        "rev_nodes_a", "rev_ptr_a", "rev_flat_a", "rev_pipe_a",
        "rev_lvl_ptr", "sinks_a",
    )


def compile_analytic(g) -> CompiledAnalytic:
    """Compiled analytic arrays for ``g``, cached per graph version."""
    cached = g.__dict__.get("_analytic_cache")
    if cached is not None and cached[0] == g._version:
        return cached[1]
    comp = _compile(g)
    g._analytic_cache = (g._version, comp)
    return comp


def _compile(g) -> CompiledAnalytic:
    tasks = g.tasks
    comp = CompiledAnalytic()
    names = list(tasks)
    idx = {nm: i for i, nm in enumerate(names)}
    n = len(names)
    comp.n, comp.names, comp.idx = n, names, idx

    rank = [0] * n
    for r, nm in enumerate(sorted(names)):
        rank[idx[nm]] = r
    comp.name_rank = rank

    size = [0.0] * n
    eunit = [0.0] * n
    nu = [1] * n
    is_compute = [False] * n
    job = [""] * n
    pipeable = [False] * n
    ceil = math.ceil
    for i, t in enumerate(tasks.values()):
        sz = t.size
        u = t.unit
        size[i] = sz
        eu = u if u is not None else sz
        eunit[i] = eu
        if sz > 0:                  # MXTask.n_units, inlined
            k = int(ceil(sz / eu - 1e-12))
            nu[i] = k if k > 1 else 1
        is_compute[i] = t.kind is TaskKind.COMPUTE
        job[i] = t.job
        pipeable[i] = u is not None and u < sz
    comp.size, comp.eunit, comp.nu = size, eunit, nu
    comp.is_compute, comp.job = is_compute, job

    # adjacency with effective-pipelining flags, resolved in ONE pass
    # over the edge dict (the dict passes call effective_pipelined per
    # edge per pass; add_edge appends to _pred/_succ in edge-insertion
    # order, so this reproduces the per-node adjacency order exactly)
    pred_lists: list[list[int]] = [[] for _ in range(n)]
    pred_pipe: list[list[bool]] = [[] for _ in range(n)]
    succ_lists: list[list[int]] = [[] for _ in range(n)]
    succ_pipe: list[list[bool]] = [[] for _ in range(n)]
    any_pipe = False
    for (s, d), e in g.edges.items():
        si, di = idx[s], idx[d]
        f = e.pipelined and pipeable[si] and pipeable[di]
        if f:
            any_pipe = True
        pred_lists[di].append(si)
        pred_pipe[di].append(f)
        succ_lists[si].append(di)
        succ_pipe[si].append(f)
    comp.pred_lists, comp.pred_pipe = pred_lists, pred_pipe
    comp.succ_lists, comp.succ_pipe = succ_lists, succ_pipe
    comp.any_pipe = any_pipe
    comp.sinks = [i for i in range(n) if not succ_lists[i]]

    # longest-path levels: every predecessor of a level-l node lives in
    # a level < l, so the forward pass is one batched step per level
    # (and level 0 ⇔ no predecessors, so deeper pred segments are never
    # empty).  Kahn by waves: a node is released only after its last —
    # i.e. deepest — predecessor's wave, so wave k IS longest-path
    # depth k.
    indeg = [len(pred_lists[i]) for i in range(n)]
    frontier = [i for i in range(n) if not indeg[i]]
    order: list[int] = []
    lvl_ptr = [0]
    while frontier:
        order.extend(frontier)
        lvl_ptr.append(len(order))
        nxt: list[int] = []
        for i in frontier:
            for s in succ_lists[i]:
                indeg[s] -= 1
                if not indeg[s]:
                    nxt.append(s)
        frontier = nxt
    if len(order) != n:
        raise ValueError("graph has a cycle")
    comp.order = order
    comp.lvl_ptr = lvl_ptr

    comp.np_ready = np is not None
    if comp.np_ready:
        comp.size_a = np.array(size, dtype=np.float64)
        comp.eunit_a = np.array(eunit, dtype=np.float64)
        comp.order_a = np.array(order, dtype=np.int64)
        ptr = [0]
        flat: list[int] = []
        pipe: list[bool] = []
        for v in order:
            flat.extend(pred_lists[v])
            pipe.extend(pred_pipe[v])
            ptr.append(len(flat))
        comp.pred_ptr_a = np.array(ptr, dtype=np.int64)
        comp.pred_flat_a = np.array(flat, dtype=np.int64)
        comp.pred_pipe_a = np.array(pipe, dtype=bool)
        # reverse structures: nodes with successors by descending level
        # (an edge u→v implies level(v) > level(u), so every successor
        # is finalized — as a deeper node or a sink — before u runs)
        rev: list[int] = []
        rlvl = [0]
        for li in range(len(lvl_ptr) - 2, -1, -1):
            for p in range(lvl_ptr[li], lvl_ptr[li + 1]):
                v = order[p]
                if succ_lists[v]:
                    rev.append(v)
            if len(rev) != rlvl[-1]:
                rlvl.append(len(rev))
        rptr = [0]
        rflat: list[int] = []
        rpipe: list[bool] = []
        for v in rev:
            rflat.extend(succ_lists[v])
            rpipe.extend(succ_pipe[v])
            rptr.append(len(rflat))
        comp.rev_nodes_a = np.array(rev, dtype=np.int64)
        comp.rev_ptr_a = np.array(rptr, dtype=np.int64)
        comp.rev_flat_a = np.array(rflat, dtype=np.int64)
        comp.rev_pipe_a = np.array(rpipe, dtype=bool)
        comp.rev_lvl_ptr = rlvl
        comp.sinks_a = np.array(comp.sinks, dtype=np.int64)
    else:
        comp.size_a = comp.eunit_a = comp.order_a = None
        comp.pred_ptr_a = comp.pred_flat_a = comp.pred_pipe_a = None
        comp.rev_nodes_a = comp.rev_ptr_a = None
        comp.rev_flat_a = comp.rev_pipe_a = None
        comp.rev_lvl_ptr = comp.sinks_a = None
    return comp


class AnalyticTiming:
    """Per-task analytic timing as flat vectors (indexed like
    ``CompiledAnalytic.names``); the array counterpart of the
    ``{name: NodeTiming}`` dicts the MXDAG methods return."""

    __slots__ = ("names", "idx", "ready", "first_out", "completion",
                 "latest", "slack", "makespan")

    def __init__(self, names, idx, ready, first_out, completion,
                 latest, slack, makespan):
        self.names = names
        self.idx = idx
        self.ready = ready
        self.first_out = first_out
        self.completion = completion
        self.latest = latest
        self.slack = slack
        self.makespan = makespan

    def to_dict(self):
        """The equivalent ``MXDAG.with_slack()`` dict (tests, adapters)."""
        from repro_torch.core.graph import NodeTiming
        out = {}
        for i, nm in enumerate(self.names):
            out[nm] = NodeTiming(ready=self.ready[i],
                                 first_out=self.first_out[i],
                                 completion=self.completion[i],
                                 latest_completion=self.latest[i])
        return out


def _times(comp: CompiledAnalytic, rsrc: Optional[dict]):
    """(completion-time, unit-time) vectors under ``rsrc``.

    ``x / 1.0 == x`` bitwise, so the unscaled vectors are shared as-is;
    scaled entries perform the identical per-element division the dict
    passes run through ``MXTask.time`` / ``unit_time`` (including their
    argument validation)."""
    if not rsrc:
        return comp.size, comp.eunit, comp.size_a, comp.eunit_a
    times = list(comp.size)
    utimes = list(comp.eunit)
    idx = comp.idx
    for nm, f in rsrc.items():
        i = idx.get(nm)
        if i is None:
            continue
        if not (0 < f <= 1.0 + 1e-12):
            raise ValueError(f"rsrc must be in (0,1], got {f}")
        times[i] = times[i] / f
        utimes[i] = utimes[i] / f
    if comp.np_ready and np is not None:
        return times, utimes, np.array(times), np.array(utimes)
    return times, utimes, None, None


def _release_vec(comp: CompiledAnalytic, release: Optional[dict]):
    rel = [0.0] * comp.n
    if release:
        idx = comp.idx
        for nm, v in release.items():
            i = idx.get(nm)
            if i is not None:
                rel[i] = v
    return rel


def forward(g, rsrc: Optional[dict] = None,
            release: Optional[dict] = None):
    """The :meth:`MXDAG.evaluate` recursion on compiled arrays.

    Returns ``(comp, times, utimes, ready, first_out, completion)``
    where the last three are per-task float lists.
    """
    return _forward(g, rsrc, release)[:6]


def _forward(g, rsrc: Optional[dict], release: Optional[dict]):
    """forward() plus, on the NumPy path, the ndarray forms of
    (completion, times, utimes) so analyze() reuses them instead of
    round-tripping the lists back through np.array (None on the
    stdlib path)."""
    comp = compile_analytic(g)
    times, utimes, times_a, utimes_a = _times(comp, rsrc)
    rel = _release_vec(comp, release)
    n = comp.n
    if comp.np_ready and np is not None and n:
        fo = np.empty(n)
        cpl = np.empty(n)
        rdy = np.empty(n)
        rel_a = np.array(rel)
        order_a, lvl = comp.order_a, comp.lvl_ptr
        pptr, pflat, ppipe = (comp.pred_ptr_a, comp.pred_flat_a,
                              comp.pred_pipe_a)
        if times_a is None:
            times_a, utimes_a = comp.size_a, comp.eunit_a
        any_pipe = comp.any_pipe
        for li in range(len(lvl) - 1):
            a, b = lvl[li], lvl[li + 1]
            vs = order_a[a:b]
            if li == 0:                      # roots: release only
                r = rel_a[vs]
            else:
                off = pptr[a:b] - pptr[a]
                pf = pflat[pptr[a]:pptr[b]]
                pp = ppipe[pptr[a]:pptr[b]]
                vals = np.where(pp, fo[pf], cpl[pf])
                r = np.maximum(rel_a[vs], np.maximum.reduceat(vals, off))
            ut = utimes_a[vs]
            c = r + times_a[vs]
            if any_pipe and li > 0 and pp.any():
                counts = pptr[a + 1:b + 1] - pptr[a:b]
                vals2 = np.where(pp, cpl[pf] + np.repeat(ut, counts), 0.0)
                c = np.maximum(c, np.maximum.reduceat(vals2, off))
            else:
                c = np.maximum(c, 0.0)       # dict floor starts at 0.0
            rdy[vs] = r
            fo[vs] = r + ut
            cpl[vs] = c
        return (comp, times, utimes, rdy.tolist(), fo.tolist(),
                cpl.tolist(), (cpl, times_a, utimes_a))

    # pure-stdlib: the dict recursion on interned ids
    rdy = [0.0] * n
    fo = [0.0] * n
    cpl = [0.0] * n
    pred_lists, pred_pipe = comp.pred_lists, comp.pred_pipe
    for v in comp.order:
        ready = rel[v]
        floor = 0.0
        ut = utimes[v]
        preds = pred_lists[v]
        if preds:
            for p, pipe in zip(preds, pred_pipe[v]):
                if pipe:
                    x = fo[p]
                    if x > ready:
                        ready = x
                    c2 = cpl[p] + ut
                    if c2 > floor:
                        floor = c2
                else:
                    x = cpl[p]
                    if x > ready:
                        ready = x
        c = ready + times[v]
        if floor > c:
            c = floor
        rdy[v] = ready
        fo[v] = ready + ut
        cpl[v] = c
    return comp, times, utimes, rdy, fo, cpl, None


def analyze(g, rsrc: Optional[dict] = None,
            release: Optional[dict] = None) -> AnalyticTiming:
    """Forward + reverse pass: the array form of
    :meth:`MXDAG.with_slack` (bit-equal values)."""
    comp, times, utimes, rdy, fo, cpl, fwd_np = _forward(g, rsrc, release)
    n = comp.n
    ms = max(cpl, default=0.0)
    if fwd_np is not None and np is not None and n:
        cpl_a, times_a, utimes_a = fwd_np
        latest = np.empty(n)
        latest[comp.sinks_a] = ms
        rptr, rflat, rpipe = comp.rev_ptr_a, comp.rev_flat_a, \
            comp.rev_pipe_a
        rl = comp.rev_lvl_ptr
        nodes = comp.rev_nodes_a
        need = np.where(rpipe, utimes_a[rflat], times_a[rflat])
        for li in range(len(rl) - 1):
            a, b = rl[li], rl[li + 1]
            vs = nodes[a:b]
            off = rptr[a:b] - rptr[a]
            vals = latest[rflat[rptr[a]:rptr[b]]] \
                - need[rptr[a]:rptr[b]]
            latest[vs] = np.minimum.reduceat(vals, off)
        latest_l = latest.tolist()
        slack = (latest - cpl_a).tolist()
        return AnalyticTiming(comp.names, comp.idx, rdy, fo, cpl,
                              latest_l, slack, ms)

    latest_l = [0.0] * n
    succ_lists, succ_pipe = comp.succ_lists, comp.succ_pipe
    for v in reversed(comp.order):
        succs = succ_lists[v]
        if not succs:
            latest_l[v] = ms
            continue
        lc = math.inf
        for s, pipe in zip(succs, succ_pipe[v]):
            x = latest_l[s] - (utimes[s] if pipe else times[s])
            if x < lc:
                lc = x
        latest_l[v] = lc
    slack = [latest_l[i] - cpl[i] for i in range(n)]
    return AnalyticTiming(comp.names, comp.idx, rdy, fo, cpl,
                          latest_l, slack, ms)


def critical_path(g, rsrc: Optional[dict] = None,
                  release: Optional[dict] = None) -> list[str]:
    """:meth:`MXDAG.critical_path` on compiled arrays (identical walk,
    identical lexicographic tie-breaks via ``name_rank``)."""
    comp, times, utimes, rdy, fo, cpl = forward(g, rsrc, release)
    if not comp.n:
        raise ValueError("empty graph has no critical path")
    rank = comp.name_rank
    # max(sinks, key=(completion, name)): strictly-greater keeps the
    # first maximal item, exactly like the dict walk
    cur = comp.sinks[0]
    for v in comp.sinks[1:]:
        if (cpl[v], rank[v]) > (cpl[cur], rank[cur]):
            cur = v
    path = [cur]
    pred_lists, pred_pipe = comp.pred_lists, comp.pred_pipe
    while pred_lists[cur]:
        t_time = times[cur]
        t_unit = utimes[cur]
        best, best_val = -1, -1.0
        for p, pipe in zip(pred_lists[cur], pred_pipe[cur]):
            if pipe:
                v = fo[p] + t_time
                v2 = cpl[p] + t_unit
                if v2 > v:
                    v = v2
            else:
                v = cpl[p] + t_time
            if v > best_val + 1e-12 or (abs(v - best_val) <= 1e-12
                                        and (best < 0
                                             or rank[p] < rank[best])):
                best, best_val = p, v
        # only follow preds that actually bind the completion
        if best < 0 or best_val + 1e-9 < cpl[cur]:
            break
        cur = best
        path.append(cur)
    path.reverse()
    names = comp.names
    return [names[i] for i in path]
