"""Flat-array DES engine: the compiled fast path behind ``Simulator.run``.

The event-calendar core in :mod:`repro_torch.core.simulator` keys every piece of
run state by task-name strings in dicts.  At Graphene scale (tens of
thousands of vertices; Grandl et al., OSDI'16) the hashing, string
comparisons and per-task Python loops dominate the wall time.  This module
compiles one (MXDAG, Cluster, coflows, routes) quadruple into
integer-interned flat arrays, then runs the *same* event-calendar
algorithm on top of them.

Compiled layout (:class:`CompiledSim`, cached on the graph keyed by graph
version + cluster identity + coflow/route keys, so scheduler and what-if
sweeps that vary only priorities/releases compile once per graph version):

- task ids are insertion-order integers; ``names``/``idx`` map back and
  forth, ``name_rank`` is each task's rank in lexicographic name order
  (dispatch and waterfill orders sort by name — ranks reproduce the
  string sorts on ints);
- per-task scalars ``size``/``unit``/``nu``/``is_compute``/``job`` as flat
  lists (mirrored as float64/int64 NumPy arrays when NumPy is present);
- flow→link incidence in CSR form: ``flow_links[p]`` is the interned link
  tuple of the flow at net position ``p``; ``fl_ptr``/``fl_flat`` are the
  NumPy CSR mirror used by the vectorized waterfill; ``link_bw`` the
  per-link capacities;
- streaming-predecessor adjacency (``stream_in``/``stream_out``) and
  start-gate structure compiled to one fused *counter* per task:
  ``init_gate[i]`` counts unmet barrier + coflow + member-sync
  preconditions (all non-negative and all required, so their sum gates
  identically), and ``gate_dec``/``cof_dec`` say which counters each
  completion (or coflow completion) decrements — start gating is
  monotone, so counter-zero is equivalent to the calendar core's
  re-scan of its gate lists;
- coflow membership (``coflow_of``/``coflows``/``coflow_fed_by``) and
  per-flow priority-class inputs (``stream_fed``).

The run state is float64 ``work``/``rate`` vectors, int heap entries
``(time, kind, task_id, stamp)``, and integer slot/link indices.  Rate
(re)allocation per priority class goes through the vectorized waterfill:
bottleneck search is a NumPy reduction over the link arrays, with the
scalar scan's first-within-EPS tie-break reproduced exactly by scanning
only the strict prefix minima of the ratio vector, and whole freeze
batches are subtracted via bincounts on the incidence CSR.

Two compile-time structures keep reallocation local (the fix for the
ddl-style serial-chain trickle, which previously saw only ~1.2x from
the arrays because every completion re-filled and re-heaped every
runnable flow):

- **contention components** — union-find over the flow→link incidence;
  flows in different components share no links, so ``allocate()``
  refills only *dirty* components (per-component lowest-dirty-class
  replay logs included) and untouched components' rates — provably what
  a global refill would recompute, since fills only read their own
  links — are skipped outright.  Coflows collapse the split into one
  component: MADD weights couple every rate and re-dirty every event.
- **coalesced completion events** — a flow with no streaming role and
  no unit boundaries (``unit >= size``) can only ever complete, so each
  component carries *one* heap entry (min next-completion over its
  runnable "simple" flows, kind 2, stamped per component) instead of
  one entry per flow per rate change.  The entry's time is exactly the
  min of the per-flow times schedule_event would have pushed, so the
  event calendar — and therefore every result — is unchanged; only the
  stale-entry volume drops from O(flows) to O(1) per reallocation.

The analytic compile (:mod:`repro_torch.core.arrayanalytic`) shares this
module's interning: ``_compile`` reuses its name table, per-task
scalars and int adjacency, so one per-task/per-edge traversal per graph
version serves both the scheduler's slack passes and the DES.

NumPy-optional policy: ``import numpy`` is guarded at module import.  The
core CI lane runs pure-stdlib — without NumPy the same compiled engine
runs list-backed kernels and the waterfill falls back to a scalar
progressive fill (a port of :func:`repro_torch.core.simulator.waterfill` to the
interned domain, same freeze order and arithmetic), so results are
engine-identical either way.  The golden differential tests assert the
array engine reproduces the calendar core — and hence the retained
``_reference_run`` seed oracle — on every scenario.
"""
from __future__ import annotations

import heapq
import math
from bisect import bisect_left
from itertools import chain

try:
    import numpy as np
except ImportError:                      # pure-stdlib core lane
    np = None

from repro_torch.core.arrayanalytic import compile_analytic
from repro_torch.core.task import TaskKind

EPS = 1e-9


class CompiledSim:
    """Flat-array form of one (graph, cluster, coflows, routes)."""

    __slots__ = (
        "n", "names", "idx", "name_rank", "size", "unit", "nu",
        "is_compute", "job", "slot_of", "slot_cap", "slot_ids",
        "net_ids", "net_pos",
        "n_net", "flow_links", "n_links", "link_bw", "link_ids", "succ",
        "gate_dec", "init_gate", "gate_stream", "stream_in",
        "stream_out",
        "has_streaming", "stream_fed", "coflow_of", "coflows", "cof_dec",
        "coflow_fed_by", "nu_sum", "np_ready", "single_job", "roots",
        # contention components: union-find over the flow→link incidence
        # (disjoint link/flow sets fill independently); ``simple`` marks
        # tasks whose only possible event is completion (flows with no
        # streaming role, no unit boundaries) — their events coalesce
        # into one per-component next-completion entry
        "n_comps", "comp_of_net", "simple",
        # NumPy mirrors (None when NumPy is absent)
        "size_a", "name_rank_a", "net_ids_a", "fl_ptr", "fl_flat",
        "link_bw_a",
        # precomputed fill structures for the full flow set (the common
        # fair-mode group: every flow runnable, none starved)
        "full_sorted_ids", "full_sg_pos", "full_row_links",
        "full_by_link", "full_counts",
    )


def compile_sim(sim) -> CompiledSim:
    """Compiled arrays for ``sim``, cached on the graph.

    Key: (graph version, cluster identity) owns a small dict keyed by
    (coflow grouping, route overrides) — the two Simulator inputs that
    change the incidence/gating structure.  Priorities, releases and
    policy are per-run inputs and never invalidate the compile.
    """
    g = sim.g
    sub = (tuple(tuple(sorted(c)) for c in sim.coflows),
           tuple(sorted(sim.routes.items())) if sim.routes else None)
    cache = g.__dict__.get("_array_compiled")
    if cache is not None and cache[0] == g._version \
            and cache[1] is sim.cluster:
        comp = cache[2].get(sub)
        if comp is not None:
            return comp
    else:
        cache = (g._version, sim.cluster, {})
        g._array_compiled = cache
    comp = _compile(sim)
    cache[2][sub] = comp
    return comp


def _compile(sim) -> CompiledSim:
    g, cluster = sim.g, sim.cluster
    tasks = g.tasks
    comp = CompiledSim()
    # the analytic compile (arrayanalytic) interns the same graph for
    # the scheduler's forward/reverse passes; reuse its name table,
    # per-task scalars and int adjacency so the two compiles share one
    # per-task/per-edge traversal per graph version
    an = compile_analytic(g)
    names, idx, n = an.names, an.idx, an.n
    comp.n, comp.names, comp.idx = n, names, idx
    comp.name_rank = an.name_rank
    comp.size = an.size
    comp.unit = an.eunit
    comp.nu = an.nu
    comp.nu_sum = sum(an.nu)
    comp.is_compute = an.is_compute
    comp.job = an.job
    comp.single_job = len(set(an.job)) <= 1
    comp.succ = an.succ_lists

    # compute slots (a pool absent from the cluster has 0 slots, exactly
    # like the calendar core's slots_free.get(r, 0))
    slot_ids: dict[tuple, int] = {}
    comp.slot_of = [-1] * n
    comp.slot_cap = []
    hosts = cluster.hosts
    is_compute = an.is_compute
    for i, t in enumerate(tasks.values()):
        if is_compute[i]:
            key = (t.host, t.proc)
            si = slot_ids.get(key)
            if si is None:
                si = slot_ids[key] = len(comp.slot_cap)
                h = hosts.get(t.host)
                comp.slot_cap.append(
                    int(h.procs.get(t.proc, 0)) if h is not None else 0)
            comp.slot_of[i] = si
    comp.slot_ids = slot_ids
    # flow→link incidence over interned links.  Without a fabric or
    # route overrides a flow's path is exactly (src NIC-out, dst NIC-in)
    # — intern those from the task fields directly, skipping the
    # string-keyed resource map (same first-seen interning order, same
    # capacities as Cluster.bandwidth on the NIC names).
    link_ids: dict = {}
    comp.flow_links = []
    comp.net_ids = []
    comp.net_pos = [-1] * n
    if cluster.topology is None and not sim.routes:
        link_bw: list[float] = []
        for i, t in enumerate(tasks.values()):
            if not is_compute[i]:
                comp.net_pos[i] = len(comp.net_ids)
                comp.net_ids.append(i)
                ko = ("o", t.src)
                lo = link_ids.get(ko)
                if lo is None:
                    lo = link_ids[ko] = len(link_bw)
                    link_bw.append(float(hosts[t.src].nic_out))
                kd = ("i", t.dst)
                ld = link_ids.get(kd)
                if ld is None:
                    ld = link_ids[kd] = len(link_bw)
                    link_bw.append(float(hosts[t.dst].nic_in))
                comp.flow_links.append((lo, ld))
        comp.n_links = len(link_bw)
        comp.link_bw = link_bw
    else:
        res = sim._res
        for i, (nm, t) in enumerate(tasks.items()):
            if not is_compute[i]:
                comp.net_pos[i] = len(comp.net_ids)
                comp.net_ids.append(i)
                ids = []
                for l in res[nm]:
                    li = link_ids.get(l)
                    if li is None:
                        li = link_ids[l] = len(link_ids)
                    ids.append(li)
                comp.flow_links.append(tuple(ids))
        comp.n_links = len(link_ids)
        bw = cluster.bandwidths(link_ids)
        comp.link_bw = [0.0] * comp.n_links
        for l, li in link_ids.items():
            comp.link_bw[li] = float(bw[l])
    comp.link_ids = link_ids
    comp.n_net = len(comp.net_ids)

    # coflows (members in sorted-name order: iteration order never
    # affects results — membership tests and maxima are commutative)
    comp.coflows = [[idx[m] for m in sorted(c)] for c in sim.coflows]
    comp.coflow_of = [-1] * n
    for ci, c in enumerate(comp.coflows):
        for m in c:
            comp.coflow_of[m] = ci

    pred_lists, pred_pipe = an.pred_lists, an.pred_pipe
    if not comp.coflows and not an.any_pipe:
        # barrier-only fast path: every edge gates at completion, so the
        # fused counter is the in-degree and the decrement list is
        # exactly the successor list (aliased, read-only)
        empty: tuple = ()
        comp.stream_in = [empty] * n
        comp.stream_out = [empty] * n
        comp.stream_fed = [False] * n
        comp.has_streaming = False
        comp.init_gate = [len(pl) for pl in pred_lists]
        comp.gate_dec = an.succ_lists
        comp.cof_dec = []
        comp.gate_stream = [empty] * n
        comp.coflow_fed_by = [empty] * n
    else:
        # streaming adjacency (coflow producers gate at start instead)
        stream_in: list[list[int]] = [[] for _ in range(n)]
        stream_out: list[list[int]] = [[] for _ in range(n)]
        comp.stream_fed = [False] * n
        # start gating compiled to counters + decrement lists: one fused
        # start-gate counter per task — unmet barrier preds + coflow
        # preconditions + member-sync preds (all non-negative and all
        # required to reach zero, so their sum gates identically)
        comp.init_gate = [0] * n
        gate_dec: list[list[int]] = [[] for _ in range(n)]
        cof_dec: list[list[int]] = [[] for _ in range(len(comp.coflows))]
        gate_stream: list[tuple[int, ...]] = [()] * n
        coflow_of = comp.coflow_of
        for i in range(n):
            stream = []
            for pi, pipe in zip(pred_lists[i], pred_pipe[i]):
                ci = coflow_of[pi]
                if ci >= 0:
                    comp.init_gate[i] += 1
                    cof_dec[ci].append(i)
                elif pipe:
                    stream.append(pi)
                    stream_in[i].append(pi)
                    stream_out[pi].append(i)
                else:
                    comp.init_gate[i] += 1
                    gate_dec[pi].append(i)
            if stream:
                gate_stream[i] = tuple(stream)
            ci = coflow_of[i]
            if ci >= 0:
                # synchronized start: every member's preds must be done
                for m in comp.coflows[ci]:
                    for p in pred_lists[m]:
                        comp.init_gate[i] += 1
                        gate_dec[p].append(i)
        # any effectively-pipelined in-edge marks the consumer
        # stream-fed (top-priority class) — including one from a coflow
        # member, whose edge otherwise gates at start
        for i in range(n):
            if pred_pipe[i] and any(pred_pipe[i]):
                comp.stream_fed[i] = True
        comp.stream_in = [tuple(v) for v in stream_in]
        comp.stream_out = [tuple(v) for v in stream_out]
        comp.has_streaming = any(stream_out)
        comp.gate_dec = [tuple(v) for v in gate_dec]
        comp.cof_dec = [tuple(v) for v in cof_dec]
        comp.gate_stream = gate_stream

        coflow_fed_by: list[list[int]] = [[] for _ in range(n)]
        for ci, c in enumerate(comp.coflows):
            for m in c:
                for p in pred_lists[m]:
                    coflow_fed_by[p].append(ci)
        comp.coflow_fed_by = [tuple(v) for v in coflow_fed_by]

    # tasks whose start-gate counters begin at zero: the only candidates
    # that can possibly pass the t=0 gating filter (everything else is
    # re-enqueued by the completion that decrements its counter)
    comp.roots = [i for i in range(n) if not comp.init_gate[i]]

    # contention components: union-find over the interned flow→link
    # incidence.  Flows in different components never share a link, so
    # a completion/start/starvation flip re-waterfills only its own
    # component (rates elsewhere are provably unchanged).  Coflows
    # disable the split: MADD weights couple rates across the whole
    # flow set and re-dirty every event, so everything collapses into
    # one component (which reproduces the global fill exactly).
    if comp.coflows:
        comp.n_comps = 1 if comp.n_net else 0
        comp.comp_of_net = [0] * comp.n_net
        comp.simple = [False] * n
    else:
        parent = list(range(comp.n_links))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for links in comp.flow_links:
            if len(links) > 1:
                r0 = find(links[0])
                for l in links[1:]:
                    r = find(l)
                    if r != r0:
                        if r < r0:
                            parent[r0] = r
                            r0 = r
                        else:
                            parent[r] = r0
        comp_ids: dict = {}
        comp_of: list[int] = []
        for pos, links in enumerate(comp.flow_links):
            key = find(links[0]) if links else ("lone", pos)
            k = comp_ids.get(key)
            if k is None:
                k = comp_ids[key] = len(comp_ids)
            comp_of.append(k)
        comp.comp_of_net = comp_of
        comp.n_comps = len(comp_ids)
        simple = [False] * n
        unit, size = comp.unit, comp.size
        for i in comp.net_ids:
            simple[i] = (not comp.stream_in[i]
                         and not comp.stream_out[i]
                         and unit[i] >= size[i])
        comp.simple = simple

    comp.np_ready = np is not None
    if comp.np_ready:
        comp.size_a = np.array(comp.size, dtype=np.float64)
        comp.name_rank_a = np.array(comp.name_rank, dtype=np.int64)
        comp.net_ids_a = np.array(comp.net_ids, dtype=np.int64)
        ptr = [0]
        flat: list[int] = []
        for links in comp.flow_links:
            flat.extend(links)
            ptr.append(len(flat))
        comp.fl_ptr = np.array(ptr, dtype=np.int64)
        comp.fl_flat = np.array(flat, dtype=np.int64)
        comp.link_bw_a = np.array(comp.link_bw, dtype=np.float64)
        # full-group fill structures: sorted rows / incidence / link
        # index for the group "every flow", bit-identical to what the
        # fill would build for it per call
        order = sorted(range(comp.n_net),
                       key=lambda p: comp.name_rank[comp.net_ids[p]])
        comp.full_sg_pos = np.array(order, dtype=np.int64)
        comp.full_sorted_ids = [comp.net_ids[p] for p in order]
        comp.full_row_links = [list(comp.flow_links[p]) for p in order]
        by_link: dict[int, list[int]] = {}
        for r, links in enumerate(comp.full_row_links):
            for l in links:
                by_link.setdefault(l, []).append(r)
        comp.full_by_link = by_link
        comp.full_counts = np.bincount(
            _gather(comp.fl_ptr, comp.fl_flat, comp.full_sg_pos),
            minlength=comp.n_links).astype(np.float64)
    else:
        comp.size_a = comp.name_rank_a = comp.net_ids_a = None
        comp.fl_ptr = comp.fl_flat = comp.link_bw_a = None
        comp.full_sorted_ids = comp.full_sg_pos = None
        comp.full_row_links = comp.full_by_link = comp.full_counts = None
    return comp


def _gather(ptr, flat, pos):
    """Concatenate CSR segments ``flat[ptr[p]:ptr[p+1]]`` for ``pos``."""
    lens = ptr[pos + 1] - ptr[pos]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=flat.dtype)
    prefix = np.concatenate(([0], np.cumsum(lens)[:-1]))
    out_idx = np.repeat(ptr[pos] - prefix, lens) \
        + np.arange(total, dtype=np.int64)
    return flat[out_idx]


def _pick_bottleneck(ratio, eps=EPS):
    """The scalar waterfill's bottleneck scan, batched.

    The scalar loop keeps the first link whose ratio beats the running
    best by more than EPS; every accepted update is a strict prefix
    minimum of the ratio sequence, so scanning only those (a handful —
    ~H(n) of a random order) reproduces the selection bit-exactly.
    """
    pm = np.minimum.accumulate(ratio)
    cmask = np.empty(len(ratio), dtype=bool)
    cmask[0] = True
    cmask[1:] = ratio[1:] < pm[:-1]
    best_ratio, best = math.inf, -1
    for j in np.nonzero(cmask)[0].tolist():
        rj = ratio[j]
        if rj < best_ratio - eps:
            best_ratio, best = rj, j
    return best, float(best_ratio)


def _wf_core_np(sg_ids, fl_ptr, fl_flat, sg_pos, link_order, residual,
                rate, weights, seq, prep=None):
    """Vectorized progressive fill of one sorted flow group.

    ``sg_ids[r]`` is the id written into ``rate``/``seq`` for sorted row
    ``r``; ``sg_pos[r]`` its CSR row.  ``link_order`` fixes the bottleneck
    iteration order (the calendar core's residual insertion order) and
    ``residual`` is the full per-link array, mutated in place.  Freeze
    order is identical to the scalar waterfill: batches come off the
    bottleneck link's flow list in sorted-group order.  ``rate`` may be a
    list or an array — frozen batches write scalars.  ``seq`` may be
    None when the caller never replays the freeze log (fair policy).
    ``prep`` optionally supplies precomputed ``(row_links, by_link,
    counts)`` for this exact group (the compile-level full-flow-set
    structures), skipping the per-call incidence builds.
    """
    k = len(sg_pos)
    if k == 0:
        return
    L = len(residual)
    if prep is not None and weights is None:
        row_links, by_link, counts0 = prep
        wsum = counts0.copy()
    else:
        cat = _gather(fl_ptr, fl_flat, sg_pos)
        lens = fl_ptr[sg_pos + 1] - fl_ptr[sg_pos]
        if weights is None:
            wsum = np.bincount(cat, minlength=L).astype(np.float64)
        else:
            row = np.repeat(np.arange(k, dtype=np.int64), lens)
            wsum = np.zeros(L)
            np.add.at(wsum, cat, weights[row])
        cat_list = cat.tolist()
        ptr_list = np.concatenate(([0], np.cumsum(lens))).tolist()
        row_links = [cat_list[ptr_list[r]:ptr_list[r + 1]]
                     for r in range(k)]
        by_link = {}
        for r in range(k):             # row order == sorted-group order
            for l in row_links[r]:
                by_link.setdefault(l, []).append(r)
    unfrozen = [True] * k
    remaining = k

    def rows_on(link: int) -> list[int]:
        """Unfrozen group rows occupying ``link``."""
        fl = by_link.get(link)
        if not fl:
            return []
        return [r for r in fl if unfrozen[r]]

    def freeze_unit(rows: list[int], alloc: float) -> int:
        """Freeze ``rows`` at rate ``alloc``; returns rows frozen."""
        if seq is None:
            for r in rows:
                rate[sg_ids[r]] = alloc
                unfrozen[r] = False
        else:
            for r in rows:
                fid = sg_ids[r]
                rate[fid] = alloc
                seq.append((fid, alloc))
                unfrozen[r] = False
        if len(rows) >= 32:
            sub = _gather(fl_ptr, fl_flat,
                          sg_pos[np.array(rows, dtype=np.int64)])
            delta = np.bincount(sub, minlength=L).astype(np.float64)
            tl = np.nonzero(delta)[0]
            residual[tl] = np.maximum(residual[tl] - alloc * delta[tl],
                                      0.0)
            wsum[tl] -= delta[tl]
        else:
            for r in rows:
                for l in row_links[r]:
                    v = residual[l] - alloc
                    residual[l] = v if v > 0.0 else 0.0
                    wsum[l] -= 1.0
        return len(rows)

    while remaining:
        rsel = residual[link_order]
        wsel = wsum[link_order]
        vidx = np.nonzero(wsel > EPS)[0]
        if len(vidx) == 0:
            for r in range(k):
                if unfrozen[r]:
                    fid = sg_ids[r]
                    rate[fid] = 0.0
                    if seq is not None:
                        seq.append((fid, 0.0))
            return
        ratio = rsel[vidx] / wsel[vidx]
        bj, best_ratio = _pick_bottleneck(ratio)
        if weights is None:
            # Freeze the whole run of links tied bitwise with the pick,
            # in link order.  After freezing a bottleneck at ratio a,
            # every remaining link's ratio stays >= a, and an exactly
            # tied link stays exactly tied under exact arithmetic — the
            # scalar fill would select precisely these links on its next
            # iterations.  Each link is re-checked before freezing; any
            # floating-point drift breaks out to a full rescan, which
            # re-derives the scalar scan's choice.
            froze_any = False
            for t in np.nonzero(ratio == best_ratio)[0].tolist():
                if t < bj:
                    continue
                link = int(link_order[vidx[t]])
                w_t = wsum[link]
                if w_t <= EPS:
                    continue
                if not froze_any:
                    froze_any = True       # the pick itself: no recheck
                elif residual[link] / w_t != best_ratio:
                    break
                rows = rows_on(link)
                if len(rows) == 0:         # numerical guard; wsum tracks
                    wsum[link] = 0.0       # unfrozen, so normally nonzero
                    continue
                remaining -= freeze_unit(rows, best_ratio)
                if not remaining:
                    break
            if not froze_any:              # guard: stale wsum on the pick
                wsum[int(link_order[vidx[bj]])] = 0.0
            continue
        best_link = int(link_order[vidx[bj]])
        rows = rows_on(best_link)
        if not rows:                       # numerical guard (see above)
            wsum[best_link] = 0.0
            continue
        for r in rows:
            fid = sg_ids[r]
            alloc = float(weights[r]) * best_ratio
            rate[fid] = alloc
            if seq is not None:
                seq.append((fid, alloc))
            unfrozen[r] = False
            for l in row_links[r]:
                v = residual[l] - alloc
                residual[l] = v if v > 0.0 else 0.0
        remaining -= len(rows)
        if remaining:
            # the scalar fill re-sums weights per iteration — recompute
            # (not decrement) so the accumulation order matches
            um = np.array(unfrozen, dtype=bool)[row]
            wsum = np.zeros(L)
            np.add.at(wsum, cat[um], weights[row[um]])


def _wf_core_py(sg_ids, flow_links, sg_pos, link_order, residual, rate,
                weights, seq):
    """Pure-stdlib fallback: simulator.waterfill ported to interned ids.

    Same freeze order and per-flow sequential subtraction as the scalar
    string-domain fill; ``link_order`` plays the residual dict's
    insertion-order role.
    """
    k = len(sg_pos)
    if k == 0:
        return
    unfrozen = list(range(k))
    unfrozen_set = set(unfrozen)
    by_link: dict[int, list[int]] = {}
    for r in unfrozen:
        for l in flow_links[sg_pos[r]]:
            by_link.setdefault(l, []).append(r)
    if weights is None:
        counts = {l: float(len(fl)) for l, fl in by_link.items()}
    while unfrozen:
        best_l, best_ratio = None, math.inf
        for l in link_order:
            fl = by_link.get(l)
            if not fl:
                continue
            if weights is None:
                w = counts[l]
            else:
                w = sum(weights[r] for r in fl if r in unfrozen_set)
            if w > EPS:
                ratio = residual[l] / w
                if ratio < best_ratio - EPS:
                    best_l, best_ratio = l, ratio
        if best_l is None:
            for r in unfrozen:
                fid = sg_ids[r]
                rate[fid] = 0.0
                if seq is not None:
                    seq.append((fid, 0.0))
            return
        best_ratio = float(best_ratio)   # residual may be an ndarray —
        #             keep rates/seq native floats for the event loop
        frozen_now = [r for r in by_link[best_l] if r in unfrozen_set]
        for r in frozen_now:
            alloc = best_ratio if weights is None \
                else weights[r] * best_ratio
            fid = sg_ids[r]
            rate[fid] = alloc
            if seq is not None:
                seq.append((fid, alloc))
            for l in flow_links[sg_pos[r]]:
                v = residual[l] - alloc
                residual[l] = v if v > 0.0 else 0.0
                if weights is None:
                    counts[l] -= 1.0
        unfrozen_set.difference_update(frozen_now)
        unfrozen = [r for r in unfrozen if r in unfrozen_set]


def _wf_fill_batch(net_ids_a, flow_links, fl_ptr, fl_flat, sg_pos,
                   link_order, residual, rate, seq, bl, unfrozen):
    """Batch-mode progressive fill: scalar-granular core on Python state.

    Unweighted groups only (coflow-weighted groups stay on
    :func:`_wf_core_np`).  Freezes touch one to a handful of links per
    row, a granularity where Python-list scalar ops beat NumPy scalar
    indexing by an order of magnitude — so the fill runs on Python
    mirrors of ``residual``/``wsum`` and the frozen rates scatter back
    in one vectorized write.  Bottleneck picks and tie-run freezes
    follow :func:`_wf_core_np` (EPS-hysteresis first-min pick,
    bitwise-tied run frozen in link order with a sequential-exact
    recheck per link); the per-row sequential subtraction matches the
    scalar oracle :func:`_wf_core_py` exactly, and freezes of >=32 rows
    collapse to one bincount (the same association order — and ulp
    drift, covered by the equivalence tolerance — as the old array
    fill's >=32 path).

    Rows are NET POSITIONS, so the incidence needs no per-call build:
    ``bl`` maps each link to the rank-sorted positions of the group
    (the caller passes the incrementally maintained per-component/class
    structure, or a per-call build when that isn't valid), ``sg_pos``
    is the rank-sorted position array, and ``unfrozen`` is a shared
    all-zero bytearray over net positions (restored to all-zero on
    return — every group member is frozen by some path).
    """
    k = len(sg_pos)
    if k == 0:
        return
    sg_list = sg_pos.tolist()
    for p in sg_list:
        unfrozen[p] = 1
    res = residual.tolist()
    ws = [0.0] * len(res)
    for l, fl in bl.items():
        if fl:
            ws[l] = float(len(fl))
    remaining = k
    frozen_pos: list[int] = []
    frozen_allocs: list[float] = []
    fp_append = frozen_pos.append
    fa_append = frozen_allocs.append
    inf = math.inf
    # links whose rows are all frozen get compacted out of the walk
    # once they are a third of it (same pick: a dead link can never
    # win); ``dead`` counts ws hitting zero in the freeze updates
    live = link_order
    dead = 0
    while remaining:
        if dead * 3 > len(live):
            live = [l for l in live if ws[l] > EPS]
            dead = 0
        # single walk: first-min scan with EPS hysteresis in link_order
        # order (== _pick_bottleneck over valid links), collecting the
        # links tied bitwise with the running best as it goes.  A link
        # bitwise-equal to the final best can never precede the pick
        # (it would have been accepted, or the pick rejected), so the
        # tie list is exactly the per-index candidate run ("pre-round
        # ratio == best, at or after the pick") of the two-pass form,
        # in order.
        best_ratio = inf
        ties: list = []
        for l in live:
            w = ws[l]
            if w <= EPS:
                continue
            q = res[l] / w
            if q < best_ratio - EPS:
                best_ratio = q
                ties = [l]
            elif q == best_ratio:
                ties.append(l)
        if not ties:
            for p in sg_list:              # rank order, like the scalar
                if unfrozen[p]:            # fill's exhaustion pass
                    unfrozen[p] = 0
                    fp_append(p)
                    fa_append(0.0)
            break
        # freeze the pick, then the run of links tied bitwise with it,
        # in link order; each later link rechecks against the current
        # (sequentially updated) residual and breaks on any drift —
        # exactly the scalar fill's iteration, with the rescans skipped
        froze_any = False
        for link in ties:
            w_t = ws[link]
            if w_t <= EPS:
                continue
            if not froze_any:
                froze_any = True           # the pick itself: no recheck
            elif res[link] / w_t != best_ratio:
                break
            # ws > 0 ==> the link is in bl with unfrozen rows (ws and
            # the incidence share bookkeeping), so index directly
            rows = [p for p in bl[link] if unfrozen[p]]
            nr = len(rows)
            if not nr:                     # numerical guard; ws tracks
                ws[link] = 0.0             # unfrozen, so normally nonzero
                dead += 1
                continue
            if nr >= 32:
                for p in rows:
                    unfrozen[p] = 0
                frozen_pos.extend(rows)
                frozen_allocs.extend([best_ratio] * nr)
                sub = _gather(fl_ptr, fl_flat,
                              np.array(rows, dtype=np.int64))
                delta = np.bincount(sub)
                for ll in np.nonzero(delta)[0].tolist():
                    c = int(delta[ll])
                    v = res[ll] - best_ratio * c
                    res[ll] = v if v > 0.0 else 0.0
                    w = ws[ll] - c
                    ws[ll] = w
                    if w <= EPS:
                        dead += 1
            else:
                for p in rows:
                    unfrozen[p] = 0
                    fp_append(p)
                    fa_append(best_ratio)
                    for ll in flow_links[p]:
                        v = res[ll] - best_ratio
                        res[ll] = v if v > 0.0 else 0.0
                        w = ws[ll] - 1.0
                        ws[ll] = w
                        if w <= EPS:
                            dead += 1
            remaining -= nr
            if not remaining:
                break
        if not froze_any:                  # guard: stale ws on the pick
            link = ties[0]
            if ws[link] > EPS:
                dead += 1
            ws[link] = 0.0
    residual[:] = res
    ia = net_ids_a[np.array(frozen_pos, dtype=np.int64)]
    rate[ia] = frozen_allocs
    if seq is not None:
        seq.extend(zip(ia.tolist(), frozen_allocs))


def vectorized_waterfill(group, paths, weight, residual, rates):
    """Drop-in vectorized :func:`repro_torch.core.simulator.waterfill`.

    Same contract: mutates ``residual`` (a dict whose insertion order is
    the bottleneck iteration order) and ``rates``; returns the freeze
    sequence in identical order.  Values agree with the scalar fill to
    within EPS (batched subtraction associates differently at the last
    ulp); the freeze order is identical.  Falls back to the scalar fill
    when NumPy is absent.
    """
    if np is None:
        from repro_torch.core.simulator import waterfill
        return waterfill(group, paths, weight, residual, rates)
    names_sorted = sorted(group)
    k = len(names_sorted)
    if k == 0:
        return []
    link_ids = {l: i for i, l in enumerate(residual)}
    res_arr = np.array([float(v) for v in residual.values()])
    ptr = [0]
    flat: list[int] = []
    for nm in names_sorted:
        for l in paths[nm]:
            flat.append(link_ids[l])
        ptr.append(len(flat))
    fl_ptr = np.array(ptr, dtype=np.int64)
    fl_flat = np.array(flat, dtype=np.int64)
    sg_ids = list(range(k))
    sg_pos = np.arange(k, dtype=np.int64)
    link_order = np.arange(len(link_ids), dtype=np.int64)
    rate_arr = [0.0] * k
    weights = None if weight is None \
        else np.array([float(weight(nm)) for nm in names_sorted])
    seq_ids: list[tuple[int, float]] = []
    _wf_core_np(sg_ids, fl_ptr, fl_flat, sg_pos, link_order, res_arr,
                rate_arr, weights, seq_ids)
    for l, li in link_ids.items():
        residual[l] = float(res_arr[li])
    seq = [(names_sorted[i], float(a)) for i, a in seq_ids]
    for nm, a in seq:
        rates[nm] = a
    return seq


class ResurrectConflict(RuntimeError):
    """``resurrect`` refused: started consumers hold the task's output.

    Raised when un-finishing a task whose data is still being consumed
    by one or more *started, unfinished* tasks — they would be running
    on data that no longer exists.  ``task`` names the resurrection
    target and ``consumers`` every offending consumer (sorted), so a
    lineage-closure caller (``kill_host``) can kill exactly those
    consumers and retry.
    """

    def __init__(self, task: str, consumers):
        self.task = task
        self.consumers = tuple(consumers)
        super().__init__(
            f"resurrect({task}): consumer(s) "
            f"{', '.join(self.consumers)} running on its output — "
            f"kill them first")


def array_run(sim, horizon: float = 1e15, batch: bool = True):
    """Run ``sim`` to completion on the compiled flat arrays.

    A faithful translation of ``Simulator.calendar_run`` — same event
    structure, gating semantics, allocation and tie-breaking orders — on
    integer-indexed state.  See the module docstring for where the two
    may differ in floating-point association (last-ulp only).

    ``batch=False`` disables the mega-batch vectorized passes (NumPy
    state vectors, batched fills/integration/completion scans and the
    per-component event heaps) and runs the retained per-event paths —
    the differential oracle the batched loop is tested against, and the
    "before" arm of the ``scale.speedup_batch_*`` benchmark rows.

    Implemented as one uninterrupted :class:`ResumableSim` session, so
    the pausable fault-capable engine and this hot path are a single
    implementation that cannot drift apart (the zero-fault differential
    tests pin the equivalence regardless).
    """
    rs = ResumableSim(sim, horizon, batch=batch)
    rs.run_until(math.inf)
    return rs.result()


class ResumableSim:
    """A pausable array-DES session: run, pause, mutate, resume.

    Construction compiles (or reuses the cached compile of) ``sim`` and
    materialises the exact run state ``array_run`` uses — flat
    work/rate/cap vectors, the event heap, per-component allocation
    state — as closure cells shared by one ``advance`` loop and a set of
    mutators.  With no mutations applied, pausing and resuming is
    bit-exact against the uninterrupted run: ``run_until`` only ever
    stops *between* events (the next event strictly after ``t_stop``
    stays in the heap), so no partial-interval work integration is
    introduced.  ``advance_to`` moves the clock into the gap before the
    next event (integrating work) so a fault can land at its exact
    scheduled time.

    Mutators implement the fault model of :mod:`repro_torch.core.nemesis`:

    - ``set_speed`` — per-task rate multiplier (straggler / slow
      executor).  Speeds multiply at use (``rate[i] * speed[i]``), so
      the all-ones default is IEEE-exact against the plain engine.  A
      straggling flow still *holds* its waterfilled share — slow
      delivery wastes the allocation, as on a real fabric.
    - ``set_link_bw`` / ``scale_link`` — link degradation or failure.
      Components touching the link are re-waterfilled through the
      existing component-level reallocation (dirtied at class ``-inf``).
    - ``kill_task`` / ``kill_host`` — progress loss.  ``kill_host``
      computes the lineage closure: finished tasks whose output data
      resided on the dead host (computes placed there, flows delivered
      there) and is still needed by an unfinished data consumer are
      resurrected (gate counters restored) so the data is reproduced.
      Compute→compute edges are treated as control-only dependencies;
      their data, if any, is assumed durable.
    - ``move_task`` / ``repath_flow`` — the replanner's recovery
      actions: re-place a compute (restarting it if begun), re-path a
      flow without recompiling, merging contention components when the
      new path bridges previously disjoint ones.
    - ``set_priorities`` — re-prioritise (and optionally switch policy)
      mid-run; freeze-sequence replay logs are invalidated and dirty
      components refill from scratch.

    Mutations queue against the paused clock and are *settled* (restart
    gating, starvation flips, component refills, event rescheduling —
    exactly the passes one event iteration runs) before the next
    advance.  ``checkpoint``/``restore`` snapshot the whole mutable
    state so scenario arms can fork from one shared pre-fault prefix.
    Resurrecting a coflow member rewinds the group's MADD bookkeeping:
    the unfinished-member count re-opens, and when the group had
    already completed, its consumers' start gates are restored (the
    all-or-nothing output is no longer complete) — so fault scenarios
    may kill coflow-coupled lineage freely.  Started consumers of a
    resurrection target raise :class:`ResurrectConflict` (naming every
    offender); ``kill_host`` catches it and kills exactly those
    consumers before retrying.
    """

    def __init__(self, sim, horizon: float = 1e15, batch: bool = True):
        from repro_torch.core.simulator import SimResult

        comp = compile_sim(sim)
        use_np = comp.np_ready and np is not None
        # mega-batch mode: NumPy-backed state vectors and vectorized
        # event-batch passes (fills, integration, completion scans,
        # per-component heaps).  Off — or NumPy absent — runs the
        # retained per-event scalar paths, which double as the
        # differential oracle for the batched loop.
        use_batch = bool(batch) and use_np
        n = comp.n
        names = comp.names
        size, unit, nu = comp.size, comp.unit, comp.nu
        is_comp = comp.is_compute
        net_pos, net_ids = comp.net_pos, comp.net_ids
        flow_links = comp.flow_links
        stream_in, stream_out = comp.stream_in, comp.stream_out
        gate_stream = comp.gate_stream
        coflow_of, coflows = comp.coflow_of, comp.coflows
        succ = comp.succ
        policy = sim.policy
        prio_get = sim.prio.get
        inf = math.inf
        heappush, heappop = heapq.heappush, heapq.heappop
        cluster = sim.cluster
        hosts = cluster.hosts

        # -- per-run priority/release arrays ---------------------------
        if policy == "fair":
            cls_net: list = [None] * comp.n_net
        else:
            cls_net = [0.0 if comp.stream_fed[i]
                       else prio_get(names[i], 0.0)
                       for i in net_ids]
        cls_net_a = np.array(cls_net, dtype=np.float64) \
            if use_batch and policy != "fair" else None
        prio_arr = [prio_get(nm, 0.0) for nm in names]
        if use_np:
            order = np.lexsort((comp.name_rank_a, np.array(prio_arr)))
            dr = np.empty(n, dtype=np.int64)
            dr[order] = np.arange(n, dtype=np.int64)
            dispatch_rank = dr.tolist()
        else:
            order = sorted(range(n),
                           key=lambda i: (prio_arr[i], comp.name_rank[i]))
            dispatch_rank = [0] * n
            for r, i in enumerate(order):
                dispatch_rank[i] = r
        rel = [0.0] * n
        for nm, v in sim.releases.items():
            rel[comp.idx[nm]] = v

        # -- dynamic state (batch mode: float64/bool NumPy vectors so
        # the fill / integration / completion passes run as array math;
        # otherwise flat lists — scalar access in the branchy event
        # code is list-speed, batch math converts on demand) -----------
        if use_batch:
            work = np.zeros(n)
            rate = np.zeros(n)
            speed = np.ones(n)           # fault-model rate multipliers
            starved_net = np.zeros(comp.n_net, dtype=bool)
            simple_a = np.array(comp.simple, dtype=bool)
            link_bw_a_run = comp.link_bw_a.copy()
            # incremental fill incidence: (K, cls) -> {link: rank-sorted
            # positions of that component/class's runnable flows}.
            # Built lazily at the first big fill, then maintained by
            # inc_add/inc_remove as flows start and complete, so the
            # steady-state fill skips the O(group x links) rebuild.
            # Cleared wholesale on anything non-incremental (restore,
            # repath, priority swaps, fault mutators).
            inc_bylink: dict = {}
            unfrozen_pos = bytearray(comp.n_net)   # all-zero between fills
            pos_rank = comp.name_rank_a[comp.net_ids_a].tolist()
        else:
            work = [0.0] * n
            rate = [0.0] * n
            speed = [1.0] * n
            starved_net = [False] * comp.n_net
            simple_a = link_bw_a_run = None
            inc_bylink = unfrozen_pos = pos_rank = None
        vcopy = (lambda a: a.copy()) if use_batch else (lambda a: a[:])
        cap = list(size)                 # cap_of default = size
        speed_on = False                 # sticky: any speed ever != 1.0
        started: list = [None] * n
        finished: list = [None] * n
        has_slot = [False] * n
        starved = [False] * n
        d_units = [0] * n
        slots_free = list(comp.slot_cap)
        cof_left = [len(c) for c in coflows]
        n_gate = list(comp.init_gate)
        active: set[int] = set()
        waiting_slot: dict[int, set[int]] = {}
        candidates: set[int] = set()
        freed: set[int] = set()
        touched: set[int] = set()        # needs a starvation re-check
        touched_sched: set[int] = set()  # only needs schedule_event
        #   (fresh capless starts, rate changes: their starvation state
        #   provably cannot have flipped, so the re-check loop skips
        #   them)
        # component state: per contention component, the runnable net
        # positions, the started-unfinished *simple* flows (whose
        # completion events coalesce into one heap entry per component),
        # the (class -> freeze sequence) replay log, and the lowest
        # dirty priority class (fair: 0.0) since the last fill
        comp_of = comp.comp_of_net
        simple = comp.simple
        n_comps = comp.n_comps
        comp_runnable: list = [set() for _ in range(n_comps)]
        comp_simple_active: list = [set() for _ in range(n_comps)]
        comp_log: list = [None] * n_comps
        comp_stamp = [0] * n_comps
        comp_dirty: dict = {}
        comp_resched: set[int] = set()
        # mutators patch link capacities in place — run-owned copy, so
        # the compile cached on the graph is never poisoned
        link_bw = list(comp.link_bw)
        residual = comp.link_bw_a.copy() if use_np else list(link_bw)
        heap: list = []
        # per-component event heaps (batch mode, >=2 components): a
        # component's kind-1/2 entries live in comp_heaps[K] and the
        # global heap carries only releases, compute-task entries, and
        # kind-3 meta hints ``(t, 3, K, 0)`` — one per component head.
        # A hint is pushed whenever a push lowers a component's head,
        # so min(hints for K) <= head(K) always holds and the global
        # heap never misses a component event; stale hints (head moved
        # by lazy pruning or draining) are refreshed on pop.  Net
        # effect: a huge component's churn (thousands of stale entries
        # per reallocation) stops inflating every other component's
        # push/pop cost.
        use_cheaps = use_batch and n_comps >= 2
        comp_heaps: list = \
            [[] for _ in range(n_comps)] if use_cheaps else None
        stamp = [0] * n
        unfinished = n
        now = 0.0
        needs_settle = False

        # copy-on-write structural state: repath/move rebind these to
        # run-local copies on first mutation; until then the compile's
        # arrays are shared read-only
        slot_of = comp.slot_of
        slot_ids_run = comp.slot_ids
        fl_ptr, fl_flat = comp.fl_ptr, comp.fl_flat
        full_sg_pos = comp.full_sg_pos
        full_sorted_ids = comp.full_sorted_ids
        full_row_links = comp.full_row_links
        full_by_link = comp.full_by_link
        full_counts = comp.full_counts

        # link-name interning (big-switch compiles key links by endpoint
        # tuples; surface the NIC resource names either way) and current
        # placement/endpoints (the graph's Task objects are never
        # mutated — moves and repaths live here)
        link_names: list = [None] * len(link_bw)
        link_name_id: dict[str, int] = {}
        for k, li in comp.link_ids.items():
            lname = k if isinstance(k, str) else \
                (k[1] + ".nic_out" if k[0] == "o" else k[1] + ".nic_in")
            link_names[li] = lname
            link_name_id[lname] = li
        cur_host: list = [None] * n
        cur_src: list = [None] * comp.n_net
        cur_dst: list = [None] * comp.n_net
        for i, t in enumerate(sim.g.tasks.values()):
            if is_comp[i]:
                cur_host[i] = t.host
            else:
                p = net_pos[i]
                cur_src[p] = t.src
                cur_dst[p] = t.dst

        def dirty_net(pos: int) -> None:
            """Mark flow ``pos``'s component dirty at its class."""
            K = comp_of[pos]
            c = cls_net[pos]
            if c is None:                # fair policy: one class
                c = 0.0
            cur = comp_dirty.get(K)
            if cur is None or c < cur:
                comp_dirty[K] = c

        def delivered_fraction(p: int) -> float:
            """Fraction of ``p``'s output delivered (unit granularity)."""
            if finished[p] is not None:
                return 1.0
            sz = size[p]
            if sz <= 0:
                return 1.0
            u = unit[p]
            return min(1.0, math.floor(work[p] / u + EPS) * u / sz)

        def start_gate_ok(i: int) -> bool:
            """Gate counter zero and first streamed unit available?"""
            if n_gate[i]:
                return False
            for p in gate_stream[i]:
                if delivered_fraction(p) + EPS < 1.0 / nu[i]:
                    return False
            return True

        def recompute_cap(i: int) -> float:
            """Work cap from streaming predecessors' delivered units."""
            c = size[i]
            nui = nu[i]
            eu = unit[i]
            for p in stream_in[i]:
                if finished[p] is None:
                    enabled = math.floor(delivered_fraction(p) * nui
                                         + EPS)
                    c2 = enabled * eu
                    if c2 < c:
                        c = c2
            return c

        pending: list = []               # kind-1 entries awaiting the heap
        _defer = pending.append

        def schedule_event(i: int) -> None:
            """(Re)compute task ``i``'s next unit/cap/completion event."""
            stamp[i] += 1
            r = rate[i]
            if speed_on:
                r = r * speed[i]
            if finished[i] is not None or started[i] is None or r <= EPS:
                active.discard(i)
                return
            active.add(i)
            sz = size[i]
            w = work[i]
            u = unit[i]
            if u >= sz and cap[i] >= sz:
                # common case: no unit boundaries, cap at size — the
                # sole target is completion (bit-identical to the
                # general fold)
                if sz > w + EPS:
                    _defer((float(now + (sz - w) / r), 1, i, stamp[i]))
                return
            if u < sz:
                tgt = (math.floor(w / u + EPS) + 1) * u
                if tgt > sz:
                    tgt = sz
            else:
                tgt = sz
            best = inf
            if tgt > w + EPS:
                best = (tgt - w) / r
            if sz > w + EPS:
                d = (sz - w) / r
                if d < best:
                    best = d
            c = cap[i]
            if c > w + EPS:
                d = (c - w) / r
                if d < best:
                    best = d
            if best < inf:
                _defer((float(now + best), 1, i, stamp[i]))

        def flush_events() -> None:
            """Move deferred entries into the heap: one heapify for a
            mega-batch (same entry set, so the event calendar is
            unchanged — only the arbitrary pop order of equal-time
            entries may differ, which batch collection absorbs),
            individual pushes otherwise.  With per-component heaps,
            flow entries route to their component's heap instead, with
            a meta hint on the global heap whenever a push lowers that
            component's head."""
            if comp_heaps is not None:
                for e in pending:
                    if e[1] == 2:
                        K = e[2]
                    else:
                        i2 = e[2]
                        if is_comp[i2]:
                            heappush(heap, e)
                            continue
                        K = comp_of[net_pos[i2]]
                    ch = comp_heaps[K]
                    if not ch or e[0] < ch[0][0]:
                        heappush(heap, (e[0], 3, K, 0))
                    heappush(ch, e)
                pending.clear()
                return
            if len(pending) > 1024 and len(pending) * 2 > len(heap):
                heap.extend(pending)
                heapq.heapify(heap)
            else:
                for e in pending:
                    heappush(heap, e)
            pending.clear()

        def meta_head(K: int):
            """Validate a kind-3 meta hint: prune component ``K``'s
            stale entries and return its true head time (None when it
            has no live events).  The caller drops the hint when this
            returns None and refreshes it when the head disagrees."""
            ch = comp_heaps[K]
            while ch:
                t2, k2, i2, s2 = ch[0]
                if k2 == 1 and (stamp[i2] != s2
                                or finished[i2] is not None):
                    heappop(ch)
                    continue
                if k2 == 2 and comp_stamp[i2] != s2:
                    heappop(ch)
                    continue
                return t2
            return None

        gate_dec = comp.gate_dec

        def schedule_comp(K: int) -> None:
            """(Re)compute a component's next *completion* among its
            simple flows: one heap entry per component instead of one
            per flow.  Each candidate time is the exact float
            schedule_event would compute (``now + (size-work)/rate``),
            and min over them is the earliest per-flow entry — so the
            event calendar is unchanged; only the stale-entry volume
            shrinks from O(flows) to O(1) per reallocation."""
            st = comp_stamp[K] + 1
            comp_stamp[K] = st
            csa = comp_simple_active[K]
            if use_batch and len(csa) >= 48:
                # same per-flow divisions elementwise, same min — the
                # candidate times are bit-identical to the scalar scan
                ids = np.fromiter(csa, dtype=np.int64, count=len(csa))
                r = rate[ids]
                if speed_on:
                    r = r * speed[ids]
                on = r > EPS
                if on.any():
                    sel = ids[on]
                    d = (comp.size_a[sel] - work[sel]) / r[on]
                    _defer((float(now + d.min()), 2, K, st))
                return
            best = inf
            for i in csa:
                r = rate[i]
                if speed_on:
                    r = r * speed[i]
                if r > EPS:
                    d = (size[i] - work[i]) / r
                    if d < best:
                        best = d
            if best < inf:
                _defer((float(now + best), 2, K, st))

        def inc_add(pos: int) -> None:
            """A flow became runnable: insert it (rank-ordered) into its
            component/class's incremental fill incidence, if built."""
            bl = inc_bylink.get(
                (comp_of[pos], None if policy == "fair" else cls_net[pos]))
            if bl is None:
                return
            rk = pos_rank[pos]
            for l in flow_links[pos]:
                fl = bl.get(l)
                if fl is None:
                    bl[l] = [pos]
                    continue
                if not fl:
                    fl.append(pos)
                    continue
                last = fl[-1]
                if last == pos:                         # tolerate re-adds
                    continue
                if pos_rank[last] < rk:                 # common: in-order
                    fl.append(pos)
                else:
                    j = bisect_left(fl, rk, key=pos_rank.__getitem__)
                    if j == len(fl) or fl[j] != pos:   # tolerate re-adds
                        fl.insert(j, pos)

        def inc_remove(pos: int) -> None:
            """A flow left the runnable set: drop it from the incidence
            (tolerant — absent positions are a no-op)."""
            bl = inc_bylink.get(
                (comp_of[pos], None if policy == "fair" else cls_net[pos]))
            if bl is None:
                return
            rk = pos_rank[pos]
            for l in flow_links[pos]:
                fl = bl.get(l)
                if fl:
                    if fl[-1] == pos:                   # common: tail pop
                        fl.pop()
                    else:
                        j = bisect_left(fl, rk,
                                        key=pos_rank.__getitem__)
                        if j < len(fl) and fl[j] == pos:
                            del fl[j]

        def complete(i: int) -> None:
            """Finish ``i``: free resources, trigger gated candidates."""
            nonlocal unfinished
            finished[i] = now
            unfinished -= 1
            active.discard(i)
            if has_slot[i]:
                si = slot_of[i]
                slots_free[si] += 1
                has_slot[i] = False
                freed.add(si)
            if is_comp[i]:
                rate[i] = 0.0
            else:
                pos = net_pos[i]
                K = comp_of[pos]
                comp_runnable[K].discard(pos)
                if inc_bylink:
                    inc_remove(pos)
                if simple[i]:
                    comp_simple_active[K].discard(i)
                if rate[i]:
                    rate[i] = 0.0
                    dirty_net(pos)
            candidates.update(succ[i])
            for s in gate_dec[i]:
                n_gate[s] -= 1
            for c in stream_out[i]:
                if started[c] is not None and finished[c] is None:
                    nc = recompute_cap(c)
                    if nc != cap[c]:
                        cap[c] = nc
                        touched.add(c)
            if coflows:
                ci = coflow_of[i]
                if ci >= 0:
                    cof_left[ci] -= 1
                    if cof_left[ci] == 0:
                        for t in comp.cof_dec[ci]:
                            n_gate[t] -= 1
                        for m in coflows[ci]:
                            candidates.update(succ[m])
                for ci2 in comp.coflow_fed_by[i]:
                    candidates.update(coflows[ci2])

        def complete_bulk(ids: list[int]) -> None:
            """complete() over a large batch: per-task effects are
            identical (each is independent of the others' — see
            complete()), but the set-membership bookkeeping is batched
            through C-level updates."""
            nonlocal unfinished
            unfinished -= len(ids)
            active.difference_update(ids)
            succs: list = []
            for i in ids:
                finished[i] = now
                if has_slot[i]:
                    si = slot_of[i]
                    slots_free[si] += 1
                    has_slot[i] = False
                    freed.add(si)
                if is_comp[i]:
                    rate[i] = 0.0
                else:
                    pos = net_pos[i]
                    K = comp_of[pos]
                    comp_runnable[K].discard(pos)
                    if inc_bylink:
                        inc_remove(pos)
                    if simple[i]:
                        comp_simple_active[K].discard(i)
                    if rate[i]:
                        rate[i] = 0.0
                        dirty_net(pos)
                if succ[i]:
                    succs.append(succ[i])
                for s in gate_dec[i]:
                    n_gate[s] -= 1
                for c in stream_out[i]:
                    if started[c] is not None and finished[c] is None:
                        nc = recompute_cap(c)
                        if nc != cap[c]:
                            cap[c] = nc
                            touched.add(c)
                if coflows:
                    ci = coflow_of[i]
                    if ci >= 0:
                        cof_left[ci] -= 1
                        if cof_left[ci] == 0:
                            for t in comp.cof_dec[ci]:
                                n_gate[t] -= 1
                            for m in coflows[ci]:
                                candidates.update(succ[m])
                    for ci2 in comp.coflow_fed_by[i]:
                        candidates.update(coflows[ci2])
            candidates.update(chain.from_iterable(succs))

        def on_start(i: int) -> None:
            """Initialize ``i``'s streaming caps/counters at start."""
            c = size[i]
            if stream_in[i]:
                c = recompute_cap(i)
                cap[i] = c
            if stream_out[i]:
                d_units[i] = 0
                for c2 in stream_out[i]:
                    candidates.add(c2)  # first-unit gate may already pass
            is_starved = c <= work[i] + EPS
            starved[i] = is_starved
            if is_comp[i]:
                rate[i] = 0.0 if is_starved else 1.0
            else:
                pos = net_pos[i]
                starved_net[pos] = is_starved
                K = comp_of[pos]
                comp_runnable[K].add(pos)
                if inc_bylink:
                    inc_add(pos)
                dirty_net(pos)
                if simple[i]:
                    # coalesced: activation and the completion event
                    # ride on the component refill this dirty_net just
                    # forced
                    comp_simple_active[K].add(i)
                    return
            # only a pipelined-input cap can move between now and the
            # starvation pass — capless tasks can't flip
            (touched if stream_in[i] else touched_sched).add(i)

        def process_starts() -> None:
            """Start every candidate whose gates and slots allow it."""
            while True:
                # gate counters inlined; stream-fraction gates (rare) go
                # through start_gate_ok
                startable = [i for i in candidates
                             if started[i] is None
                             and rel[i] <= now + EPS
                             and not n_gate[i]
                             and (not gate_stream[i] or start_gate_ok(i))]
                candidates.clear()
                if not startable:
                    return
                zero_done = False
                if not any(map(is_comp.__getitem__, startable)):
                    # flow-only pass: no slot contention, so dispatch
                    # order is immaterial (all effects are commutative
                    # set/flag updates) — skip the sort, inline the
                    # common case and batch the set bookkeeping
                    for i in startable:
                        started[i] = now
                        if stream_in[i] or stream_out[i] \
                                or size[i] <= EPS:
                            on_start(i)
                            if size[i] <= EPS:
                                complete(i)
                                zero_done = True
                            continue
                        pos = net_pos[i]
                        starved[i] = False
                        starved_net[pos] = False
                        K = comp_of[pos]
                        comp_runnable[K].add(pos)
                        if inc_bylink:
                            inc_add(pos)
                        dirty_net(pos)
                        if simple[i]:
                            comp_simple_active[K].add(i)
                        else:
                            touched_sched.add(i)
                else:
                    for i in sorted(startable,
                                    key=dispatch_rank.__getitem__):
                        if is_comp[i]:
                            si = slot_of[i]
                            if slots_free[si] >= 1:
                                slots_free[si] -= 1
                                has_slot[i] = True
                                started[i] = now
                                w = waiting_slot.get(si)
                                if w is not None:
                                    w.discard(i)
                            else:
                                waiting_slot.setdefault(si, set()).add(i)
                                continue
                        else:
                            started[i] = now
                        on_start(i)
                        if size[i] <= EPS:
                            complete(i)
                            zero_done = True
                for si in freed:
                    candidates.update(waiting_slot.get(si, ()))
                freed.clear()
                if not zero_done and not candidates:
                    return

        def group_weights(fids):
            """MADD weights (∝ remaining work) for a coflow group."""
            out = []
            for fid in fids:
                ci = coflow_of[fid]
                if ci < 0:
                    out.append(1.0)
                    continue
                rem = {m: size[m] - work[m] for m in coflows[ci]
                       if finished[m] is None}
                mx = max(rem.values(), default=1.0)
                out.append(max(rem.get(fid, 0.0) / mx, 1e-6)
                           if mx > 0 else 1.0)
            return out

        any_coflow = bool(coflows)

        def allocate() -> list:
            """Waterfill every *dirty component*, classes from that
            component's lowest dirty one up (replaying the logged freeze
            sequences of its unchanged classes below), exactly as the
            calendar core's global allocate() — components share no
            links, so an untouched component's rates (and the residual
            its links hold) are provably the ones a full refill would
            recompute, and it is skipped entirely.  Groups of ≥48 flows
            over ≥48 links use the vectorized fill; smaller groups stay
            on the scalar port, whose constant factors beat NumPy-call
            overhead at that size."""
            changed: list = []
            fast_groups = use_batch and not any_coflow
            for K in sorted(comp_dirty):
                pos_a = None
                if fast_groups:
                    m = len(comp_runnable[K])
                    old_log = comp_log[K]
                    if m == 0:
                        comp_log[K] = None
                        continue
                    ps = np.fromiter(comp_runnable[K], dtype=np.int64,
                                     count=m)
                    ps.sort()
                    pos_a = ps[~starved_net[ps]]
                    if len(pos_a) == 0:
                        comp_log[K] = None
                        continue
                    positions = pos_a.tolist()
                    # first-seen link order over the sorted positions:
                    # the concatenated incidence is exactly the scalar
                    # append order, so sorting the unique links by first
                    # occurrence reproduces it
                    cat_k = _gather(fl_ptr, fl_flat, pos_a)
                    uniq, first = np.unique(cat_k, return_index=True)
                    lo_arr = uniq[np.argsort(first, kind="stable")]
                    residual[lo_arr] = link_bw_a_run[lo_arr]
                    link_order = lo_arr.tolist()
                else:
                    positions = [p for p in sorted(comp_runnable[K])
                                 if not starved_net[p]]
                    old_log = comp_log[K]
                    if not positions:
                        comp_log[K] = None
                        continue
                    seen: set[int] = set()
                    link_order = []
                    for p in positions:
                        for l in flow_links[p]:
                            if l not in seen:
                                seen.add(l)
                                link_order.append(l)
                    for l in link_order:  # reset only this comp's links
                        residual[l] = link_bw[l]
                    lo_arr = None
                if policy == "fair":
                    classes: list = [None]
                    lowest = None
                    pos_cls = None
                elif fast_groups:
                    pos_cls = cls_net_a[pos_a]
                    classes = np.unique(pos_cls).tolist()
                    lowest = comp_dirty[K]
                else:
                    classes = sorted({cls_net[p] for p in positions})
                    lowest = comp_dirty[K]
                    pos_cls = None
                new_log: dict = {}
                for cls in classes:
                    if lowest is None or cls >= lowest \
                            or old_log is None or cls not in old_log:
                        # the freeze log is only ever replayed under the
                        # priority policy (fair always refills) — skip
                        # building it when it can never be read
                        seq = None if policy == "fair" else []
                        if fast_groups:
                            gpa = pos_a if cls is None \
                                else pos_a[pos_cls == cls]
                            gpos = gpa.tolist()
                        else:
                            gpa = None
                            gpos = positions if cls is None else \
                                [p for p in positions
                                 if cls_net[p] == cls]
                        # batch mode drops the link-count requirement:
                        # the scalar fill's only remaining edge is tiny
                        # groups, where NumPy call overhead dominates
                        big = use_np and len(gpos) >= 48 \
                            and (use_batch or len(link_order) >= 48)
                        full = big and full_counts is not None \
                            and len(gpos) == comp.n_net
                        if full:
                            sg_pos_a = full_sg_pos
                            sg_ids = full_sorted_ids
                        elif big:
                            ga = gpa if gpa is not None \
                                else np.array(gpos, dtype=np.int64)
                            o = np.argsort(
                                comp.name_rank_a[comp.net_ids_a[ga]],
                                kind="stable")
                            sg_pos_a = ga[o]
                            sg_ids = comp.net_ids_a[sg_pos_a].tolist()
                        else:
                            sg_pos = sorted(
                                gpos,
                                key=lambda p: comp.name_rank[net_ids[p]])
                            sg_ids = [net_ids[p] for p in sg_pos]
                        if fast_groups:
                            gids_a = comp.net_ids_a[gpa]
                            old_a = rate[gids_a].copy()
                            gids = old = None
                        else:
                            gids_a = None
                            gids = [net_ids[p] for p in gpos]
                            old = [rate[f] for f in gids]
                        weights = None
                        if any_coflow \
                                and any(coflow_of[f] >= 0
                                        for f in sg_ids):
                            weights = group_weights(sg_ids)
                        # the scalar-granular batch fill wins when
                        # rounds freeze a handful of rows each (layered
                        # / trickle shapes); huge uniform groups
                        # (all-to-all shuffles) freeze thousands of
                        # rows in a round or two, where the vectorized
                        # np rounds are far cheaper — route those there
                        if big and use_batch and weights is None \
                                and len(gpos) < 2048:
                            # per-(component, class) link incidence:
                            # valid exactly when the group is the whole
                            # runnable membership (no starved members),
                            # which is when inc_add/inc_remove have been
                            # tracking it; otherwise build per-call
                            use_inc = pos_a is not None \
                                and len(pos_a) == m
                            bl = inc_bylink.get((K, cls)) \
                                if use_inc else None
                            if bl is None:
                                bl = {}
                                bget = bl.get
                                # rank-sorted positions -> plain appends
                                # yield the rank-sorted per-link lists
                                # the incremental hooks maintain
                                for p in sg_pos_a.tolist():
                                    for l in flow_links[p]:
                                        fl2 = bget(l)
                                        if fl2 is None:
                                            bl[l] = [p]
                                        else:
                                            fl2.append(p)
                                if use_inc:
                                    inc_bylink[(K, cls)] = bl
                            _wf_fill_batch(comp.net_ids_a, flow_links,
                                           fl_ptr, fl_flat, sg_pos_a,
                                           link_order, residual, rate,
                                           seq, bl, unfrozen_pos)
                        elif big:
                            if lo_arr is None:
                                lo_arr = np.array(link_order,
                                                  dtype=np.int64)
                            _wf_core_np(sg_ids, fl_ptr, fl_flat,
                                        sg_pos_a, lo_arr, residual,
                                        rate,
                                        None if weights is None
                                        else np.array(weights), seq,
                                        prep=((full_row_links,
                                               full_by_link,
                                               full_counts)
                                              if full
                                              and weights is None
                                              else None))
                        else:
                            _wf_core_py(sg_ids, flow_links, sg_pos,
                                        link_order, residual, rate,
                                        weights, seq)
                        if fast_groups:
                            chm = rate[gids_a] != old_a
                            if chm.any():
                                changed.extend(gids_a[chm].tolist())
                        else:
                            changed.extend(f for f, o in zip(gids, old)
                                           if rate[f] != o)
                        new_log[cls] = seq
                    else:
                        # unchanged class: replay the logged freeze seq
                        for fid, alloc in old_log[cls]:
                            rate[fid] = alloc
                            for l in flow_links[net_pos[fid]]:
                                v = residual[l] - alloc
                                residual[l] = v if v > 0.0 else 0.0
                        new_log[cls] = old_log[cls]
                comp_log[K] = new_log
            comp_resched.update(comp_dirty)
            comp_dirty.clear()
            return changed

        def apply_changed(changed) -> None:
            """Route freshly waterfilled rates to their event mechanism:
            coalesced (simple) flows only need their ``active``
            membership maintained — their component's next-completion
            entry is being recomputed by schedule_comp — while
            everything else re-derives its per-task event."""
            if use_batch and len(changed) >= 64:
                ca = np.array(changed, dtype=np.int64)
                sm = simple_a[ca]
                simp = ca[sm]
                on = rate[simp] > EPS
                active.update(simp[on].tolist())
                active.difference_update(simp[~on].tolist())
                touched_sched.update(ca[~sm].tolist())
                return
            for i in changed:
                if simple[i]:
                    if rate[i] > EPS:
                        active.add(i)
                    else:
                        active.discard(i)
                else:
                    touched_sched.add(i)

        # -- initialisation --------------------------------------------
        for nm, v in sim.releases.items():
            if v > EPS:
                heappush(heap, (float(v), 0, comp.idx[nm], 0))
        candidates.update(comp.roots)
        process_starts()
        if comp_dirty:
            apply_changed(allocate())
        for i in touched:
            schedule_event(i)
        for i in touched_sched:
            if i not in touched:
                schedule_event(i)
        for K in comp_resched:
            schedule_comp(K)
        comp_resched.clear()
        flush_events()
        touched.clear()
        touched_sched.clear()

        guard = 0
        max_iters = 10000 * (n + 1) + comp.nu_sum

        # -- settle: post-mutation fixup at a frozen clock -------------
        def settle() -> None:
            """Apply queued mutations' consequences at time ``now``:
            the completion/start/starvation/reallocation/reschedule
            passes one event iteration runs, with an empty event batch.
            Called automatically before the next advance."""
            nonlocal needs_settle
            needs_settle = False
            done_now = [i for i in active if work[i] >= size[i] - EPS]
            for i in done_now:
                complete(i)
            for si in freed:
                candidates.update(waiting_slot.get(si, ()))
            freed.clear()
            if candidates:
                process_starts()
            for i in list(touched):
                if started[i] is None or finished[i] is not None:
                    continue
                is_starved = cap[i] <= work[i] + EPS
                if is_starved != starved[i]:
                    starved[i] = is_starved
                    if is_comp[i]:
                        rate[i] = 0.0 if is_starved else 1.0
                    else:
                        pos = net_pos[i]
                        starved_net[pos] = is_starved
                        if is_starved:
                            rate[i] = 0.0
                        dirty_net(pos)
            if coflows:
                for ci, c in enumerate(coflows):
                    if any(started[m] is not None and finished[m] is None
                           for m in c):
                        for m in c:
                            dirty_net(net_pos[m])
            if comp_dirty:
                apply_changed(allocate())
            for i in touched:
                schedule_event(i)
            for i in touched_sched:
                if i not in touched:
                    schedule_event(i)
            for K in comp_resched:
                schedule_comp(K)
            comp_resched.clear()
            flush_events()
            touched.clear()
            touched_sched.clear()

        # -- main loop, pausable ---------------------------------------
        def advance(t_stop: float, allow_stall: bool) -> str:
            """Process events up to ``t_stop`` (inclusive); returns
            ``"done"`` (all tasks finished), ``"paused"`` (next event
            strictly after ``t_stop``) or, with ``allow_stall``,
            ``"stalled"`` (unfinished tasks but no events — e.g. every
            runnable task starved by a fault and nobody replanning)."""
            nonlocal now, guard
            if needs_settle:
                settle()
            while unfinished:
                t_next = None
                while heap:
                    tm, kind, i, stp = heap[0]
                    if kind == 1 and (stamp[i] != stp
                                      or finished[i] is not None):
                        heappop(heap)
                        continue
                    if kind == 0 and started[i] is not None:
                        heappop(heap)
                        continue
                    if kind == 2 and comp_stamp[i] != stp:
                        heappop(heap)
                        continue
                    if kind == 3:
                        th = meta_head(i)
                        if th is None:
                            heappop(heap)
                            continue
                        if th != tm:         # stale hint: refresh
                            heappop(heap)
                            heappush(heap, (th, 3, i, 0))
                            continue
                    t_next = tm
                    break
                if t_next is None:
                    if allow_stall:
                        return "stalled"
                    pend = [names[i] for i in range(n)
                            if finished[i] is None]
                    raise RuntimeError(f"deadlock at t={now:.6g}: {pend}")
                if t_next > t_stop:
                    return "paused"
                guard += 1
                if guard > max_iters:
                    raise RuntimeError(
                        "simulator did not converge (livelock?)")
                if t_next > horizon:
                    t_next = horizon
                dt = t_next - now
                act_arr = None
                if use_batch and len(active) >= 64:
                    act_arr = np.fromiter(active, dtype=np.int64,
                                          count=len(active))
                if dt > 0.0:
                    if act_arr is not None:
                        # same elementwise arithmetic as the scalar
                        # loop (w + r*dt, clamp to size == the
                        # conditional store), one array pass
                        r = rate[act_arr]
                        if speed_on:
                            r = r * speed[act_arr]
                        w = work[act_arr] + r * dt
                        np.minimum(w, comp.size_a[act_arr], out=w)
                        work[act_arr] = w
                    elif speed_on:
                        for i in active:
                            w = work[i] + rate[i] * speed[i] * dt
                            sz = size[i]
                            work[i] = sz if w > sz else w
                    else:
                        for i in active:
                            w = work[i] + rate[i] * dt
                            sz = size[i]
                            work[i] = sz if w > sz else w
                now = t_next

                batch: list[int] = []
                while heap and heap[0][0] <= t_next:
                    tm, kind, i, stp = heappop(heap)
                    if kind == 1 and stamp[i] == stp \
                            and finished[i] is None:
                        batch.append(i)
                    elif kind == 0 and started[i] is None:
                        candidates.add(i)
                    elif kind == 2 and comp_stamp[i] == stp:
                        # a component's next-completion fired; re-derive
                        # it even if no completion/reallocation follows
                        # (FP shortfall)
                        comp_resched.add(i)
                    elif kind == 3:
                        # drain the component's due events; leave one
                        # fresh hint behind if any remain
                        ch = comp_heaps[i]
                        while ch and ch[0][0] <= t_next:
                            t2, k2, i2, s2 = heappop(ch)
                            if k2 == 1 and stamp[i2] == s2 \
                                    and finished[i2] is None:
                                batch.append(i2)
                            elif k2 == 2 and comp_stamp[i2] == s2:
                                comp_resched.add(i2)
                        if ch:
                            heappush(heap, (ch[0][0], 3, i, 0))

                # completions (a task reaching its cap/size keeps
                # rate > 0 until this very event — scan the active set)
                if act_arr is not None:
                    finished_now = act_arr[
                        work[act_arr] >= comp.size_a[act_arr] - EPS
                    ].tolist()
                else:
                    finished_now = [i for i in active
                                    if work[i] >= size[i] - EPS]
                if len(finished_now) >= 128:
                    complete_bulk(finished_now)
                else:
                    for i in finished_now:
                        complete(i)

                # unit-boundary crossings feed streaming consumers
                if comp.has_streaming:
                    for i in batch:
                        if not stream_out[i] or finished[i] is not None:
                            continue
                        du = math.floor(work[i] / unit[i] + EPS)
                        if du != d_units[i]:
                            d_units[i] = du
                            for c in stream_out[i]:
                                if started[c] is None:
                                    candidates.add(c)
                                elif finished[c] is None:
                                    nc = recompute_cap(c)
                                    if nc != cap[c]:
                                        cap[c] = nc
                                        touched.add(c)

                for si in freed:
                    candidates.update(waiting_slot.get(si, ()))
                freed.clear()
                if candidates:
                    process_starts()

                # starvation flips (cap moved, or work caught up)
                for i in touched.union(x for x in batch
                                       if finished[x] is None):
                    if started[i] is None or finished[i] is not None:
                        continue
                    is_starved = cap[i] <= work[i] + EPS
                    if is_starved != starved[i]:
                        starved[i] = is_starved
                        if is_comp[i]:
                            rate[i] = 0.0 if is_starved else 1.0
                        else:
                            pos = net_pos[i]
                            starved_net[pos] = is_starved
                            if is_starved:
                                rate[i] = 0.0
                            dirty_net(pos)
                    touched.add(i)

                # MADD weights drift with remaining work (coflows
                # collapse the component split, so this dirties the
                # single component at the members' lowest class — the
                # global lowest, as before)
                if coflows:
                    for ci, c in enumerate(coflows):
                        if any(started[m] is not None
                               and finished[m] is None for m in c):
                            for m in c:
                                dirty_net(net_pos[m])

                if comp_dirty:
                    apply_changed(allocate())

                for i in touched:
                    schedule_event(i)
                for i in touched_sched:
                    if i not in touched:
                        schedule_event(i)
                for i in batch:
                    if finished[i] is None and i not in touched \
                            and i not in touched_sched:
                        schedule_event(i)
                for K in comp_resched:
                    schedule_comp(K)
                comp_resched.clear()
                flush_events()
                touched.clear()
                touched_sched.clear()
            return "done"

        def peek_next():
            """Earliest valid event time (stale entries are popped);
            None when the calendar is empty."""
            while heap:
                tm, kind, i, stp = heap[0]
                if kind == 1 and (stamp[i] != stp
                                  or finished[i] is not None):
                    heappop(heap)
                    continue
                if kind == 0 and started[i] is not None:
                    heappop(heap)
                    continue
                if kind == 2 and comp_stamp[i] != stp:
                    heappop(heap)
                    continue
                if kind == 3:
                    th = meta_head(i)
                    if th is None:
                        heappop(heap)
                        continue
                    if th != tm:             # stale hint: refresh
                        heappop(heap)
                        heappush(heap, (th, 3, i, 0))
                        continue
                return tm
            return None

        def advance_to(t: float) -> None:
            """Integrate active work up to ``t`` and move the clock
            there, without processing any event — ``t`` must lie in the
            gap before the next event (run_until(t) returned "paused"),
            so a mutation can land at its exact scheduled time."""
            nonlocal now
            if needs_settle:
                settle()
            if t <= now:
                return
            tn = peek_next()
            if tn is not None and tn < t:
                raise ValueError(f"advance_to({t!r}) would skip the "
                                 f"event at t={tn!r}")
            dt = t - now
            for i in active:
                w = work[i] + rate[i] * speed[i] * dt
                sz = size[i]
                work[i] = sz if w > sz else w
            now = t

        def result():
            """SimResult for the completed run (raises if unfinished)."""
            if unfinished:
                raise RuntimeError(
                    f"simulation incomplete: {unfinished} unfinished "
                    f"task(s) at t={now:.6g}")
            start = dict(zip(names, started))
            finish = dict(zip(names, finished))
            makespan = max(finished, default=0.0)
            if comp.single_job:
                jobs = {comp.job[0]: makespan} if n else {}
            else:
                jobs = {}
                for i in range(n):
                    j = comp.job[i]
                    f = finished[i]
                    if f > jobs.get(j, -1.0):
                        jobs[j] = f
            return SimResult(start=start, finish=finish,
                             makespan=makespan, job_completion=jobs)

        def progress(at=None):
            """Per-task completed fraction, projected to time ``at``
            (default: the paused clock) — read-only, no state change."""
            t = now if at is None else at
            ext = t - now
            out = {}
            for i in range(n):
                if finished[i] is not None:
                    out[names[i]] = 1.0
                elif started[i] is None:
                    out[names[i]] = 0.0
                else:
                    w = work[i]
                    if ext > 0.0 and i in active:
                        w = w + rate[i] * speed[i] * ext
                    sz = size[i]
                    out[names[i]] = 1.0 if sz <= 0 \
                        else (1.0 if w >= sz else w / sz)
            return out

        # -- fault-model mutators --------------------------------------
        def kill(i: int) -> None:
            """Reset an unfinished task to unstarted with zero progress
            (its slot is freed; its component's bandwidth refills)."""
            nonlocal needs_settle
            if finished[i] is not None:
                raise ValueError(f"{names[i]} already finished "
                                 f"(use resurrect)")
            if inc_bylink:
                inc_bylink.clear()     # non-incremental runnable edit
            stamp[i] += 1
            active.discard(i)
            if has_slot[i]:
                si = slot_of[i]
                slots_free[si] += 1
                has_slot[i] = False
                freed.add(si)
            if is_comp[i]:
                w = waiting_slot.get(slot_of[i])
                if w is not None:
                    w.discard(i)
            else:
                pos = net_pos[i]
                K = comp_of[pos]
                if pos in comp_runnable[K] or rate[i]:
                    comp_dirty[K] = -inf
                comp_runnable[K].discard(pos)
                comp_simple_active[K].discard(i)
                comp_resched.add(K)
                starved_net[pos] = False
            rate[i] = 0.0
            work[i] = 0.0
            cap[i] = size[i]
            d_units[i] = 0
            starved[i] = False
            started[i] = None
            candidates.add(i)
            touched.discard(i)
            touched_sched.discard(i)
            for c in stream_out[i]:
                if started[c] is not None and finished[c] is None:
                    nc = recompute_cap(c)
                    if nc != cap[c]:
                        cap[c] = nc
                        touched.add(c)
            needs_settle = True

        def resurrect(i: int) -> None:
            """Un-finish a task whose output data was lost: restore its
            consumers' gate counters and reset it to unstarted.  Started
            barrier/coflow consumers raise :class:`ResurrectConflict`
            (they would be running on data that no longer exists; the
            exception names all of them so the caller can kill exactly
            those and retry).  For a coflow member the group's MADD
            bookkeeping is rewound: ``cof_left`` re-opens, and when the
            group had completed, every start gate its all-or-nothing
            output had released is re-armed.  Started *streaming*
            consumers are handled like ``kill`` handles them — their
            caps shrink back to the (now zero) delivered units and they
            stall until re-delivery."""
            nonlocal unfinished, needs_settle
            if finished[i] is None:
                return
            if inc_bylink:
                inc_bylink.clear()     # non-incremental runnable edit
            ci = coflow_of[i]
            group_done = ci >= 0 and cof_left[ci] == 0
            # gate_dec[i] holds every counter i's own completion
            # decremented (barrier successors + member-sync gates of
            # coflows i feeds); a completed group's cof_dec adds the
            # consumers its *group* completion released
            held = set(gate_dec[i])
            if group_done:
                held.update(comp.cof_dec[ci])
            running = sorted(
                names[s] for s in held
                if started[s] is not None and finished[s] is None)
            if running:
                raise ResurrectConflict(names[i], running)
            finished[i] = None
            unfinished += 1
            for s in gate_dec[i]:
                n_gate[s] += 1
            if ci >= 0:
                if group_done:
                    # mirror of the group-completion decrement: one per
                    # member-pred edge in cof_dec (entries repeat)
                    for t in comp.cof_dec[ci]:
                        n_gate[t] += 1
                cof_left[ci] += 1
            stamp[i] += 1
            started[i] = None
            work[i] = 0.0
            rate[i] = 0.0
            cap[i] = size[i]
            d_units[i] = 0
            starved[i] = False
            if not is_comp[i]:
                starved_net[net_pos[i]] = False
            for c in stream_out[i]:
                if started[c] is not None and finished[c] is None:
                    nc = recompute_cap(c)
                    if nc != cap[c]:
                        cap[c] = nc
                        touched.add(c)
            candidates.add(i)
            touched.discard(i)
            touched_sched.discard(i)
            needs_settle = True

        def kill_or_resurrect(i: int) -> None:
            """Restart ``i`` from zero whatever its current state."""
            if finished[i] is not None:
                resurrect(i)
            else:
                kill(i)

        def set_speed(i: int, s: float) -> None:
            """Set task ``i``'s rate multiplier (1.0 = nominal)."""
            nonlocal speed_on, needs_settle
            s = float(s)
            if s < 0.0:
                raise ValueError("speed must be >= 0")
            speed[i] = s
            if s != 1.0:
                speed_on = True
            if started[i] is not None and finished[i] is None:
                if not is_comp[i] and simple[i]:
                    comp_resched.add(comp_of[net_pos[i]])
                else:
                    touched_sched.add(i)
            needs_settle = True

        def set_link_bw(li: int, bw: float) -> None:
            """Patch link ``li``'s capacity; dirty touched components."""
            nonlocal needs_settle
            link_bw[li] = float(bw)
            if use_batch:
                link_bw_a_run[li] = float(bw)
            for pos in range(len(flow_links)):
                if li in flow_links[pos] \
                        and finished[net_ids[pos]] is None:
                    comp_dirty[comp_of[pos]] = -inf
            needs_settle = True

        def link_id(lname: str):
            """Interned id of a link resource name (None when the link
            never appears in any compiled flow path)."""
            return link_name_id.get(lname)

        def move(i: int, host: str, proc) -> None:
            """Re-place compute ``i`` onto ``host`` (restarting it if it
            had begun — speculative re-execution)."""
            nonlocal slot_of, slot_ids_run, needs_settle
            if not is_comp[i]:
                raise ValueError(f"{names[i]} is not a compute task")
            if proc is None:
                proc = sim.g.tasks[names[i]].proc
            kill_or_resurrect(i)
            if slot_of is comp.slot_of:
                slot_of = list(comp.slot_of)
            if slot_ids_run is comp.slot_ids:
                slot_ids_run = dict(comp.slot_ids)
            key = (host, proc)
            si = slot_ids_run.get(key)
            if si is None:
                si = slot_ids_run[key] = len(slots_free)
                h = hosts.get(host)
                slots_free.append(
                    int(h.procs.get(proc, 0)) if h is not None else 0)
            slot_of[i] = si
            cur_host[i] = host
            needs_settle = True

        def rebuild_csr() -> None:
            """Refresh the NumPy CSR mirror after a structural patch and
            drop the (now stale) full-group fill prep."""
            nonlocal fl_ptr, fl_flat, full_sg_pos, full_sorted_ids, \
                full_row_links, full_by_link, full_counts
            full_sg_pos = full_sorted_ids = None
            full_row_links = full_by_link = full_counts = None
            if use_np:
                ptr = [0]
                flat: list[int] = []
                for links in flow_links:
                    flat.extend(links)
                    ptr.append(len(flat))
                fl_ptr = np.array(ptr, dtype=np.int64)
                fl_flat = np.array(flat, dtype=np.int64)

        def repath(i: int, route, reset: bool, src2, dst2) -> None:
            """Re-path flow ``i`` onto ``route`` (link resource names,
            endpoint NICs included), merging contention components the
            new path bridges.  ``reset`` restarts an in-flight transfer
            from zero; a finished flow is resurrected (re-delivery)."""
            nonlocal flow_links, comp_of, residual, needs_settle, \
                link_bw_a_run
            if is_comp[i]:
                raise ValueError(f"{names[i]} is not a flow")
            pos = net_pos[i]
            if finished[i] is not None:
                resurrect(i)
            elif reset and started[i] is not None:
                kill(i)
            ids = []
            for lname in route:
                li = link_name_id.get(lname)
                if li is None:
                    li = len(link_bw)
                    link_name_id[lname] = li
                    link_names.append(lname)
                    link_bw.append(float(cluster.bandwidth(lname)))
                    if use_np:
                        residual = np.append(residual, 0.0)
                    else:
                        residual.append(0.0)
                    if use_batch:
                        link_bw_a_run = np.append(link_bw_a_run,
                                                  link_bw[-1])
                ids.append(li)
            if flow_links is comp.flow_links:
                flow_links = list(comp.flow_links)
            if comp_of is comp.comp_of_net:
                comp_of = list(comp.comp_of_net)
            old_k = comp_of[pos]
            flow_links[pos] = tuple(ids)
            if src2 is not None:
                cur_src[pos] = src2
            if dst2 is not None:
                cur_dst[pos] = dst2
            # merge every component sharing a link with the new path:
            # the disjointness invariant (no link in two components)
            # must hold or the waterfill double-books bandwidth
            idset = set(ids)
            ks = {old_k}
            for p2, links2 in enumerate(flow_links):
                if p2 != pos and comp_of[p2] not in ks \
                        and not idset.isdisjoint(links2):
                    ks.add(comp_of[p2])
            kt = min(ks)
            if len(ks) > 1:
                for p2 in range(len(comp_of)):
                    if comp_of[p2] in ks:
                        comp_of[p2] = kt
                for k2 in ks:
                    if k2 == kt:
                        continue
                    comp_runnable[kt] |= comp_runnable[k2]
                    comp_runnable[k2] = set()
                    comp_simple_active[kt] |= comp_simple_active[k2]
                    comp_simple_active[k2] = set()
                    comp_log[k2] = None
                    comp_stamp[k2] += 1
            else:
                comp_of[pos] = kt
            comp_log[kt] = None
            comp_log[old_k] = None
            comp_stamp[kt] += 1
            comp_resched.add(kt)
            if old_k != kt:
                comp_stamp[old_k] += 1
                comp_resched.add(old_k)
            comp_dirty[kt] = -inf
            if comp_runnable[old_k]:
                comp_dirty[old_k] = -inf
            if inc_bylink:
                inc_bylink.clear()     # incidence/component maps changed
            rebuild_csr()
            needs_settle = True

        def kill_host(host: str) -> list:
            """Fail ``host``: zero its slots and NIC links, restart its
            unfinished tasks, and resurrect the lineage closure —
            finished tasks whose output data resided there (computes
            placed on it, flows delivered to it) and is still needed by
            an unfinished data consumer.  Started consumers of the
            resurrected data (even on healthy hosts) are killed too —
            they were running on output that no longer exists.  Returns
            the restarted task names (sorted); the replanner must
            re-place/re-path them."""
            nonlocal needs_settle
            resident: list[int] = []
            direct: set[int] = set()
            for i in range(n):
                if is_comp[i]:
                    if cur_host[i] == host:
                        if finished[i] is None:
                            direct.add(i)
                        else:
                            resident.append(i)
                else:
                    pos = net_pos[i]
                    if finished[i] is None:
                        if cur_src[pos] == host or cur_dst[pos] == host:
                            direct.add(i)
                    elif cur_dst[pos] == host:
                        resident.append(i)
            # lineage fixpoint: a finished resident task re-runs when a
            # *data* consumer of its output is (or becomes) unfinished —
            # for computes that means NETWORK successors (data leaves
            # via flows; compute→compute edges are control-only), for
            # delivered flows any successor
            need = set(direct)
            changed = True
            while changed:
                changed = False
                for i in resident:
                    if i in need:
                        continue
                    for s in succ[i]:
                        if is_comp[i] and is_comp[s]:
                            continue
                        if finished[s] is None or s in need:
                            need.add(i)
                            changed = True
                            break
            for i in sorted(need):
                if finished[i] is None:
                    kill(i)
            idx = comp.idx
            for i in sorted(need):
                while finished[i] is not None:
                    try:
                        resurrect(i)
                    except ResurrectConflict as e:
                        # a started consumer on a *healthy* host is
                        # running on the data being resurrected: kill
                        # exactly the named offenders (they join the
                        # restarted set) and retry — each retry strictly
                        # shrinks the running-consumer set, so this
                        # terminates
                        for nm in e.consumers:
                            j = idx[nm]
                            if finished[j] is None:
                                kill(j)
                            need.add(j)
            for (h, _proc), si in slot_ids_run.items():
                if h == host:
                    slots_free[si] = 0
            for lname in (host + ".nic_out", host + ".nic_in"):
                li = link_name_id.get(lname)
                if li is not None:
                    set_link_bw(li, 0.0)
            needs_settle = True
            return sorted(names[i] for i in need)

        def revive_host(host: str) -> None:
            """Bring a killed host back (the reboot model): slot pools
            to full capacity and NICs to nominal.  Prior progress stays
            lost — ``kill_host`` already restarted the lineage.  Only
            valid on a host with nothing running (guaranteed after
            ``kill_host``: zero slots stop computes, zero NICs leave
            flows parked at rate 0 — those resume on revive)."""
            nonlocal needs_settle
            if host not in sim.cluster.hosts:
                raise KeyError(host)
            if slot_ids_run is not comp.slot_ids:
                raise RuntimeError(
                    "revive_host is not supported after move_task "
                    "(slot pools diverged from the compiled capacities)")
            for i in range(n):
                if is_comp[i] and cur_host[i] == host \
                        and started[i] is not None and finished[i] is None:
                    raise RuntimeError(
                        f"revive_host({host!r}): {names[i]!r} is "
                        f"running there — revive only a killed host")
            for (h, _proc), si in slot_ids_run.items():
                if h == host:
                    slots_free[si] = comp.slot_cap[si]
                    freed.add(si)    # tasks parked in waiting_slot
                    # must be reconsidered at the next settle
            for lname in (host + ".nic_out", host + ".nic_in"):
                li = link_name_id.get(lname)
                if li is not None:
                    set_link_bw(li, sim.cluster.bandwidth(lname))
            needs_settle = True

        def set_priorities(prio: dict, new_policy) -> None:
            """Swap in a replanned priority map (optionally switching
            policy); rebuilt classes/dispatch ranks, invalidated replay
            logs, runnable components refill from scratch."""
            nonlocal policy, cls_net, prio_arr, dispatch_rank, \
                needs_settle, cls_net_a
            if new_policy is not None:
                if new_policy not in ("fair", "priority"):
                    raise ValueError(f"unknown policy {new_policy}")
                policy = new_policy
            pget = prio.get
            if policy == "fair":
                cls_net = [None] * comp.n_net
            else:
                cls_net = [0.0 if comp.stream_fed[i]
                           else pget(names[i], 0.0)
                           for i in net_ids]
            cls_net_a = np.array(cls_net, dtype=np.float64) \
                if use_batch and policy != "fair" else None
            prio_arr = [pget(nm, 0.0) for nm in names]
            if use_np:
                o = np.lexsort((comp.name_rank_a, np.array(prio_arr)))
                dr = np.empty(n, dtype=np.int64)
                dr[o] = np.arange(n, dtype=np.int64)
                dispatch_rank = dr.tolist()
            else:
                o = sorted(range(n),
                           key=lambda i: (prio_arr[i],
                                          comp.name_rank[i]))
                dispatch_rank = [0] * n
                for r2, i2 in enumerate(o):
                    dispatch_rank[i2] = r2
            if inc_bylink:
                inc_bylink.clear()     # classes re-keyed
            for K in range(n_comps):
                comp_log[K] = None
                if comp_runnable[K]:
                    comp_dirty[K] = -inf
            needs_settle = True

        # -- checkpoint / restore --------------------------------------
        def snapshot() -> dict:
            """Copy every piece of mutable run state (compile-owned
            arrays are immutable and shared by reference).  Taken at a
            settled boundary; heap tuples and logged freeze sequences
            are never mutated in place, so shallow copies suffice."""
            if needs_settle:
                settle()
            return {
                "work": vcopy(work), "rate": vcopy(rate), "cap": cap[:],
                "speed": vcopy(speed), "speed_on": speed_on,
                "starved_net": vcopy(starved_net), "started": started[:],
                "finished": finished[:], "has_slot": has_slot[:],
                "starved": starved[:], "d_units": d_units[:],
                "slots_free": slots_free[:], "cof_left": cof_left[:],
                "n_gate": n_gate[:], "stamp": stamp[:],
                "active": set(active),
                "waiting_slot": {k2: set(v)
                                 for k2, v in waiting_slot.items()},
                "candidates": set(candidates),
                "comp_runnable": [set(s) for s in comp_runnable],
                "comp_simple_active": [set(s)
                                       for s in comp_simple_active],
                "comp_log": [None if lg is None else dict(lg)
                             for lg in comp_log],
                "comp_stamp": comp_stamp[:],
                "heap": heap[:],
                "comp_heaps": (None if comp_heaps is None
                               else [h[:] for h in comp_heaps]),
                "unfinished": unfinished, "now": now,
                "guard": guard,
                "policy": policy, "cls_net": cls_net[:],
                "prio_arr": prio_arr[:],
                "dispatch_rank": dispatch_rank[:],
                "link_bw": link_bw[:],
                "residual": residual.copy() if use_np else residual[:],
                "flow_links": flow_links[:], "comp_of": comp_of[:],
                "slot_of": slot_of[:],
                "slot_ids": dict(slot_ids_run),
                "link_names": link_names[:],
                "link_name_id": dict(link_name_id),
                "cur_host": cur_host[:], "cur_src": cur_src[:],
                "cur_dst": cur_dst[:],
                "csr": (fl_ptr, fl_flat, full_sg_pos, full_sorted_ids,
                        full_row_links, full_by_link, full_counts),
            }

        def restore(snap: dict) -> None:
            """Reset the run state to a snapshot() (which survives and
            may be restored again)."""
            nonlocal work, rate, cap, speed, speed_on, starved_net, \
                started, finished, has_slot, starved, d_units, \
                slots_free, cof_left, n_gate, stamp, active, \
                waiting_slot, candidates, comp_runnable, \
                comp_simple_active, comp_log, comp_stamp, heap, \
                comp_heaps, \
                unfinished, now, guard, policy, cls_net, prio_arr, \
                dispatch_rank, link_bw, residual, flow_links, \
                comp_of, slot_of, slot_ids_run, link_names, \
                link_name_id, cur_host, cur_src, cur_dst, fl_ptr, \
                fl_flat, full_sg_pos, full_sorted_ids, \
                full_row_links, full_by_link, full_counts, \
                needs_settle, link_bw_a_run, cls_net_a
            work = vcopy(snap["work"])
            rate = vcopy(snap["rate"])
            cap = snap["cap"][:]
            speed = vcopy(snap["speed"])
            speed_on = snap["speed_on"]
            starved_net = vcopy(snap["starved_net"])
            started = snap["started"][:]
            finished = snap["finished"][:]
            has_slot = snap["has_slot"][:]
            starved = snap["starved"][:]
            d_units = snap["d_units"][:]
            slots_free = snap["slots_free"][:]
            cof_left = snap["cof_left"][:]
            n_gate = snap["n_gate"][:]
            stamp = snap["stamp"][:]
            active = set(snap["active"])
            waiting_slot = {k2: set(v)
                            for k2, v in snap["waiting_slot"].items()}
            candidates = set(snap["candidates"])
            comp_runnable = [set(s) for s in snap["comp_runnable"]]
            comp_simple_active = [set(s)
                                  for s in snap["comp_simple_active"]]
            comp_log = [None if lg is None else dict(lg)
                        for lg in snap["comp_log"]]
            comp_stamp = snap["comp_stamp"][:]
            if inc_bylink:
                inc_bylink.clear()     # rebuilt lazily from new state
            heap = snap["heap"][:]
            ch_snap = snap["comp_heaps"]
            comp_heaps = None if ch_snap is None \
                else [h[:] for h in ch_snap]
            unfinished = snap["unfinished"]
            now = snap["now"]
            guard = snap["guard"]
            policy = snap["policy"]
            cls_net = snap["cls_net"][:]
            prio_arr = snap["prio_arr"][:]
            dispatch_rank = snap["dispatch_rank"][:]
            link_bw = snap["link_bw"][:]
            residual = snap["residual"].copy() if use_np \
                else snap["residual"][:]
            flow_links = snap["flow_links"][:]
            comp_of = snap["comp_of"][:]
            slot_of = snap["slot_of"][:]
            slot_ids_run = dict(snap["slot_ids"])
            link_names = snap["link_names"][:]
            link_name_id = dict(snap["link_name_id"])
            cur_host = snap["cur_host"][:]
            cur_src = snap["cur_src"][:]
            cur_dst = snap["cur_dst"][:]
            (fl_ptr, fl_flat, full_sg_pos, full_sorted_ids,
             full_row_links, full_by_link, full_counts) = snap["csr"]
            if use_batch:
                link_bw_a_run = np.array(link_bw, dtype=np.float64)
                cls_net_a = np.array(cls_net, dtype=np.float64) \
                    if policy != "fair" else None
            comp_dirty.clear()
            comp_resched.clear()
            touched.clear()
            touched_sched.clear()
            freed.clear()
            pending.clear()
            needs_settle = False

        def state_view() -> dict:
            """Light read-only view of scalar run state plus shared
            handles on the per-task vectors (do not mutate)."""
            return {"now": now, "unfinished": unfinished,
                    "started": started, "finished": finished,
                    "work": work, "speed": speed}

        def free_slots() -> dict:
            """Free slot count per (host, proc) pool."""
            return {key: slots_free[si]
                    for key, si in slot_ids_run.items()}

        def flow_route(i: int) -> tuple:
            """Current link-name path of flow ``i``."""
            return tuple(link_names[l]
                         for l in flow_links[net_pos[i]])

        def flow_ends(i: int) -> tuple:
            """Current (src, dst) endpoints of flow ``i``."""
            pos = net_pos[i]
            return (cur_src[pos], cur_dst[pos])

        # -- live admission / departure (name-keyed state transfer) ----
        def export_admission() -> dict:
            """Name-keyed dump of the dynamic run state, for transfer
            into a recompiled session over a merged (admit) or shrunk
            (retire) graph.  Keys are task names, (host, proc) slot
            pools, link names and sorted coflow member tuples, so the
            receiving compile maps them onto its own interning — ids
            never cross the boundary.  Settles queued mutations first
            (like snapshot); structural mutations (move/repath) have no
            name-stable representation and refuse the export."""
            if needs_settle:
                settle()
            if list(slot_of) != list(comp.slot_of) \
                    or list(flow_links) != list(comp.flow_links):
                raise RuntimeError(
                    "cannot admit/retire after move_task/repath_flow: "
                    "the session's placement no longer matches the "
                    "graph, so a recompiled merge cannot represent it")
            key_of_slot = {si: key for key, si in slot_ids_run.items()}
            tasks = {}
            for i in range(n):
                tasks[names[i]] = (
                    float(work[i]), started[i], finished[i], cap[i],
                    d_units[i], has_slot[i], starved[i],
                    float(speed[i]), n_gate[i], rel[i], float(rate[i]))
            # the live event calendar: per-task next-event times and
            # per-component coalesced next-completion times, exported
            # verbatim.  Recomputing them after the transfer would
            # re-anchor ``now + (size-work)/rate`` at the admission
            # instant and shift every float by ulps — the receiving
            # session pushes these exact times instead, so untouched
            # tasks keep the calendar a from-scratch merged run carries.
            ev1: dict = {}
            ev2: list = []

            def _scan(entries) -> None:
                for e in entries:
                    tm, kind, i2, stp = e
                    if kind == 1 and stamp[i2] == stp \
                            and finished[i2] is not None:
                        continue
                    if kind == 1 and stamp[i2] == stp:
                        ev1[names[i2]] = tm
                    elif kind == 2 and comp_stamp[i2] == stp:
                        ev2.append((tuple(sorted(
                            names[m] for m in comp_simple_active[i2])),
                            tm))
            _scan(heap)
            if comp_heaps is not None:
                for ch in comp_heaps:
                    _scan(ch)
            return {
                "ev1": ev1, "ev2": ev2,
                "now": now, "speed_on": speed_on, "policy": policy,
                "prio": {names[i]: prio_arr[i] for i in range(n)
                         if prio_arr[i]},
                "tasks": tasks,
                "slots": {key: slots_free[si]
                          for key, si in slot_ids_run.items()},
                "waiting": {key_of_slot[si]: [names[i] for i in s]
                            for si, s in waiting_slot.items() if s},
                "links": {link_names[li]: link_bw[li]
                          for li in range(len(link_bw))},
                "cof_left": {tuple(sorted(names[m] for m in c)):
                             cof_left[ci]
                             for ci, c in enumerate(coflows)},
                "candidates": [names[i] for i in candidates],
            }

        def transplant(st: dict) -> None:
            """Load an export_admission() dump into this freshly built
            session: wipe the t=0 initialisation, overlay the exported
            per-task/slot/link state by name (names absent from this
            compile — retired rows — are skipped), re-register in-flight
            work, and leave everything dirty for one settle().  The
            settle at the admission instant then completes exact-time
            tasks and runs one combined dispatch pass, exactly the event
            batch a from-scratch run of the merged graph would execute
            there."""
            nonlocal now, unfinished, speed_on, guard, needs_settle
            # wipe: the constructor already started roots at t=0
            heap.clear()
            pending.clear()
            if comp_heaps is not None:
                for ch in comp_heaps:
                    ch.clear()
            active.clear()
            waiting_slot.clear()
            candidates.clear()
            freed.clear()
            touched.clear()
            touched_sched.clear()
            comp_dirty.clear()
            comp_resched.clear()
            if inc_bylink:
                inc_bylink.clear()
            for K in range(n_comps):
                comp_runnable[K].clear()
                comp_simple_active[K].clear()
                comp_log[K] = None
                comp_stamp[K] += 1
            if use_batch:
                work[:] = 0.0
                rate[:] = 0.0
                speed[:] = 1.0
                starved_net[:] = False
            else:
                for i in range(n):
                    work[i] = 0.0
                    rate[i] = 0.0
                    speed[i] = 1.0
                for p in range(len(starved_net)):
                    starved_net[p] = False
            for i in range(n):
                started[i] = None
                finished[i] = None
                has_slot[i] = False
                starved[i] = False
                d_units[i] = 0
                cap[i] = size[i]
                stamp[i] += 1
            slots_free[:] = list(comp.slot_cap)
            cof_left[:] = [len(c) for c in coflows]
            n_gate[:] = list(comp.init_gate)
            link_bw[:] = list(comp.link_bw)
            if use_batch:
                link_bw_a_run[:] = comp.link_bw_a
            now = st["now"]
            speed_on = st["speed_on"]
            guard = 0
            unfinished = n
            # overlay the exported state by name
            idx_get = comp.idx.get
            for nm, ts in st["tasks"].items():
                i = idx_get(nm)
                if i is None:
                    continue
                (w, s0, f0, cp, du, hs, sv, spd, ng, _r, rt) = ts
                work[i] = w
                started[i] = s0
                finished[i] = f0
                cap[i] = cp
                d_units[i] = du
                has_slot[i] = hs
                starved[i] = sv
                speed[i] = spd
                n_gate[i] = ng
                rate[i] = rt
                if f0 is not None:
                    unfinished -= 1
            for key, v in st["slots"].items():
                si = slot_ids_run.get(key)
                if si is not None:
                    slots_free[si] = v
            lid_get = link_name_id.get
            for lname, bw in st["links"].items():
                li = lid_get(lname)
                if li is not None:
                    link_bw[li] = bw
                    if use_batch:
                        link_bw_a_run[li] = bw
            if use_np:
                residual[:] = np.asarray(link_bw, dtype=np.float64)
            else:
                residual[:] = link_bw
            if coflows:
                ci_of = {tuple(sorted(names[m] for m in c)): ci
                         for ci, c in enumerate(coflows)}
                for ckey, left in st["cof_left"].items():
                    ci = ci_of.get(ckey)
                    if ci is not None:
                        cof_left[ci] = left
            # streaming bookkeeping is a pure function of work — derive
            # it rather than trusting a dump taken one event earlier
            if comp.has_streaming:
                for i in range(n):
                    if started[i] is None or finished[i] is not None:
                        continue
                    if stream_out[i]:
                        d_units[i] = math.floor(work[i] / unit[i] + EPS)
                for i in range(n):
                    if started[i] is None or finished[i] is not None:
                        continue
                    if stream_in[i]:
                        cap[i] = recompute_cap(i)
            # re-register in-flight tasks: rates and the exported
            # calendar carry over verbatim — nothing is re-anchored at
            # the admission instant unless the merged run would have
            # re-anchored it there too.  A task whose recomputed cap
            # contradicts its exported starvation flag (a streaming
            # boundary landing exactly at the admission time) goes
            # through settle's starvation pass, which is where the
            # from-scratch run flips it as well.
            for i in range(n):
                if started[i] is None or finished[i] is not None:
                    continue
                active.add(i)
                if not is_comp[i]:
                    pos = net_pos[i]
                    starved_net[pos] = starved[i]
                    K = comp_of[pos]
                    comp_runnable[K].add(pos)
                    if simple[i]:
                        comp_simple_active[K].add(i)
                if (cap[i] <= work[i] + EPS) != starved[i]:
                    touched.add(i)
            for key, nms in st["waiting"].items():
                si = slot_ids_run.get(key)
                if si is None:
                    continue
                ws = waiting_slot.setdefault(si, set())
                for nm in nms:
                    i = idx_get(nm)
                    if i is not None:
                        ws.add(i)
            # future releases re-enter via the calendar; everything
            # gate-ready (new-job roots included) via candidates — the
            # settle's dispatch pass sorts them all together
            for i in range(n):
                if started[i] is not None:
                    continue
                if rel[i] > now + EPS:
                    heappush(heap, (float(rel[i]), 0, i, 0))
                elif not n_gate[i]:
                    candidates.add(i)
            for nm in st["candidates"]:
                i = idx_get(nm)
                if i is not None:
                    candidates.add(i)
            # replant the exported calendar at its original anchors.
            # Coalesced (kind-2) entries are keyed by their member set:
            # admission can merge the owning components (the entry lands
            # on the union — an early fire just triggers a rescan, as
            # the merged run's own coalesced entry does) and retirement
            # can split them (the entry is replanted on every component
            # holding survivors)
            for nm, tv in st["ev1"].items():
                i = idx_get(nm)
                if i is None or started[i] is None \
                        or finished[i] is not None:
                    continue
                _defer((tv, 1, i, stamp[i]))
            for members, tv in st["ev2"]:
                ks = set()
                for nm in members:
                    i = idx_get(nm)
                    if i is None or started[i] is None \
                            or finished[i] is not None:
                        continue
                    ks.add(comp_of[net_pos[i]])
                for K in ks:
                    _defer((tv, 2, K, comp_stamp[K]))
            flush_events()
            needs_settle = True

        self._sim = sim
        self._names = names
        self._idx = comp.idx
        self._horizon = horizon
        self._batch = bool(batch)
        self._ops = {
            "advance": advance, "advance_to": advance_to,
            "settle": settle, "result": result, "progress": progress,
            "peek": peek_next, "export_admission": export_admission,
            "transplant": transplant,
            "snapshot": snapshot, "restore": restore,
            "state": state_view, "free_slots": free_slots,
            "flow_route": flow_route, "flow_ends": flow_ends,
            "set_speed": set_speed, "set_link_bw": set_link_bw,
            "link_id": link_id, "link_bw_of": link_bw.__getitem__,
            "kill": kill_or_resurrect, "kill_host": kill_host,
            "revive_host": revive_host,
            "move": move, "repath": repath,
            "set_priorities": set_priorities,
            "cur_host": lambda i: cur_host[i],
        }

    # -- session control -----------------------------------------------
    def run_until(self, t_stop: float, *,
                  allow_stall: bool = False) -> str:
        """Advance through every event at time <= ``t_stop``.

        Returns ``"done"``, ``"paused"`` (next event is strictly later
        — the clock rests at the last processed event), or
        ``"stalled"`` when ``allow_stall`` is set and unfinished tasks
        remain with an empty event calendar (without ``allow_stall``
        that raises, as the plain engine's deadlock check does).
        """
        return self._ops["advance"](t_stop, allow_stall)

    def run(self):
        """Run to completion and return the SimResult."""
        self._ops["advance"](math.inf, False)
        return self._ops["result"]()

    def advance_to(self, t: float) -> None:
        """Move the paused clock to ``t`` (before the next event),
        integrating in-flight work, so a mutation lands exactly there."""
        self._ops["advance_to"](t)

    def result(self):
        """SimResult of the finished run (raises while unfinished)."""
        return self._ops["result"]()

    # -- introspection -------------------------------------------------
    @property
    def now(self) -> float:
        """The paused simulation clock."""
        return self._ops["state"]()["now"]

    @property
    def unfinished(self) -> int:
        """Number of tasks not yet finished."""
        return self._ops["state"]()["unfinished"]

    def progress(self, at: float | None = None) -> dict:
        """Completed fraction per task, projected to ``at`` (read-only;
        defaults to the paused clock)."""
        return self._ops["progress"](at)

    def started_at(self, name: str):
        """Observed start time of ``name`` (None if not started)."""
        return self._ops["state"]()["started"][self._idx[name]]

    def finished_at(self, name: str):
        """Observed finish time of ``name`` (None if unfinished)."""
        return self._ops["state"]()["finished"][self._idx[name]]

    def unfinished_tasks(self) -> list:
        """Names of tasks not yet finished, in id (insertion) order."""
        fin = self._ops["state"]()["finished"]
        return [nm for nm, f in zip(self._names, fin) if f is None]

    def task_host(self, name: str):
        """Current placement of a compute task (tracks move_task)."""
        return self._ops["cur_host"](self._idx[name])

    def flow_route(self, name: str) -> tuple:
        """Current link-name path of a flow (tracks repath_flow)."""
        return self._ops["flow_route"](self._idx[name])

    def flow_ends(self, name: str) -> tuple:
        """Current (src, dst) of a flow (tracks repath_flow)."""
        return self._ops["flow_ends"](self._idx[name])

    def free_slots(self) -> dict:
        """Free slot count per (host, proc) pool, moves included."""
        return self._ops["free_slots"]()

    def link_capacity(self, name: str) -> float:
        """Current capacity of link ``name`` (mutations included).
        A cluster link no compiled flow path traverses reports its
        static capacity (it was never interned)."""
        li = self._ops["link_id"](name)
        if li is None:
            return self._sim.cluster.bandwidth(name)
        return self._ops["link_bw_of"](li)

    # -- fault-model mutators ------------------------------------------
    def set_speed(self, name: str, s: float) -> None:
        """Set ``name``'s rate multiplier (straggler model; 1.0 resets
        to nominal).  Effective progress rate is ``rate * speed``."""
        self._ops["set_speed"](self._idx[name], s)

    def set_link_bw(self, name: str, bw: float) -> None:
        """Set link ``name``'s capacity (0.0 = failed link).  Degrading
        a cluster link that no compiled flow path traverses is a no-op
        (it carries nothing, so it cannot affect the run) — but the
        name must at least be a real link of the cluster."""
        li = self._ops["link_id"](name)
        if li is None:
            self._sim.cluster.bandwidth(name)   # KeyError on garbage
            return
        self._ops["set_link_bw"](li, bw)

    def scale_link(self, name: str, factor: float) -> None:
        """Multiply link ``name``'s current capacity by ``factor``
        (no-op on an untraversed link, like :meth:`set_link_bw`)."""
        li = self._ops["link_id"](name)
        if li is None:
            self._sim.cluster.bandwidth(name)
            return
        self._ops["set_link_bw"](li, self._ops["link_bw_of"](li) * factor)

    def kill_task(self, name: str) -> None:
        """Lose ``name``'s progress (and output, if finished): reset to
        unstarted, restoring consumers' start gates as needed."""
        self._ops["kill"](self._idx[name])

    def kill_host(self, host: str) -> list:
        """Fail ``host`` (slots and NICs to zero); returns the names of
        every task restarted, including the resurrected lineage of data
        that lived on it.  See the class docstring for the fault model."""
        return self._ops["kill_host"](host)

    def revive_host(self, host: str) -> None:
        """Bring a killed host back online (reboot model): slot pools
        restored to capacity, NICs to nominal.  Progress lost to the
        kill stays lost; flows parked at rate 0 resume."""
        self._ops["revive_host"](host)

    def move_task(self, name: str, host: str,
                  proc: str | None = None) -> None:
        """Re-place compute ``name`` onto ``host`` (restarts it if it
        had begun — speculative re-execution)."""
        self._ops["move"](self._idx[name], host, proc)

    def repath_flow(self, name: str, route, *, reset: bool = False,
                    src: str | None = None,
                    dst: str | None = None) -> None:
        """Re-path flow ``name`` onto ``route`` (full link-name path,
        endpoint NICs included).  ``reset`` restarts an in-flight
        transfer; ``src``/``dst`` record re-pointed endpoints after a
        consumer/producer move."""
        self._ops["repath"](self._idx[name], route, reset, src, dst)

    def set_priorities(self, priorities: dict,
                       policy: str | None = None) -> None:
        """Swap in a replanned priority map (optionally switching the
        allocation policy) without recompiling."""
        self._ops["set_priorities"](dict(priorities), policy)

    # -- checkpoint / restore ------------------------------------------
    def checkpoint(self) -> dict:
        """Snapshot the mutable run state (settling queued mutations
        first); pass to :meth:`restore` to fork arms from one prefix."""
        return self._ops["snapshot"]()

    def restore(self, snap: dict) -> None:
        """Reset the session to a :meth:`checkpoint` snapshot."""
        self._ops["restore"](snap)

    # -- live admission / departure ------------------------------------
    def _adopt(self, other: "ResumableSim") -> None:
        """Swap this session's engine for ``other``'s: every public
        method dispatches through ``_ops``, so rebinding the handles is
        a full engine replacement (prior checkpoints no longer apply)."""
        self._sim = other._sim
        self._names = other._names
        self._idx = other._idx
        self._ops = other._ops

    def admit_graph(self, graph, at: float | None = None, *,
                    priorities: dict | None = None) -> None:
        """Splice a new job's DAG into the running session at time
        ``at`` (default: the paused clock), warm-starting from the
        current state — the history is never re-simulated.

        Events strictly before ``at`` are processed first, then the
        merged graph is compiled (the new job's rows extend the interned
        name table, gates, CSR incidence and contention components; the
        old rows keep their ids) and the dynamic state carries over
        name-keyed.  Bit-exact invariant: after ``admit_graph(g, at=t)``
        the session evolves exactly as a fresh session over the merged
        graph with every new task released at ``t``.  ``priorities``
        overlays priority classes for the new tasks (``set_priorities``
        re-ranks everything later, as the service layer does on each
        admission).

        Not supported after ``move_task``/``repath_flow`` (the placement
        diverged from the graph), nor at ``t == 0`` (build the merged
        simulation directly — the constructor has already dispatched the
        t=0 starts without the new job).
        """
        from repro_torch.core.graph import MXDAG
        from repro_torch.core.simulator import Simulator

        ops = self._ops
        sim = self._sim
        at = self.now if at is None else float(at)
        if at < self.now - EPS:
            raise ValueError(f"admit_graph at t={at!r}: the clock is "
                             f"already at {self.now!r}")
        if at <= 0.0:
            raise ValueError(
                "admit_graph at t=0: all jobs are known upfront — "
                "simulate the merged graph directly")
        jobs_old = {t.job for t in sim.g.tasks.values()}
        jobs_new = {t.job for t in graph.tasks.values()}
        taken = jobs_old & jobs_new
        if taken:
            raise ValueError(f"admitted job name(s) already running: "
                             f"{sorted(taken)}")
        # drive to the admission instant: events strictly before ``at``
        while True:
            tn = ops["peek"]()
            if tn is None or tn >= at:
                break
            ops["advance"](tn, True)
        ops["advance_to"](at)
        st = ops["export_admission"]()
        merged = MXDAG(sim.g.name)
        for t in sim.g.tasks.values():
            merged.add(t)
        for nm, t in graph.tasks.items():
            if nm in merged.tasks:
                raise ValueError(
                    f"admitted task name {nm!r} collides with the "
                    f"running graph (prefix task names with the job "
                    f"name, as builders.poisson_jobs does)")
            merged.add(t)
        for e in sim.g.edges.values():
            merged.add_edge(e.src, e.dst, pipelined=e.pipelined)
        for e in graph.edges.values():
            merged.add_edge(e.src, e.dst, pipelined=e.pipelined)
        releases = {nm: ts[9] for nm, ts in st["tasks"].items()
                    if ts[9] > 0.0}
        for nm in graph.tasks:
            releases[nm] = at
        prio = dict(st["prio"])
        if priorities:
            prio.update(priorities)
        fresh = ResumableSim(
            Simulator(merged, sim.cluster, policy=st["policy"],
                      priorities=prio, releases=releases,
                      coflows=sim.coflows, routes=sim.routes,
                      engine="array"),
            self._horizon, batch=self._batch)
        fresh._ops["transplant"](st)
        self._adopt(fresh)

    def retire_job(self, job: str) -> None:
        """Free a finished job's rows: recompile the session over the
        graph without ``job``'s tasks and carry the dynamic state over
        name-keyed.  Every task of the job must be finished, and the
        job must share no edges or coflows with the survivors (its
        completed outputs have already released all gates).  The job's
        start/finish times leave the session with it — record them (the
        service layer does) before retiring.
        """
        from repro_torch.core.graph import MXDAG
        from repro_torch.core.simulator import Simulator

        sim = self._sim
        doomed = {nm for nm, t in sim.g.tasks.items() if t.job == job}
        if not doomed:
            raise KeyError(f"unknown job {job!r}")
        if len(doomed) == len(sim.g.tasks):
            raise ValueError("cannot retire the only job in the "
                             "session")
        st = self._ops["export_admission"]()
        for nm in sorted(doomed):
            if st["tasks"][nm][2] is None:
                raise RuntimeError(f"retire_job({job!r}): task {nm} "
                                   f"has not finished")
        for e in sim.g.edges.values():
            if (e.src in doomed) != (e.dst in doomed):
                raise ValueError(f"retire_job({job!r}): cross-job edge "
                                 f"{e.src} -> {e.dst}")
        coflows = []
        for c in sim.coflows:
            inside = c & doomed
            if inside and inside != c:
                raise ValueError(f"retire_job({job!r}): coflow "
                                 f"{sorted(c)} spans the retired job")
            if not inside:
                coflows.append(c)
        shrunk = MXDAG(sim.g.name)
        for nm, t in sim.g.tasks.items():
            if nm not in doomed:
                shrunk.add(t)
        for e in sim.g.edges.values():
            if e.src not in doomed and e.dst not in doomed:
                shrunk.add_edge(e.src, e.dst, pipelined=e.pipelined)
        releases = {nm: ts[9] for nm, ts in st["tasks"].items()
                    if ts[9] > 0.0 and nm not in doomed}
        prio = {nm: v for nm, v in st["prio"].items()
                if nm not in doomed}
        routes = {nm: p for nm, p in sim.routes.items()
                  if nm not in doomed}
        fresh = ResumableSim(
            Simulator(shrunk, sim.cluster, policy=st["policy"],
                      priorities=prio, releases=releases,
                      coflows=coflows, routes=routes, engine="array"),
            self._horizon, batch=self._batch)
        fresh._ops["transplant"](st)
        self._adopt(fresh)
