"""Discrete-event simulator for MXDAG execution on a cluster.

Models exactly the behaviours the paper reasons about:

- compute tasks occupy processor slots exclusively and non-preemptively
  (compute "can be easily isolated"),
- network flows share bandwidth on every link of their path — just the two
  endpoint NICs on a big-switch cluster, or the full ToR/spine route when
  the cluster carries a fabric Topology — under a pluggable allocation
  policy ("fair" max-min sharing — the network-aware-DAG baseline of
  Fig. 1(b) — or "priority" — the co-scheduler of Fig. 1(c)); flow rates
  are preemptible and recomputed at every event,
- pipelined edges stream units: the consumer may process its j-th unit only
  once every streaming predecessor has *delivered* input fraction
  ≥ (j+1)/n_units (unit-granular, as in Fig. 5),
- coflows (for the §2.2 baseline): synchronized start, MADD-style coupled
  rates (members' rates proportional to remaining work so they finish
  together), and all-or-nothing downstream gating.

The simulator advances by exact rate integration between events; events are
unit boundaries, task completions, and release times, so no behaviour change
can occur between events and the result is exact for piecewise-constant
rates.

Event-calendar invariants (the fast :meth:`Simulator.run` core)
---------------------------------------------------------------
Between two consecutive events every rate is constant, so the engine keeps
a heap of upcoming event times instead of rescanning all tasks:

- A task's rate can change **only** when the set of runnable, unstarved
  flows in some priority class changes (a start, a completion, or a
  starvation flip when work catches up with the pipelined input cap), or —
  for coflow members — when remaining sizes shift the MADD weights.  A
  unit-boundary event that changes none of those leaves every rate intact,
  so the waterfill is skipped entirely and the previous rates are reused.
- Within the "priority" policy, classes are waterfilled in ascending order
  on residual capacity; class c's allocation depends only on classes < c.
  When only class c's runnable set changed, classes below c *replay* their
  logged freeze sequence (bit-identical residual subtraction) and only
  classes ≥ c are waterfilled afresh.
- ``work_cap``/``delivered_fraction`` are maintained incrementally from a
  precomputed streaming-predecessor adjacency: a consumer's cap is
  recomputed only when a streaming producer crosses one of its own unit
  boundaries (its event) or completes.
- Start gating is monotone (done, delivered fraction, coflow completion
  and release only ever progress), so gating is re-evaluated only for
  tasks *triggered* by a completion, a first-unit delivery, a release, or
  a freed compute slot — never by a global rescan.

The retained :meth:`Simulator._reference_run` slow path is the seed
implementation; the golden differential tests assert the event-calendar
core reproduces its start/finish/makespan to within EPS on every scenario.

Engines
-------
:meth:`Simulator.run` dispatches on the ``engine`` argument:

- ``"array"`` (default) — the flat-array engine in
  :mod:`repro_torch.core.arraysim`.  The (MXDAG, Cluster, coflows, routes)
  quadruple is compiled once into integer-interned arrays, cached on the
  graph keyed by (graph version, cluster identity, coflow grouping,
  route overrides) — so scheduler ``_best`` loops and what-if sweeps
  that vary only priorities/releases/policy compile once per graph
  version.  Compiled layout: insertion-order task ids with a
  lexicographic ``name_rank`` (reproducing every name-ordered tie-break
  on ints); per-task ``size``/``unit``/``n_units``/kind/job scalars;
  flow→link incidence as interned link-id tuples plus a CSR
  (``fl_ptr``/``fl_flat``) mirror for the vectorized waterfill;
  start-gating compiled to *counters* (unmet barrier / coflow /
  member-sync preconditions, with per-completion decrement lists —
  equivalent to the calendar's gate re-scan because gating is
  monotone); streaming-predecessor adjacency; coflow membership and
  slot-pool interning; *contention components* (union-find over the
  link incidence) so a completion re-waterfills only the flows
  sharing its component, with per-component coalesced next-completion
  heap entries for streaming-free unit-free flows (see the arraysim
  module docstring).  Run state is flat float64 work/rate vectors and
  int heap entries.  NumPy is optional and import-guarded: with it, the
  waterfill's bottleneck search and batch freezing run as array
  reductions over the incidence CSR; without it (the pure-stdlib core
  CI lane) the same compiled engine runs list-backed kernels with a
  scalar progressive fill, producing identical results.
- ``"calendar"`` — :meth:`Simulator.calendar_run`, the dict-based
  event-calendar core above (pure stdlib; the differential oracle for
  the array engine, and the "before" timing in the scale benchmarks).
- ``"reference"`` — :meth:`Simulator._reference_run`, the seed loop.

:meth:`Simulator.resumable` opens the array engine as a *session*
(:class:`~repro_torch.core.arraysim.ResumableSim`): pause between events,
checkpoint/restore the flat run state, apply fault mutations (host
loss, link degradation, stragglers, task moves, flow re-paths), and
resume without recompiling — the substrate of the fault-injection and
live-replanning layer in :mod:`repro_torch.core.nemesis`.  ``array_run``
itself is one uninterrupted session, so the fault-capable engine and
the plain one cannot drift.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Mapping, Optional, Sequence

from repro_torch.core.cluster import Cluster
from repro_torch.core.fabric import link_flow_index, nic_in, nic_out
from repro_torch.core.graph import MXDAG
from repro_torch.core.task import MXTask, TaskKind

EPS = 1e-9


def waterfill_prep(group, paths) -> tuple[list[str], dict[str, list[str]]]:
    """The (sorted group, link→flows index) pair :func:`waterfill` scans.

    Both are pure functions of ``(group, paths)`` and are never mutated by
    the fill, so a caller replaying the same flow group per event (every
    priority-class pass of :meth:`Simulator._allocate_rates`, most events
    of the calendar core) computes them once and passes ``prep=`` instead
    of re-sorting and re-inverting the paths on every call.
    """
    unfrozen = sorted(group)
    return unfrozen, link_flow_index(unfrozen, paths)


def waterfill(group: list[str], paths, weight, residual: dict[str, float],
              rates: dict[str, float],
              prep: Optional[tuple] = None) -> list[tuple[str, float]]:
    """Weighted max-min fair allocation of ``group`` over ``residual``.

    ``paths[n]`` is the tuple of links flow n occupies; ``weight(n)`` its
    share weight, or ``None`` for unit weights.  Progressive filling:
    repeatedly find the bottleneck link (minimum residual capacity per unit
    weight), freeze every flow crossing it at its weighted share, subtract
    along those flows' paths, recurse on the rest.  Mutates ``residual``
    and ``rates``; returns the freeze sequence ``[(flow, rate), ...]`` in
    allocation order so a caller can replay the identical subtraction.
    ``prep`` is an optional cached :func:`waterfill_prep` result for this
    exact ``(group, paths)`` pair.
    """
    if prep is None:
        prep = waterfill_prep(group, paths)
    unfrozen, by_link = prep
    unfrozen = list(unfrozen)
    seq: list[tuple[str, float]] = []
    if not unfrozen:
        return seq
    unfrozen_set = set(unfrozen)
    if weight is None:
        counts = {r: float(len(fl)) for r, fl in by_link.items()}
    while unfrozen:
        best_r, best_ratio = None, float("inf")
        for r in residual:
            fl = by_link.get(r)
            if not fl:
                continue
            if weight is None:
                w = counts[r]
            else:
                w = sum(weight(n) for n in fl if n in unfrozen_set)
            if w > EPS:
                ratio = residual[r] / w
                if ratio < best_ratio - EPS:
                    best_r, best_ratio = r, ratio
        if best_r is None:
            for n in unfrozen:
                rates[n] = 0.0
                seq.append((n, 0.0))
            return seq
        frozen_now = [n for n in by_link[best_r] if n in unfrozen_set]
        for n in frozen_now:
            alloc = best_ratio if weight is None else weight(n) * best_ratio
            rates[n] = alloc
            seq.append((n, alloc))
            for r in paths[n]:
                residual[r] = max(0.0, residual[r] - alloc)
                if weight is None:
                    counts[r] -= 1.0
        unfrozen_set.difference_update(frozen_now)
        unfrozen = [n for n in unfrozen if n in unfrozen_set]
    return seq


def max_min_rates(paths, capacity,
                  weights: Optional[dict[str, float]] = None,
                  ) -> dict[str, float]:
    """Weighted max-min fair rates for flows over shared links.

    ``paths``: flow → iterable of links; ``capacity``: link → bandwidth.
    A pure function of its inputs — the Simulator's per-event allocation
    reduces to it within each priority class, and the fabric property
    tests check its invariants directly on random topologies.
    """
    p = {n: tuple(ls) for n, ls in paths.items()}
    residual = {r: float(capacity[r]) for ls in p.values() for r in ls}
    w = weights or {}
    rates: dict[str, float] = {}
    weight = (lambda n: w.get(n, 1.0)) if w else None
    waterfill(sorted(p), p, weight, residual, rates)
    return rates


@dataclasses.dataclass
class SimResult:
    """Per-task start/finish times plus makespan and per-job JCTs."""

    start: dict[str, float]
    finish: dict[str, float]
    makespan: float
    job_completion: dict[str, float]

    def jct(self, job: str) -> float:
        """Job completion time of ``job``."""
        return self.job_completion[job]


class _State:
    __slots__ = ("task", "work", "started", "finished", "has_slot")

    def __init__(self, task: MXTask) -> None:
        self.task = task
        self.work = 0.0
        self.started: Optional[float] = None
        self.finished: Optional[float] = None
        self.has_slot = False

    @property
    def done(self) -> bool:
        """Whether the task has finished."""
        return self.finished is not None

    def delivered_fraction(self) -> float:
        """Fraction of output delivered downstream (unit granularity)."""
        t = self.task
        if self.done:
            return 1.0
        if t.size <= 0:
            return 1.0
        u = t.effective_unit
        return min(1.0, math.floor(self.work / u + EPS) * u / t.size)


class Simulator:
    """The DES: executes one MXDAG on a Cluster under a Schedule's
    decisions (see the module docstring for semantics and engines)."""

    def __init__(self, graph: MXDAG, cluster: Optional[Cluster] = None, *,
                 policy: str = "fair",
                 priorities: Optional[dict[str, float]] = None,
                 releases: Optional[dict[str, float]] = None,
                 coflows: Optional[list[set[str]]] = None,
                 routes: Optional[Mapping[str, Sequence[str]]] = None,
                 engine: str = "array",
                 ) -> None:
        if policy not in ("fair", "priority"):
            raise ValueError(f"unknown policy {policy}")
        if engine not in ("array", "calendar", "reference"):
            raise ValueError(f"unknown engine {engine}")
        self.engine = engine
        unbound = graph.unbound()
        if unbound:
            raise ValueError(
                f"cannot simulate {graph.name}: unbound tasks {unbound} "
                f"(apply a placement with MXDAG.bind, or schedule with "
                f"MXDAGScheduler on an explicit cluster)")
        self.g = graph
        if cluster is None:
            # the default cluster is a pure function of the graph; cache
            # it so scheduler loops don't rebuild it per simulation
            cached = graph.__dict__.get("_default_cluster")
            if cached is not None and cached[0] == graph._version:
                cluster = cached[1]
            else:
                cluster = Cluster.for_graph(graph)
                graph._default_cluster = (graph._version, cluster)
        self.cluster = cluster
        self.policy = policy
        self.prio = dict(priorities or {})
        self.releases = dict(releases or {})
        self.coflows = [set(c) for c in (coflows or [])]
        # per-flow route overrides (routing as a scheduling decision): an
        # overlay on a fresh dict, so the version-keyed base cache is
        # never poisoned by one run's route choices
        self.routes = {n: tuple(p) for n, p in (routes or {}).items()}
        if self.routes:
            topo = cluster.topology
            for n, p in self.routes.items():
                t = graph.tasks.get(n)
                if t is None:
                    raise KeyError(f"route override for unknown task {n}")
                if t.kind is not TaskKind.NETWORK:
                    raise ValueError(f"route override for {n}: only "
                                     f"network tasks are routed")
                # a route must connect the flow's actual endpoints — a
                # path between other hosts would silently uncharge the
                # real sender/receiver NICs
                first, last = nic_out(t.src), nic_in(t.dst)
                if len(p) < 2 or p[0] != first or p[-1] != last:
                    raise ValueError(
                        f"route override for {n} must start at {first} "
                        f"and end at {last}, got {p}")
                bad = [l for l in p[1:-1]
                       if topo is None or l not in topo.links]
                if bad:
                    raise KeyError(f"route override for {n} uses "
                                   f"unknown fabric links {bad}")
        self._coflow_of: dict[str, int] = {}
        for i, c in enumerate(self.coflows):
            for n in c:
                if n in self._coflow_of:
                    raise ValueError(f"{n} in two coflows")
                if self.g.tasks[n].kind is not TaskKind.NETWORK:
                    raise ValueError(f"coflow member {n} must be a flow")
                self._coflow_of[n] = i

    @property
    def _res(self) -> dict:
        """Resource paths, resolved lazily and cached: a compute task's
        processor pool, a flow's full link path (endpoint NICs only on
        big-switch clusters), with this run's route overrides overlaid.
        The base map is cached on the graph per (version, cluster); it
        is only materialized for the calendar/reference engines and for
        fabric/route compiles — the big-switch array compile interns
        links straight from the task endpoints and never builds the
        string map.
        """
        res = self.__dict__.get("_res_map")
        if res is None:
            graph, cluster = self.g, self.cluster
            cached = graph.__dict__.get("_res_cache")
            if cached is not None and cached[0] == graph._version \
                    and cached[1] is cluster:
                base_res = cached[2]
            else:
                base_res = {n: cluster.resources_for(t)
                            for n, t in graph.tasks.items()}
                graph._res_cache = (graph._version, cluster, base_res)
            res = {**base_res, **self.routes} if self.routes else base_res
            self.__dict__["_res_map"] = res
        return res

    def run(self, horizon: float = 1e15, *,
            batch: bool = True) -> SimResult:
        """Simulate to completion with the configured engine.

        ``batch=False`` makes the array engine process events strictly
        one at a time (the pre-mega-batch loop, kept as the batched
        loop's differential oracle); calendar/reference engines ignore
        it.  Results are bit-identical either way.
        """
        if self.engine == "calendar":
            return self.calendar_run(horizon)
        if self.engine == "reference":
            return self._reference_run(horizon)
        from repro_torch.core.arraysim import array_run
        return array_run(self, horizon, batch=batch)

    def resumable(self, horizon: float = 1e15, *, batch: bool = True):
        """A pausable array-engine session over this simulation.

        Returns a :class:`~repro_torch.core.arraysim.ResumableSim`: the same
        compiled flat-array run as ``engine="array"``, but exposing
        pause/mutate/resume, checkpoint/restore, and the fault-model
        mutators (kill_host, scale_link, set_speed, move_task,
        repath_flow, set_priorities) used by :mod:`repro_torch.core.nemesis`.
        With no mutations applied it is bit-exact against :meth:`run`;
        ``batch=False`` selects the per-event oracle loop as in
        :meth:`run`.
        """
        from repro_torch.core.arraysim import ResumableSim
        return ResumableSim(self, horizon, batch=batch)

    # ------------------------------------------------------------------
    # incremental event-calendar core (see module docstring invariants)
    # ------------------------------------------------------------------
    def _statics(self) -> dict:
        """Graph/coflow-derived constants of a run, cached on the graph.

        Everything here is a pure function of (graph version, coflows) —
        the scheduler simulates the same graph under several priority
        maps, and what-if sweeps re-simulate scheduled graphs, so the
        precompute is shared across runs instead of rebuilt per sim.
        """
        g = self.g
        tasks = g.tasks
        coflows = self.coflows
        coflow_of = self._coflow_of
        key = (g._version,
               tuple(tuple(sorted(c)) for c in coflows))
        cached = g.__dict__.get("_sim_statics")
        if cached is not None and cached[0] == key:
            return cached[1]

        # per-task scalars (size/effective_unit/n_units are properties;
        # the event loop reads them millions of times)
        size_of = {n: t.size for n, t in tasks.items()}
        unit_of = {n: t.effective_unit for n, t in tasks.items()}
        nu_of = {n: t.n_units for n, t in tasks.items()}
        is_compute = {n: t.kind is TaskKind.COMPUTE
                      for n, t in tasks.items()}

        # streaming adjacency for work_cap maintenance (coflow producers
        # gate at start instead, exactly as the reference's work_cap skip)
        stream_in: dict[str, list[str]] = {n: [] for n in tasks}
        stream_out: dict[str, list[str]] = {n: [] for n in tasks}
        # flows fed by any effectively-pipelined edge (coflow or not):
        # they contend in the top priority class (paper §4.1)
        stream_fed: set[str] = set()
        for (p, n), e in g.edges.items():
            if g.effective_pipelined(e):
                stream_fed.add(n)
                if coflow_of.get(p) is None:
                    stream_in[n].append(p)
                    stream_out[p].append(n)

        # start-gating lists, compiled once: barrier preds (must be done),
        # streaming preds (first-unit fraction), coflow preds (coflow must
        # be done), plus the member-sync preds of the task's own coflow
        _empty: tuple = ()
        gate_barrier: dict[str, tuple] = {}
        gate_stream: dict[str, tuple] = {}
        gate_cof: dict[str, tuple] = {}
        gate_sync: dict[str, tuple] = {}
        for n in tasks:
            barrier, stream, cofs = [], [], []
            for p in g.preds(n):
                ci = coflow_of.get(p)
                if ci is not None:
                    cofs.append(ci)
                elif g.effective_pipelined(g.edges[(p, n)]):
                    stream.append(p)
                else:
                    barrier.append(p)
            gate_barrier[n] = tuple(barrier) if barrier else _empty
            gate_stream[n] = tuple(stream) if stream else _empty
            gate_cof[n] = tuple(cofs) if cofs else _empty
            ci = coflow_of.get(n)
            gate_sync[n] = (tuple(p for m in coflows[ci]
                                  for p in g.preds(m))
                            if ci is not None else _empty)

        net_order = [n for n, t in tasks.items()
                     if t.kind is TaskKind.NETWORK]
        net_idx = {n: i for i, n in enumerate(net_order)}

        # tasks whose coflow-sync start gate cares about a completion of n
        coflow_fed_by: dict[str, list[int]] = {}
        for i, c in enumerate(coflows):
            for m in c:
                for p in g.preds(m):
                    coflow_fed_by.setdefault(p, []).append(i)

        data = dict(size_of=size_of, unit_of=unit_of, nu_of=nu_of,
                    is_compute=is_compute, stream_in=stream_in,
                    stream_out=stream_out, stream_fed=stream_fed,
                    has_streaming=any(stream_out.values()),
                    gate_barrier=gate_barrier, gate_stream=gate_stream,
                    gate_cof=gate_cof, gate_sync=gate_sync,
                    net_order=net_order, net_idx=net_idx,
                    coflow_fed_by=coflow_fed_by)
        g._sim_statics = (key, data)
        return data

    def calendar_run(self, horizon: float = 1e15) -> SimResult:
        """The incremental event-calendar engine (dict-keyed oracle)."""
        g = self.g
        tasks = g.tasks
        st = {n: _State(t) for n, t in tasks.items()}
        now = 0.0
        slots_free = {f"{h}.{p}": k
                      for h, host in self.cluster.hosts.items()
                      for p, k in host.procs.items()}
        coflow_of = self._coflow_of
        coflows = self.coflows
        inf = float("inf")
        prio_get = self.prio.get

        sd = self._statics()
        size_of = sd["size_of"]
        unit_of = sd["unit_of"]
        nu_of = sd["nu_of"]
        is_compute = sd["is_compute"]
        stream_in = sd["stream_in"]
        stream_out = sd["stream_out"]
        has_streaming = sd["has_streaming"]
        gate_barrier = sd["gate_barrier"]
        gate_stream = sd["gate_stream"]
        gate_cof = sd["gate_cof"]
        gate_sync = sd["gate_sync"]
        net_order = sd["net_order"]
        net_idx = sd["net_idx"]
        coflow_fed_by = sd["coflow_fed_by"]
        stream_fed = sd["stream_fed"]

        # flow priority classes are static for a run: the streaming flag
        # and the priority map never change mid-simulation
        cls_of = ({n: None for n in net_order} if self.policy == "fair"
                  else {n: 0.0 if n in stream_fed else prio_get(n, 0.0)
                        for n in net_order})
        # dispatch order of the start pass (static: priority, then name)
        sort_key = {n: (prio_get(n, 0.0), n) for n in tasks}

        bw = self.cluster.bandwidths(
            r for n in net_order for r in self._res[n])

        # -- dynamic state ---------------------------------------------
        cap: dict[str, float] = {}       # work_cap, tasks with stream_in
        d_units: dict[str, int] = {}     # delivered units, stream_out keys
        starved = {n: False for n in tasks}
        rates = {n: 0.0 for n in tasks}
        active: set[str] = set()         # started, unfinished, rate > EPS
        runnable_net: set[str] = set()   # started, unfinished flows
        waiting_slot: dict[str, set[str]] = {}
        dirty_classes: set = set()
        alloc_log: dict = {}             # class -> freeze sequence
        heap: list[tuple[float, int, str, int]] = []
        stamp = {n: 0 for n in tasks}
        unfinished = len(tasks)
        heappush = heapq.heappush
        heappop = heapq.heappop
        succs_of = g._succ

        def coflow_done(i: int) -> bool:
            """All-or-nothing: has every member of coflow ``i`` finished?"""
            return all(st[m].finished is not None for m in coflows[i])

        def delivered_fraction(p: str) -> float:
            """Fraction of ``p``'s output delivered (unit granularity)."""
            ps = st[p]
            if ps.finished is not None:
                return 1.0
            size = size_of[p]
            if size <= 0:
                return 1.0
            u = unit_of[p]
            return min(1.0, math.floor(ps.work / u + EPS) * u / size)

        def pred_satisfied_for_start(n: str) -> bool:
            """Can task n begin its first unit now?  (Seed semantics.)"""
            for p in gate_barrier[n]:
                if st[p].finished is None:
                    return False
            for ci in gate_cof[n]:
                if not coflow_done(ci):            # all-or-nothing gating
                    return False
            for p in gate_stream[n]:
                if delivered_fraction(p) + EPS < 1.0 / nu_of[n]:
                    return False
            # coflow synchronized start: every member's preds must be done
            for p in gate_sync[n]:
                if st[p].finished is None:
                    return False
            return True

        def recompute_cap(n: str) -> float:
            """Work cap from streaming predecessors' delivered units."""
            c = size_of[n]
            nu = nu_of[n]
            eu = unit_of[n]
            for p in stream_in[n]:
                if st[p].finished is None:
                    enabled = math.floor(delivered_fraction(p) * nu + EPS)
                    c = min(c, enabled * eu)
            return c

        def cap_of(n: str) -> float:
            """Current work cap of ``n`` (size when unconstrained)."""
            return cap.get(n, size_of[n])

        def dirty(n: str) -> None:
            """Mark ``n``'s priority class for re-waterfill."""
            dirty_classes.add(cls_of[n])

        def schedule_event(n: str) -> None:
            """(Re)compute task n's next unit-boundary/cap/completion."""
            ver = stamp[n] + 1
            stamp[n] = ver
            s = st[n]
            r = rates[n]
            if s.finished is not None or s.started is None or r <= EPS:
                active.discard(n)
                return
            active.add(n)
            size = size_of[n]
            w = s.work
            u = unit_of[n]
            if u < size:
                tgt = (math.floor(w / u + EPS) + 1) * u
                if tgt > size:
                    tgt = size
            else:
                tgt = size
            best = inf
            if tgt > w + EPS:
                best = (tgt - w) / r
            if size > w + EPS:
                d = (size - w) / r
                if d < best:
                    best = d
            c = cap.get(n)
            if c is not None and c > w + EPS:
                d = (c - w) / r
                if d < best:
                    best = d
            if best < inf:
                heappush(heap, (now + best, 1, n, ver))

        def weight_for(group_has_coflow: bool):
            """MADD weight function for a class, or None when uniform."""
            if not group_has_coflow:
                return None

            def weight(n: str) -> float:
                """Member weight ∝ remaining work (MADD coupling)."""
                ci = coflow_of.get(n)
                if ci is None:
                    return 1.0
                rem = {m: size_of[m] - st[m].work
                       for m in coflows[ci] if st[m].finished is None}
                mx = max(rem.values(), default=1.0)
                return max(rem.get(n, 0.0) / mx, 1e-6) if mx > 0 else 1.0
            return weight

        wf_prep: dict = {}           # (cls, group) -> waterfill_prep

        def allocate() -> set[str]:
            """Waterfill classes from the lowest dirty one up; replay the
            untouched classes below it (their runnable sets are unchanged,
            so their rates — and the residual they leave behind — are the
            ones already logged).  Returns the freshly waterfilled flows."""
            # task-insertion order, as the seed's full scan produced it
            flows = sorted((n for n in runnable_net if not starved[n]),
                           key=net_idx.__getitem__)
            changed: set[str] = set()
            residual: dict[str, float] = {}
            for n in flows:
                for r in self._res[n]:
                    if r not in residual:
                        residual[r] = bw[r]
            if self.policy == "fair":
                classes: list = [None]
                lowest = None            # single class: always waterfill
            else:
                classes = sorted({cls_of[n] for n in flows})
                lowest = min(dirty_classes) if dirty_classes else None
            new_log: dict = {}
            for cls in classes:
                if lowest is None or cls >= lowest or cls not in alloc_log:
                    group = [n for n in flows if cls_of[n] == cls]
                    old = [rates[n] for n in group]
                    # an unchanged class group re-fills with the identical
                    # sorted order and link index: cache the prep per
                    # (class, group) instead of rebuilding it every event
                    pkey = (cls, tuple(group))
                    prep = wf_prep.get(pkey)
                    if prep is None:
                        if len(wf_prep) > 512:
                            wf_prep.clear()
                        prep = wf_prep[pkey] = waterfill_prep(
                            group, self._res)
                    seq = waterfill(
                        group, self._res,
                        weight_for(any(n in coflow_of for n in group)),
                        residual, rates, prep=prep)
                    # an unchanged rate means unchanged absolute event
                    # times — the existing heap entry stays valid
                    changed.update(n for n, o in zip(group, old)
                                   if rates[n] != o)
                    new_log[cls] = seq
                else:
                    # unchanged class: replay the logged freeze sequence —
                    # identical subtraction order, bit-identical residual
                    for n, alloc in alloc_log[cls]:
                        rates[n] = alloc
                        for r in self._res[n]:
                            residual[r] = max(0.0, residual[r] - alloc)
                    new_log[cls] = alloc_log[cls]
            alloc_log.clear()
            alloc_log.update(new_log)
            dirty_classes.clear()
            return changed

        candidates: set[str] = set()
        freed: set[str] = set()
        touched: set[str] = set()        # need schedule_event refresh

        def complete(n: str) -> None:
            """Finish ``n``: free its slot, trigger gated candidates."""
            nonlocal unfinished
            s = st[n]
            s.finished = now
            unfinished -= 1
            active.discard(n)
            if s.has_slot:
                r = tasks[n].resources()[0]
                slots_free[r] += 1
                s.has_slot = False
                freed.add(r)
            if is_compute[n]:
                rates[n] = 0.0
            else:
                runnable_net.discard(n)
                if rates[n]:
                    rates[n] = 0.0
                    dirty_classes.add(cls_of[n])
            candidates.update(succs_of[n])
            for c in stream_out[n]:
                cs = st[c]
                if cs.started is not None and cs.finished is None:
                    nc = recompute_cap(c)
                    if nc != cap.get(c):
                        cap[c] = nc
                        touched.add(c)
            if coflows:
                ci = coflow_of.get(n)
                if ci is not None and coflow_done(ci):
                    for m in coflows[ci]:
                        candidates.update(succs_of[m])
                for ci2 in coflow_fed_by.get(n, ()):
                    candidates.update(coflows[ci2])

        def on_start(n: str) -> None:
            """Initialize ``n``'s streaming caps/counters at start."""
            s = st[n]
            c = size_of[n]
            if stream_in[n]:
                c = cap[n] = recompute_cap(n)
            if stream_out[n]:
                d_units[n] = 0
                for c2 in stream_out[n]:
                    candidates.add(c2)   # first-unit gate may already pass
            is_starved = c <= s.work + EPS
            starved[n] = is_starved
            if is_compute[n]:
                rates[n] = 0.0 if is_starved else 1.0
            else:
                runnable_net.add(n)
                dirty_classes.add(cls_of[n])
            touched.add(n)

        def process_starts() -> None:
            """Start every gated candidate; cascade zero-size completions
            (the seed's same-timestamp `continue` loop)."""
            while True:
                startable = [n for n in candidates
                             if st[n].started is None
                             and self.releases.get(n, 0.0) <= now + EPS
                             and pred_satisfied_for_start(n)]
                candidates.clear()
                if not startable:
                    return
                zero_done = False
                for n in sorted(startable, key=sort_key.__getitem__):
                    s = st[n]
                    if is_compute[n]:
                        r = tasks[n].resources()[0]
                        if slots_free.get(r, 0) >= 1:
                            slots_free[r] -= 1
                            s.has_slot = True
                            s.started = now
                            waiting_slot.get(r, set()).discard(n)
                        else:
                            waiting_slot.setdefault(r, set()).add(n)
                            continue
                    else:
                        s.started = now
                    on_start(n)
                    if size_of[n] <= EPS:
                        complete(n)
                        zero_done = True
                # newly freed slots may admit earlier waiters immediately
                for r in freed:
                    candidates.update(waiting_slot.get(r, ()))
                freed.clear()
                if not zero_done and not candidates:
                    return

        # -- initialisation --------------------------------------------
        for n, rel in self.releases.items():
            if rel > EPS:
                heapq.heappush(heap, (rel, 0, n, 0))
        candidates.update(st)
        process_starts()
        if dirty_classes:
            touched.update(allocate())
        for n in touched:
            schedule_event(n)
        touched.clear()

        # -- main loop -------------------------------------------------
        guard = 0
        max_iters = 10000 * (len(tasks) + 1) + sum(nu_of.values())
        while unfinished:
            guard += 1
            if guard > max_iters:
                raise RuntimeError("simulator did not converge (livelock?)")

            # next event time (skip stale heap entries lazily)
            t_next = None
            while heap:
                tm, kind, n, stp = heap[0]
                if kind == 1 and (stamp[n] != stp
                                  or st[n].finished is not None):
                    heappop(heap)
                    continue
                if kind == 0 and st[n].started is not None:
                    heappop(heap)
                    continue
                t_next = tm
                break
            if t_next is None:
                pend = [n for n, s in st.items() if not s.done]
                raise RuntimeError(f"deadlock at t={now:.6g}: {pend}")
            if t_next > horizon:
                t_next = horizon     # seed semantics: never pass horizon;
                #                      no progress past it trips the guard
            dt = t_next - now
            if dt > 0.0:
                for n in active:
                    s = st[n]
                    w = s.work + rates[n] * dt
                    size = size_of[n]
                    s.work = size if w > size else w
            now = t_next

            batch: list[str] = []
            while heap and heap[0][0] <= t_next:
                tm, kind, n, stp = heappop(heap)
                if kind == 1 and stamp[n] == stp \
                        and st[n].finished is None:
                    batch.append(n)
                elif kind == 0 and st[n].started is None:
                    candidates.add(n)

            # completions (scan active: a task reaching its cap or size is
            # still rate>0 until this very event)
            finished_now = [n for n in active
                            if st[n].work >= size_of[n] - EPS]
            for n in finished_now:
                complete(n)

            # unit-boundary crossings feed streaming consumers
            if has_streaming:
                for n in batch:
                    if not stream_out[n] or st[n].finished is not None:
                        continue
                    du = math.floor(st[n].work / unit_of[n] + EPS)
                    if du != d_units[n]:
                        d_units[n] = du
                        for c in stream_out[n]:
                            cs = st[c]
                            if cs.started is None:
                                candidates.add(c)
                            elif cs.finished is None:
                                nc = recompute_cap(c)
                                if nc != cap.get(c):
                                    cap[c] = nc
                                    touched.add(c)

            for r in freed:
                candidates.update(waiting_slot.get(r, ()))
            freed.clear()
            if candidates:
                process_starts()

            # starvation flips (cap moved, or work caught up with cap)
            for n in touched.union(x for x in batch
                                   if st[x].finished is None):
                s = st[n]
                if s.started is None or s.finished is not None:
                    continue
                is_starved = cap_of(n) <= s.work + EPS
                if is_starved != starved[n]:
                    starved[n] = is_starved
                    if is_compute[n]:
                        rates[n] = 0.0 if is_starved else 1.0
                    else:
                        if is_starved:
                            rates[n] = 0.0   # excluded from the waterfill
                        dirty(n)
                touched.add(n)

            # MADD weights drift with remaining work: any class holding a
            # running coflow member reallocates every event
            if coflows:
                for i, c in enumerate(coflows):
                    if any(st[m].started is not None
                           and st[m].finished is None for m in c):
                        for m in c:
                            dirty_classes.add(cls_of[m])

            if dirty_classes:
                touched.update(allocate())

            for n in touched:
                schedule_event(n)
            for n in batch:
                if n not in touched:
                    schedule_event(n)
            touched.clear()

        start = {n: s.started for n, s in st.items()}         # type: ignore
        finish = {n: s.finished for n, s in st.items()}       # type: ignore
        jobs: dict[str, float] = {}
        for n, s in st.items():
            j = tasks[n].job
            jobs[j] = max(jobs.get(j, 0.0), s.finished)       # type: ignore
        return SimResult(start=start, finish=finish,
                         makespan=max(finish.values(), default=0.0),
                         job_completion=jobs)

    # ------------------------------------------------------------------
    # golden slow path: the seed implementation, kept as the differential-
    # test oracle for the event-calendar core.  Verbatim except for two
    # crash fixes the fuzzer surfaced (the results on every non-crashing
    # input are untouched): (1) the zero-size start cascade re-looped on
    # *any historical* zero-size completion, livelocking whenever one
    # coexisted with a startable compute task blocked on a busy slot;
    # (2) a DAG whose final tasks complete inside that cascade fell
    # through to the deadlock check with nothing pending.
    # ------------------------------------------------------------------
    def _reference_run(self, horizon: float = 1e15) -> SimResult:
        g = self.g
        st = {n: _State(t) for n, t in g.tasks.items()}
        now = 0.0
        slots_free = {f"{h}.{p}": k
                      for h, host in self.cluster.hosts.items()
                      for p, k in host.procs.items()}

        def coflow_done(i: int) -> bool:
            """All-or-nothing: has every member of coflow ``i`` finished?"""
            return all(st[m].done for m in self.coflows[i])

        def pred_satisfied_for_start(n: str) -> bool:
            """Can task n begin its first unit now?"""
            for p in g.preds(n):
                e = g.edges[(p, n)]
                ps = st[p]
                ci = self._coflow_of.get(p)
                if ci is not None:
                    if not coflow_done(ci):        # all-or-nothing gating
                        return False
                    continue
                if g.effective_pipelined(e):
                    nu = g.tasks[n].n_units
                    if ps.delivered_fraction() + EPS < 1.0 / nu:
                        return False
                elif not ps.done:
                    return False
            # coflow synchronized start: every member's preds must be done
            ci = self._coflow_of.get(n)
            if ci is not None:
                for m in self.coflows[ci]:
                    for p in g.preds(m):
                        if not st[p].done:
                            return False
            return True

        def work_cap(n: str) -> float:
            """Max work task n may perform given currently delivered inputs.

            Quantized to the *consumer's* unit granularity: unit j may be
            processed only once its full input (fraction (j+1)/n_units) has
            been delivered by every streaming predecessor (Fig. 5).
            """
            t = g.tasks[n]
            cap = t.size
            nu = t.n_units
            for p in g.preds(n):
                e = g.edges[(p, n)]
                if self._coflow_of.get(p) is not None:
                    continue  # gated at start; coflow edges are barriers
                if g.effective_pipelined(e) and not st[p].done:
                    frac = st[p].delivered_fraction()
                    enabled = math.floor(frac * nu + EPS)
                    cap = min(cap, enabled * t.effective_unit)
            return cap

        def release(n: str) -> float:
            """Earliest allowed start of ``n`` (0.0 when unconstrained)."""
            return self.releases.get(n, 0.0)

        # main loop ----------------------------------------------------
        guard = 0
        max_iters = 10000 * (len(g.tasks) + 1) + sum(
            t.n_units for t in g.tasks.values())
        while any(not s.done for s in st.values()):
            guard += 1
            if guard > max_iters:
                raise RuntimeError("simulator did not converge (livelock?)")

            # 1) start tasks whose gating allows it
            startable = [n for n, s in st.items()
                         if s.started is None and release(n) <= now + EPS
                         and pred_satisfied_for_start(n)]
            # compute tasks need a free slot; dispatch by (priority, name)
            zero_completed = False
            for n in sorted(startable,
                            key=lambda n: (self.prio.get(n, 0.0), n)):
                t = g.tasks[n]
                if t.kind is TaskKind.COMPUTE:
                    r = t.resources()[0]
                    if slots_free.get(r, 0) >= 1:
                        slots_free[r] -= 1
                        st[n].has_slot = True
                        st[n].started = now
                else:
                    st[n].started = now
                if t.size <= EPS and st[n].started is not None:
                    st[n].finished = now
                    zero_completed = True
                    if st[n].has_slot:
                        slots_free[t.resources()[0]] += 1
                        st[n].has_slot = False

            # zero-size completions may unlock more starts immediately.
            # Only a completion from *this* pass warrants the re-loop —
            # the seed keyed this on any historical zero-size completion,
            # which livelocked whenever one existed alongside a startable
            # compute task blocked on a busy slot (nothing changes between
            # passes, so the same-timestamp loop never exits).
            if zero_completed:
                # cheap: loop again to re-evaluate gating at same timestamp
                if any(st[n].started is None and release(n) <= now + EPS
                       and pred_satisfied_for_start(n)
                       for n in st):
                    continue

            # 2) rates
            rates = self._allocate_rates(st, work_cap)

            # 3) dt to next boundary
            dt = horizon - now
            progressing = False
            for n, s in st.items():
                if s.done or s.started is None:
                    continue
                r = rates.get(n, 0.0)
                if r <= EPS:
                    continue
                progressing = True
                t = g.tasks[n]
                u = t.effective_unit
                # next unit boundary strictly above current work
                k = math.floor(s.work / u + EPS) + 1
                targets = [min(k * u, t.size), t.size, work_cap(n)]
                for tgt in targets:
                    if tgt > s.work + EPS:
                        dt = min(dt, (tgt - s.work) / r)
            future_rel = [rel for n, rel in self.releases.items()
                          if st[n].started is None and rel > now + EPS]
            if future_rel:
                dt = min(dt, min(future_rel) - now)
            if not progressing:
                if future_rel:
                    now = min(future_rel)
                    continue
                # could be waiting on a compute slot that frees only at a
                # completion — but nothing progresses ⇒ deadlock
                pend = [n for n, s in st.items() if not s.done]
                if not pend:
                    break   # a zero-size start cascade finished the DAG
                    # mid-iteration (seed bug fix: it raised "deadlock"
                    # with nothing pending)
                raise RuntimeError(f"deadlock at t={now:.6g}: {pend}")
            dt = max(dt, 0.0)

            # 4) integrate
            now += dt
            for n, s in st.items():
                if s.done or s.started is None:
                    continue
                r = rates.get(n, 0.0)
                if r > EPS:
                    s.work = min(g.tasks[n].size, s.work + r * dt)

            # 5) completions
            for n, s in st.items():
                t = g.tasks[n]
                if not s.done and s.started is not None \
                        and s.work >= t.size - EPS:
                    s.finished = now
                    if s.has_slot:
                        slots_free[t.resources()[0]] += 1
                        s.has_slot = False

        start = {n: s.started for n, s in st.items()}         # type: ignore
        finish = {n: s.finished for n, s in st.items()}       # type: ignore
        jobs: dict[str, float] = {}
        for n, s in st.items():
            j = g.tasks[n].job
            jobs[j] = max(jobs.get(j, 0.0), s.finished)       # type: ignore
        return SimResult(start=start, finish=finish,
                         makespan=max(finish.values(), default=0.0),
                         job_completion=jobs)

    # ------------------------------------------------------------------
    def _allocate_rates(self, st: dict[str, _State],
                        work_cap) -> dict[str, float]:
        """Instantaneous rates for all runnable tasks (reference path).

        Compute tasks: rate 1 while holding a slot and not input-starved.
        Flows: weighted max-min fair within a priority class over every
        link on their path, classes served in strict priority order on
        residual link capacity.  Coflow members get weights ∝ remaining
        work (MADD: finish together).

        Paper semantic (§4.1): a *pipelined* task "enforces the resources to
        be occupied right after the precedent task begins processing, which
        may contend with the tasks on the critical path" — so a flow fed by
        a streaming edge contends in the top priority class once started.
        This is precisely why Principle 1 applies pipelining only when it
        shrinks the makespan (Fig. 3 case 3).
        """
        g = self.g
        rates: dict[str, float] = {}
        flows: list[str] = []
        for n, s in st.items():
            if s.done or s.started is None:
                continue
            if work_cap(n) <= s.work + EPS:
                rates[n] = 0.0           # starved on pipelined input
                continue
            t = g.tasks[n]
            if t.kind is TaskKind.COMPUTE:
                rates[n] = 1.0 if s.has_slot else 0.0
            else:
                flows.append(n)

        if not flows:
            return rates

        residual = {}
        for n in flows:
            for r in self._res[n]:
                residual.setdefault(r, self.cluster.bandwidth(r))

        def weight(n: str) -> float:
            """MADD weight: member rate ∝ remaining work."""
            ci = self._coflow_of.get(n)
            if ci is None:
                return 1.0
            rem = {m: g.tasks[m].size - st[m].work for m in self.coflows[ci]
                   if not st[m].done}
            mx = max(rem.values(), default=1.0)
            return max(rem.get(n, 0.0) / mx, 1e-6) if mx > 0 else 1.0

        def flow_class(n: str) -> float:
            """Priority class of flow ``n`` under the current policy."""
            # streaming flows occupy bandwidth eagerly (paper §4.1)
            if any(g.effective_pipelined(g.edges[(p, n)])
                   for p in g.preds(n)):
                return 0.0
            return self.prio.get(n, 0.0)

        has_coflow = bool(self._coflow_of)
        if self.policy == "priority":
            classes = sorted({flow_class(n) for n in flows})
        else:
            classes = [None]

        # hoisted waterfill prep: the reference loop reallocates every
        # event, but a class whose runnable group did not change replays
        # the same (sorted group, link index) — cache it per (cls, group)
        # instead of re-sorting and re-inverting paths per event
        prep_cache = self.__dict__.setdefault("_wf_prep_cache", {})
        for cls in classes:
            group = [n for n in flows
                     if cls is None or flow_class(n) == cls]
            pkey = (cls, tuple(group))
            prep = prep_cache.get(pkey)
            if prep is None:
                if len(prep_cache) > 512:
                    prep_cache.clear()
                prep = prep_cache[pkey] = waterfill_prep(group, self._res)
            waterfill(group, self._res, weight if has_coflow else None,
                      residual, rates, prep=prep)
        return rates


def simulate(graph: MXDAG, cluster: Optional[Cluster] = None, *,
             policy: str = "fair",
             priorities: Optional[dict[str, float]] = None,
             releases: Optional[dict[str, float]] = None,
             coflows: Optional[list[set[str]]] = None,
             routes: Optional[Mapping[str, Sequence[str]]] = None,
             engine: str = "array",
             ) -> SimResult:
    """One-shot convenience wrapper: build a Simulator and run it."""
    return Simulator(graph, cluster, policy=policy, priorities=priorities,
                     releases=releases, coflows=coflows, routes=routes,
                     engine=engine).run()
