"""MXDAG schedulers (paper §4).

- :class:`FairShareScheduler` — the network-aware-DAG baseline of Fig. 1(b):
  every task starts as soon as its dependencies allow; NIC bandwidth is
  max-min fair-shared; no flow-level priorities; no pipelining decisions.

- :class:`CoflowConfig` — the §2.2 baseline: flows grouped into coflows with
  synchronized start, MADD-coupled rates and all-or-nothing gating.

- :class:`MXDAGScheduler` — Principle 1: prioritize the critical path within
  any copath (without letting non-critical paths exceed the critical path),
  and enable pipelining on an edge only when it shrinks the makespan
  (the Fig. 3 analysis, automated as a greedy what-if loop).  With a
  :class:`PlacementScheduler` stage, *where* logical tasks run and *which
  path* each flow takes become further decisions in the same loop.

- :class:`PlacementScheduler` — slack-guided greedy placement of logical
  (unbound) tasks onto cluster hosts, avoiding oversubscribed uplinks,
  refined by memoized what-if DES runs.

- :class:`AltruisticMultiScheduler` — Principle 2: a job delays/demotes its
  non-critical tasks, bounded by their slack, to donate resources to other
  jobs' critical paths without extending its own completion time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import arrayanalytic
from repro_torch.core.cluster import Cluster
from repro_torch.core.fabric import nic_in, nic_out
from repro_torch.core.graph import MXDAG
from repro_torch.core.parallel import effective_workers, trial_map
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.task import TaskKind

# priority classes (lower value = more urgent)
CRITICAL = 0.0
NONCRITICAL = 1.0
ALTRUIST_DEMOTED = 2.0


@dataclasses.dataclass
class Schedule:
    """Everything needed to execute a scheduling decision in the DES.

    A Schedule carries every *kind* of decision the co-scheduler can make:

    - **priorities** — per-task priority classes (Principle 1: critical
      path first; Principle 2: altruistic demotion), consumed by the
      ``"priority"`` policy's strict-class waterfill;
    - **pipelining** — edge streaming flags, applied on :attr:`graph`
      (Fig. 3: enabled only where it shrinks the makespan);
    - **coflows** — flow groupings with synchronized start, MADD-coupled
      rates and all-or-nothing gating (the §2.2 baseline);
    - **releases** — per-task earliest start times (delaying a flow is
      sometimes the optimal decision, Fig. 2);
    - **placement** — the host assignment applied to logical tasks;
      :attr:`graph` is the *bound* graph, and :attr:`placement` records
      the assignment that produced it;
    - **routes** — per-flow path overrides (members of the fabric's
      candidate sets) replacing the static ECMP pick, threaded into the
      DES via ``Simulator(routes=...)``.

    Default-constructed fields are inert: a Schedule with no placement and
    no routes executes exactly as one predating those decision kinds.
    """
    graph: MXDAG                        # with pipelining flags applied
    policy: str = "fair"
    priorities: dict[str, float] = dataclasses.field(default_factory=dict)
    releases: dict[str, float] = dataclasses.field(default_factory=dict)
    coflows: Optional[list[set[str]]] = None
    placement: dict = dataclasses.field(default_factory=dict)
    routes: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def simulate(self, cluster: Optional[Cluster] = None,
                 routes: Optional[dict] = None,
                 engine: str = "array") -> SimResult:
        """Execute this Schedule in the DES.

        :param cluster: capacities/fabric; default derived from the graph.
        :param routes: extra per-flow route overrides layered on top of
            (and winning over) :attr:`routes`.
        :param engine: ``"array"`` (default), ``"calendar"``, or
            ``"reference"`` — see the engine ladder in the simulator docs.
        :returns: the :class:`~repro_torch.core.simulator.SimResult`.
        """
        merged = {**self.routes, **(routes or {})}
        return simulate(self.graph, cluster, policy=self.policy,
                        priorities=self.priorities, releases=self.releases,
                        coflows=self.coflows, routes=merged or None,
                        engine=engine)


class FairShareScheduler:
    """Baseline: dependency-driven start, fair NIC sharing, no priorities."""

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """An empty decision: default fair sharing on ``graph``.

        :param graph: the MXDAG to run.
        :param cluster: accepted for interface symmetry; unused.
        :returns: a ``policy="fair"`` Schedule with no other decisions.
        """
        return Schedule(graph=graph, policy="fair")


class CoflowConfig:
    """Coflow baseline: caller supplies the grouping (the paper's point in
    §2.2 is precisely that the grouping is ambiguous — Fig. 2(b1..b3));
    :func:`auto_coflows` derives one conventional grouping."""

    def __init__(self, coflows: list[set[str]]):
        """:param coflows: the flow grouping to impose (disjoint sets)."""
        self.coflows = coflows

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Impose the configured grouping under fair sharing.

        :param graph: the MXDAG to run.
        :param cluster: accepted for interface symmetry; unused.
        :returns: a ``policy="fair"`` Schedule carrying the §2.2 coflow
            semantics for the configured groups.
        """
        return Schedule(graph=graph, policy="fair", coflows=self.coflows,
                        meta={"coflows": self.coflows})


def auto_coflows(graph: MXDAG, *, singletons: bool = False,
                 ) -> list[set[str]]:
    """Conventional stage-grouping: flows sharing the same successor set
    (aggregations) or, failing that, the same predecessor set (broadcasts).

    :param graph: the MXDAG whose network tasks are grouped.
    :param singletons: also return one-flow groups.  The default drops
        them (a singleton "coflow" adds nothing to the §2.2 baseline),
        but coflow-*ordering* schedulers (:mod:`repro_torch.core.baselines`)
        need every flow covered — an unordered flow would default to
        priority class 0.0 and preempt the whole ordering.  This switch
        is the one extension the baseline bake-off forced on the coflow
        API.
    :returns: disjoint flow-name groups, in task-insertion order.
    """
    groups: dict[tuple, set[str]] = {}
    for t in graph.network_tasks():
        succ = frozenset(graph.succs(t.name))
        pred = frozenset(graph.preds(t.name))
        key = ("succ", succ) if succ else ("pred", pred)
        groups.setdefault(key, set()).add(t.name)
    return [g for g in groups.values() if singletons or len(g) >= 2]


class PlacementScheduler:
    """Slack-guided greedy placement of logical tasks onto cluster hosts.

    A graph's unbound placement fields form co-location classes (see
    ``MXDAG._location_vars``): a compute task and the endpoints of the
    flows it produces/consumes must land on one host.  Classes are placed
    most-urgent first (ascending analytic slack — "do the hard stuff
    first"), each onto the host minimizing a congestion estimate: for
    every adjacent flow whose other endpoint is already known, the
    bottleneck ratio ``(assigned load + flow size) / capacity`` along the
    candidate route — so oversubscribed uplinks repel placements in
    proportion to how contended they already are — plus a large penalty
    for oversubscribing processor slots.

    With ``des_refine`` (default), the greedy result is then improved by
    what-if DES runs: each class tries its ``max_candidates`` best
    alternative hosts through the scheduler's memoized ``_best`` cache and
    keeps strict makespan improvements.
    """

    def __init__(self, *, max_candidates: int = 4,
                 des_refine: bool = True):
        if max_candidates < 1:
            raise ValueError("max_candidates must be >= 1")
        self.max_candidates = max_candidates
        self.des_refine = des_refine

    # -- helpers -------------------------------------------------------
    @staticmethod
    def _path_of(cluster: Cluster, src: str, dst: str) -> tuple[str, ...]:
        if cluster.topology is not None:
            return cluster.topology.path(src, dst)
        return (nic_out(src), nic_in(dst))

    def place(self, graph: MXDAG, cluster: Cluster, *,
              scheduler: "Optional[MXDAGScheduler]" = None,
              cache: Optional[dict] = None) -> dict:
        """Choose hosts for every undecided co-location class of
        ``graph``; returns an assignment for :meth:`MXDAG.bind`."""
        find, variables = graph._location_vars()
        classes: dict[tuple, list[tuple]] = {}
        for v in variables:
            classes.setdefault(find(v), []).append(v)

        tasks = graph.tasks

        def var_value(v: tuple) -> Optional[str]:
            """The host already bound to location variable ``v``, if any."""
            t = tasks[v[1]]
            if v[0] == "c":
                return t.host
            return t.src if v[0] == "s" else t.dst

        # decisions = classes where *no* member is anchored by a bound
        # field (anchored classes are forced; bind() infers them — their
        # value still counts toward the congestion estimate)
        free: list[tuple] = []
        anchored: dict[tuple, str] = {}
        for root, vs in classes.items():
            vals = {var_value(v) for v in vs} - {None}
            if vals:
                anchored[root] = min(vals)
            else:
                free.append(root)
        if not free:
            return {}

        # urgency: tightest analytic slack of any task in the class
        timing = graph.with_slack()
        slack_of = {root: min(timing[v[1]].slack for v in classes[root])
                    for root in free}
        order = sorted(free, key=lambda r: (slack_of[r], r))

        # congestion state from everything already decided
        load: dict[str, float] = {}
        slot_load: dict[tuple[str, str], int] = {}
        placed: dict[tuple, str] = {}

        def loc(v: tuple) -> Optional[str]:
            """Current (bound or tentatively placed) host of ``v``."""
            val = var_value(v)
            if val is not None:
                return val
            root = find(v)
            host = placed.get(root)
            return host if host is not None else anchored.get(root)

        charged: set[str] = set()

        def charge_ready_flows(names) -> None:
            """Charge flows whose endpoints just became known to links."""
            for n in names:
                if n in charged or tasks[n].kind is not TaskKind.NETWORK:
                    continue
                s, d = loc(("s", n)), loc(("d", n))
                if s is None or d is None:
                    continue
                charged.add(n)
                for l in self._path_of(cluster, s, d):
                    load[l] = load.get(l, 0.0) + tasks[n].size

        for n, t in tasks.items():
            if t.kind is TaskKind.COMPUTE and t.host is not None:
                slot_load[(t.host, t.proc)] = \
                    slot_load.get((t.host, t.proc), 0) + 1
        charge_ready_flows(tasks)

        hosts = list(cluster.hosts)
        ranked: dict[tuple, list[str]] = {}
        for root in order:
            vs = classes[root]
            computes = [n for (k, n) in vs if k == "c"]
            flows = [(n, k) for (k, n) in vs if k != "c"]
            cands = [h for h in hosts
                     if all(cluster.hosts[h].procs.get(tasks[n].proc, 0)
                            >= 1 for n in computes)]
            if not cands:
                raise ValueError(
                    f"no host offers the processor pools needed by "
                    f"{sorted(computes)}")
            scored: list[tuple[float, str]] = []
            for h in cands:
                cost = 0.0
                for n, k in flows:
                    other = loc(("d", n)) if k == "s" else loc(("s", n))
                    if other is None:
                        continue     # charged when the other class lands
                    p = self._path_of(cluster, h, other) if k == "s" \
                        else self._path_of(cluster, other, h)
                    cost += max((load.get(l, 0.0) + tasks[n].size)
                                / cluster.bandwidth(l) for l in p)
                for n in computes:
                    t = tasks[n]
                    spare = cluster.hosts[h].procs.get(t.proc, 0) \
                        - slot_load.get((h, t.proc), 0)
                    if spare < 1:
                        cost += 1e6      # queuing on a busy pool
                scored.append((cost, h))
            scored.sort()
            ranked[root] = [h for _, h in scored]
            placed[root] = ranked[root][0]
            for n in computes:
                t = tasks[n]
                slot_load[(placed[root], t.proc)] = \
                    slot_load.get((placed[root], t.proc), 0) + 1
            charge_ready_flows([n for n, _ in flows])

        # -- what-if DES refinement (memoized via the scheduler cache) --
        if self.des_refine and scheduler is not None:
            best_ms = scheduler._best(
                graph.bind(self._assignment(classes, placed)),
                cluster, cache)[2]
            for root in order:
                for h in ranked[root][:self.max_candidates]:
                    if h == placed[root]:
                        continue
                    trial = dict(placed)
                    trial[root] = h
                    ms = scheduler._best(
                        graph.bind(self._assignment(classes, trial)),
                        cluster, cache)[2]
                    if ms < best_ms - 1e-9:
                        best_ms, placed = ms, trial
        return self._assignment(classes, placed)

    @staticmethod
    def _assignment(classes: dict, placed: dict) -> dict:
        """Express per-class host choices as a bind() assignment (one
        anchor per class is enough — bind() re-derives the same classes
        and propagates it)."""
        out: dict = {}
        flow_ends: dict[str, list] = {}
        for root, host in placed.items():
            vs = classes[root]
            anchor = next((v for v in vs if v[0] == "c"), vs[0])
            if anchor[0] == "c":
                out[anchor[1]] = host
            else:
                ends = flow_ends.setdefault(anchor[1], [None, None])
                ends[0 if anchor[0] == "s" else 1] = host
        for n, (src, dst) in flow_ends.items():
            out[n] = (src, dst)
        return out


class MXDAGScheduler:
    """Principle 1 (§4.1) — critical-path-first co-scheduling.

    1. Analytic forward/backward pass (contention-free) yields per-task
       slack; zero-slack tasks form the critical path.
    2. Flow & compute priorities: critical tasks get class 0; others are
       ordered by ascending slack within class 1 (a non-critical path is
       never allowed to pre-empt the critical path, but among themselves
       tighter paths go first — "without letting the non-critical paths
       have longer completion time than the critical path").
    3. Pipelining: greedily enable a pipelineable edge only if the
       simulated makespan shrinks (Fig. 3 cases 1–3 automated).
    4. Placement: a graph with logical (unbound) tasks is first placed on
       the cluster by the :class:`PlacementScheduler` stage — slack-guided
       greedy host selection that avoids oversubscribed uplinks, refined
       by memoized what-if DES runs — and the resulting assignment is
       recorded on the Schedule.
    5. Routing (``try_routing=True``, needs a fabric topology): each flow
       may be moved off its static ECMP path onto any member of the
       fabric's candidate set when the DES shows a strictly smaller
       makespan; chosen overrides land in ``Schedule.routes``.

    ``memoize`` caches DES results within one :meth:`schedule` call, keyed
    by (graph signature, policy, priorities, routes), so identical what-if
    queries are simulated once — the placement and routing stages share
    the same cache.  ``incremental_pipelining`` replaces the seed's
    fixpoint re-scan of every candidate edge after each accepted decision
    with a worklist that re-evaluates only candidates whose endpoints
    touch resources affected by that decision (a task whose simulated
    start/finish moved, or the accepted edge itself).  Both default on;
    benchmarks flip them off to measure the seed behaviour.

    ``analytic`` picks the substrate for the slack/critical-path passes:
    ``"array"`` runs them as compiled level-batched passes over
    :mod:`repro_torch.core.arrayanalytic`'s interned arrays — *the same
    compile the flat-array DES engine reuses* (``arraysim._compile``
    consumes its name table and adjacency), cached per graph version so
    a schedule() call compiles the graph once for analytics and DES
    together — with ``_priorities`` as an argsort-rank over the slack
    vector; ``"dict"`` is ``MXDAG.with_slack``/``critical_path``
    verbatim (the pre-compiled pipeline, retained as the differential
    oracle and benchmark "before"); ``"auto"`` (default) mirrors the
    DES engine threshold.  The two substrates are bit-equal, so the
    resulting Schedule is identical either way — pinned by the
    ``scale.schedule_*.ref_match`` CI rows and the arrayanalytic golden
    tests.

    On a fully-bound graph with ``try_routing`` off (the defaults), the
    decision pipeline and its outputs are bit-identical to the
    pre-placement scheduler.
    """

    def __init__(self, *, try_pipelining: bool = True,
                 slack_eps: float = 1e-9, memoize: bool = True,
                 incremental_pipelining: bool = True,
                 placement: "Optional[PlacementScheduler]" = None,
                 try_routing: bool = False, engine: str = "auto",
                 analytic: str = "auto",
                 workers: Optional[int] = None):
        self.try_pipelining = try_pipelining
        # workers > 1 lets _best evaluate its independent DES candidates
        # (the initial priority run and the fair floor) in forked worker
        # processes; the chosen Schedule is bit-identical to serial.
        self.workers = workers
        self.slack_eps = slack_eps
        self.memoize = memoize
        self.incremental_pipelining = incremental_pipelining
        self.placement = placement
        self.try_routing = try_routing
        # DES engine for every what-if run this scheduler issues.  The
        # default "auto" picks per graph: the flat-array engine's compile
        # (re-done per pipelining trial, since each trial is a graph
        # copy) and per-run setup only pay off from a few hundred tasks
        # up, while on small graphs the calendar core's constants win —
        # the two are differentially-tested equivalent, so the choice is
        # a pure time optimisation.
        if engine not in ("auto", "array", "calendar", "reference"):
            raise ValueError(f"unknown engine {engine}")
        self.engine = engine
        # analytic substrate for the forward/reverse slack passes and
        # the critical-path walk: "array" runs them as compiled
        # level-batched passes over repro_torch.core.arrayanalytic's interned
        # arrays (bit-equal to the dict implementation — the golden
        # tests assert ==), "dict" is MXDAG.with_slack/critical_path
        # verbatim (the pre-compiled-analytics decision pipeline, kept
        # as the benchmark "before" and differential oracle).  "auto"
        # mirrors the DES engine threshold.
        if analytic not in ("auto", "array", "dict"):
            raise ValueError(f"unknown analytic {analytic}")
        self.analytic = analytic

    def _engine_for(self, g: MXDAG) -> str:
        if self.engine != "auto":
            return self.engine
        return "array" if len(g.tasks) >= 256 else "calendar"

    def _use_array_analytic(self, g: MXDAG) -> bool:
        if self.analytic != "auto":
            return self.analytic == "array"
        return len(g.tasks) >= 256

    def _timing_view(self, g: MXDAG) -> tuple[list, list, list]:
        """(names, slack, latest_completion) per task — the only pieces
        of the forward/reverse analytic pass the decision pipeline
        consumes — from the compiled or the dict substrate (bit-equal
        by the arrayanalytic golden tests; name order may differ, which
        nothing downstream observes)."""
        if self._use_array_analytic(g):
            at = arrayanalytic.analyze(g)
            return at.names, at.slack, at.latest
        timing = g.with_slack()
        names = list(timing)
        return (names, [timing[n].slack for n in names],
                [timing[n].latest_completion for n in names])

    def _priorities(self, graph: MXDAG,
                    timing: Optional[dict] = None) -> dict[str, float]:
        """Principle-1 priority classes from per-task slack.

        ``timing`` may be a ``with_slack()`` dict or ``None`` (computed
        via the configured analytic substrate).  The compiled path is an
        argsort-rank over the slack vector; values are identical to the
        dict path because the rank map is the same sorted-unique-rounded
        table either way.
        """
        if timing is not None:
            names = list(timing)
            slack = [timing[n].slack for n in names]
        else:
            names, slack, _ = self._timing_view(graph)
        return self._priorities_from(names, slack)

    def _priorities_from(self, names: list, slack: list,
                         ) -> dict[str, float]:
        rounded = [round(s, 12) for s in slack]
        ranks = sorted(set(rounded))
        rank = {s: i for i, s in enumerate(ranks)}
        denom = max(len(ranks), 1)
        eps = self.slack_eps
        prio: dict[str, float] = {}
        for n, s, rs in zip(names, slack, rounded):
            if s <= eps:
                prio[n] = CRITICAL
            else:
                # rank-normalized slack keeps classes strictly above CRITICAL
                prio[n] = NONCRITICAL + rank[rs] / denom
        return prio

    @staticmethod
    def _sim_key(sig, policy: str, prio: dict[str, float],
                 routes: Optional[dict]):
        # prio key in dict-insertion order: every producer builds the
        # map in a deterministic per-graph order, so equal content ⇒
        # equal key in practice, and a differently-ordered duplicate
        # only costs a cache miss (re-simulating is always correct) —
        # while skipping the O(n log n) sort per memo lookup
        return (sig, policy, tuple(prio.items()),
                tuple(sorted(routes.items())) if routes else None)

    def _sim(self, g: MXDAG, cluster: Optional[Cluster],
             cache: Optional[dict], policy: str, prio: dict[str, float],
             routes: Optional[dict] = None, sig=None) -> SimResult:
        """One DES run, memoized by (graph signature, policy, priorities,
        route overrides) when a cache is supplied."""
        if cache is None:
            return simulate(g, cluster, policy=policy, priorities=prio,
                            routes=routes or None,
                            engine=self._engine_for(g))
        if sig is None:
            sig_ids = cache.setdefault("sig_ids", {})
            sig = sig_ids.setdefault(g.signature(), len(sig_ids))
        key = self._sim_key(sig, policy, prio, routes)
        res = cache.get(key)
        if res is None:
            res = simulate(g, cluster, policy=policy, priorities=prio,
                           routes=routes or None,
                           engine=self._engine_for(g))
            cache[key] = res
        return res

    def _best(self, g: MXDAG, cluster: Optional[Cluster],
              cache: Optional[dict] = None,
              routes: Optional[dict] = None,
              workers: Optional[int] = None,
              ) -> tuple[str, dict[str, float], float, SimResult]:
        """Principle 1 with its own caveat enforced.

        Strict slack-priority can delay a non-critical path *beyond its
        slack* under contention, which the principle forbids ("without
        letting the non-critical paths have longer completion time than the
        critical path").  So: start from strict priority, iteratively
        promote tasks that the DES shows finishing past their analytic
        latest-completion, and never return anything worse than plain fair
        sharing.  ``cache`` memoizes DES runs across _best calls;
        ``routes`` (per-flow path overrides) apply to every run.

        Compiled-analytic fast path: when every task lands in the
        CRITICAL class (a fully-critical DAG — e.g. any symmetric
        shuffle), the "priority" run is *provably identical* to the
        "fair" run — one priority class means one waterfill group, the
        same (priority, name) dispatch order, and replay never fires —
        so the fair guard reuses the priority result instead of paying
        a second DES run.  The candidate comparison (priority wins
        ties) is unchanged, so the Schedule is bit-identical; the dict
        substrate keeps the pre-PR two-run pipeline verbatim.
        """
        if cache is not None:
            # intern the graph signature: hash the (large) task/edge tuple
            # once per _best call, not once per memo lookup
            sig_ids = cache.setdefault("sig_ids", {})
            sig = sig_ids.setdefault(g.signature(), len(sig_ids))
        else:
            sig = None

        def sim(policy: str, prio: dict[str, float]) -> SimResult:
            """Memoized DES run of ``g`` under (policy, priorities)."""
            return self._sim(g, cluster, cache, policy, prio,
                             routes, sig=sig)

        names, slack, latest = self._timing_view(g)
        prio = self._priorities_from(names, slack)
        cands: list[tuple[str, dict[str, float], float, SimResult]] = []
        cur = dict(prio)
        # Speculative parallel start: the fair-floor run never depends
        # on the promote loop, so with workers>1 the first priority run
        # and the fair run evaluate in concurrent forked processes and
        # land in the memo cache; the loop below then hits the cache for
        # its first iteration and any later promotions stay serial (each
        # depends on the previous run's finish times).  Skipped when the
        # initial classes are all-critical — there the single-class
        # shortcut below makes the fair run free, and forking would
        # *add* a redundant DES.  Results are bit-identical to serial:
        # the same two (policy, priorities) runs feed the same argmin.
        if workers is None:
            workers = self.workers
        fair: Optional[SimResult] = None
        if effective_workers(workers) > 1 and cache is not None and not (
                cur and self._use_array_analytic(g)
                and all(v == CRITICAL for v in cur.values())):
            spec = [("priority", dict(cur)), ("fair", {})]
            out = trial_map(
                lambda i: self._sim(g, cluster, None, spec[i][0],
                                    spec[i][1], routes),
                range(len(spec)), workers, label="_best candidates")
            for (pol, pr), r in zip(spec, out):
                cache.setdefault(self._sim_key(sig, pol, pr, routes), r)
            fair = out[1]
        for _ in range(len(g.tasks)):
            res = sim("priority", cur)
            cands.append(("priority", dict(cur), res.makespan, res))
            finish = res.finish
            cget = cur.get
            late = [n for n, lc in zip(names, latest)
                    if cget(n, 0.0) > CRITICAL
                    and finish[n] > lc + 1e-9]
            if not late:
                break
            for n in late:
                cur[n] = CRITICAL
        if fair is None:
            if cur and self._use_array_analytic(g) \
                    and all(v == CRITICAL for v in cur.values()):
                fair = res               # single class ≡ fair (see above)
            else:
                fair = sim("fair", {})
        cands.append(("fair", {}, fair.makespan, fair))
        return min(cands, key=lambda c: (c[2], c[0] == "fair"))

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Run the full decision pipeline on ``graph``.

        Stages (each only when applicable): placement of logical tasks,
        slack-driven priority classes vs the fair floor, greedy
        pipelining (``try_pipelining``), ECMP rerouting
        (``try_routing``).

        :param graph: the MXDAG to schedule (may contain logical tasks).
        :param cluster: capacities/fabric; default derived from the
            graph (required when placement has choices to make).
        :returns: the winning Schedule with all decision kinds recorded
            (``meta`` carries the critical path and stage diagnostics).
        """
        # the pipeline only mutates the working graph when it flips
        # pipelining flags; without that stage every step is read-only
        # (bind() already copies), so the input graph is used as-is and
        # its version-keyed compiled caches (analytic arrays, DES
        # compile, resource maps) stay warm across repeated schedule()
        # calls — what-if sweeps re-schedule the same graph constantly
        g = graph.copy() if self.try_pipelining else graph
        cache: Optional[dict] = {} if self.memoize else None

        assignment: dict = {}
        if graph.unbound():
            if cluster is None:
                raise ValueError(
                    f"{graph.name} has logical (unbound) tasks; placing "
                    f"them needs an explicit cluster to choose hosts from")
            placer = self.placement or PlacementScheduler()
            assignment = placer.place(graph, cluster,
                                      scheduler=self, cache=cache)
            g = g.bind(assignment)

        if self.try_pipelining:
            # start from no pipelining: paper applies it only when it helps
            for (s, d) in list(g.edges):
                g.set_pipelined(s, d, False)

        policy, prio, best, best_res = self._best(g, cluster, cache)
        decisions: dict[tuple[str, str], bool] = {}

        if self.try_pipelining:
            candidates = sorted(
                ((e.src, e.dst) for e in graph.edges.values()
                 if graph.tasks[e.src].pipelineable
                 and graph.tasks[e.dst].pipelineable),
            )
            if self.incremental_pipelining:
                g, policy, prio, best, best_res = self._greedy_pipeline(
                    g, cluster, cache, candidates, decisions,
                    policy, prio, best, best_res)
            else:
                # seed fixpoint: full candidate re-scan after any accept
                improved = True
                while improved:
                    improved = False
                    for (s, d) in candidates:
                        if decisions.get((s, d)):
                            continue
                        trial = g.copy()
                        trial.set_pipelined(s, d, True)
                        tpolicy, tprio, tms, tres = self._best(
                            trial, cluster, cache)
                        if tms < best - 1e-9:
                            g, best, best_res = trial, tms, tres
                            policy, prio = tpolicy, tprio
                            decisions[(s, d)] = True
                            improved = True

        routes: dict[str, tuple[str, ...]] = {}
        if self.try_routing and cluster is not None \
                and cluster.topology is not None:
            routes, policy, prio, best, best_res = self._route_select(
                g, cluster, cache, policy, prio, best, best_res)

        cp = arrayanalytic.critical_path(g) \
            if self._use_array_analytic(g) else g.critical_path()
        return Schedule(graph=g, policy=policy, priorities=prio,
                        placement=assignment, routes=routes,
                        meta={"pipelined": sorted(k for k, v in
                                                  decisions.items() if v),
                              "critical_path": cp,
                              "predicted_makespan": best})

    def _route_select(self, g: MXDAG, cluster: Cluster,
                      cache: Optional[dict], policy: str,
                      prio: dict[str, float], best: float,
                      best_res: SimResult):
        """Greedy per-flow route selection over the fabric's candidate
        sets (most-urgent flows first).  A flow is moved off its static
        ECMP path only when the DES shows a strictly smaller makespan
        given all overrides accepted so far; a final :meth:`_best` pass
        re-settles priorities under the chosen routes.
        """
        topo = cluster.topology
        routes: dict[str, tuple[str, ...]] = {}
        order = sorted((t.name for t in g.network_tasks()),
                       key=lambda n: (prio.get(n, 0.0), n))
        for n in order:
            t = g.tasks[n]
            cands = topo.paths(t.src, t.dst)
            if len(cands) <= 1:
                continue
            cur = routes.get(n, topo.path(t.src, t.dst))
            chosen = None
            for p in cands:
                if p == cur:
                    continue
                res = self._sim(g, cluster, cache, policy, prio,
                                {**routes, n: p})
                if res.makespan < best - 1e-9:
                    best, chosen, chosen_res = res.makespan, p, res
            if chosen is not None:
                routes[n] = chosen
                best_res = chosen_res
        if routes:
            rpolicy, rprio, rbest, rres = self._best(
                g, cluster, cache, routes=routes)
            if rbest <= best + 1e-12:
                policy, prio, best, best_res = rpolicy, rprio, rbest, rres
        return routes, policy, prio, best, best_res

    def _greedy_pipeline(self, g: MXDAG, cluster: Optional[Cluster],
                         cache: Optional[dict],
                         candidates: list[tuple[str, str]],
                         decisions: dict[tuple[str, str], bool],
                         policy: str, prio: dict[str, float],
                         best: float, best_res: SimResult):
        """Worklist greedy: each candidate edge is evaluated once; an
        accepted decision re-enqueues only the rejected candidates whose
        endpoints touch a resource the decision affected (a task whose
        simulated start/finish moved, or the accepted edge's endpoints).

        This is a heuristic pruning of the seed's full fixpoint re-scan:
        a decision can in principle shift analytic slack (and thus _best
        priorities) for tasks whose simulated timing did not move, so a
        far-away rejected candidate could become profitable without being
        requeued.  Makespan monotonicity is unaffected (only improvements
        are ever accepted); pass ``incremental_pipelining=False`` for the
        seed's exhaustive behaviour.
        """
        res_of = {n: (cluster.resources_for(t) if cluster is not None
                      else t.resources())
                  for n, t in g.tasks.items()}
        queue = list(candidates)
        queued = set(candidates)
        rejected: list[tuple[str, str]] = []
        i = 0
        while i < len(queue):
            s, d = queue[i]
            i += 1
            queued.discard((s, d))
            if decisions.get((s, d)):
                continue
            trial = g.copy()
            trial.set_pipelined(s, d, True)
            tpolicy, tprio, tms, tres = self._best(trial, cluster, cache)
            if tms >= best - 1e-9:
                rejected.append((s, d))
                continue
            affected = set(res_of[s]) | set(res_of[d])
            for n in g.tasks:
                if (abs(best_res.start[n] - tres.start[n]) > 1e-9
                        or abs(best_res.finish[n] - tres.finish[n]) > 1e-9):
                    affected.update(res_of[n])
            g, best, best_res = trial, tms, tres
            policy, prio = tpolicy, tprio
            decisions[(s, d)] = True
            requeue = [c for c in rejected
                       if c not in queued and not decisions.get(c)
                       and (affected & set(res_of[c[0]])
                            or affected & set(res_of[c[1]]))]
            rejected = [c for c in rejected if c not in requeue]
            for c in sorted(requeue):
                queue.append(c)
                queued.add(c)
        return g, policy, prio, best, best_res


class AltruisticMultiScheduler:
    """Principle 2 (§4.2) — altruism across MXDAGs sharing a cluster.

    Each job's critical tasks keep class 0.  A job's non-critical task is
    demoted below *other* jobs' critical tasks only when its slack (from the
    isolated analytic pass) covers the foreign critical work queued on the
    same resource — this implements "delaying its non-critical path resource
    allocation ... without increasing its own end-to-end completion time".

    ``analytic`` picks the substrate, mirroring :class:`MXDAGScheduler`:
    ``"array"`` runs the per-job isolated slack passes as compiled
    level-batched passes over :mod:`repro_torch.core.arrayanalytic` (memoized
    per ``(job name, graph version)`` so a service loop re-admitting the
    same jobs reuses warm passes) and computes each foreign-critical-work
    sum once per ``(resource, excluded job)`` pair instead of once per
    ``(task, resource)`` pair; ``"dict"`` is the original
    ``with_slack`` pipeline verbatim, retained as the bit-exact oracle
    and benchmark "before"; ``"auto"`` (default) picks ``"array"`` from
    256 merged tasks up.  The two substrates produce identical priority
    maps: the per-job slack vectors are bit-equal (arrayanalytic golden
    tests) and the grouped demotion sums add the same floats in the
    same sequential order as the dict path's inner loop.
    """

    def __init__(self, *, try_pipelining: bool = False,
                 analytic: str = "auto"):
        """:param try_pipelining: forwarded to the per-job scheduler.
        :param analytic: ``"auto"`` | ``"array"`` | ``"dict"`` substrate
            for the per-job slack/critical passes and demotion sums.
        """
        self.try_pipelining = try_pipelining
        if analytic not in ("auto", "array", "dict"):
            raise ValueError(f"unknown analytic {analytic}")
        self.analytic = analytic
        # per-job isolated analytics keyed on (job name -> graph
        # version): the same version-keyed trick as MXDAGScheduler._best,
        # so repeated service-loop calls reuse warm passes.
        self._job_cache: dict[str, tuple] = {}
        # merged-graph (+ resource maps) keyed on the job set identity
        self._merged_cache: dict[tuple, tuple] = {}
        # per-job resource-map fragments (job name -> ((version, cluster
        # signature), resource map, task->resources)) the merged view
        # concatenates — jobs rarely change between service-loop calls
        self._res_cache: dict[str, tuple] = {}

    def _use_array(self, graphs: list[MXDAG]) -> bool:
        if self.analytic != "auto":
            return self.analytic == "array"
        return sum(len(g.tasks) for g in graphs) >= 256

    @staticmethod
    def _merge(graphs: list[MXDAG]) -> MXDAG:
        """Union the jobs into one graph, rejecting name collisions."""
        merged = MXDAG("+".join(g.name for g in graphs))
        owner: dict[str, str] = {}
        for g in graphs:
            for t in g:
                who = f"{g.name!r} (job {t.job!r})"
                if t.name in owner:
                    raise ValueError(
                        f"cross-job task name collision: {t.name!r} is "
                        f"defined by both {owner[t.name]} and {who}; "
                        f"task names must be unique across the jobs "
                        f"sharing a cluster (prefix them with the job "
                        f"name, as builders.mapreduce does)")
                owner[t.name] = who
                merged.add(t)
            for e in g.edges.values():
                merged.add_edge(e.src, e.dst, pipelined=e.pipelined)
        return merged

    def schedule(self, graphs: list[MXDAG],
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Schedule several jobs altruistically on one cluster.

        :param graphs: the jobs; task names must be globally unique.
        :param cluster: shared capacities; default derived from the
            merged graph.
        :returns: one Schedule over the merged graph whose priority
            classes interleave the jobs per Principle 2.
        """
        if self._use_array(graphs):
            return self._schedule_array(graphs, cluster)
        return self._schedule_dict(graphs, cluster)

    def _schedule_dict(self, graphs: list[MXDAG],
                       cluster: Optional[Cluster] = None) -> Schedule:
        """The original dict pipeline, verbatim — the differential
        oracle for the compiled path and the benchmark "before"."""
        merged = self._merge(graphs)

        # isolated analytics per job
        prio: dict[str, float] = {}
        slack: dict[str, float] = {}
        critical: dict[str, set[str]] = {}
        for g in graphs:
            timing = g.with_slack()
            crit = {n for n, tm in timing.items() if tm.slack <= 1e-9}
            critical[g.name] = crit
            for n, tm in timing.items():
                slack[n] = tm.slack
                prio[n] = CRITICAL if n in crit else NONCRITICAL

        # altruistic demotion, bounded by slack; fabric-aware when the
        # cluster has a Topology (contention on shared uplinks counts too)
        by_resource = merged.resource_map(cluster)
        res_of = {n: (cluster.resources_for(t) if cluster is not None
                      else t.resources())
                  for n, t in merged.tasks.items()}
        for g in graphs:
            others_crit = set().union(*(critical[o.name] for o in graphs
                                        if o.name != g.name)) \
                if len(graphs) > 1 else set()
            for n in g.tasks:
                if prio[n] != NONCRITICAL:
                    continue
                foreign = 0.0
                for r in res_of[n]:
                    foreign += sum(merged.tasks[m].size
                                   for m in by_resource[r]
                                   if m in others_crit)
                if foreign > 0 and slack[n] >= foreign - 1e-9:
                    prio[n] = ALTRUIST_DEMOTED
        return Schedule(graph=merged, policy="priority", priorities=prio,
                        meta={"critical": critical})

    def _job_analytics(self, g: MXDAG) -> tuple[dict[str, float],
                                                set[str]]:
        """Memoized per-job isolated (slack map, critical set) from the
        compiled analytic pass, keyed on the job's graph version."""
        cached = self._job_cache.get(g.name)
        if cached is not None and cached[0] == g._version:
            return cached[1], cached[2]
        at = arrayanalytic.analyze(g)
        slack = dict(zip(at.names, at.slack))
        crit = {n for n, s in slack.items() if s <= 1e-9}
        self._job_cache[g.name] = (g._version, slack, crit)
        return slack, crit

    def _merged_view(self, graphs: list[MXDAG],
                     cluster: Optional[Cluster]) -> tuple:
        """Memoized (merged graph, resource→tasks map, task→resources
        map) keyed on the job-set identity and the cluster."""
        sig = cluster.signature() if cluster is not None else None
        key = (tuple((g.name, g._version) for g in graphs), sig)
        cached = self._merged_cache.get(key)
        if cached is not None:
            return cached
        # bulk union (no per-edge cycle walk — see MXDAG.union) plus
        # per-job memoized resource maps concatenated in job order:
        # merged.resource_map iterates tasks in insertion order, which
        # is exactly job order then within-job insertion order, so the
        # concatenation reproduces its lists element for element (the
        # demotion sums below depend on that order for bit-exactness
        # against the dict oracle).
        merged = MXDAG.union(graphs)
        by_resource: dict[str, list[str]] = {}
        res_of: dict[str, tuple] = {}
        for g in graphs:
            rmap, jres = self._job_resources(g, cluster, sig)
            for r, ns in rmap.items():
                lst = by_resource.get(r)
                if lst is None:
                    by_resource[r] = list(ns)
                else:
                    lst.extend(ns)
            res_of.update(jres)
        if len(self._merged_cache) >= 64:     # service loops churn keys
            self._merged_cache.clear()
        self._merged_cache[key] = (merged, by_resource, res_of)
        return merged, by_resource, res_of

    def _job_resources(self, g: MXDAG, cluster: Optional[Cluster],
                       sig) -> tuple:
        """Memoized per-job (resource map, task→resources) fragments,
        keyed on the job's graph version and the cluster signature."""
        cached = self._res_cache.get(g.name)
        if cached is not None and cached[0] == (g._version, sig):
            return cached[1], cached[2]
        rmap = g.resource_map(cluster)
        jres = {n: (cluster.resources_for(t) if cluster is not None
                    else t.resources())
                for n, t in g.tasks.items()}
        self._res_cache[g.name] = ((g._version, sig), rmap, jres)
        return rmap, jres

    def _schedule_array(self, graphs: list[MXDAG],
                        cluster: Optional[Cluster] = None) -> Schedule:
        """The compiled pipeline: per-job passes over the interned
        arrays, demotion sums grouped per (resource, excluded job).

        Bit-exact vs :meth:`_schedule_dict`: each grouped sum walks the
        same ``by_resource[r]`` slice in the same order the dict path's
        inner ``sum()`` does — filtering on "critical and foreign" picks
        the identical float subsequence, so Python's strictly sequential
        ``sum`` yields the identical value; it is merely computed once
        per (resource, job) instead of once per (task, resource).
        """
        merged, by_resource, res_of = self._merged_view(graphs, cluster)

        prio: dict[str, float] = {}
        slack: dict[str, float] = {}
        critical: dict[str, set[str]] = {}
        for g in graphs:
            jslack, crit = self._job_analytics(g)
            critical[g.name] = crit
            for n, s in jslack.items():
                slack[n] = s
                prio[n] = CRITICAL if n in crit else NONCRITICAL

        # crit sets are disjoint (names are globally unique), so
        # "critical for some OTHER job" ≡ "critical and not mine"
        all_crit = set()
        for c in critical.values():
            all_crit |= c
        tasks = merged.tasks
        foreign_of: dict[tuple[str, str], float] = {}
        for g in graphs:
            if len(graphs) > 1:
                own = critical[g.name]
                others_crit = {m for m in all_crit if m not in own}
            else:
                others_crit = set()
            jname = g.name
            for n in g.tasks:
                if prio[n] != NONCRITICAL:
                    continue
                foreign = 0.0
                for r in res_of[n]:
                    fr = foreign_of.get((r, jname))
                    if fr is None:
                        fr = sum(tasks[m].size for m in by_resource[r]
                                 if m in others_crit)
                        foreign_of[(r, jname)] = fr
                    foreign += fr
                if foreign > 0 and slack[n] >= foreign - 1e-9:
                    prio[n] = ALTRUIST_DEMOTED
        return Schedule(graph=merged, policy="priority", priorities=prio,
                        meta={"critical": critical})
