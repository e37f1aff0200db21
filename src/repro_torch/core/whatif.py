"""What-if analysis on MXDAGs (paper §4.3).

MXDAG's explicit network tasks make questions answerable that a traditional
DAG cannot express: *would pipelining these two tasks help?*, *what unit
(chunk) size is best?*, *what if we re-partition work between compute and
network?* — and, with placement and routing as first-class decisions,
*what if this task ran on another host?* (:meth:`WhatIf.move_task`) and
*what if this flow took another path through the fabric?*
(:meth:`WhatIf.reroute_flow`).  Each query re-evaluates the scheduled DAG
in the DES.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from repro_torch.core.cluster import Cluster
from repro_torch.core.graph import MXDAG
from repro_torch.core.parallel import trial_map
from repro_torch.core.schedule import MXDAGScheduler
from repro_torch.core.task import MXTask, TaskKind


def follow_moves(g: MXDAG, task: str, host: str) -> dict[str, str]:
    """Which flow endpoints follow when compute ``task`` moves to ``host``.

    Placement is DAG-derived: a flow the task *produces* moves its source
    with it, a flow it *consumes* moves its destination — unless the flow
    is shared with other compute producers/consumers that stay behind, in
    which case its endpoint stays where their data is.  Returns
    ``{flow_name: "src" | "dst"}`` for every flow whose named endpoint
    should become ``host``.  Shared by :meth:`WhatIf.move_task` (offline
    what-if) and the nemesis replan controller (live recovery), so the
    two layers cannot disagree about what a move means.
    """
    moves: dict[str, str] = {}
    for s in g.succs(task):
        ts = g.tasks[s]
        if ts.kind is TaskKind.NETWORK and all(
                g.tasks[p].kind is not TaskKind.COMPUTE or p == task
                for p in g.preds(s)):
            moves[s] = "src"
    for p in g.preds(task):
        tp = g.tasks[p]
        if tp.kind is TaskKind.NETWORK and all(
                g.tasks[s].kind is not TaskKind.COMPUTE or s == task
                for s in g.succs(p)):
            moves[p] = "dst"
    return moves


@dataclasses.dataclass
class WhatIfResult:
    """Baseline vs variant makespan of one what-if query."""

    baseline: float
    variant: float

    @property
    def speedup(self) -> float:
        """baseline/variant; a zero-makespan variant is "infinitely
        faster" only if the baseline was actually slower — two equal
        (including both-zero) makespans are a 1.0, not an inf."""
        if self.variant > 0:
            return self.baseline / self.variant
        return 1.0 if self.variant == self.baseline else float("inf")

    @property
    def helps(self) -> bool:
        """Whether the variant is strictly faster (beyond EPS)."""
        return self.variant < self.baseline - 1e-9


class WhatIf:
    """What-if query engine with a shared result cache.

    The baseline is scheduled+simulated once per WhatIf instance, not once
    per query — a sweep of k variants costs k evaluations instead of 2k.
    Variant results are also memoized by (graph signature, cluster
    signature), so repeated or overlapping sweeps re-use earlier answers.
    """

    def __init__(self, graph: MXDAG, cluster: Optional[Cluster] = None,
                 scheduler: Optional[MXDAGScheduler] = None):
        self.graph = graph
        self.cluster = cluster
        self.scheduler = scheduler or MXDAGScheduler(try_pipelining=False)
        self._cache: dict = {}

    @staticmethod
    def _cluster_key(cl: Optional[Cluster]):
        return None if cl is None else cl.signature()

    def _makespan(self, g: MXDAG, cluster: Optional[Cluster] = None,
                  routes: Optional[Mapping[str, tuple[str, ...]]] = None,
                  ) -> float:
        cl = cluster if cluster is not None else self.cluster
        base_key = (g.signature(), self._cluster_key(cl))
        key = (base_key,
               tuple(sorted(routes.items())) if routes else None)
        ms = self._cache.get(key)
        if ms is None:
            # the Schedule is independent of the routes argument: cache
            # it on its own key so a route sweep pays one schedule() and
            # one DES run per candidate, not one full pipeline each
            sched = self._cache.get(("sched", base_key))
            if sched is None:
                sched = self.scheduler.schedule(g, cl)
                self._cache[("sched", base_key)] = sched
            ms = sched.simulate(cl, routes=dict(routes or {})).makespan
            self._cache[key] = ms
        return ms

    def baseline(self) -> float:
        """The unmodified graph's makespan (cached)."""
        return self._makespan(self.graph)

    # ------------------------------------------------------------------
    def pipeline_edges(self, edges: Sequence[tuple[str, str]]) -> WhatIfResult:
        """Would streaming these edges shrink the makespan? (Fig. 3)"""
        g = self.graph.copy()
        for s, d in edges:
            g.set_pipelined(s, d, True)
        return WhatIfResult(self.baseline(), self._makespan(g))

    def _sweep(self, graphs: Sequence[MXDAG], workers: Optional[int],
               label: str) -> list[float]:
        """Evaluate variant graphs, optionally across worker processes.

        The baseline is evaluated first so forked workers inherit the
        warm schedule/compile caches copy-on-write.  Trials are
        dispatched by index and collected in index order, so the result
        list is bit-identical to the serial sweep no matter which worker
        finishes first; the parent cache is backfilled afterwards so
        later queries reuse the sweep even though each child's own cache
        dies with it.
        """
        self.baseline()
        vals = trial_map(lambda i: self._makespan(graphs[i]),
                         range(len(graphs)), workers, label=label)
        ck = self._cluster_key(self.cluster)
        for g, ms in zip(graphs, vals):
            self._cache[((g.signature(), ck), None)] = ms
        return vals

    def _unit_graph(self, task: str, unit: Optional[float]) -> MXDAG:
        g = self.graph.copy()
        t = g.tasks[task]
        if unit is not None and t.size > 0:
            unit = min(unit, t.size)
        g.replace_task(dataclasses.replace(t, unit=unit))
        return g

    def set_unit(self, task: str, unit: Optional[float]) -> WhatIfResult:
        """Change a task's pipeline unit (chunk) size.

        A candidate unit above the task's size is clamped to the size
        (``unit == size`` ⇒ not pipelineable), exactly as
        :meth:`repartition` clamps a surviving unit when shrinking a
        task — a sweep crossing the task size answers "what if the
        chunking were coarser" instead of crashing mid-sweep on
        MXTask's ``unit <= size`` validation.
        """
        g = self._unit_graph(task, unit)    # validate before simulating
        return WhatIfResult(self.baseline(), self._makespan(g))

    def sweep_unit(self, task: str, units: Sequence[float],
                   workers: Optional[int] = None,
                   ) -> list[tuple[float, float]]:
        """Makespan as a function of the unit size — pick the knee.

        ``workers`` > 1 fans the trials across forked processes (one
        schedule+DES per unit); the returned list is bit-identical to
        the serial sweep.
        """
        units = list(units)
        vals = self._sweep([self._unit_graph(task, u) for u in units],
                           workers, f"sweep_unit({task})")
        return list(zip(units, vals))

    def resize_fabric(self, scale: Optional[float] = None, *,
                      links: Optional[Mapping[str, float]] = None,
                      ) -> WhatIfResult:
        """Would changing fabric link capacities change the makespan?

        ``scale`` multiplies every fabric (non-NIC) link — e.g. ``scale=4``
        undoes a 4:1 oversubscribed core; ``links`` sets individual link
        capacities (NICs included) by name.  The answerable question a
        big-switch model cannot even pose: *is this job actually
        core-bound, and how much fabric would it take to stop being so?*
        """
        if self.cluster is None or self.cluster.topology is None:
            raise ValueError("resize_fabric needs a cluster with a "
                             "fabric Topology")
        topo = self.cluster.topology.resized(scale, links=links)
        return WhatIfResult(self.baseline(),
                            self._makespan(self.graph,
                                           self.cluster.with_topology(topo)))

    def move_task(self, task: str, host: str) -> WhatIfResult:
        """Would running ``task`` on ``host`` change the makespan?

        Placement is DAG-derived: moving a compute task moves the flows
        it produces (their source) and the flows it consumes (their
        destination) with it — the answerable question of a scheduler
        where placement is a decision, not a frozen input.  A flow shared
        with *other* compute producers/consumers keeps its endpoint (its
        data still lands where the tasks that stay behind are).
        """
        g = self._move_graph(task, host)    # validate before simulating
        return WhatIfResult(self.baseline(), self._makespan(g))

    def _move_graph(self, task: str, host: str) -> MXDAG:
        g = self.graph.copy()
        t = g.tasks[task]
        if t.kind is not TaskKind.COMPUTE:
            raise ValueError(f"{task}: move_task re-places compute tasks "
                             f"(use reroute_flow for network tasks)")
        if self.cluster is not None:
            h = self.cluster.hosts.get(host)
            if h is None:
                raise KeyError(f"unknown host {host!r}")
            if h.procs.get(t.proc, 0) < 1:
                raise ValueError(f"host {host!r} has no {t.proc!r} pool "
                                 f"for {task}")
        g.replace_task(dataclasses.replace(t, host=host))
        for fname, side in follow_moves(g, task, host).items():
            g.replace_task(dataclasses.replace(g.tasks[fname],
                                               **{side: host}))
        return g

    def sweep_moves(self, task: str, hosts: Sequence[str],
                    workers: Optional[int] = None,
                    ) -> list[tuple[str, float]]:
        """Makespan of running ``task`` on each candidate host.

        Validation (unknown host, missing proc pool) happens up front in
        the parent, so a bad candidate raises before any worker forks.
        """
        hosts = list(hosts)
        vals = self._sweep([self._move_graph(task, h) for h in hosts],
                           workers, f"sweep_moves({task})")
        return list(zip(hosts, vals))

    def sweep_routes(self, flow: str,
                     routes: Optional[Sequence[Sequence[str]]] = None,
                     workers: Optional[int] = None,
                     ) -> list[tuple[tuple[str, ...], float]]:
        """Makespan of sending ``flow`` over each candidate route.

        ``routes`` defaults to the fabric's candidate paths for the
        flow's endpoints.  The Schedule is shared across the sweep (a
        route override changes only the DES), so each trial is one
        simulation; ``workers`` fans those across processes.
        """
        t = self.graph.tasks[flow]
        if t.kind is not TaskKind.NETWORK:
            raise ValueError(f"{flow}: only network tasks are routed")
        if routes is None:
            if self.cluster is None:
                raise ValueError("sweep_routes needs explicit routes or a "
                                 "cluster with a fabric Topology")
            routes = self.cluster.candidate_routes(t)
        cands = [tuple(r) for r in routes]
        self.baseline()
        vals = trial_map(
            lambda i: self._makespan(self.graph, routes={flow: cands[i]}),
            range(len(cands)), workers, label=f"sweep_routes({flow})")
        base_key = (self.graph.signature(),
                    self._cluster_key(self.cluster))
        for r, ms in zip(cands, vals):
            self._cache[(base_key, ((flow, r),))] = ms
        return list(zip(cands, vals))

    def reroute_flow(self, flow: str,
                     route: Sequence[str]) -> WhatIfResult:
        """Would sending ``flow`` over ``route`` (one of the fabric's
        candidate paths — see :meth:`Cluster.candidate_routes`) change
        the makespan?"""
        t = self.graph.tasks[flow]
        if t.kind is not TaskKind.NETWORK:
            raise ValueError(f"{flow}: only network tasks are routed")
        return WhatIfResult(
            self.baseline(),
            self._makespan(self.graph, routes={flow: tuple(route)}))

    def repartition(self, changes: dict[str, float]) -> WhatIfResult:
        """Re-size tasks (e.g. move work between compute and network)."""
        g = self.graph.copy()
        for name, size in changes.items():
            t = g.tasks[name]
            unit = t.unit if (t.unit is None or t.unit <= size) else size
            g.replace_task(dataclasses.replace(t, size=size, unit=unit))
        return WhatIfResult(self.baseline(), self._makespan(g))
