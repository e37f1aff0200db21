"""Fabric-aware scheduler baselines: the abstractions MXDAG subsumes (§2).

The paper's headline claim is not "MXDAG beats fair sharing" — it is that
*neither of the two dominant abstractions* can reach the co-scheduled
optimum: the Coflow abstraction sees flows but not the compute DAG behind
them (§2.2), and compute-only DAG scheduling sees the DAG but leaves the
network to fair sharing (§2.1).  This module implements competitive,
fabric-aware schedulers from both families so the comparison can be run
numerically (``benchmarks/bakeoff.py``):

- :class:`SEBFScheduler` — Varys-style Smallest-Effective-Bottleneck-First
  coflow ordering.  Coflows are ordered by their effective bottleneck
  Γ(C) = max over links of (bytes C places on the link / link capacity),
  computed over each flow's *full fabric path* (oversubscribed uplinks
  count), and strict-priority classes serialize the coflows on shared
  links.  DAG-blind: a tiny coflow feeding the job's longest compute chain
  gets no special treatment.

- :class:`DependencyCoflowScheduler` — the dependency-graph coflow
  scheduling of Shafiee & Ghaderi ("Scheduling Coflows with Dependency
  Graph"): the coflow groups are contracted into a coflow-level precedence
  DAG (A → B iff data flows from a member of A to a member of B through
  compute-only intermediaries) and ordered by a precedence-respecting
  greedy — among coflows whose predecessors are all ordered, smallest
  effective bottleneck first.  Sees coflow *dependencies*, still not
  compute durations.

- :class:`GrapheneScheduler` — a Graphene/DAGPS-style "do the hard stuff
  first" packer over the *compute* tasks: each compute task's priority is
  its analytic bottom level (longest remaining work to a sink, flows
  counted at nominal NIC rate), longest first, driving the non-preemptive
  slot dispatch.  Network-oblivious: flows carry no priorities, so every
  link fair-shares — exactly the compute-only-DAG half of Fig. 1(b).

- :class:`MetaflowScheduler` — Metaflow-style network-DAG scheduling
  (Fei et al.): flows are priority-ordered by their depth in the
  flow-level DAG (stage-0 flows first — upstream flows unblock the most
  downstream work), compute unmanaged.  Network-DAG-aware but blind to
  compute durations: it cannot tell which stage-0 flow feeds the long
  reduce.

Every baseline expresses its *entire* decision through the existing
:class:`~repro_torch.core.schedule.Schedule` abstraction — per-task priority
classes plus coflow groupings; placement and routes stay default.  That
was the point of building them: the bake-off stress-tests whether the
Schedule decision catalogue spans the published competitors.  It does,
with one refactor the exercise forced (documented as it happened):
coflow-*ordering* baselines need every flow covered by the ordering, so
:func:`~repro_torch.core.schedule.auto_coflows` grew a ``singletons=`` switch —
a flow outside every group would otherwise default to priority class 0.0
and silently preempt the entire ordering.  Ordering itself (SEBF ranks,
precedence-respecting list order, bottom-level ranks, depth ranks) maps
onto priority classes, and group coupling onto ``Schedule.coflows``
(synchronized start + MADD rates + all-or-nothing gating, the §2.2
semantics), so no new decision kind was needed.

All baselines are deterministic: ties break on sorted member names, so a
baseline's Schedule — like the co-scheduler's — is a pure function of
(graph, cluster).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.cluster import Cluster
from repro_torch.core.graph import MXDAG
from repro_torch.core.schedule import FairShareScheduler, Schedule, auto_coflows
from repro_torch.core.task import TaskKind


def _cluster_for(graph: MXDAG, cluster: Optional[Cluster]) -> Cluster:
    """``cluster`` or the graph's cached default, exactly as the
    Simulator resolves it — so a baseline's bottleneck analysis and the
    subsequent :meth:`Schedule.simulate` see the same capacities."""
    if cluster is not None:
        return cluster
    cached = graph.__dict__.get("_default_cluster")
    if cached is not None and cached[0] == graph._version:
        return cached[1]
    cluster = Cluster.for_graph(graph)
    graph._default_cluster = (graph._version, cluster)
    return cluster


def effective_bottleneck(group, graph: MXDAG, cluster: Cluster) -> float:
    """Varys' Γ: the time ``group`` needs on its most contended link.

    ``max`` over every resource any member flow occupies of (total bytes
    the group places on it) / capacity.  Fabric-aware: with a Topology,
    a flow charges every link on its static route, so an oversubscribed
    rack uplink carrying the whole group dominates the endpoint NICs.

    :param group: iterable of flow names forming one coflow.
    :param graph: the MXDAG owning the flows.
    :param cluster: capacities + (optional) fabric the flows run on.
    :returns: Γ in seconds; ``0.0`` for an empty group.
    """
    load: dict[str, float] = {}
    for n in group:
        t = graph.tasks[n]
        for link in cluster.resources_for(t):
            load[link] = load.get(link, 0.0) + t.size
    return max((v / cluster.bandwidth(link) for link, v in load.items()),
               default=0.0)


def coflow_dag(graph: MXDAG, groups: list[set[str]]) -> list[set[int]]:
    """Contract the task DAG into coflow-level precedence.

    Group A precedes group B iff a directed path runs from a member of A
    to a member of B passing through no other group's member — the
    "dependency graph" of Shafiee & Ghaderi, where each stage's coflow
    must finish before the next stage's can start.

    :param graph: the task-level MXDAG.
    :param groups: disjoint flow groups (every flow in at most one).
    :returns: per-group predecessor index sets, aligned with ``groups``.
    """
    gid: dict[str, int] = {}
    for i, grp in enumerate(groups):
        for n in grp:
            gid[n] = i
    preds: list[set[int]] = [set() for _ in groups]
    # nearest upstream groups per task, propagated in topo order
    up: dict[str, frozenset[int]] = {}
    for n in graph.topo_order():
        acc: set[int] = set()
        for p in graph.preds(n):
            acc |= up[p]
        i = gid.get(n)
        if i is None:
            up[n] = frozenset(acc)
        else:
            preds[i] |= acc - {i}
            up[n] = frozenset((i,))
    return preds


def flow_depth(graph: MXDAG) -> dict[str, int]:
    """Per-flow depth in the flow-level DAG (Metaflow's network DAG).

    A flow's depth is the largest number of flows on any path from a DAG
    source up to and including itself, minus one — stage-0 flows are
    depth 0, the flows they (transitively) feed are depth 1, and so on.
    Compute tasks are transparent: they relay depth without adding to it.

    :param graph: the task-level MXDAG.
    :returns: name → depth for every network task.
    """
    depth: dict[str, int] = {}
    out: dict[str, int] = {}
    for n in graph.topo_order():
        d = max((depth[p] for p in graph.preds(n)), default=0)
        if graph.tasks[n].kind is TaskKind.NETWORK:
            out[n] = d
            d += 1
        depth[n] = d
    return out


def _group_key(group: set[str]) -> tuple[str, ...]:
    """Deterministic identity of a flow group (sorted member names)."""
    return tuple(sorted(group))


def _coflow_priorities(groups: list[set[str]], order: list[int],
                       ) -> dict[str, float]:
    """Priority classes from a coflow ordering: the i-th scheduled
    group's members all land in class ``float(i)``."""
    prio: dict[str, float] = {}
    for rank, gi in enumerate(order):
        for n in groups[gi]:
            prio[n] = float(rank)
    return prio


class SEBFScheduler:
    """Varys-style Smallest-Effective-Bottleneck-First coflow ordering.

    Flows are grouped into coflows (caller-supplied, or the conventional
    stage grouping of :func:`~repro_torch.core.schedule.auto_coflows` with
    singleton coverage), each group's effective bottleneck Γ is computed
    over full fabric paths, and groups are ordered ascending Γ (ties:
    lexicographic member names).  The ordering becomes strict priority
    classes; groups of ≥2 flows additionally run under the §2.2 coflow
    semantics (synchronized start, MADD rates, all-or-nothing gating).
    DAG precedence between coflows is deliberately ignored — that is the
    abstraction's blind spot the bake-off measures.
    """

    def __init__(self, *, coflows: Optional[list[set[str]]] = None):
        """:param coflows: explicit flow grouping; default derives the
        conventional stage grouping (plus singletons) from the DAG."""
        self.coflows = coflows

    def _groups(self, graph: MXDAG) -> list[set[str]]:
        """The flow grouping this scheduler orders (see ``__init__``)."""
        if self.coflows is not None:
            return [set(c) for c in self.coflows]
        return auto_coflows(graph, singletons=True)

    def _order(self, graph: MXDAG,
               cluster: Cluster) -> tuple[list[set[str]], list[int]]:
        """(groups, scheduling order): ascending Γ, name tie-break."""
        groups = self._groups(graph)
        gamma = [effective_bottleneck(grp, graph, cluster)
                 for grp in groups]
        order = sorted(range(len(groups)),
                       key=lambda i: (gamma[i], _group_key(groups[i])))
        return groups, order

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Order the graph's coflows by Γ and emit the Schedule.

        :param graph: a fully-bound MXDAG (baselines do not place tasks).
        :param cluster: capacities/fabric; default derived from the graph.
        :returns: a ``policy="priority"`` Schedule whose classes encode
            the SEBF order and whose ``coflows`` carry the ≥2 groups.
        """
        cl = _cluster_for(graph, cluster)
        groups, order = self._order(graph, cl)
        prio = _coflow_priorities(groups, order)
        multi = [groups[i] for i in order if len(groups[i]) >= 2]
        return Schedule(graph=graph, policy="priority", priorities=prio,
                        coflows=multi or None,
                        meta={"algorithm": "sebf",
                              "order": [_group_key(groups[i])
                                        for i in order]})


class DependencyCoflowScheduler(SEBFScheduler):
    """Shafiee & Ghaderi dependency-graph coflow scheduling.

    Same grouping and bottleneck metric as :class:`SEBFScheduler`, but
    the order respects the coflow-level precedence DAG: a group becomes
    eligible only once every predecessor group is ordered, and among
    eligible groups the smallest Γ goes next — the natural greedy member
    of the ordering-based algorithm family their paper analyses.  Still
    blind to compute durations: precedence says *which* coflows wait,
    not which feed the long compute chain.
    """

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Order coflows by precedence-respecting smallest-Γ-first.

        :param graph: a fully-bound MXDAG.
        :param cluster: capacities/fabric; default derived from the graph.
        :returns: a ``policy="priority"`` Schedule (see
            :meth:`SEBFScheduler.schedule`); ``meta["coflow_dag"]`` maps
            each group to its predecessor groups.
        """
        cl = _cluster_for(graph, cluster)
        groups = self._groups(graph)
        gamma = [effective_bottleneck(grp, graph, cl) for grp in groups]
        preds = coflow_dag(graph, groups)
        remaining = set(range(len(groups)))
        done: set[int] = set()
        order: list[int] = []
        while remaining:
            ready = [i for i in remaining if preds[i] <= done]
            # a cycle is impossible (the task DAG is acyclic and the
            # contraction preserves reachability), so ready is never empty
            nxt = min(ready, key=lambda i: (gamma[i],
                                            _group_key(groups[i])))
            order.append(nxt)
            remaining.discard(nxt)
            done.add(nxt)
        prio = _coflow_priorities(groups, order)
        multi = [groups[i] for i in order if len(groups[i]) >= 2]
        return Schedule(graph=graph, policy="priority", priorities=prio,
                        coflows=multi or None,
                        meta={"algorithm": "sg_coflow",
                              "order": [_group_key(groups[i])
                                        for i in order],
                              "coflow_dag": {
                                  _group_key(groups[i]): sorted(
                                      _group_key(groups[p])
                                      for p in preds[i])
                                  for i in range(len(groups))}})


class GrapheneScheduler:
    """Graphene/DAGPS-style "do the hard stuff first" compute packer.

    Each compute task is scored by its bottom level — the longest
    remaining-work path from the task to a sink under the analytic
    (contention-free) calculus, flows counted at nominal rate 1.0 — and
    compute priority classes rank descending bottom level, so the tasks
    heading the longest chains claim contended processor slots first.
    Flows carry **no** priorities: the network fair-shares, which is the
    compute-only-DAG abstraction's defining blind spot (Fig. 1(b)) —
    on an oversubscribed core this baseline collapses to fair sharing
    no matter how well it packs the computes.
    """

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Rank compute tasks by descending bottom level.

        :param graph: a fully-bound MXDAG.
        :param cluster: accepted for interface symmetry; the packer is
            network-oblivious, so only slot pools would matter and those
            are per-host either way.
        :returns: a ``policy="priority"`` Schedule with classes on
            compute tasks only (flows fair-share in the implicit class).
        """
        del cluster          # network-oblivious by construction
        down: dict[str, float] = {}
        for n in reversed(graph.topo_order()):
            t = graph.tasks[n]
            down[n] = t.time(1.0) + max((down[s] for s in graph.succs(n)),
                                        default=0.0)
        levels = sorted({round(down[t.name], 12)
                         for t in graph.compute_tasks()}, reverse=True)
        rank = {v: i for i, v in enumerate(levels)}
        prio = {t.name: float(rank[round(down[t.name], 12)])
                for t in graph.compute_tasks()}
        return Schedule(graph=graph, policy="priority", priorities=prio,
                        meta={"algorithm": "graphene",
                              "bottom_level": down})


class MetaflowScheduler:
    """Metaflow-style network-DAG scheduling: depth-ordered flows.

    The network abstraction is the DAG *of flows*: each flow's priority
    class is its depth in that DAG (stage-0 flows first — an upstream
    flow gates strictly more downstream work than the flows it feeds).
    Compute is unmanaged — and because the flow DAG carries no compute
    durations, two same-depth flows are indistinguishable even when one
    feeds an 8-second reduce and the other a 1-second one.  That gap is
    exactly what MXDAG's slack-driven classes close.
    """

    def schedule(self, graph: MXDAG,
                 cluster: Optional[Cluster] = None) -> Schedule:
        """Assign each flow its network-DAG depth as its class.

        :param graph: a fully-bound MXDAG.
        :param cluster: accepted for interface symmetry; depth is a pure
            graph property.
        :returns: a ``policy="priority"`` Schedule with classes on
            network tasks only (compute dispatch stays name-ordered).
        """
        del cluster          # depth is topology-independent
        prio = {n: float(d) for n, d in flow_depth(graph).items()}
        return Schedule(graph=graph, policy="priority", priorities=prio,
                        meta={"algorithm": "metaflow"})


#: name → zero-arg factory for every baseline the bake-off sweeps;
#: "fair" is the Fig. 1(b) dependency-driven fair-sharing floor.
BASELINES = {
    "fair": FairShareScheduler,
    "sebf": SEBFScheduler,
    "sg_coflow": DependencyCoflowScheduler,
    "graphene": GrapheneScheduler,
    "metaflow": MetaflowScheduler,
}
