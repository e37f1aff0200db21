"""MXDAG: directed acyclic graph of MXTasks (paper §3.1–§3.2).

Implements:

- the graph itself (explicit compute *and* network nodes, dummy start/end),
- edge-level pipelineability (an edge may stream units instead of barriers),
- the path-length calculus of §3.2:
    Eq.(1)  Len(P_seq)  = Σ Size(v_i)/Rsrc(v_i)
    Eq.(2)  Len(P_pipe) = Σ Unit(v_i)/Rsrc(v_i) + max_i Size(v_i)/Rsrc(v_i)
                          − max_i Unit(v_i)/Rsrc(v_i)
- a contention-free analytic evaluator (earliest first-unit-out / completion
  recursion) that is exact for deterministic pipelines with unbounded
  buffers and reduces to Eq.(1)/(2) on chains,
- critical-path extraction and per-task slack (drives Principle 1/2),
- copath detection (groups of paths sharing head and tail; §3.2).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterable, Iterator, Optional

from repro_torch.core.task import MXTask, TaskKind

START = "__start__"
END = "__end__"


@dataclasses.dataclass(frozen=True)
class Edge:
    """A precedence (optionally streaming) edge between two tasks."""

    src: str
    dst: str
    pipelined: bool = False  # stream units across this edge when both ends allow


@dataclasses.dataclass
class NodeTiming:
    """Analytic timing for one task under a given resource assignment."""
    ready: float        # earliest time the first unit of input is available
    first_out: float    # earliest time the first output unit is emitted
    completion: float   # earliest completion of the whole task
    latest_completion: float = float("inf")  # from reverse pass (slack calc)

    @property
    def slack(self) -> float:
        """How late completion may slip without moving the makespan."""
        return self.latest_completion - self.completion


class MXDAG:
    """A directed acyclic graph over MXTasks with pipelineable edges."""

    def __init__(self, name: str = "mxdag") -> None:
        self.name = name
        self.tasks: dict[str, MXTask] = {}
        self.edges: dict[tuple[str, str], Edge] = {}
        self._succ: dict[str, list[str]] = {}
        self._pred: dict[str, list[str]] = {}
        # bumped by every mutator; keys the signature and simulator-static
        # caches.  Mutate tasks only through the MXDAG API (or on a fresh
        # copy()) so cached derived state is never stale.
        self._version = 0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add(self, task: MXTask) -> MXTask:
        """Add a task (its name must be new) and return it."""
        if task.name in self.tasks:
            raise ValueError(f"duplicate task {task.name}")
        self.tasks[task.name] = task
        self._succ[task.name] = []
        self._pred[task.name] = []
        self._version += 1
        return task

    def add_edge(self, src: str | MXTask, dst: str | MXTask,
                 *, pipelined: bool = False) -> Edge:
        """Add the edge src→dst, rejecting duplicates and cycles."""
        s = src.name if isinstance(src, MXTask) else src
        d = dst.name if isinstance(dst, MXTask) else dst
        for n in (s, d):
            if n not in self.tasks:
                raise KeyError(f"unknown task {n}")
        if (s, d) in self.edges:
            raise ValueError(f"duplicate edge {s}->{d}")
        self._check_no_cycle_via(s, d)
        e = Edge(s, d, pipelined)
        self.edges[(s, d)] = e
        self._succ[s].append(d)
        self._pred[d].append(s)
        self._version += 1
        return e

    def chain(self, *tasks: MXTask, pipelined: bool = False) -> None:
        """Add tasks (if new) and connect them in sequence."""
        for t in tasks:
            if t.name not in self.tasks:
                self.add(t)
        for a, b in zip(tasks, tasks[1:]):
            self.add_edge(a, b, pipelined=pipelined)

    def set_pipelined(self, src: str, dst: str, pipelined: bool) -> None:
        """Flip one existing edge's streaming flag."""
        e = self.edges[(src, dst)]
        self.edges[(src, dst)] = Edge(e.src, e.dst, pipelined)
        self._version += 1

    def replace_task(self, task: MXTask) -> MXTask:
        """Swap in a new MXTask under its existing name (what-if resizing,
        monitor re-estimation).  The supported way to mutate a task:
        assigning ``g.tasks[name]`` directly would leave the version-keyed
        signature/simulator caches stale."""
        if task.name not in self.tasks:
            raise KeyError(f"unknown task {task.name}")
        self.tasks[task.name] = task
        self._version += 1
        return task

    @classmethod
    def union(cls, graphs: Iterable["MXDAG"],
              name: Optional[str] = None) -> "MXDAG":
        """Disjoint union of whole DAGs (the multi-job merge), bulk.

        Equivalent to ``add``-ing every task and ``add_edge``-ing every
        edge job by job, but skips the per-edge cycle walk: task names
        must be globally unique (checked — ``ValueError`` on collision),
        so every edge stays inside its own already-acyclic input graph
        and the union cannot create a cycle.  This is the hot path of
        the online service loop, where the running job set is re-merged
        on every admission and completion.
        """
        graphs = list(graphs)
        m = cls(name if name is not None
                else "+".join(g.name for g in graphs))
        owner: dict[str, str] = {}
        for g in graphs:
            for nm, t in g.tasks.items():
                if nm in m.tasks:
                    raise ValueError(
                        f"cross-job task name collision: {nm!r} is "
                        f"defined by both {owner[nm]} and "
                        f"{g.name!r} (job {t.job!r}); task names must "
                        f"be unique across the jobs sharing a cluster "
                        f"(prefix them with the job name, as "
                        f"builders.mapreduce does)")
                m.tasks[nm] = t
                owner[nm] = f"{g.name!r} (job {t.job!r})"
            m.edges.update(g.edges)
            for nm, ss in g._succ.items():
                m._succ[nm] = list(ss)
            for nm, ps in g._pred.items():
                m._pred[nm] = list(ps)
        m._version = len(graphs)
        return m

    def copy(self) -> "MXDAG":
        """Independent shallow copy (tasks are frozen; structure is new)."""
        g = MXDAG(self.name)
        g.tasks = dict(self.tasks)
        g.edges = dict(self.edges)
        g._succ = {k: list(v) for k, v in self._succ.items()}
        g._pred = {k: list(v) for k, v in self._pred.items()}
        return g

    # ------------------------------------------------------------------
    # logical placement (late binding of hosts / flow endpoints)
    # ------------------------------------------------------------------
    def unbound(self) -> list[str]:
        """Names of tasks whose placement is still undecided."""
        return [n for n, t in self.tasks.items() if not t.bound]

    def _location_vars(self):
        """Union-find over placement variables, with dataflow constraints.

        Variables: ``("c", task)`` for a compute task's host, ``("s", f)``
        / ``("d", f)`` for a flow's endpoints.  Edges impose co-location:
        a compute→flow edge pins the flow's source to the producer's host,
        flow→compute pins the destination to the consumer's host, and
        flow→flow means the data lands where the next hop departs from.
        Returns ``(find, vars)`` where ``find`` maps a variable to its
        class representative.
        """
        parent: dict[tuple, tuple] = {}

        def find(v: tuple) -> tuple:
            """Union-find root of ``v`` with path compression."""
            root = v
            while parent.setdefault(root, root) != root:
                root = parent[root]
            while parent[v] != root:            # path compression
                parent[v], v = root, parent[v]
            return root

        def union(a: tuple, b: tuple) -> None:
            """Merge the classes of ``a`` and ``b`` (smaller root wins)."""
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

        variables: list[tuple] = []
        for n, t in self.tasks.items():
            if t.kind is TaskKind.COMPUTE:
                variables.append(("c", n))
            else:
                variables.append(("s", n))
                variables.append(("d", n))
        for (p, n) in self.edges:
            tp, tn = self.tasks[p], self.tasks[n]
            if tp.kind is TaskKind.COMPUTE and tn.kind is TaskKind.NETWORK:
                union(("c", p), ("s", n))
            elif tp.kind is TaskKind.NETWORK \
                    and tn.kind is TaskKind.COMPUTE:
                union(("d", p), ("c", n))
            elif tp.kind is TaskKind.NETWORK \
                    and tn.kind is TaskKind.NETWORK:
                union(("d", p), ("s", n))
        return find, variables

    def bind(self, assignment: "dict[str, object]") -> "MXDAG":
        """A copy with the placement ``assignment`` applied.

        ``assignment`` maps task names to placements: a host string for a
        compute task, or an ``(src, dst)`` pair for a flow (either element
        may be ``None`` to leave it to inference).  Unassigned endpoints
        are inferred by co-location: a flow departs from its producing
        compute task's host, arrives at its consuming compute task's host,
        and a flow feeding another flow hands its data off at a common
        host.  Raises if an assignment targets an already-bound task (use
        :meth:`replace_task` / what-if ``move_task`` for re-placement), if
        inference meets two conflicting anchors, or if any placement is
        still undecided after inference.
        """
        find, variables = self._location_vars()
        value: dict[tuple, str] = {}       # class representative -> host

        # classes holding at least one undecided variable; only those are
        # anchored and consistency-checked, so a fully-bound graph — even
        # one whose bound endpoints disagree with the co-location rules —
        # binds to itself untouched
        open_classes: set[tuple] = set()
        for n, t in self.tasks.items():
            if t.kind is TaskKind.COMPUTE:
                if t.host is None:
                    open_classes.add(find(("c", n)))
            else:
                if t.src is None:
                    open_classes.add(find(("s", n)))
                if t.dst is None:
                    open_classes.add(find(("d", n)))

        def anchor(var: tuple, host: str, why: str) -> None:
            """Pin a location class to ``host``, rejecting conflicts."""
            root = find(var)
            if root not in open_classes:
                return
            old = value.get(root)
            if old is not None and old != host:
                raise ValueError(
                    f"conflicting placement for {why}: {old!r} vs {host!r}")
            value[root] = host

        for n, t in self.tasks.items():
            if t.kind is TaskKind.COMPUTE:
                if t.host is not None:
                    anchor(("c", n), t.host, f"compute {n}")
            else:
                if t.src is not None:
                    anchor(("s", n), t.src, f"flow {n} src")
                if t.dst is not None:
                    anchor(("d", n), t.dst, f"flow {n} dst")

        for name, placement in assignment.items():
            t = self.tasks.get(name)
            if t is None:
                raise KeyError(f"unknown task {name}")
            if t.bound:
                raise ValueError(
                    f"{name} is already bound; bind() only places logical "
                    f"tasks (use replace_task to re-place)")
            if t.kind is TaskKind.COMPUTE:
                if not isinstance(placement, str):
                    raise ValueError(f"{name}: compute placement must be "
                                     f"a host name")
                anchor(("c", name), placement, f"compute {name}")
            else:
                src, dst = placement          # type: ignore[misc]
                # an endpoint that is already bound on the task itself is
                # not up for (re)assignment — its class may be closed, so
                # anchor() would silently drop a conflicting value
                if src is not None:
                    if t.src is not None and t.src != src:
                        raise ValueError(
                            f"flow {name} src is already bound to "
                            f"{t.src!r}; bind() cannot move it to {src!r}")
                    anchor(("s", name), src, f"flow {name} src")
                if dst is not None:
                    if t.dst is not None and t.dst != dst:
                        raise ValueError(
                            f"flow {name} dst is already bound to "
                            f"{t.dst!r}; bind() cannot move it to {dst!r}")
                    anchor(("d", name), dst, f"flow {name} dst")

        unresolved = [v for v in variables
                      if find(v) in open_classes and find(v) not in value]
        if unresolved:
            names = sorted({v[1] for v in unresolved})
            raise ValueError(f"placement still undecided for: {names}")

        g = self.copy()
        for n, t in self.tasks.items():
            if t.bound:
                continue
            if t.kind is TaskKind.COMPUTE:
                g.replace_task(dataclasses.replace(
                    t, host=value[find(("c", n))]))
            else:
                src = t.src if t.src is not None else value[find(("s", n))]
                dst = t.dst if t.dst is not None else value[find(("d", n))]
                g.replace_task(dataclasses.replace(t, src=src, dst=dst))
        return g

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------
    def preds(self, name: str) -> list[str]:
        """Direct predecessors of ``name`` (insertion order)."""
        return self._pred[name]

    def succs(self, name: str) -> list[str]:
        """Direct successors of ``name`` (insertion order)."""
        return self._succ[name]

    def sources(self) -> list[str]:
        """Tasks with no predecessors."""
        return [n for n in self.tasks if not self._pred[n]]

    def sinks(self) -> list[str]:
        """Tasks with no successors."""
        return [n for n in self.tasks if not self._succ[n]]

    def topo_order(self) -> list[str]:
        """Deterministic topological order (lexicographic Kahn)."""
        # heap-based Kahn: lexicographically smallest available task first
        # (identical order to the seed's re-sorted frontier list, without
        # its O(V² log V) repeated sorting)
        indeg = {n: len(self._pred[n]) for n in self.tasks}
        frontier = [n for n, d in indeg.items() if d == 0]
        heapq.heapify(frontier)
        order: list[str] = []
        while frontier:
            n = heapq.heappop(frontier)
            order.append(n)
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(frontier, s)
        if len(order) != len(self.tasks):
            raise ValueError("graph has a cycle")
        return order

    def _check_no_cycle_via(self, src: str, dst: str) -> None:
        """Adding src→dst creates a cycle iff dst already reaches src.

        Checked *before* mutating, by DFS from dst — O(V+E) worst case but
        O(1) in the common build order where dst has no successors yet
        (the seed instead re-ran a full topological sort per edge, making
        graph construction quadratic in the edge count).
        """
        if src == dst:
            raise ValueError("graph has a cycle")
        stack = [dst]
        seen = {dst}
        while stack:
            for s in self._succ[stack.pop()]:
                if s == src:
                    raise ValueError("graph has a cycle")
                if s not in seen:
                    seen.add(s)
                    stack.append(s)

    def signature(self) -> tuple:
        """Hashable identity: tasks, edges and their pipelining flags.

        Deliberately insertion-order-sensitive — the DES breaks ties
        (residual link order, start dispatch) by task order, so graphs
        with identical content but different construction order are
        distinct simulation inputs.  Keys the scheduler's and WhatIf's
        simulation memo caches.  Cached per graph version.
        """
        cached = self.__dict__.get("_sig_cache")
        if cached is not None and cached[0] == self._version:
            return cached[1]
        sig = (tuple(self.tasks.values()),
               tuple((e.src, e.dst, e.pipelined)
                     for e in self.edges.values()))
        self._sig_cache = (self._version, sig)
        return sig

    def effective_pipelined(self, e: Edge) -> bool:
        """An edge streams units only if marked AND both endpoints can.

        A non-pipelineable consumer needs its full input before starting, so
        a pipelined edge into it degenerates to a barrier (paper §3.1).
        """
        return (e.pipelined
                and self.tasks[e.src].pipelineable
                and self.tasks[e.dst].pipelineable)

    # ------------------------------------------------------------------
    # §3.2 path-length calculus (explicit-path form, Eqs. 1 & 2)
    # ------------------------------------------------------------------
    @staticmethod
    def len_sequential(tasks: Iterable[MXTask],
                       rsrc: Optional[dict[str, float]] = None) -> float:
        """Eq. (1): length of a sequential-only path."""
        r = rsrc or {}
        return sum(t.time(r.get(t.name, 1.0)) for t in tasks)

    @staticmethod
    def len_pipelined(tasks: Iterable[MXTask],
                      rsrc: Optional[dict[str, float]] = None) -> float:
        """Eq. (2): length of a pipelineable-only path."""
        ts = list(tasks)
        r = rsrc or {}
        units = [t.unit_time(r.get(t.name, 1.0)) for t in ts]
        sizes = [t.time(r.get(t.name, 1.0)) for t in ts]
        return sum(units) + max(sizes) - max(units)

    # ------------------------------------------------------------------
    # analytic evaluator (contention-free; exact on chains, lower bound
    # in general — the DES in simulator.py adds resource contention)
    # ------------------------------------------------------------------
    def evaluate(self, rsrc: Optional[dict[str, float]] = None,
                 release: Optional[dict[str, float]] = None,
                 ) -> dict[str, NodeTiming]:
        """Earliest-time recursion over the DAG.

        ready(v)      = max over in-edges e=(p,v):
                          first_out(p) if e streams else completion(p)
        first_out(v)  = ready(v) + unit_time(v)
        completion(v) = max( ready(v) + time(v),
                             max over streaming preds: completion(p) + unit_time(v) )

        For deterministic unit pipelines with unbounded buffers this is exact
        and reproduces Eq. (2) on pipelineable chains.
        """
        r = rsrc or {}
        rel = release or {}
        # per-task times resolved once: t.time()/t.unit_time() validate
        # their argument per call, which dominates on large DAGs
        times = {n: t.time(r.get(n, 1.0)) for n, t in self.tasks.items()}
        utimes = {n: t.unit_time(r.get(n, 1.0))
                  for n, t in self.tasks.items()}
        out: dict[str, NodeTiming] = {}
        for n in self.topo_order():
            ready = rel.get(n, 0.0)
            comp_floor = 0.0
            ut = utimes[n]
            for p in self._pred[n]:
                e = self.edges[(p, n)]
                pt = out[p]
                if self.effective_pipelined(e):
                    ready = max(ready, pt.first_out)
                    comp_floor = max(comp_floor, pt.completion + ut)
                else:
                    ready = max(ready, pt.completion)
            completion = max(ready + times[n], comp_floor)
            out[n] = NodeTiming(ready=ready,
                                first_out=ready + ut,
                                completion=completion)
        return out

    def makespan(self, rsrc: Optional[dict[str, float]] = None,
                 release: Optional[dict[str, float]] = None) -> float:
        """Analytic (contention-free) makespan under ``rsrc``/``release``."""
        timing = self.evaluate(rsrc, release)
        return max((t.completion for t in timing.values()), default=0.0)

    def with_slack(self, rsrc: Optional[dict[str, float]] = None,
                   release: Optional[dict[str, float]] = None,
                   ) -> dict[str, NodeTiming]:
        """Forward + reverse pass: fills ``latest_completion`` (⇒ slack).

        ``release`` threads per-task earliest start times through the
        forward pass, exactly as :meth:`evaluate`/:meth:`makespan`
        accept them — without it the slack of a late-released branch is
        overstated (its completion is computed as if it could start at
        t=0 while the makespan it is compared against cannot shrink).
        """
        timing = self.evaluate(rsrc, release)
        ms = max((t.completion for t in timing.values()), default=0.0)
        r = rsrc or {}
        times = {n: t.time(r.get(n, 1.0)) for n, t in self.tasks.items()}
        utimes = {n: t.unit_time(r.get(n, 1.0))
                  for n, t in self.tasks.items()}
        for n in reversed(self.topo_order()):
            if not self._succ[n]:
                timing[n].latest_completion = ms
                continue
            lc = float("inf")
            for s in self._succ[n]:
                e = self.edges[(n, s)]
                if self.effective_pipelined(e):
                    # successor needs our first unit by latest_start(s);
                    # conservative: our completion by its latest_completion
                    # minus one of its units.
                    lc = min(lc, timing[s].latest_completion - utimes[s])
                else:
                    lc = min(lc, timing[s].latest_completion - times[s])
            timing[n].latest_completion = lc
        return timing

    def critical_path(self, rsrc: Optional[dict[str, float]] = None,
                      release: Optional[dict[str, float]] = None,
                      ) -> list[str]:
        """Longest path under the analytic evaluator (ties: lexicographic).

        ``release`` carries per-task earliest starts into the forward
        pass (e.g. observed starts from a runtime monitor); the
        walk-back stops where a release, rather than a predecessor,
        binds the completion.
        """
        timing = self.evaluate(rsrc, release)
        r = rsrc or {}
        # walk back from the sink with max completion
        cur = max(self.sinks(), key=lambda n: (timing[n].completion, n))
        path = [cur]
        while self._pred[cur]:
            t = self.tasks[cur]
            f = r.get(cur, 1.0)
            best, best_val = None, -1.0
            for p in self._pred[cur]:
                e = self.edges[(p, cur)]
                pt = timing[p]
                if self.effective_pipelined(e):
                    v = max(pt.first_out + t.time(f),
                            pt.completion + t.unit_time(f))
                else:
                    v = pt.completion + t.time(f)
                if v > best_val + 1e-12 or (abs(v - best_val) <= 1e-12
                                            and (best is None or p < best)):
                    best, best_val = p, v
            # only follow preds that actually bind the completion
            if best is None or best_val + 1e-9 < timing[cur].completion:
                break
            cur = best
            path.append(cur)
        path.reverse()
        return path

    # ------------------------------------------------------------------
    # copaths (§3.2): groups of ≥2 distinct paths with same head & tail
    # ------------------------------------------------------------------
    def paths_between(self, head: str, tail: str,
                      limit: int = 10000) -> list[list[str]]:
        """All directed paths head→tail, in DFS (adjacency) order.

        Iterative: the previous recursive DFS hit Python's recursion
        limit (RecursionError) on chains deeper than ~1000 tasks —
        ``ddl(1024)``-scale serial DAGs exceed it.  The explicit stack
        reproduces the recursive enumeration order exactly.
        """
        out: list[list[str]] = []
        # stack of (node, #successors already expanded); path mirrors it
        path = [head]
        stack = [(head, 0)]
        while stack:
            if len(out) >= limit:
                break
            n, child = stack[-1]
            if n == tail and child == 0:
                out.append(list(path))
                stack.pop()
                path.pop()
                continue
            succs = self._succ[n]
            if child >= len(succs):
                stack.pop()
                path.pop()
                continue
            stack[-1] = (n, child + 1)
            s = succs[child]
            stack.append((s, 0))
            path.append(s)
        return out

    def copaths(self, limit: int = 10000) -> dict[tuple[str, str], list[list[str]]]:
        """All (head, tail) pairs joined by ≥2 distinct paths."""
        # count paths between all pairs via DP to avoid useless DFS
        order = self.topo_order()
        idx = {n: i for i, n in enumerate(order)}
        npaths: dict[tuple[str, str], int] = {}
        for h in order:
            counts = {h: 1}
            for n in order[idx[h]:]:
                c = counts.get(n, 0)
                if not c:
                    continue
                for s in self._succ[n]:
                    counts[s] = counts.get(s, 0) + c
            for t, c in counts.items():
                if t != h and c >= 2:
                    npaths[(h, t)] = c
        return {pair: self.paths_between(*pair, limit=limit)
                for pair in sorted(npaths)}

    # ------------------------------------------------------------------
    def resource_map(self, cluster=None) -> dict[str, list[str]]:
        """Resource → tasks occupying it, in task-insertion order.

        With a :class:`~repro_torch.core.cluster.Cluster` carrying a fabric
        :class:`~repro_torch.core.fabric.Topology`, flows are charged against
        every link on their path — so schedulers see in-network contention
        (shared ToR uplinks, spine links) and not just endpoint NICs.
        """
        out: dict[str, list[str]] = {}
        for n, t in self.tasks.items():
            res = cluster.resources_for(t) if cluster is not None \
                else t.resources()
            for r in res:
                out.setdefault(r, []).append(n)
        return out

    # ------------------------------------------------------------------
    def network_tasks(self) -> list[MXTask]:
        """All flow tasks, insertion order."""
        return [t for t in self.tasks.values() if t.kind is TaskKind.NETWORK]

    def compute_tasks(self) -> list[MXTask]:
        """All compute tasks, insertion order."""
        return [t for t in self.tasks.values() if t.kind is TaskKind.COMPUTE]

    def pipelineable_edges(self) -> list[Edge]:
        """Edges whose both endpoints carry unit structure."""
        return [e for e in self.edges.values()
                if self.tasks[e.src].pipelineable
                and self.tasks[e.dst].pipelineable]

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self) -> Iterator[MXTask]:
        return iter(self.tasks.values())

    def __repr__(self) -> str:
        return (f"MXDAG({self.name}: {len(self.tasks)} tasks, "
                f"{len(self.edges)} edges, "
                f"{len(self.network_tasks())} network)")
