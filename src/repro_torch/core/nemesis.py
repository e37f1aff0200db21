"""Nemesis: fault injection + live replanning on the compiled DES.

The paper's case for MXDAG's hybrid abstraction is not only better
offline schedules but *runtime adaptation*: with compute and network
tasks in one DAG, a controller that notices a straggler or a failure can
tell which kind it is (§4.3) and answer recovery what-ifs — move this
task, re-path that flow — that neither a coflow scheduler nor a
compute-only DAG scheduler can express.  This module closes that loop
against a *running* simulation:

- :class:`Fault` / :func:`random_faults` — a seeded fault schedule:
  host loss, link degradation, task stragglers (rate multipliers),
  plus the correlated kinds: ``rack_loss`` (a ToR/edge-switch loss
  whose blast radius — :func:`rack_blast` — takes its fabric links and
  every resident host in one stroke) and ``link_recover`` (the healing
  half of a flapping link; :func:`flapping_link` emits
  degrade→recover→degrade cycles, :func:`fault_storm` packs several
  distinct faults into one overlapping window).
- :class:`ReplanController` — the recovery brain.  It feeds observed
  progress into :class:`~repro_torch.core.monitor.Monitor`, diagnoses what
  went wrong (host vs network straggler; which fabric link), updates a
  *belief* cluster (surviving hosts, degraded capacities), re-runs
  :class:`~repro_torch.core.schedule.MXDAGScheduler` warm on the remaining
  work, and applies the recovery through the live simulation's
  mutators (``move_task`` off dead/slow hosts, ``repath_flow`` around
  degraded links, ``set_priorities`` from the warm replan).  With
  ``cost_aware=True`` it prices every *speculative* move first: the
  compiled analytic critical path (:mod:`repro_torch.core.arrayanalytic`)
  of the remaining work with the straggler at its observed rate vs
  restarting it from zero elsewhere and re-fetching its inputs —
  committing only past a hysteresis margin, under a bounded
  speculation budget with a cooldown that backs off exponentially
  after a losing speculation (so flapping faults cannot thrash it).
- :class:`RecoveryTracker` — the referee: per fault, did the system
  notice (detection), what did it conclude (diagnosis), what did it do
  (actions), and did the run still finish (recovery).
- :class:`Nemesis` — the harness driving both: it advances a
  :class:`~repro_torch.core.arraysim.ResumableSim` between fault times and
  probe ticks, injects each fault at its exact scheduled time via
  ``advance_to`` + the fault mutators, and lets the controller react.

Everything is deterministic: the fault schedule is a pure function of
its seed, probe ticks are a fixed cadence, and the simulation itself is
the bit-reproducible array engine — so every scenario replays exactly.
"""
from __future__ import annotations

import dataclasses
import math
import random
import re
from typing import Optional, Sequence

from repro_torch.core.arraysim import ResumableSim
from repro_torch.core.cluster import Cluster
from repro_torch.core.fabric import is_nic_link, nic_in, nic_out
from repro_torch.core.monitor import Monitor
from repro_torch.core.schedule import MXDAGScheduler, Schedule
from repro_torch.core.simulator import Simulator
from repro_torch.core.task import TaskKind
from repro_torch.core.whatif import follow_moves

#: the independent single-victim fault classes random_faults samples
BASE_FAULT_KINDS = ("host_loss", "link_degrade", "straggler")

#: every injectable kind, including the correlated/cascade ones:
#: ``rack_loss`` (ToR blast radius) and ``link_recover`` (the healing
#: half of a flap — never sampled on its own; it is not a fault)
FAULT_KINDS = BASE_FAULT_KINDS + ("rack_loss", "link_recover")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault event.

    ``kind`` is one of :data:`FAULT_KINDS`; ``target`` names the victim
    (a host, a fabric link, a compute task, or — for ``rack_loss`` — a
    ToR/edge switch group as named by :func:`tor_groups`); ``factor``
    is the rate multiplier for ``link_degrade``/``straggler`` and the
    restored capacity fraction for ``link_recover`` (ignored for
    host/rack loss — lost slots, NICs and switch links go to zero).
    """

    time: float
    kind: str
    target: str
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


def random_faults(graph, cluster: Cluster, *, horizon: float,
                  n: int = 2, seed: int = 0,
                  kinds: Sequence[str] = BASE_FAULT_KINDS,
                  window: tuple[float, float] = (0.15, 0.6),
                  severity: tuple[float, float] = (0.05, 0.25),
                  ) -> list[Fault]:
    """A seeded random fault schedule for a graph/cluster pair.

    Targets are drawn from *sorted* candidate lists through one
    ``random.Random(seed)`` stream, so the schedule is a pure function
    of its arguments (satellite of the determinism requirement: every
    scenario replays bit-exact).  Fault times land in
    ``[window[0], window[1]] * horizon`` — mid-run, where there is
    progress to lose; degradation/straggler factors land in
    ``severity`` (fraction of nominal speed).  Any host may die;
    whether the scenario is recoverable is exactly what the harness
    measures.
    """
    rng = random.Random(seed)
    hosts = sorted(cluster.hosts)
    links = sorted(l for l in
                   (cluster.topology.links if cluster.topology is not None
                    else ())
                   if not is_nic_link(l))
    computes = sorted(t.name for t in graph
                      if t.kind is TaskKind.COMPUTE)
    racks = sorted(tor_groups(cluster)) if "rack_loss" in kinds else []
    out: list[Fault] = []
    for _ in range(n):
        choices = [k for k in kinds
                   if (k != "link_degrade" or links)
                   and (k != "straggler" or computes)
                   and (k != "host_loss" or hosts)
                   and (k != "rack_loss" or racks)
                   and k != "link_recover"]
        if not choices:
            break
        kind = rng.choice(choices)
        t = round(rng.uniform(window[0], window[1]) * horizon, 6)
        f = round(rng.uniform(*severity), 6)
        if kind == "host_loss":
            out.append(Fault(t, kind, rng.choice(hosts)))
        elif kind == "link_degrade":
            out.append(Fault(t, kind, rng.choice(links), f))
        elif kind == "rack_loss":
            out.append(Fault(t, kind, rng.choice(racks)))
        else:
            out.append(Fault(t, kind, rng.choice(computes), f))
    return sorted(out, key=lambda x: (x.time, x.kind, x.target))


# ----------------------------------------------------------------------
# correlated fault campaigns (cascades, flaps, storms)
# ----------------------------------------------------------------------
def _switch_group(link: str) -> str:
    """The switch-group name of a fabric link: the link name without
    its ``.up``/``.down`` leaf and any trailing aggregation suffix —
    ``rack0.up → rack0``, ``leaf1.up2 → leaf1``,
    ``p0.e1a2.up → p0.e1`` (the fat-tree edge switch)."""
    stem = link.rsplit(".", 1)[0]
    return re.sub(r"a\d+$", "", stem)


def tor_groups(cluster: Cluster) -> dict[str, tuple[list, list]]:
    """ToR/edge switch groups with resident hosts:
    ``name -> (hosts, links)``.

    A fabric link belongs to group :func:`_switch_group` of its name; a
    host is *resident* in the group that owns every first fabric hop of
    its egress paths — the host's only way into the fabric.  Groups
    without residents (aggregation/core link bundles) are dropped: a
    core-switch loss degrades paths but strands no host, which ECMP
    already models as individual ``link_degrade`` faults.
    """
    topo = cluster.topology
    if topo is None:
        return {}
    groups: dict[str, set] = {}
    for l in topo.links:
        if not is_nic_link(l):
            groups.setdefault(_switch_group(l), set()).add(l)
    if not groups:
        return {}
    hosts = sorted(cluster.hosts)
    first: dict[str, set] = {}
    for h in hosts:
        fl: set = set()
        for d in hosts:
            if d == h:
                continue
            for p in topo.paths(h, d):
                for l in p:
                    if not is_nic_link(l):
                        fl.add(l)
                        break
        first[h] = fl
    out: dict[str, tuple[list, list]] = {}
    for name in sorted(groups):
        resident = [h for h in hosts
                    if first[h] and first[h] <= groups[name]]
        if resident:
            out[name] = (resident, sorted(groups[name]))
    return out


def rack_blast(cluster: Cluster, tor: str) -> tuple[list, list]:
    """Blast radius of losing ToR/edge switch ``tor``:
    ``(resident hosts, switch links)`` — what one ``rack_loss`` fault
    takes down in a single stroke."""
    groups = tor_groups(cluster)
    if tor not in groups:
        raise ValueError(
            f"unknown ToR group {tor!r}; known: {sorted(groups) or '—'}")
    return groups[tor]


def flapping_link(link: str, *, start: float, period: float,
                  cycles: int = 2, factor: float = 0.1) -> list[Fault]:
    """A flapping fabric link: degrade → recover → degrade …

    Cycle ``c`` degrades ``link`` to ``factor`` of nominal at
    ``start + c*period`` and restores full capacity half a period
    later.  Degradation is *grey* (the controller must infer it);
    recovery is announced (``link_recover`` — fabrics advertise
    port-up, it is grey failure that hides).
    """
    if period <= 0 or cycles < 1:
        raise ValueError("need period > 0 and cycles >= 1")
    out: list[Fault] = []
    for c in range(cycles):
        t = start + c * period
        out.append(Fault(round(t, 9), "link_degrade", link, factor))
        out.append(Fault(round(t + period / 2.0, 9),
                         "link_recover", link, 1.0))
    return out


def fault_storm(graph, cluster: Cluster, *, horizon: float,
                n: int = 3, seed: int = 0,
                window: tuple[float, float] = (0.2, 0.4),
                severity: tuple[float, float] = (0.05, 0.25),
                kinds: Sequence[str] = BASE_FAULT_KINDS) -> list[Fault]:
    """A seeded burst of *distinct* overlapping faults.

    Like :func:`random_faults` but with the times packed into a tight
    window (every fault lands while the previous ones are still being
    detected/recovered — simultaneously *active* faults, the storm the
    per-fault attribution machinery exists for) and targets drawn
    without replacement, so no victim is hit twice and the fault mix
    cycles through the available kinds.
    """
    rng = random.Random(seed)
    pools = {
        "host_loss": sorted(cluster.hosts),
        "link_degrade": sorted(
            l for l in (cluster.topology.links
                        if cluster.topology is not None else ())
            if not is_nic_link(l)),
        "straggler": sorted(t.name for t in graph
                            if t.kind is TaskKind.COMPUTE),
        "rack_loss": sorted(tor_groups(cluster))
        if "rack_loss" in kinds else [],
    }
    out: list[Fault] = []
    order = [k for k in kinds if k != "link_recover"]
    i = 0
    while len(out) < n and any(pools.get(k) for k in order):
        kind = order[i % len(order)]
        i += 1
        pool = pools.get(kind) or []
        if not pool:
            continue
        target = pool.pop(rng.randrange(len(pool)))
        t = round(rng.uniform(window[0], window[1]) * horizon, 6)
        f = round(rng.uniform(*severity), 6)
        out.append(Fault(t, kind, target,
                         f if kind in ("link_degrade", "straggler")
                         else 1.0))
    return sorted(out, key=lambda x: (x.time, x.kind, x.target))


@dataclasses.dataclass
class FaultRecord:
    """The tracker's verdict on one injected fault."""

    fault: Fault
    injected_at: float
    detected: bool = False
    detected_at: Optional[float] = None
    diagnosis: str = ""
    actions: list = dataclasses.field(default_factory=list)
    recovered: bool = False


class RecoveryTracker:
    """Referee: per injected fault, detection, diagnosis, and recovery."""

    def __init__(self):
        self.records: list[FaultRecord] = []

    def injected(self, fault: Fault, at: float) -> FaultRecord:
        """Register an injected fault; returns its (mutable) record."""
        rec = FaultRecord(fault=fault, injected_at=at)
        self.records.append(rec)
        return rec

    def detection_rate(self) -> float:
        """Fraction of injected faults the controller noticed (1.0 on
        an empty schedule — nothing to miss)."""
        if not self.records:
            return 1.0
        return sum(r.detected for r in self.records) / len(self.records)

    def recovery_rate(self) -> float:
        """Fraction of injected faults after which the run finished."""
        if not self.records:
            return 1.0
        return sum(r.recovered for r in self.records) / len(self.records)

    def report(self) -> str:
        """Markdown recovery table (one row per fault)."""
        lines = ["| t | fault | target | detected | diagnosis | actions |",
                 "|---|-------|--------|----------|-----------|---------|"]
        for r in self.records:
            det = (f"t={r.detected_at:.3g}" if r.detected else "MISSED")
            acts = "; ".join(str(a) for a in r.actions) or "—"
            lines.append(f"| {r.fault.time:.3g} | {r.fault.kind} "
                         f"| {r.fault.target} | {det} "
                         f"| {r.diagnosis or '—'} | {acts} |")
        return "\n".join(lines)


class ReplanController:
    """Live recovery: Monitor-fed detection, belief update, warm replan.

    The controller never reads the fault schedule.  It sees what a real
    control plane would see: heartbeat loss (host failures are
    *announced* via :meth:`on_host_loss` — the one fault class detected
    out-of-band) and per-task progress probes (everything else is
    *inferred* from the Monitor's straggler analysis in :meth:`check`).
    Its belief about the cluster — which hosts survive, what each link's
    usable capacity is — is updated per diagnosis, and every reaction
    ends with a warm :class:`MXDAGScheduler` pass over the remaining
    work on the believed cluster, whose priorities are swapped into the
    running simulation without recompiling.
    """

    def __init__(self, schedule: Schedule, cluster: Cluster,
                 rs: ResumableSim, *,
                 scheduler: Optional[MXDAGScheduler] = None,
                 threshold: float = 0.2,
                 expected=None,
                 cost_aware: bool = False,
                 hysteresis: float = 0.05,
                 spec_budget: int = 8,
                 spec_cooldown: float = 1.0,
                 link_budget: int = 4):
        self.schedule = schedule
        self.graph = schedule.graph
        self.cluster = cluster
        self.rs = rs
        self.scheduler = scheduler or MXDAGScheduler(try_pipelining=False)
        if expected is None:
            expected = schedule.simulate(cluster)
        self.monitor = Monitor(self.graph, expected, threshold=threshold)
        self.dead_hosts: set[str] = set()
        self.degraded: dict[str, float] = {}    # link -> believed capacity
        self.suspect_hosts: set[str] = set()    # believed slow executors
        self.actions: list[tuple] = []          # full action log
        # -- cost model (inactive unless cost_aware) --
        self.cost_aware = cost_aware
        self.hysteresis = hysteresis
        self.link_budget = link_budget
        self.declined: list[tuple] = []         # (time, what, reason)
        self._spec_left = spec_budget
        self._spec_ok_at = 0.0
        self._base_cooldown = spec_cooldown
        self._cooldown = spec_cooldown
        self._pending: list[tuple] = []         # (task, t0, projected dur)
        self._link_events: dict[str, int] = {}
        self._rebase: dict[str, tuple] = {}     # flow -> (t, frac) at repath

    # -- belief --------------------------------------------------------
    def belief_cluster(self) -> Cluster:
        """The cluster as the controller currently believes it to be."""
        cl = self.cluster
        if self.dead_hosts:
            cl = cl.without_hosts(self.dead_hosts)
        if self.degraded:
            cl = cl.degraded(self.degraded)
        return cl

    def probe(self) -> None:
        """Feed the live run's progress into the Monitor (one runtime
        progress report per started task, stamped with the sim clock)."""
        t = self.rs.now
        for name, frac in self.rs.progress().items():
            if self.rs.started_at(name) is not None:
                self.monitor.observe(name, frac, t)

    # -- recovery actions ----------------------------------------------
    def _route_for(self, src: str, dst: str) -> tuple[str, ...]:
        """A believed-good route src→dst: the first ECMP candidate whose
        fabric links are not believed degraded (falling back to the
        static pick when every candidate is suspect)."""
        topo = self.cluster.topology
        if topo is None:
            return (nic_out(src), nic_in(dst))
        cands = topo.paths(src, dst)
        for p in cands:
            if not any(l in self.degraded for l in p):
                return p
        return topo.path(src, dst)

    def _pick_host(self, proc: str, avoid: set[str]) -> Optional[str]:
        """A believed-healthy host with a free ``proc`` slot (most free
        slots first, then name order, skipping ``avoid``)."""
        free = self.rs.free_slots()
        best = None
        for (host, pool), k in sorted(free.items()):
            if pool != proc or k < 1 or host in avoid \
                    or host in self.dead_hosts \
                    or host in self.suspect_hosts:
                continue
            if best is None or k > free[(best, proc)]:
                best = host
        return best

    def _repath(self, fname: str, route, **kw) -> None:
        """Repath a flow in the live run and *rebase* its progress
        clock: rate judgements after this point start from the flow's
        progress now, so the lifetime average depressed by the old
        route cannot keep implicating the new one."""
        self.rs.repath_flow(fname, route, **kw)
        self._rebase[fname] = (self.rs.now, self.rs.progress()[fname])

    def _recent_rate(self, task: str) -> tuple[float, float]:
        """``(observed, nominal)`` progress rate (fraction per time) of
        a running flow, measured since its last repath (or its start)
        — the window in which its *current* route is the suspect."""
        rs = self.rs
        st = rs.started_at(task)
        frac = rs.progress()[task]
        t0, f0 = self._rebase.get(task, (st, 0.0))
        if t0 < st or f0 > frac:    # restarted since the repath
            self._rebase.pop(task, None)
            t0, f0 = st, 0.0
        exp = self.monitor.expected
        nominal = 1.0 / max(exp.finish[task] - exp.start[task], 1e-12)
        dt = rs.now - t0
        if dt <= 1e-12:
            return nominal, nominal     # no evidence yet: assume fine
        return (frac - f0) / dt, nominal

    def _relocate(self, task: str, host: str, why: str) -> list[tuple]:
        """Move compute ``task`` to ``host`` in the live run and carry
        its DAG-derived flows (producer sources / consumer destinations
        — the same :func:`follow_moves` rule the offline what-if uses)
        with it, restarting the carried transfers on believed-good
        routes."""
        acts: list[tuple] = [("move_task", task, host, why)]
        self.rs.move_task(task, host)
        for fname, side in follow_moves(self.graph, task, host).items():
            src, dst = self.rs.flow_ends(fname)
            if side == "src":
                src = host
            else:
                dst = host
            acts.append(("repath_flow", fname, f"{src}->{dst}", why))
            self._repath(fname, self._route_for(src, dst),
                         reset=True, src=src, dst=dst)
        return acts

    def _remaining_graph(self) -> tuple:
        """The remaining work as an MXDAG: unfinished tasks only, at
        their *remaining* sizes (ground-truth progress from the live
        run), with current placements/endpoints, keeping only edges
        between unfinished tasks (a finished predecessor is a satisfied
        dependency).  Returns ``(rem, alive)``."""
        from repro_torch.core.graph import MXDAG

        rs = self.rs
        prog = rs.progress()
        g = self.graph
        rem = MXDAG(f"{g.name}:replan@{rs.now:.6g}")
        alive = set()
        for name, t in g.tasks.items():
            frac = prog[name]
            if frac >= 1.0:
                continue
            alive.add(name)
            left = max(t.size * (1.0 - frac), 1e-9)
            unit = t.unit
            if unit is not None and unit > left:
                unit = left
            if t.kind is TaskKind.COMPUTE:
                rem.add(dataclasses.replace(
                    t, size=left, unit=unit, host=rs.task_host(name)))
            else:
                src, dst = rs.flow_ends(name)
                rem.add(dataclasses.replace(
                    t, size=left, unit=unit, src=src, dst=dst))
        for (s, d), e in g.edges.items():
            if s in alive and d in alive:
                rem.add_edge(s, d, pipelined=e.pipelined)
        return rem, alive

    def _replan_priorities(self) -> list[tuple]:
        """Warm MXDAGScheduler pass over the remaining work
        (:meth:`_remaining_graph`): schedules it on the believed
        cluster, and swaps the resulting priorities/policy into the
        running simulation.
        """
        rem, alive = self._remaining_graph()
        if not alive:
            return []
        # a task still stranded on a dead host (no relocation target was
        # found) cannot be scheduled on the believed cluster — the
        # scenario is unrecoverable and a priority shuffle won't fix it
        for name in alive:
            t = rem.tasks[name]
            ends = ((t.host,) if t.kind is TaskKind.COMPUTE
                    else (t.src, t.dst))
            if any(h in self.dead_hosts for h in ends):
                return []
        plan = self.scheduler.schedule(rem, self.belief_cluster())
        self.rs.set_priorities(plan.priorities, plan.policy)
        return [("set_priorities", len(plan.priorities), plan.policy,
                 "warm replan")]

    # -- fault handlers ------------------------------------------------
    def on_host_loss(self, host: str, restarted: Sequence[str]
                     ) -> list[tuple]:
        """React to an announced host failure: mark it dead, re-place
        every restarted compute stranded on it, re-path every restarted
        flow touching it, and warm-replan priorities on the survivors.
        ``restarted`` is what the failure actually reset (the live
        run's lineage closure) — the work list a real controller would
        get from its task tracker."""
        self.dead_hosts.add(host)
        acts: list[tuple] = []
        for name in restarted:
            t = self.graph.tasks[name]
            if t.kind is TaskKind.COMPUTE \
                    and self.rs.task_host(name) in self.dead_hosts:
                new = self._pick_host(t.proc, avoid={host})
                if new is not None:
                    acts += self._relocate(name, new,
                                           f"host {host} lost")
        carried = {a[1] for a in acts if a[0] == "repath_flow"}
        for name in restarted:
            if self.graph.tasks[name].kind is TaskKind.COMPUTE \
                    or name in carried:
                continue
            src, dst = self.rs.flow_ends(name)
            if src in self.dead_hosts or dst in self.dead_hosts:
                continue        # endpoint compute found no new home
            acts.append(("repath_flow", name, f"{src}->{dst}",
                         f"host {host} lost"))
            self._repath(name, self._route_for(src, dst))
        acts += self._replan_priorities()
        self.actions += acts
        return acts

    def on_link_recover(self, link: str, capacity: float) -> list[tuple]:
        """React to an announced port-up: restore the link's believed
        capacity (dropping the degraded mark entirely when it is back
        at nominal) and warm-replan so routes may reclaim it."""
        nominal = self.cluster.bandwidth(link)
        if capacity >= nominal - 1e-12:
            self.degraded.pop(link, None)
        else:
            self.degraded[link] = capacity
        acts = self._replan_priorities()
        self.actions += acts
        return acts

    # -- cost model -----------------------------------------------------
    def _move_arm(self, rem, task: str, new_host: str):
        """The what-if graph for speculatively re-executing ``task`` on
        ``new_host``: the remaining graph with the task restarted at
        FULL size (speculation pays the restart) and its carried flows
        (:func:`follow_moves`) restarted at full size on the moved
        endpoint — re-added even when already finished, because the
        live ``_relocate`` restarts them too."""
        from repro_torch.core.graph import MXDAG

        g = self.graph
        carried = follow_moves(g, task, new_host)
        present = set(rem.tasks) | {task} | set(carried)
        arm = MXDAG(f"{rem.name}:move:{task}")
        for name in sorted(present):
            if name == task:
                arm.add(dataclasses.replace(g.tasks[name], host=new_host))
            elif name in carried:
                src, dst = self.rs.flow_ends(name)
                if carried[name] == "src":
                    src = new_host
                else:
                    dst = new_host
                arm.add(dataclasses.replace(g.tasks[name],
                                            src=src, dst=dst))
            else:
                arm.add(rem.tasks[name])
        for (s, d), e in g.edges.items():
            if s in present and d in present:
                arm.add_edge(s, d, pipelined=e.pipelined)
        return arm

    def _speculation_veto(self, task: str, new_host: str,
                          est: float) -> Optional[str]:
        """Is speculatively re-executing ``task`` on ``new_host`` worth
        it?  Returns ``None`` to commit (charging the speculation
        budget and arming the cooldown) or the veto reason.

        Prices both arms with the compiled analytic critical path on
        the remaining graph: *stay* keeps the straggler at its observed
        rate fraction ``est``; *move* restarts it (and its carried
        flows) at full size on the new host.  The move must beat stay
        by the hysteresis margin — near-ties are not worth the restart
        risk.  Committed speculations are tracked; one that finishes
        later than projected doubles the cooldown (exponential backoff
        against flap-driven thrash), an on-time one resets it."""
        from repro_torch.core.arrayanalytic import analyze

        now = self.rs.now
        if self._spec_left <= 0:
            return "speculation budget exhausted"
        if now < self._spec_ok_at - 1e-12:
            return f"speculation cooldown until t={self._spec_ok_at:.4g}"
        rem, alive = self._remaining_graph()
        if task not in alive:
            return None         # raced with completion: nothing to price
        est = min(1.0, max(0.02, est))
        stay = analyze(rem, rsrc={task: est}).makespan
        timing = analyze(self._move_arm(rem, task, new_host))
        if timing.makespan >= stay * (1.0 - self.hysteresis):
            return (f"not worth it: move~{timing.makespan:.4g} vs "
                    f"stay~{stay:.4g}")
        self._spec_left -= 1
        self._spec_ok_at = now + self._cooldown
        self._pending.append(
            (task, now, timing.completion[timing.idx[task]]))
        return None

    def _speculation_feedback(self) -> None:
        """Score finished speculations: losing ones (actual duration
        beyond projection by more than the hysteresis margin) double
        the cooldown; winners reset it."""
        if not self._pending:
            return
        rs = self.rs
        still = []
        for task, t0, proj in self._pending:
            ft = rs.finished_at(task)
            if ft is None:
                still.append((task, t0, proj))
                continue
            if ft - t0 > proj * (1.0 + self.hysteresis) + 1e-9:
                self._cooldown *= 2.0
                self._spec_ok_at = max(self._spec_ok_at,
                                       rs.now + self._cooldown)
                self.declined.append(
                    (rs.now, task,
                     f"losing speculation ({ft - t0:.4g} vs projected "
                     f"{proj:.4g}); cooldown -> {self._cooldown:.4g}"))
            else:
                self._cooldown = self._base_cooldown
        self._pending = still

    def check(self) -> tuple[list[str], list[tuple]]:
        """One probe-tick reaction: feed the Monitor, diagnose
        stragglers, and act.  Returns ``(diagnoses, actions)``.

        - A *compute* straggler (slow executor) is speculatively
          re-executed: moved to a believed-healthy host, its
          DAG-derived flows carried along (re-fetching inputs).
        - *Network* stragglers are attributed to the fabric link most
          shared among their current routes; the belief capacity drops
          to the observed/expected rate ratio and each affected flow is
          re-pathed onto an ECMP alternate avoiding the suspect link,
          keeping transferred progress.
        """
        self.probe()
        if self.cost_aware:
            self._speculation_feedback()
        diagnoses: list[str] = []
        acts: list[tuple] = []
        mon = self.monitor
        rs = self.rs
        for s in mon.host_stragglers():
            host = rs.task_host(s.task)
            st = rs.started_at(s.task)
            if host is None or host in self.suspect_hosts \
                    or st is None or rs.finished_at(s.task) is not None:
                continue
            # lateness alone is not a slow executor: a task restarted
            # after an upstream fault is behind schedule yet progressing
            # at full rate, and re-executing it would thrash.  Require
            # the *observed* rate to be well below nominal.
            t = self.graph.tasks[s.task]
            elapsed = rs.now - st
            exp_dur = max(mon.expected.finish[s.task]
                          - mon.expected.start[s.task], 1e-12)
            if elapsed <= 1e-12 or (rs.progress()[s.task] * t.size
                                    / elapsed) > 0.7 * (t.size / exp_dur):
                continue
            self.suspect_hosts.add(host)
            diagnoses.append(f"compute straggler {s.task} on {host}")
            new = self._pick_host(t.proc, avoid={host})
            if new is None:
                continue
            if self.cost_aware:
                # observed / nominal rate fraction = frac * exp_dur / t
                est = rs.progress()[s.task] * exp_dur / elapsed
                veto = self._speculation_veto(s.task, new, est)
                if veto is not None:
                    self.declined.append((rs.now, s.task, veto))
                    continue
            acts += self._relocate(s.task, new,
                                   f"straggler on {host}")
        nets = []
        for s in mon.network_stragglers():
            if rs.finished_at(s.task) is not None \
                    or rs.started_at(s.task) is None:
                continue
            # lateness alone is not a bad route: a flow repathed off a
            # degraded link is behind schedule yet moving at full rate
            # on its new route, and blaming that route would cascade
            # false positives across the fabric.  Judge the *recent*
            # rate — since the last repath — against nominal.
            obs, nominal = self._recent_rate(s.task)
            if obs > 0.7 * nominal:
                continue
            nets.append(s)
        if nets:
            counts: dict[str, int] = {}
            for s in nets:
                for l in self.rs.flow_route(s.task):
                    if not is_nic_link(l):
                        counts[l] = counts.get(l, 0) + 1
            if counts:
                link = max(sorted(counts), key=counts.__getitem__)
                if link not in self.degraded:
                    est = self._estimate_link_factor(link, nets)
                    if est >= 0.7:
                        # mildly slow is ambient contention, not a
                        # fault — acting on it would thrash
                        link = None
                if link is not None and link not in self.degraded:
                    cap = self.cluster.bandwidth(link)
                    self.degraded[link] = cap * est
                    diagnoses.append(
                        f"degraded link {link} (~{est:.0%} of nominal)")
                    self._link_events[link] = \
                        self._link_events.get(link, 0) + 1
                    if self.cost_aware \
                            and self._link_events[link] > self.link_budget:
                        # a link diagnosed degraded this many times is
                        # flapping: stop paying the repath churn, keep
                        # the belief (routes avoid it where possible)
                        self.declined.append(
                            (rs.now, link,
                             f"link {link} flapped "
                             f"{self._link_events[link]}x; repath "
                             f"budget ({self.link_budget}) exhausted"))
                    else:
                        for s in nets:
                            if link not in self.rs.flow_route(s.task):
                                continue
                            src, dst = self.rs.flow_ends(s.task)
                            route = self._route_for(src, dst)
                            if link in route:
                                continue    # no alternate avoids it
                            acts.append(("repath_flow", s.task,
                                         f"{src}->{dst}",
                                         f"avoid {link}"))
                            self._repath(s.task, route)
        if acts:
            acts += self._replan_priorities()
        self.actions += acts
        return diagnoses, acts

    def _estimate_link_factor(self, link: str, stragglers) -> float:
        """Believed remaining capacity fraction of a suspect link: the
        median observed/expected progress-rate ratio over the straggling
        flows that traverse it (clamped away from 0 — a belief of zero
        would make the replanner treat the link as down)."""
        ratios = []
        for s in stragglers:
            if link not in self.rs.flow_route(s.task):
                continue
            obs_rate, exp_rate = self._recent_rate(s.task)
            ratios.append(obs_rate / max(exp_rate, 1e-12))
        if not ratios:
            return 0.5
        ratios.sort()
        return min(1.0, max(0.02, ratios[len(ratios) // 2]))


@dataclasses.dataclass
class NemesisReport:
    """Outcome of one Nemesis run."""

    makespan: float             # inf when the run never finished
    completed: bool
    tracker: RecoveryTracker
    result: object = None       # SimResult when completed

    @property
    def detection_rate(self) -> float:
        """Tracker detection rate (see RecoveryTracker)."""
        return self.tracker.detection_rate()


class Nemesis:
    """The fault-injection harness: drive a live run, hurt it on
    schedule, and let (or don't let) the controller fight back.

    ``probe_every`` is the controller's progress-report cadence (the
    detection latency floor for inferred faults).  With
    ``replan=False`` faults are injected but nothing reacts — the
    no-replan arm of the recovery benchmark; an unrecoverable fault
    then stalls the run and the report's makespan is ``inf``.

    Straggler semantics: a task's speed multiplier models its current
    *executor*.  When the controller speculatively moves a slowed
    compute task to another host, the harness restores its speed to
    nominal — the new executor is a different machine.
    """

    def __init__(self, schedule: Schedule, cluster: Cluster, *,
                 faults: Sequence[Fault],
                 replan: bool = True,
                 probe_every: float = 0.5,
                 scheduler: Optional[MXDAGScheduler] = None,
                 threshold: float = 0.2,
                 expected=None,
                 cost_aware: bool = False):
        self.schedule = schedule
        self.cluster = cluster
        self.faults = sorted(faults, key=lambda f: f.time)
        self.replan = replan
        self.probe_every = probe_every
        self.scheduler = scheduler
        self.threshold = threshold
        self.expected = expected
        self.cost_aware = cost_aware

    def _make_rs(self) -> ResumableSim:
        s = self.schedule
        sim = Simulator(s.graph, self.cluster, policy=s.policy,
                        priorities=s.priorities, releases=s.releases,
                        coflows=s.coflows, routes=s.routes or None)
        return ResumableSim(sim)

    def run(self, horizon: float = 1e9) -> NemesisReport:
        """Execute the scenario; returns the :class:`NemesisReport`.

        The loop advances the live simulation to the next fault time or
        probe tick (whichever is sooner), injects/reacts there, and
        repeats.  Deterministic by construction: the timeline is the
        sorted merge of the fault schedule and the fixed probe cadence.
        """
        rs = self._make_rs()
        tracker = RecoveryTracker()
        ctl = (ReplanController(self.schedule, self.cluster, rs,
                                scheduler=self.scheduler,
                                threshold=self.threshold,
                                expected=self.expected,
                                cost_aware=self.cost_aware,
                                spec_cooldown=2 * self.probe_every)
               if self.replan else None)
        self.controller = ctl       # exposed for post-run introspection
        slowed: dict[str, float] = {}
        faults = list(self.faults)
        open_recs: list[FaultRecord] = []
        next_probe = self.probe_every
        idle_probes = 0
        status = "paused"
        while True:
            t_fault = faults[0].time if faults else math.inf
            t = min(t_fault, next_probe if ctl is not None else math.inf)
            if t > horizon:
                status = rs.run_until(horizon, allow_stall=True)
                break
            status = rs.run_until(t, allow_stall=True)
            if status == "done":
                break
            if status == "stalled" and not faults:
                # nothing left to inject and nothing can move: without a
                # controller this is the no-replan arm's dead end; with
                # one, give it a final look before giving up
                if ctl is None:
                    break
                _, acts = ctl.check()
                self._executor_moves(rs, acts, slowed)
                if not acts:
                    break
                continue
            if status != "stalled":
                rs.advance_to(t)
            acted = False
            while faults and faults[0].time <= t:
                f = faults.pop(0)
                rec = tracker.injected(f, rs.now)
                self._inject(rs, f, rec, ctl, slowed)
                if not (rec.detected or ctl is None):
                    open_recs.append(rec)
                acted = True
            if ctl is not None and t >= next_probe - 1e-12:
                while next_probe <= t + 1e-12:
                    next_probe += self.probe_every
                diagnoses, acts = ctl.check()
                self._executor_moves(rs, acts, slowed)
                if diagnoses or acts:
                    idle_probes = 0
                    for rec in open_recs:
                        if rec.detected:
                            continue
                        # per-fault attribution: in a storm one probe
                        # tick may diagnose several faults at once —
                        # give each record only the diagnoses (and
                        # actions) naming its own victim
                        mine = [d for d in diagnoses
                                if self._matches(rec.fault, [d], ctl)]
                        if mine:
                            rec.detected = True
                            rec.detected_at = rs.now
                            rec.diagnosis = "; ".join(mine)
                            rec.actions += self._attributed(
                                rec.fault, acts, ctl)
                    open_recs = [r for r in open_recs if not r.detected]
                else:
                    idle_probes += 1
                acted = acted or bool(acts)
            if status == "stalled" and not acted:
                break
            if ctl is not None and idle_probes > 1000:
                break       # controller idle for 1000 probes: give up
        completed = status == "done" or rs.unfinished == 0
        if not completed and rs.unfinished:
            # drain whatever can still run (e.g. faults exhausted, no
            # controller, nothing stalled) up to the horizon
            status = rs.run_until(horizon, allow_stall=True)
            completed = status == "done"
        result = rs.result() if completed else None
        makespan = result.makespan if completed else math.inf
        for rec in tracker.records:
            rec.recovered = completed
        return NemesisReport(makespan=makespan, completed=completed,
                             tracker=tracker, result=result)

    # ------------------------------------------------------------------
    def _inject(self, rs: ResumableSim, f: Fault, rec: FaultRecord,
                ctl: Optional[ReplanController],
                slowed: dict[str, float]) -> None:
        """Apply one fault to the live run (and, for announced faults,
        notify the controller)."""
        if f.kind == "host_loss":
            restarted = rs.kill_host(f.target)
            if ctl is not None:
                rec.detected = True     # heartbeat loss is announced
                rec.detected_at = rs.now
                rec.diagnosis = f"host {f.target} lost heartbeat"
                acts = ctl.on_host_loss(f.target, restarted)
                rec.actions += acts
                self._executor_moves(rs, acts, slowed)
        elif f.kind == "rack_loss":
            # correlated blast radius: the ToR's links go dark and every
            # resident host dies with it, one atomic stroke
            hosts_r, links_r = rack_blast(self.cluster, f.target)
            for l in links_r:
                rs.set_link_bw(l, 0.0)
            per_host = [(h, rs.kill_host(h)) for h in hosts_r]
            if ctl is not None:
                rec.detected = True     # heartbeat loss is announced
                rec.detected_at = rs.now
                rec.diagnosis = (
                    f"rack {f.target} lost: {len(hosts_r)} hosts "
                    f"({', '.join(hosts_r)}), {len(links_r)} links dark")
                # mark the whole radius dead up front so relocation for
                # the first host never lands on a sibling about to die
                ctl.dead_hosts.update(hosts_r)
                for h, restarted in per_host:
                    acts = ctl.on_host_loss(h, restarted)
                    rec.actions += acts
                    self._executor_moves(rs, acts, slowed)
        elif f.kind == "link_recover":
            cap = self.cluster.bandwidth(f.target) * f.factor
            rs.set_link_bw(f.target, cap)
            if ctl is not None:
                rec.detected = True     # port-up is announced
                rec.detected_at = rs.now
                rec.diagnosis = (f"link {f.target} up at "
                                 f"{f.factor:g}x nominal")
                rec.actions += ctl.on_link_recover(f.target, cap)
        elif f.kind == "link_degrade":
            rs.scale_link(f.target, f.factor)
        else:
            rs.set_speed(f.target, f.factor)
            slowed[f.target] = f.factor

    @staticmethod
    def _executor_moves(rs: ResumableSim, acts: Sequence[tuple],
                        slowed: dict[str, float]) -> None:
        """The executor-follows-host rule: a slowed (straggling) task
        the controller just moved runs on a *new* machine — its speed
        multiplier returns to nominal (speculative re-execution)."""
        for a in acts:
            if a and a[0] == "move_task" and a[1] in slowed:
                rs.set_speed(a[1], 1.0)
                del slowed[a[1]]

    @staticmethod
    def _matches(fault: Fault, diagnoses: list[str],
                 ctl: ReplanController) -> bool:
        """Does a diagnosis batch explain ``fault``?  Straggler faults
        match a compute-straggler diagnosis naming the task or its
        host; link faults match a degraded-link diagnosis naming the
        link."""
        if fault.kind == "straggler":
            host = ctl.rs.task_host(fault.target)
            return any(d.startswith("compute straggler")
                       and (fault.target in d
                            or (host is not None and host in d))
                       for d in diagnoses)
        if fault.kind == "link_degrade":
            return any(d.startswith("degraded link")
                       and fault.target in d for d in diagnoses)
        return True

    @staticmethod
    def _attributed(fault: Fault, acts: Sequence[tuple],
                    ctl: ReplanController) -> list[tuple]:
        """The subset of a probe tick's actions that name the fault's
        victim (its target, or for stragglers the task's current host)
        — per-fault credit when a storm makes one tick react to several
        faults at once.  Falls back to the whole batch when nothing
        names the victim (e.g. a pure priority replan)."""
        keys = {fault.target}
        if fault.kind == "straggler":
            h = ctl.rs.task_host(fault.target)
            if h is not None:
                keys.add(h)
        mine = [a for a in acts
                if any(isinstance(x, str) and k in x
                       for x in a for k in keys)]
        return mine if mine else list(acts)
