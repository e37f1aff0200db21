"""Online multi-job service: admission, dispatch and live re-planning.

The paper's Principle 2 (§4.2) is altruism *across* jobs sharing a
cluster; this module turns the offline multi-job scheduler into a
service with a request stream (the ROADMAP "millions of users" path).
The front end follows the MDBconductor shape (SNIPPETS.md §3): for each
incoming DAG it estimates a footprint (isolated analytic critical path,
total compute work, total flow volume), grows the placement domain to
cover the job's hosts, and admits, queues or rejects based on the load
already conducted.  Admitted jobs are spliced into one live
:class:`~repro_torch.core.arraysim.ResumableSim` session via
``admit_graph`` — the history is never re-simulated — and on every
admission and completion the altruistic priority classes are recomputed
over the currently-running jobs and swapped in with ``set_priorities``.
Finished jobs are retired from the engine so the hot arrays stay sized
to the running set, not the history.

Everything here is deterministic: the same arrival stream (e.g. from
:func:`repro_torch.core.builders.poisson_jobs`) produces the same admission
log, the same JCTs and the same rejections, run after run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import arrayanalytic
from repro_torch.core.cluster import Cluster
from repro_torch.core.graph import MXDAG
from repro_torch.core.schedule import AltruisticMultiScheduler
from repro_torch.core.simulator import Simulator
from repro_torch.core.task import TaskKind

EPS = 1e-9

_POLICIES = ("altruistic", "fifo", "fair")


@dataclass
class JobStats:
    """Per-job service record: footprint estimate and observed times."""

    name: str
    submitted: float
    cp: float                 # isolated analytic critical path (seconds)
    work: float               # total compute seconds
    volume: float             # total flow volume (link-seconds)
    status: str = "queued"    # queued | running | done | rejected
    order: int = -1           # admission sequence number (-1 = never)
    admitted: Optional[float] = None
    finished: Optional[float] = None

    @property
    def jct(self) -> Optional[float]:
        """Completion time minus submission time (None while running)."""
        if self.finished is None:
            return None
        return self.finished - self.submitted

    @property
    def queue_delay(self) -> Optional[float]:
        """Admission time minus submission time (None if never admitted)."""
        if self.admitted is None:
            return None
        return self.admitted - self.submitted


def footprint(graph: MXDAG) -> tuple[float, float, float]:
    """Estimate a job's resource footprint from its isolated analytics.

    Returns ``(cp, work, volume)``: the analytic critical-path length
    (the job's lower-bound running time alone on the cluster), the total
    compute seconds and the total flow volume.  This is the
    MDBconductor move — size the request before picking where (and
    whether) to run it — computed from the same compiled forward pass
    the altruistic scheduler uses, so the estimate is free when the job
    is later admitted (the pass is memoized per graph version).
    """
    cp = arrayanalytic.analyze(graph).makespan if graph.tasks else 0.0
    work = 0.0
    volume = 0.0
    for t in graph.tasks.values():
        if t.kind is TaskKind.COMPUTE:
            work += t.size
        else:
            volume += t.size
    return cp, work, volume


def _job_hosts(graph: MXDAG) -> set:
    """Hosts a bound job touches (compute placements + flow endpoints)."""
    hosts = set()
    for t in graph.tasks.values():
        if t.kind is TaskKind.COMPUTE:
            if t.host is not None:
                hosts.add(t.host)
        else:
            if t.src is not None:
                hosts.add(t.src)
            if t.dst is not None:
                hosts.add(t.dst)
    return hosts


def _quantile(sorted_xs: list, q: float) -> float:
    """Nearest-rank quantile of an ascending list (0 on empty)."""
    if not sorted_xs:
        return 0.0
    k = max(0, min(len(sorted_xs) - 1,
                   math.ceil(q * len(sorted_xs)) - 1))
    return sorted_xs[k]


class AdmissionService:
    """MDBconductor-style front end over a live :class:`ResumableSim`.

    Jobs are submitted as ``(graph, at)`` in non-decreasing time order.
    Each submission sizes the job (:func:`footprint`), grows the
    placement domain to its hosts, and either admits it into the running
    engine (``admit_graph`` at the arrival time), parks it in a bounded
    FIFO queue when the cluster is over ``max_backlog`` of estimated
    critical-path work, or rejects it outright when the queue is full
    (or the job alone exceeds the backlog budget and so could never be
    admitted).  Queued jobs are re-considered, in order, at every job
    completion.  After every admission and completion the priority
    classes are recomputed per ``policy`` and swapped in live:

    - ``"altruistic"`` — :class:`AltruisticMultiScheduler` over the
      running jobs (Principle 2 demotion, compiled passes);
    - ``"fifo"`` — strict admission-order classes (earlier job wins
      every resource conflict);
    - ``"fair"`` — no classes, plain max-min fair sharing.

    The whole pipeline is deterministic for a given arrival stream; the
    admission log is exposed as :attr:`log` for exactly that test.
    """

    def __init__(self, cluster: Cluster, *,
                 policy: str = "altruistic",
                 analytic: str = "auto",
                 max_backlog: float = math.inf,
                 queue_limit: Optional[int] = None,
                 batch: bool = True,
                 horizon: float = 1e15):
        """:param cluster: the shared cluster every job runs on.
        :param policy: ``"altruistic"`` | ``"fifo"`` | ``"fair"``
            re-prioritisation run on each admission/completion.
        :param analytic: substrate for the altruistic passes
            (forwarded to :class:`AltruisticMultiScheduler`).
        :param max_backlog: admission budget in estimated critical-path
            seconds; a job is queued while the running backlog plus its
            own critical path exceeds this.  ``inf`` = admit always.
        :param queue_limit: queued jobs beyond this are rejected
            (``None`` = unbounded queue).
        :param batch: forwarded to ``Simulator.resumable``.
        :param horizon: forwarded to ``Simulator.resumable``.
        """
        if policy not in _POLICIES:
            raise ValueError(f"unknown service policy {policy!r}; "
                             f"pick one of {_POLICIES}")
        self.cluster = cluster
        self.policy = policy
        self.max_backlog = float(max_backlog)
        self.queue_limit = queue_limit
        self.stats: dict[str, JobStats] = {}
        self.domain: set = set()
        self.log: list[tuple] = []
        self.restarted: list[str] = []
        self._scheduler = AltruisticMultiScheduler(analytic=analytic)
        self._batch = bool(batch)
        self._horizon = float(horizon)
        self._rs = None
        self._graphs: dict[str, MXDAG] = {}     # admitted, not retired
        self._active: list[str] = []            # admitted, unfinished
        self._zombies: list[str] = []           # finished, not retired
        self._queue: list[str] = []             # waiting, FIFO
        self._revives: list[tuple] = []         # (t, host), time-sorted
        self._seq = 0

    # -- introspection -------------------------------------------------
    @property
    def now(self) -> float:
        """The service clock (the engine's paused clock; 0 if idle)."""
        return self._rs.now if self._rs is not None else 0.0

    @property
    def running(self) -> list[str]:
        """Names of admitted, unfinished jobs (admission order)."""
        return list(self._active)

    @property
    def queued(self) -> list[str]:
        """Names of jobs waiting for admission (FIFO order)."""
        return list(self._queue)

    def backlog(self, at: Optional[float] = None) -> float:
        """Estimated critical-path seconds still in flight at ``at``:
        per running job, the optimistic remainder
        ``max(0, admitted + cp - at)``."""
        t = self.now if at is None else at
        total = 0.0
        for name in self._active:
            s = self.stats[name]
            total += max(0.0, s.admitted + s.cp - t)
        return total

    # -- the request path ----------------------------------------------
    def submit(self, graph: MXDAG, at: float) -> str:
        """Offer a job to the service at time ``at``.

        Advances the engine to ``at`` first (reaping completions, which
        may drain the queue), then admits, queues or rejects per the
        backlog budget.  Returns ``"admitted"``, ``"queued"`` or
        ``"rejected"``.
        """
        name = graph.name
        if name in self.stats:
            raise ValueError(f"duplicate job name {name!r}")
        jobs = {t.job for t in graph.tasks.values()}
        if jobs != {name}:
            raise ValueError(
                f"job {name!r}: every task's job field must equal the "
                f"graph name (got {sorted(jobs)}); pass job={name!r} to "
                f"the builder so retire_job can find the rows")
        at = float(at)
        if at < self.now - EPS:
            raise ValueError(f"submissions must arrive in time order "
                             f"(t={at} < clock {self.now})")
        self._advance(at)
        cp, work, volume = footprint(graph)
        self.stats[name] = JobStats(name=name, submitted=at, cp=cp,
                                    work=work, volume=volume)
        self._graphs[name] = graph
        if not self._queue and self._fits(cp, at):
            self._admit(name, at)
            verdict = "admitted"
        elif cp <= self.max_backlog and (
                self.queue_limit is None
                or len(self._queue) < self.queue_limit):
            self._queue.append(name)
            verdict = "queued"
        else:
            self.stats[name].status = "rejected"
            del self._graphs[name]
            verdict = "rejected"
        self.log.append(("submit", at, name, verdict))
        return verdict

    def kill_host(self, host: str, at: float, *,
                  downtime: Optional[float] = None) -> list:
        """Fail ``host`` at time ``at`` mid-stream: advance to ``at``,
        kill it on the live engine, and re-plan the survivors (the
        recovery-drill hook — jobs keep arriving afterwards).  With
        ``downtime`` the host reboots (``revive_host``) that many
        seconds later; without it the host stays dark, so every job
        bound to it deadlocks — pass a downtime unless the stream
        avoids the host.  Returns the restarted task names."""
        at = float(at)
        self._advance(at)
        restarted = self._rs.kill_host(host) if self._rs is not None \
            else []
        self.restarted.extend(restarted)
        self.log.append(("kill", at, host, len(restarted)))
        if downtime is not None and self._rs is not None:
            self._revives.append((at + float(downtime), host))
            self._revives.sort(key=lambda e: e[0])
        self._replan()
        return restarted

    def finish(self):
        """Drain the engine and the queue to completion; returns self."""
        self._advance(math.inf)
        if self._queue:
            raise RuntimeError(
                f"stream drained with {len(self._queue)} jobs still "
                f"queued — max_backlog too small for the workload")
        return self

    # -- results -------------------------------------------------------
    def jcts(self) -> dict[str, float]:
        """Observed JCT per completed job."""
        return {n: s.jct for n, s in self.stats.items()
                if s.finished is not None}

    def summary(self) -> dict:
        """Aggregate service metrics (the online-benchmark row source):
        submitted/completed/rejected counts, rejection rate, throughput
        (jobs per unit time over the span), and mean/p50/p99 JCT."""
        done = sorted(s.jct for s in self.stats.values()
                      if s.finished is not None)
        n_sub = len(self.stats)
        n_rej = sum(1 for s in self.stats.values()
                    if s.status == "rejected")
        span = max((s.finished for s in self.stats.values()
                    if s.finished is not None), default=0.0)
        return {
            "submitted": n_sub,
            "completed": len(done),
            "rejected": n_rej,
            "rejection_rate": n_rej / n_sub if n_sub else 0.0,
            "makespan": span,
            "throughput": len(done) / span if span > 0 else 0.0,
            "mean_jct": sum(done) / len(done) if done else 0.0,
            "p50_jct": _quantile(done, 0.50),
            "p99_jct": _quantile(done, 0.99),
        }

    # -- internals -----------------------------------------------------
    def _fits(self, cp: float, at: float) -> bool:
        return self.backlog(at) + cp <= self.max_backlog + EPS

    def _grow(self, graph: MXDAG) -> None:
        hosts = _job_hosts(graph)
        unknown = hosts - set(self.cluster.hosts)
        if unknown:
            raise KeyError(
                f"job {graph.name!r} is bound to hosts outside the "
                f"cluster: {sorted(unknown)}")
        grown = hosts - self.domain
        if grown:
            self.domain |= grown
            self.log.append(("grow", self.now, graph.name,
                             tuple(sorted(grown))))

    def _admit(self, name: str, at: float) -> None:
        graph = self._graphs[name]
        self._grow(graph)
        s = self.stats[name]
        s.status = "running"
        s.admitted = at
        s.order = self._seq
        self._seq += 1
        if self._rs is None or at <= 0.0:
            # First job, or an admission at t=0 (where admit_graph has
            # no pre-history to preserve): (re)build the engine over the
            # merged running set with each job released at its admission
            # time — bit-identical to the spliced path by the
            # admit_graph invariant.
            self._active.append(name)
            graphs = [self._graphs[j] for j in self._active]
            merged = AltruisticMultiScheduler._merge(graphs) \
                if len(graphs) > 1 else graphs[0]
            rel = {}
            for j in self._active:
                tj = self.stats[j].admitted
                if tj and tj > 0.0:
                    rel.update({nm: tj for nm in self._graphs[j].tasks})
            sim = Simulator(merged, self.cluster, releases=rel)
            self._rs = sim.resumable(self._horizon, batch=self._batch)
        else:
            self._rs.admit_graph(graph, at=at)
            self._active.append(name)
            self._retire_zombies()
        self.log.append(("admit", at, name))
        self._replan()

    def _retire_zombies(self) -> None:
        # retire_job refuses to empty the engine, so zombies are
        # reaped lazily, right after the next admission.
        while self._zombies and len(self._graphs) > 1:
            z = self._zombies.pop(0)
            self._rs.retire_job(z)
            del self._graphs[z]

    def _replan(self) -> None:
        if self._rs is None or not self._active:
            return
        if self.policy == "fair":
            self._rs.set_priorities({}, "fair")
            self._rs._ops["settle"]()
            return
        if self.policy == "fifo":
            prio = {}
            for j in self._active:
                rank = float(self.stats[j].order)
                for nm in self._graphs[j].tasks:
                    prio[nm] = rank
        else:
            graphs = [self._graphs[j] for j in self._active]
            prio = self._scheduler.schedule(graphs,
                                            self.cluster).priorities
        self._rs.set_priorities(prio, "priority")
        # settle immediately: peek_next does not, and an unsettled
        # re-prioritisation can move the next event earlier
        self._rs._ops["settle"]()

    def _advance(self, t: float) -> None:
        if self._rs is None:
            return
        while True:
            # re-read the handle every iteration: a _reap below can
            # admit a queued job, and admit_graph swaps the engine
            rs = self._rs
            tn = rs._ops["peek"]()
            if self._revives and self._revives[0][0] <= t \
                    and (tn is None or self._revives[0][0] <= tn):
                tr, host = self._revives.pop(0)
                if tr > rs.now:
                    rs.advance_to(tr)
                rs.revive_host(host)
                rs._ops["settle"]()
                self.log.append(("revive", tr, host))
                continue
            if tn is None or tn > t:
                break
            rs.run_until(tn)
            self._reap()
        if t is not math.inf and t > rs.now:
            rs.advance_to(t)
        assert rs is self._rs

    def _reap(self) -> None:
        rs = self._rs
        state = rs._ops["state"]()
        fin = state["finished"]
        idx = rs._idx
        now = state["now"]
        done = []
        for name in self._active:
            fins = [fin[idx[nm]] for nm in self._graphs[name].tasks]
            if all(f is not None for f in fins):
                done.append((name, max(fins)))
        if not done:
            return
        for name, t_done in done:
            s = self.stats[name]
            s.status = "done"
            s.finished = t_done
            self._active.remove(name)
            self._zombies.append(name)
            self.log.append(("done", t_done, name))
        self._replan()
        while self._queue and self._fits(self.stats[self._queue[0]].cp,
                                         now):
            self._admit(self._queue.pop(0), now)


def run_stream(cluster: Cluster, arrivals, *,
               policy: str = "altruistic",
               faults=(), fault_downtime: float = 1.0,
               **kwargs) -> AdmissionService:
    """Feed a ``[(t, graph), ...]`` arrival stream (and optional
    ``[(t, host), ...]`` host-kill faults, each rebooting after
    ``fault_downtime``) through an :class:`AdmissionService` and drain
    it; returns the service with its stats populated.  The one-call
    entry the online benchmark, the determinism tests and the recovery
    drill all share."""
    svc = AdmissionService(cluster, policy=policy, **kwargs)
    events = sorted(
        [(float(t), 0, i, g) for i, (t, g) in enumerate(arrivals)]
        + [(float(t), 1, i, h) for i, (t, h) in enumerate(faults)],
        key=lambda e: e[:3])
    for t, tag, _i, payload in events:
        if tag == 0:
            svc.submit(payload, at=t)
        else:
            svc.kill_host(payload, at=t, downtime=fault_downtime)
    return svc.finish()


def online_recovery_drill(cluster, arrivals, *, host: str, at: float,
                          downtime: float = 1.0,
                          policy: str = "altruistic", **kwargs) -> dict:
    """Smoke-level online fault drill: run the same arrival stream
    twice — clean, and with ``host`` failing at ``at`` (rebooting
    ``downtime`` later) while jobs keep arriving — and report the
    p99-JCT degradation and restart count.  Informational only (no
    gate): the live engine restarts the lost lineage and the service
    re-plans around the hole."""
    clean = run_stream(cluster, arrivals, policy=policy, **kwargs)
    hurt = run_stream(cluster, arrivals, policy=policy,
                      faults=[(at, host)], fault_downtime=downtime,
                      **kwargs)
    cs, hs = clean.summary(), hurt.summary()
    return {
        "clean_p99_jct": cs["p99_jct"],
        "fault_p99_jct": hs["p99_jct"],
        "degradation": (hs["p99_jct"] / cs["p99_jct"]
                        if cs["p99_jct"] > 0 else 1.0),
        "restarted": len(hurt.restarted),
        "clean_completed": cs["completed"],
        "fault_completed": hs["completed"],
    }
