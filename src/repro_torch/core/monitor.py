"""Runtime monitoring & straggler identification over an MXDAG (§4.3).

Because MXDAG distinguishes compute from network tasks, lagging progress on
a node immediately identifies *which kind* of straggler it is — "traditional
DAG cannot distinguish those two kinds of stragglers".  The monitor also
re-estimates task sizes from observed progress and recomputes the critical
path so the scheduler can replan at runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.graph import MXDAG
from repro_torch.core.simulator import SimResult
from repro_torch.core.task import MXTask, TaskKind


@dataclasses.dataclass
class Straggler:
    """A task projected to finish later than its expected schedule."""

    task: str
    kind: TaskKind          # host straggler vs network straggler
    expected_finish: float
    projected_finish: float

    @property
    def lag(self) -> float:
        """Projected minus expected finish time (seconds late)."""
        return self.projected_finish - self.expected_finish


@dataclasses.dataclass
class Observation:
    """One runtime progress report for a task."""

    time: float
    fraction: float         # fraction of the task's work completed


class Monitor:
    """Runtime introspection: progress reports vs the expected schedule."""

    def __init__(self, graph: MXDAG, expected: SimResult,
                 *, threshold: float = 0.2):
        """``threshold``: relative lag beyond which a task is a straggler."""
        self.graph = graph
        self.expected = expected
        self.threshold = threshold
        self.obs: dict[str, Observation] = {}

    def observe(self, task: str, fraction: float, time: float) -> None:
        """Record that ``task`` had completed ``fraction`` at ``time``.

        ``fraction`` is clamped to [0, 1]: progress probes built on
        noisy byte/FLOP counters routinely report slightly-negative or
        >100% fractions at the edges, and a negative fraction would
        otherwise poison :meth:`projected_finish`'s rate estimate with a
        negative rate (projecting finish into the past).
        """
        if task not in self.graph.tasks:
            raise KeyError(task)
        self.obs[task] = Observation(time=time,
                                     fraction=min(1.0, max(0.0, fraction)))

    # ------------------------------------------------------------------
    def projected_finish(self, task: str) -> Optional[float]:
        """Linear extrapolation from observed progress."""
        o = self.obs.get(task)
        if o is None:
            return None
        if o.fraction >= 1.0:
            return o.time
        exp_start = self.expected.start[task]
        if o.fraction <= 0.0:
            # not started: shift the expected duration to start "now"
            dur = self.expected.finish[task] - exp_start
            return max(o.time, exp_start) + dur
        rate = o.fraction / max(o.time - exp_start, 1e-12)
        return o.time + (1.0 - o.fraction) / rate

    def stragglers(self) -> list[Straggler]:
        """Observed tasks lagging beyond the relative threshold."""
        out = []
        for name, o in sorted(self.obs.items()):
            proj = self.projected_finish(name)
            exp = self.expected.finish[name]
            dur = max(exp - self.expected.start[name], 1e-12)
            if proj is not None and proj > exp + self.threshold * dur:
                out.append(Straggler(task=name,
                                     kind=self.graph.tasks[name].kind,
                                     expected_finish=exp,
                                     projected_finish=proj))
        return out

    def host_stragglers(self) -> list[Straggler]:
        """Stragglers among compute tasks."""
        return [s for s in self.stragglers() if s.kind is TaskKind.COMPUTE]

    def network_stragglers(self) -> list[Straggler]:
        """Stragglers among flows."""
        return [s for s in self.stragglers() if s.kind is TaskKind.NETWORK]

    # ------------------------------------------------------------------
    def reestimated_graph(self) -> MXDAG:
        """Graph with task sizes re-scaled by observed progress rates."""
        g = self.graph.copy()
        for name, o in self.obs.items():
            proj = self.projected_finish(name)
            if proj is None or o.fraction >= 1.0:
                continue
            t = g.tasks[name]
            exp_start = self.expected.start[name]
            new_size = max(proj - exp_start, 1e-12)
            unit = t.unit
            if unit is not None:
                unit = unit * new_size / max(t.size, 1e-12)
            g.replace_task(dataclasses.replace(t, size=new_size, unit=unit))
        return g

    def replan_critical_path(self, release: Optional[dict[str, float]]
                             = None) -> list[str]:
        """New critical path after folding in runtime observations.

        Observed tasks are pinned to their starts: each one's planned
        start is threaded into the analytic pass as a ``release`` (the
        progress-rate re-estimation already extrapolates from that
        start), so a branch that began late stays late in the replanned
        path instead of being evaluated as if it could restart at t=0.
        Pass ``release`` explicitly to override — e.g. with actually
        observed start times when they diverge from the plan.
        """
        if release is None:
            release = {n: self.expected.start[n] for n in self.obs}
        return self.reestimated_graph().critical_path(release=release)
