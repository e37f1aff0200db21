"""Fault-tolerant training runtime: the port of the JAX package's
``repro.runtime.fault``.

- periodic (optionally async) checkpointing with atomic rename,
- crash/restart: the loop resumes from the latest checkpoint, and the
  deterministic data pipeline replays the exact step's batch,
- failure injection for tests (``fail_at_step``),
- straggler detection: per-step wall-time EWMA plus MXDAG-based
  attribution (§4.3 of the paper — compute vs network straggler) when a
  step MXDAG is provided,
- ``recovery_drill``: faults injected into a live simulation of the step
  MXDAG, recovery measured with and without replanning,
- data parallelism: ``run_training`` runs on every rank of a process
  group; rank 0 writes the checkpoints and every rank waits for each
  write, so a restart reads the same step everywhere.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core.graph import MXDAG
from repro_torch.core.monitor import Monitor
from repro_torch.core.simulator import SimResult


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    ewma: float
    kind: str                  # "step-time" | "compute" | "network"
    detail: str = ""


class StepMonitor:
    """EWMA wall-time monitor; with an expected step MXDAG it attributes
    anomalies to compute vs network (paper §4.3)."""

    def __init__(self, *, alpha: float = 0.2, threshold: float = 1.5,
                 step_graph: Optional[MXDAG] = None,
                 expected: Optional[SimResult] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self.reports: list[StragglerReport] = []
        self.mxdag_monitor = (Monitor(step_graph, expected)
                              if step_graph is not None
                              and expected is not None else None)

    def record(self, step: int, seconds: float,
               task_progress: Optional[dict[str, float]] = None
               ) -> Optional[StragglerReport]:
        if self.ewma is None:
            self.ewma = seconds
            return None
        is_slow = seconds > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        if not is_slow:
            return None
        kind, detail = "step-time", ""
        if self.mxdag_monitor is not None and task_progress:
            for task, frac in task_progress.items():
                self.mxdag_monitor.observe(task, frac, seconds)
            hosts = self.mxdag_monitor.host_stragglers()
            nets = self.mxdag_monitor.network_stragglers()
            if nets and (not hosts or nets[0].lag >= hosts[0].lag):
                kind, detail = "network", nets[0].task
            elif hosts:
                kind, detail = "compute", hosts[0].task
        rep = StragglerReport(step=step, step_time=seconds,
                              ewma=self.ewma, kind=kind, detail=detail)
        self.reports.append(rep)
        return rep


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    ckpt_async: bool = False
    keep: int = 3
    fail_at_step: Optional[int] = None      # failure injection (tests)
    max_restarts: int = 3
    # also save after the last step (as the JAX loop always does); a run
    # that only drills a restart can skip that write
    ckpt_final: bool = True


def recovery_drill(schedule, cluster, *, faults=None, n_faults: int = 2,
                   seed: int = 0, probe_every: float = 0.5,
                   horizon: float = 1e9, campaign: str = "random",
                   cost_aware: bool = False) -> dict:
    """Game-day drill for a step schedule: inject faults into a live DES
    of the step MXDAG and measure recovery with vs without replanning.

    The runtime-side entry point to :mod:`repro_torch.core.nemesis`: given the
    :class:`~repro_torch.core.schedule.Schedule` of one training step (the
    same graph a :class:`StepMonitor` attributes stragglers on), it
    derives a seeded fault schedule (when ``faults`` is not given),
    runs the no-replan, replan, and cost-aware-replan arms, and returns
    a comparable summary — what an SRE would ask of the runtime before
    trusting it: *if a host dies mid-step, does the controller notice,
    and what does the step time become?*

    :param campaign: shape of the derived fault schedule when
        ``faults`` is not given — ``"random"`` (independent faults
        spread over the step, :func:`~repro_torch.core.nemesis.random_faults`)
        or ``"storm"`` (distinct overlapping faults packed into a tight
        window, :func:`~repro_torch.core.nemesis.fault_storm`; on a fabric
        cluster the storm mix also samples correlated ``rack_loss``
        blast-radius faults).
    :param cost_aware: run the *replan* arm with the cost-aware
        controller (analytic worth-it model, hysteresis, bounded
        speculation budget) instead of the always-act one; the
        always-act arm is still reported as ``replan`` and the chosen
        arm's makespan as ``cost_replan``.
    :returns: dict with ``no_replan``/``replan``/``cost_replan``
        makespans, the fault list, ``detection_rate``, ``recovered``,
        and the markdown recovery ``report``.
    """
    from repro_torch.core.nemesis import (BASE_FAULT_KINDS, Nemesis,
                                    fault_storm, random_faults,
                                    tor_groups)

    expected = schedule.simulate(cluster)
    if faults is None:
        if campaign == "storm":
            kinds = BASE_FAULT_KINDS
            if tor_groups(cluster):
                kinds = kinds + ("rack_loss",)
            faults = fault_storm(schedule.graph, cluster,
                                 horizon=expected.makespan,
                                 n=n_faults, seed=seed, kinds=kinds)
        elif campaign == "random":
            faults = random_faults(schedule.graph, cluster,
                                   horizon=expected.makespan,
                                   n=n_faults, seed=seed)
        else:
            raise ValueError(f"unknown campaign {campaign!r} "
                             "(want 'random' or 'storm')")
    arm_no = Nemesis(schedule, cluster, faults=faults, replan=False,
                     probe_every=probe_every,
                     expected=expected).run(horizon)
    arm_yes = Nemesis(schedule, cluster, faults=faults, replan=True,
                      probe_every=probe_every,
                      expected=expected).run(horizon)
    arm_cost = (Nemesis(schedule, cluster, faults=faults, replan=True,
                        probe_every=probe_every, expected=expected,
                        cost_aware=True).run(horizon)
                if cost_aware else arm_yes)
    return {
        "baseline": expected.makespan,
        "faults": [dataclasses.asdict(f) for f in faults],
        "no_replan": arm_no.makespan,
        "replan": arm_yes.makespan,
        "cost_replan": arm_cost.makespan,
        "detection_rate": arm_cost.detection_rate,
        "recovered": arm_cost.completed,
        "report": arm_cost.tracker.report(),
    }


def _block_until_ready(state: dict) -> None:
    """Wait for the step's device work (JAX: ``block_until_ready``)."""
    dev = state["params"].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_training(loop: LoopConfig, *,
                 train_step: Callable,          # (state, batch) -> (state, metrics)
                 init_state: Callable,          # () -> state
                 batch_at: Callable,            # (step) -> batch
                 monitor: Optional[StepMonitor] = None,
                 on_step: Optional[Callable] = None,
                 group: Optional[dist.ProcessGroup] = None) -> dict:
    """Crash-safe training loop.  Returns a summary dict; beside JAX's
    keys it has the seconds each checkpoint write (``save_seconds``; for
    an async write, the snapshot) and each restore took.

    Under a process ``group`` every rank runs the loop (the same steps,
    the same injected failure); rank 0 alone writes each checkpoint (an
    async one is joined first) and every rank then waits at a barrier, so
    a restart finds the same ``latest_step`` on every rank."""
    restarts = 0
    history: list[float] = []
    seconds = {"save_seconds": [], "restore_seconds": []}
    injected = {"armed": loop.fail_at_step is not None}
    writer = group is None or group.rank() == 0
    state = None

    while True:
        # ---- (re)start: restore or init --------------------------------
        last = ckpt_lib.latest_step(loop.ckpt_dir)
        state = None            # let the old state go before the new one
        state = init_state()
        start_step = 0
        if last is not None:
            t0 = time.perf_counter()
            state = ckpt_lib.restore(loop.ckpt_dir, last, state)
            _block_until_ready(state)
            seconds["restore_seconds"].append(time.perf_counter() - t0)
            start_step = last + 1
        try:
            pending = None
            for step in range(start_step, loop.total_steps):
                if injected["armed"] and step == loop.fail_at_step:
                    injected["armed"] = False
                    raise SimulatedFailure(f"injected at step {step}")
                t0 = time.monotonic()
                batch = batch_at(step)
                state, metrics = train_step(state, batch)
                _block_until_ready(state)
                dt = time.monotonic() - t0
                history.append(float(metrics.get("loss", float("nan"))))
                if monitor is not None:
                    monitor.record(step, dt)
                if on_step is not None:
                    on_step(step, metrics)
                if (step + 1) % loop.ckpt_every == 0 or (
                        loop.ckpt_final and step == loop.total_steps - 1):
                    t0 = time.perf_counter()
                    if writer and loop.ckpt_async:
                        pending = ckpt_lib.save_async(
                            loop.ckpt_dir, step, state, keep=loop.keep)
                    elif writer:
                        ckpt_lib.save(loop.ckpt_dir, step, state,
                                      keep=loop.keep)
                    if group is not None:
                        if pending is not None:
                            pending.join()
                            pending = None
                        dist.barrier(group=group)
                    seconds["save_seconds"].append(time.perf_counter() - t0)
            if pending is not None:
                pending.join()
            return {"completed": True, "restarts": restarts,
                    "final_step": loop.total_steps - 1,
                    "loss_history": history, **seconds}
        except SimulatedFailure:
            restarts += 1
            if restarts > loop.max_restarts:
                raise
            # loop re-enters: restore from latest checkpoint
