"""Fault-tolerant training runtime: the port of the JAX package's
``repro.runtime.fault``.

- periodic (optionally async) checkpointing with atomic rename,
- crash/restart: the loop resumes from the latest checkpoint, and the
  deterministic data pipeline replays the exact step's batch,
- failure injection for tests (``fail_at_step``),
- straggler detection by a per-step wall-time EWMA.

The JAX runtime also attributes a slow step to compute or network on the
step's MXDAG, and drills recovery on a simulated cluster; both need the
port's own copy of ``repro.core`` and wait for multi-GPU sync (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    ewma: float
    kind: str                  # "step-time" (compute/network: item 5)
    detail: str = ""


class StepMonitor:
    """EWMA wall-time monitor: a step slower than ``threshold`` × the
    running mean is reported."""

    def __init__(self, *, alpha: float = 0.2, threshold: float = 1.5):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self.reports: list[StragglerReport] = []

    def record(self, step: int, seconds: float
               ) -> Optional[StragglerReport]:
        if self.ewma is None:
            self.ewma = seconds
            return None
        is_slow = seconds > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        if not is_slow:
            return None
        rep = StragglerReport(step=step, step_time=seconds, ewma=self.ewma,
                              kind="step-time")
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
                 on_step: Optional[Callable] = None) -> dict:
    """Crash-safe training loop.  Returns a summary dict; beside JAX's
    keys it has the seconds each checkpoint write (``save_seconds``; for
    an async write, the snapshot) and each restore took."""
    restarts = 0
    history: list[float] = []
    seconds = {"save_seconds": [], "restore_seconds": []}
    injected = {"armed": loop.fail_at_step is not None}
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
                    if loop.ckpt_async:
                        pending = ckpt_lib.save_async(
                            loop.ckpt_dir, step, state, keep=loop.keep)
                    else:
                        ckpt_lib.save(loop.ckpt_dir, step, state,
                                      keep=loop.keep)
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
