"""Fault-tolerant training runtime."""
from repro_torch.runtime.fault import (
    LoopConfig, SimulatedFailure, StepMonitor, StragglerReport,
    recovery_drill, run_training,
)

__all__ = ["LoopConfig", "SimulatedFailure", "StepMonitor",
           "StragglerReport", "recovery_drill", "run_training"]
