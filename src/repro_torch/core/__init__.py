"""MXDAG core: the paper's abstraction, calculus, schedulers and simulator."""
from repro_torch.core.task import MXTask, TaskKind, compute, flow
from repro_torch.core.graph import MXDAG, Edge, NodeTiming
from repro_torch.core.fabric import Link, Topology
from repro_torch.core.cluster import Cluster, Host
from repro_torch.core.arraysim import vectorized_waterfill
from repro_torch.core.simulator import SimResult, Simulator, max_min_rates, simulate
from repro_torch.core.schedule import (
    AltruisticMultiScheduler,
    CoflowConfig,
    FairShareScheduler,
    MXDAGScheduler,
    PlacementScheduler,
    Schedule,
    auto_coflows,
)
from repro_torch.core.baselines import (
    BASELINES,
    DependencyCoflowScheduler,
    GrapheneScheduler,
    MetaflowScheduler,
    SEBFScheduler,
)
from repro_torch.core.service import (
    AdmissionService,
    JobStats,
    online_recovery_drill,
    run_stream,
)
from repro_torch.core.whatif import WhatIf, WhatIfResult
from repro_torch.core.monitor import Monitor, Straggler

__all__ = [
    "MXTask", "TaskKind", "compute", "flow",
    "MXDAG", "Edge", "NodeTiming",
    "Link", "Topology",
    "Cluster", "Host",
    "SimResult", "Simulator", "max_min_rates", "simulate",
    "vectorized_waterfill",
    "FairShareScheduler", "CoflowConfig", "MXDAGScheduler",
    "PlacementScheduler", "AltruisticMultiScheduler", "Schedule",
    "auto_coflows",
    "BASELINES", "SEBFScheduler", "DependencyCoflowScheduler",
    "GrapheneScheduler", "MetaflowScheduler",
    "AdmissionService", "JobStats", "run_stream",
    "online_recovery_drill",
    "WhatIf", "WhatIfResult", "Monitor", "Straggler",
]
