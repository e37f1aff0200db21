"""MXTask: the node type of an MXDAG (paper §3.1).

An MXTask is either a *compute* task (bound to a host processor) or a
*network* task (a single sender→receiver flow).  Every MXTask carries the two
quantitative annotations the paper defines:

- ``size``  — completion time (seconds) with the **maximum** resource
  assigned (full processor / full NIC bandwidth).  Equivalent to task
  duration in Decima/Graphene.
- ``unit``  — the smallest pipelineable unit, in the same seconds-at-full-
  resource measure.  ``unit == size`` means the task cannot be pipelined.

Completion time under a partial resource assignment ``r ∈ (0, 1]`` is
``size / r`` (paper: "the size can be used to estimate the completion time
when only partial resources are assigned").

Placement is a *decision*, not an intrinsic property: a compute task may be
constructed with ``host=None`` (a logical task whose executing host is
chosen by the scheduler) and a flow with ``src``/``dst`` ``None`` (endpoints
bound late, usually inferred from the placement of the compute tasks it
connects — see :meth:`~repro_torch.core.graph.MXDAG.bind`).  An unbound task has
no resource identity yet: :meth:`MXTask.resources` raises until every
placement field it needs is bound.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class TaskKind(enum.Enum):
    """The two first-class task kinds of the abstraction (§3.1)."""

    COMPUTE = "compute"
    NETWORK = "network"


@dataclasses.dataclass(frozen=True)
class MXTask:
    """A single physical process (compute) or flow (network) in an MXDAG."""

    name: str
    kind: TaskKind
    size: float                      # seconds at full resource
    unit: Optional[float] = None     # pipeline unit; None => not pipelineable
    # Placement (None = logical / unbound; see MXDAG.bind) -------------
    host: Optional[str] = None       # compute tasks: executing host
    src: Optional[str] = None        # network tasks: sender host
    dst: Optional[str] = None        # network tasks: receiver host
    proc: str = "cpu"                # compute tasks: processor pool on host
    # Bookkeeping ------------------------------------------------------
    job: str = "job0"                # owning MXDAG/job id (multi-job sched)

    def __post_init__(self) -> None:
        if self.size < 0:
            raise ValueError(f"{self.name}: size must be >= 0")
        if self.unit is not None and not (0 < self.unit <= self.size or self.size == 0):
            raise ValueError(f"{self.name}: unit must be in (0, size]")
        if self.kind is TaskKind.COMPUTE and (self.src is not None
                                              or self.dst is not None):
            raise ValueError(f"{self.name}: compute task takes host, "
                             f"not src/dst")
        if self.kind is TaskKind.NETWORK and self.host is not None:
            raise ValueError(f"{self.name}: network task takes src/dst, "
                             f"not host")

    # -- derived -------------------------------------------------------
    @property
    def bound(self) -> bool:
        """True iff every placement field this task needs is set."""
        if self.kind is TaskKind.COMPUTE:
            return self.host is not None
        return self.src is not None and self.dst is not None

    @property
    def pipelineable(self) -> bool:
        """Whether the task has unit structure finer than its size."""
        return self.unit is not None and self.unit < self.size

    @property
    def effective_unit(self) -> float:
        """Unit size; for unpipelineable tasks the paper sets unit = size."""
        return self.unit if self.unit is not None else self.size

    @property
    def n_units(self) -> int:
        """Number of units (``ceil(size / effective_unit)``, min 1)."""
        if self.size == 0:
            return 1
        return max(1, int(math.ceil(self.size / self.effective_unit - 1e-12)))

    def time(self, rsrc: float = 1.0) -> float:
        """Completion time under resource fraction ``rsrc``."""
        if not (0 < rsrc <= 1.0 + 1e-12):
            raise ValueError(f"rsrc must be in (0,1], got {rsrc}")
        return self.size / rsrc

    def unit_time(self, rsrc: float = 1.0) -> float:
        """One unit's completion time under resource fraction ``rsrc``."""
        if not (0 < rsrc <= 1.0 + 1e-12):
            raise ValueError(f"rsrc must be in (0,1], got {rsrc}")
        return self.effective_unit / rsrc

    # -- resource identity --------------------------------------------
    def resources(self, topology=None) -> tuple[str, ...]:
        """Names of the resources this task occupies while running.

        Compute tasks occupy one processor pool.  Network tasks occupy the
        sender's egress NIC and the receiver's ingress NIC — plus, when a
        :class:`~repro_torch.core.fabric.Topology` is given, every fabric link on
        the flow's static route (the flow's rate is capped by the tightest
        link at any instant).
        """
        if not self.bound:
            raise ValueError(
                f"{self.name}: unbound task has no resources yet — apply a "
                f"placement with MXDAG.bind() before simulating")
        if self.kind is TaskKind.COMPUTE:
            return (f"{self.host}.{self.proc}",)
        if topology is not None:
            return tuple(topology.path(self.src, self.dst))
        return (f"{self.src}.nic_out", f"{self.dst}.nic_in")


def compute(name: str, size: float, host: Optional[str] = None, *,
            unit: float | None = None, proc: str = "cpu",
            job: str = "job0") -> MXTask:
    """Convenience constructor for compute MXTasks (``host=None``: logical,
    placed later by the scheduler via :meth:`MXDAG.bind`)."""
    return MXTask(name=name, kind=TaskKind.COMPUTE, size=size, unit=unit,
                  host=host, proc=proc, job=job)


def flow(name: str, size: float, src: Optional[str] = None,
         dst: Optional[str] = None, *,
         unit: float | None = None, job: str = "job0") -> MXTask:
    """Convenience constructor for network MXTasks (``None`` endpoints are
    bound late, usually inferred from adjacent compute placements)."""
    return MXTask(name=name, kind=TaskKind.NETWORK, size=size, unit=unit,
                  src=src, dst=dst, job=job)
