"""Cluster resource model: hosts with processor pools, NICs, and an
optional link-level fabric topology.

Resource naming convention (matches ``MXTask.resources()``):

- ``"<host>.<proc>"``   — a processor pool with an integer slot count
  (compute tasks occupy one slot exclusively, non-preemptively),
- ``"<host>.nic_out"`` / ``"<host>.nic_in"`` — NIC directions with a float
  capacity (flows share them; rate allocation is policy-driven and
  preemptible, reflecting the paper's observation that network tasks cannot
  be isolated the way compute tasks can),
- any other name — a fabric link (ToR uplink, spine link, ...) owned by the
  cluster's :class:`~repro_torch.core.fabric.Topology`.

Without a topology a flow occupies exactly its two endpoint NICs (the seed
"big switch" model).  With one, it occupies every link on its static route,
of which the endpoint NICs are the first and last — so single-switch
topologies reproduce the endpoint-only results exactly.

Capacities are normalized: a flow of ``size`` seconds completes in ``size``
seconds when allocated rate 1.0.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.core.fabric import Topology
from repro_torch.core.graph import MXDAG
from repro_torch.core.task import MXTask, TaskKind


@dataclasses.dataclass(frozen=True)
class Host:
    """One machine: processor slot pools plus NIC capacities."""

    name: str
    procs: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"cpu": 1})
    nic_in: float = 1.0
    nic_out: float = 1.0


class Cluster:
    """The resource model: named hosts, optionally under a Topology."""

    def __init__(self, hosts: list[Host],
                 topology: Optional[Topology] = None) -> None:
        self.hosts = {h.name: h for h in hosts}
        self.topology = topology
        if topology is not None:
            missing = [h for h in self.hosts if h not in topology.hosts()]
            if missing:
                raise ValueError(f"hosts not in topology: {missing}")

    @classmethod
    def homogeneous(cls, names: list[str], *, procs: Mapping[str, int] | None = None,
                    nic: float = 1.0) -> "Cluster":
        """A cluster of identical hosts (no fabric)."""
        return cls([Host(n, procs=dict(procs or {"cpu": 1}),
                         nic_in=nic, nic_out=nic) for n in names])

    @classmethod
    def for_graph(cls, g: MXDAG, *, nic: float = 1.0,
                  topology: Optional[Topology] = None) -> "Cluster":
        """Build a sufficient homogeneous cluster for a graph's placements."""
        names: set[str] = set()
        procs: dict[str, int] = {}
        for t in g:
            if not t.bound:
                raise ValueError(
                    f"cannot build a cluster for {g.name}: task {t.name} "
                    f"is unbound (apply a placement with MXDAG.bind, or "
                    f"let MXDAGScheduler place it on an explicit cluster)")
            if t.kind is TaskKind.COMPUTE:
                names.add(t.host)  # type: ignore[arg-type]
                procs[t.proc] = 1
            else:
                names.add(t.src)   # type: ignore[arg-type]
                names.add(t.dst)   # type: ignore[arg-type]
        procs = procs or {"cpu": 1}
        if topology is not None:
            if nic != 1.0:
                raise ValueError("with a topology, NIC capacities come "
                                 "from its links; don't pass nic")
            return cls.from_topology(topology, procs=procs).restricted(names)
        return cls.homogeneous(sorted(names), procs=procs, nic=nic)

    @classmethod
    def from_topology(cls, topology: Topology, *,
                      procs: Mapping[str, int] | None = None) -> "Cluster":
        """One host per topology endpoint; NIC caps read off the NIC links."""
        hosts = [Host(h, procs=dict(procs or {"cpu": 1}),
                      nic_in=topology.capacity(f"{h}.nic_in"),
                      nic_out=topology.capacity(f"{h}.nic_out"))
                 for h in topology.hosts()]
        return cls(hosts, topology=topology)

    def restricted(self, names: set[str]) -> "Cluster":
        """The sub-cluster of ``names`` (topology, with its full link set,
        is kept — other hosts' flows just never appear)."""
        return Cluster([h for n, h in self.hosts.items() if n in names],
                       topology=self.topology)

    # ------------------------------------------------------------------
    def slots(self, resource: str) -> int:
        """Slot count of a ``<host>.<pool>`` processor resource."""
        host, pool = resource.rsplit(".", 1)
        return int(self.hosts[host].procs.get(pool, 0))

    def bandwidth(self, resource: str) -> float:
        """Capacity of a NIC or fabric link (topology wins when present)."""
        if self.topology is not None and resource in self.topology.links:
            return self.topology.capacity(resource)
        host, direction = resource.rsplit(".", 1)
        h = self.hosts[host]
        return h.nic_out if direction == "nic_out" else h.nic_in

    def bandwidths(self, resources) -> dict[str, float]:
        """Capacity index for a set of links, resolved once.

        The simulator's event loop rebuilds residual capacities at every
        rate reallocation; resolving each link's capacity through the
        topology/NIC lookup there would re-parse resource names per event.
        """
        return {r: self.bandwidth(r) for r in set(resources)}

    def resources_for(self, task: MXTask,
                      route: Optional[tuple[str, ...]] = None,
                      ) -> tuple[str, ...]:
        """The resources ``task`` occupies on *this* cluster.

        Compute tasks: their processor pool.  Flows: the full link path
        under the cluster's topology, or the two endpoint NICs without
        one.  ``route`` overrides a flow's path with an explicit link
        tuple — a per-flow routing decision (normally one member of
        :meth:`candidate_routes`) that wins over the topology's static
        ECMP pick.
        """
        if route is not None:
            if task.kind is not TaskKind.NETWORK:
                raise ValueError(f"{task.name}: only network tasks "
                                 f"take a route override")
            return tuple(route)
        if task.kind is TaskKind.COMPUTE or self.topology is None:
            return task.resources()
        return task.resources(self.topology)

    def candidate_routes(self, task: MXTask) -> tuple[tuple[str, ...], ...]:
        """All routes a flow could take on this cluster (the ECMP group
        under a fabric topology; just the endpoint-NIC path without one).
        ``resources_for(task)`` is always a member."""
        if task.kind is not TaskKind.NETWORK:
            raise ValueError(f"{task.name}: compute tasks are not routed")
        if self.topology is None:
            return (task.resources(),)
        return self.topology.paths(task.src, task.dst)

    def without_hosts(self, names: set[str]) -> "Cluster":
        """The surviving cluster after losing ``names`` (the fault-model
        complement of :meth:`restricted`).  The topology keeps its full
        link set — a dead host's links simply carry no flows, exactly as
        the replanner's belief should model a crashed-but-cabled machine."""
        return Cluster([h for n, h in self.hosts.items() if n not in names],
                       topology=self.topology)

    def degraded(self, links: Mapping[str, float]) -> "Cluster":
        """A copy with the given link capacities (absolute values, NICs
        included) — the replanner's belief of a degraded fabric.  Works
        with or without a topology: fabric links are resized through it,
        NIC entries also patch the Host records so big-switch clusters
        (whose compile reads NIC caps off the hosts) degrade identically."""
        topo = self.topology
        if topo is not None:
            in_topo = {k: v for k, v in links.items() if k in topo.links}
            if in_topo:
                topo = topo.resized(links=in_topo)
            unknown = [k for k in links if k not in self.topology.links]
        else:
            unknown = list(links)
        hosts = []
        for h in self.hosts.values():
            ni = links.get(f"{h.name}.nic_in", h.nic_in)
            no = links.get(f"{h.name}.nic_out", h.nic_out)
            unknown = [k for k in unknown
                       if k not in (f"{h.name}.nic_in", f"{h.name}.nic_out")]
            hosts.append(h if (ni == h.nic_in and no == h.nic_out)
                         else dataclasses.replace(h, nic_in=ni, nic_out=no))
        if unknown:
            raise KeyError(f"unknown links: {sorted(unknown)}")
        return Cluster(hosts, topology=topo)

    def with_topology(self, topology: Optional[Topology]) -> "Cluster":
        """Same hosts, different fabric (used by what-if queries)."""
        return Cluster(list(self.hosts.values()), topology=topology)

    def signature(self) -> tuple:
        """Hashable identity: hosts (with pools and NIC caps) and fabric
        links.  Two clusters with equal signatures produce identical
        simulations for any graph; keys what-if memo caches (and any
        other cache that must distinguish cluster variants, e.g. resized
        fabrics, without holding object identity)."""
        topo = self.topology
        return (tuple(sorted((h.name, tuple(sorted(h.procs.items())),
                              h.nic_in, h.nic_out)
                             for h in self.hosts.values())),
                None if topo is None else tuple(sorted(topo.links.items())))
