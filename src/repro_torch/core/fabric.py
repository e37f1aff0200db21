"""Link-level network fabric: multi-tier topologies with path-based routing.

The seed cluster model charges a flow only against its endpoint NICs — the
"big switch" simplification that coflow schedulers assume and that loses
in-network contention information.  Real fabrics are multi-tier: flows
crossing racks share ToR uplinks and spine links, and an oversubscribed
core is exactly where co-scheduling decisions matter most.

A :class:`Topology` is a set of named, capacitated, *directed* links plus a
static route table mapping each ``(src_host, dst_host)`` pair to the tuple
of links the flow traverses.  By convention the first link of every path is
the sender's egress NIC ``"<host>.nic_out"`` and the last is the receiver's
ingress NIC ``"<host>.nic_in"`` — so NIC endpoints are just the first/last
links of the path and the seed resource-naming convention is preserved.
Host pairs without an explicit route fall back to the direct NIC-only path,
i.e. the big-switch model.

Builders:

- :meth:`Topology.single_switch` — the seed model as a topology (every path
  is exactly ``(src.nic_out, dst.nic_in)``; simulation results are
  bit-identical to a topology-less cluster),
- :meth:`Topology.two_tier`  — racks under ToR switches joined by a core;
  per-rack uplink/downlink capacity ``hosts * nic / oversubscription``,
- :meth:`Topology.leaf_spine` — each leaf holds one uplink/downlink pair
  per spine; flows pick a spine by ECMP-style static hashing,
- :meth:`Topology.fat_tree`  — the k-ary Clos of Al-Fares et al.; ECMP
  hashing selects the aggregation and core switch per host pair.

Routing *defaults* to static hash-based ECMP (as in flow-level fabric
simulators): the default path of a flow is a pure function of its
endpoints, so the simulator's piecewise-constant-rate integration stays
exact.  But the hash pick is just one member of the candidate set the
fabric actually offers — :meth:`Topology.paths` exposes the full ECMP
group (every spine, every (agg, core) pair) per host pair, and the
scheduler may override a flow's route with any candidate (threaded through
``Cluster.resources_for(task, route=...)`` and ``Simulator(routes=...)``),
making routing a per-flow scheduling decision instead of a frozen input.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Iterable, Mapping, Optional, Sequence


def nic_out(host: str) -> str:
    """Resource name of ``host``'s egress NIC."""
    return f"{host}.nic_out"


def nic_in(host: str) -> str:
    """Resource name of ``host``'s ingress NIC."""
    return f"{host}.nic_in"


_NIC_SUFFIXES = (".nic_out", ".nic_in")


def is_nic_link(link: str) -> bool:
    """NIC links are endpoint resources; everything else is fabric."""
    return link.endswith(_NIC_SUFFIXES)


def link_flow_index(flows, paths) -> dict[str, list[str]]:
    """Invert flow→path into link→flows, preserving ``flows`` order.

    The waterfill's bottleneck search needs, per link, the flows crossing
    it; scanning every flow's path per link is O(links·flows) per
    iteration, while this index makes it O(flows on the link).  Order
    preservation matters: weight sums and freeze batches must enumerate
    flows exactly as the ordered scan would, so allocations (and their
    floating-point round-off) are unchanged.
    """
    by_link: dict[str, list[str]] = {}
    for n in flows:
        for r in paths[n]:
            by_link.setdefault(r, []).append(n)
    return by_link


def ecmp_choice(src: str, dst: str, n: int) -> int:
    """Deterministic ECMP: stable per host pair across processes/runs."""
    if n <= 1:
        return 0
    return zlib.crc32(f"{src}->{dst}".encode()) % n


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed fabric link with a normalized bandwidth capacity."""
    name: str
    capacity: float

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError(f"link {self.name}: capacity must be > 0")


class Topology:
    """Named links + static per-host-pair routes over them."""

    def __init__(self, name: str = "fabric") -> None:
        self.name = name
        self.links: dict[str, float] = {}
        self._hosts: dict[str, None] = {}          # ordered set
        # explicit routes (add_route) double as the memo cache for _router
        self._routes: dict[tuple[str, str], tuple[str, ...]] = {}
        # host pairs routed explicitly via add_route (a single-member
        # candidate set), as opposed to memoized ECMP picks in _routes
        self._explicit: set[tuple[str, str]] = set()
        # routing function (src, dst) -> fabric via-links, or None for the
        # direct NIC-only path; builders install one so construction stays
        # O(hosts + links) instead of materializing O(hosts^2) routes
        self._router: Optional[
            Callable[[str, str], Optional[Sequence[str]]]] = None
        # multipath router (src, dst) -> the *candidate* via-link tuples
        # (the full ECMP group), or None when only the direct NIC path
        # exists; path() picks member ecmp_choice(src, dst, len) of it, so
        # installing a multipath router reproduces the single-path hash
        # pick exactly while exposing every alternative to the scheduler
        self._multi: Optional[
            Callable[[str, str],
                     Optional[Sequence[tuple[str, ...]]]]] = None

    # -- construction --------------------------------------------------
    def add_host(self, host: str, *, nic_in_cap: float = 1.0,
                 nic_out_cap: float = 1.0) -> None:
        """Add a host plus its two NIC links."""
        if host in self._hosts:
            raise ValueError(f"duplicate host {host}")
        self._hosts[host] = None
        self.add_link(nic_out(host), nic_out_cap)
        self.add_link(nic_in(host), nic_in_cap)

    def add_link(self, name: str, capacity: float) -> None:
        """Add a named link with the given capacity."""
        if name in self.links:
            raise ValueError(f"duplicate link {name}")
        self.links[name] = Link(name, capacity).capacity

    def add_route(self, src: str, dst: str,
                  via: Sequence[str] = ()) -> None:
        """Route src→dst through fabric links ``via`` (NICs are implicit)."""
        for h in (src, dst):
            if h not in self._hosts:
                raise KeyError(f"unknown host {h}")
        for l in via:
            if l not in self.links:
                raise KeyError(f"unknown link {l}")
        self._routes[(src, dst)] = (nic_out(src), *via, nic_in(dst))
        self._explicit.add((src, dst))

    # -- queries -------------------------------------------------------
    def hosts(self) -> list[str]:
        """All host names, insertion order."""
        return list(self._hosts)

    def capacity(self, link: str) -> float:
        """Capacity of ``link`` (KeyError if unknown)."""
        return self.links[link]

    def _via_candidates(self, src: str,
                        dst: str) -> Optional[list[tuple[str, ...]]]:
        """Candidate via-link tuples for a host pair, or None for direct."""
        if self._multi is not None:
            vias = self._multi(src, dst)
            return None if vias is None else [tuple(v) for v in vias]
        if self._router is not None:
            via = self._router(src, dst)
            return None if via is None else [tuple(via)]
        return None

    def path(self, src: str, dst: str) -> tuple[str, ...]:
        """The *default* links a src→dst flow occupies (first = egress
        NIC, last = ingress NIC): the explicit route if one was added,
        else the ECMP-hash member of the candidate set.  Unrouted pairs
        use the direct NIC-only path."""
        route = self._routes.get((src, dst))
        if route is not None:
            return route
        for h in (src, dst):
            if h not in self._hosts:
                raise KeyError(
                    f"unknown host {h!r} in topology {self.name!r}")
        vias = self._via_candidates(src, dst)
        via = None if vias is None \
            else vias[ecmp_choice(src, dst, len(vias))]
        route = (nic_out(src), *(via or ()), nic_in(dst))
        self._routes[(src, dst)] = route
        return route

    def paths(self, src: str, dst: str) -> tuple[tuple[str, ...], ...]:
        """All candidate routes for a host pair (the ECMP group).

        :meth:`path` returns exactly one member of this set (the static
        hash pick), so ``path(s, d) in paths(s, d)`` always holds.  Pairs
        routed explicitly via :meth:`add_route` have a single candidate;
        pairs with no fabric route offer only the direct NIC path.  A
        scheduler treats this set as the decision space for per-flow route
        overrides.
        """
        if (src, dst) in self._explicit:
            return (self._routes[(src, dst)],)
        for h in (src, dst):
            if h not in self._hosts:
                raise KeyError(
                    f"unknown host {h!r} in topology {self.name!r}")
        vias = self._via_candidates(src, dst)
        if vias is None:
            return ((nic_out(src), nic_in(dst)),)
        return tuple((nic_out(src), *v, nic_in(dst)) for v in vias)

    def fabric_links(self) -> list[str]:
        """All non-NIC (in-fabric) link names."""
        return [l for l in self.links if not is_nic_link(l)]

    # -- what-if support ----------------------------------------------
    def resized(self, scale: Optional[float] = None, *,
                links: Optional[Mapping[str, float]] = None) -> "Topology":
        """A copy with fabric link capacities scaled by ``scale`` and/or
        individual links (NICs included) set from ``links``."""
        if links is not None:
            unknown = sorted(set(links) - set(self.links))
            if unknown:
                raise KeyError(f"unknown links in topology "
                               f"{self.name!r}: {unknown}")
        t = Topology(self.name)
        t._hosts = dict(self._hosts)
        t._routes = dict(self._routes)
        t._explicit = set(self._explicit)
        t._router = self._router
        t._multi = self._multi
        for l, cap in self.links.items():
            if links is not None and l in links:
                cap = links[l]
            elif scale is not None and not is_nic_link(l):
                cap = cap * scale
            t.links[l] = Link(l, cap).capacity
        return t

    def __repr__(self) -> str:
        return (f"Topology({self.name}: {len(self._hosts)} hosts, "
                f"{len(self.fabric_links())} fabric links)")

    # ------------------------------------------------------------------
    # builders
    # ------------------------------------------------------------------
    @staticmethod
    def _rack_names(racks, prefix: str = "r") -> list[list[str]]:
        """Accept explicit host-name lists or an (n_racks, per_rack) pair."""
        if (isinstance(racks, tuple) and len(racks) == 2
                and all(isinstance(x, int) for x in racks)):
            n, per = racks
            return [[f"{prefix}{r}h{i}" for i in range(per)]
                    for r in range(n)]
        return [list(r) for r in racks]

    @classmethod
    def single_switch(cls, hosts: Iterable[str], *,
                      nic: float = 1.0) -> "Topology":
        """The seed "big switch": every path is the two endpoint NICs."""
        t = cls("single_switch")
        for h in hosts:
            t.add_host(h, nic_in_cap=nic, nic_out_cap=nic)
        return t

    @classmethod
    def two_tier(cls, racks, *, nic: float = 1.0,
                 oversubscription: float = 1.0) -> "Topology":
        """Racks under ToR switches joined by a non-blocking core.

        ``racks`` is a list of host-name lists or an ``(n_racks,
        hosts_per_rack)`` pair.  Each rack r gets one uplink ``rack<r>.up``
        and one downlink ``rack<r>.down`` of capacity ``len(rack) * nic /
        oversubscription`` — ``oversubscription=4`` is the classic 4:1
        oversubscribed core where only a quarter of the rack's NIC
        bandwidth can leave the rack at once.
        """
        if oversubscription <= 0:
            raise ValueError("oversubscription must be > 0")
        groups = cls._rack_names(racks)
        t = cls(f"two_tier_{oversubscription:g}to1")
        rack_of: dict[str, int] = {}
        for r, hosts in enumerate(groups):
            cap = len(hosts) * nic / oversubscription
            t.add_link(f"rack{r}.up", cap)
            t.add_link(f"rack{r}.down", cap)
            for h in hosts:
                t.add_host(h, nic_in_cap=nic, nic_out_cap=nic)
                rack_of[h] = r
        def routes(s: str, d: str) -> Optional[list[tuple[str, ...]]]:
            """Via-links for s→d (None = intra-rack direct)."""
            rs, rd = rack_of[s], rack_of[d]
            if rs == rd:            # intra-rack: direct NIC-only path
                return None
            return [(f"rack{rs}.up", f"rack{rd}.down")]

        t._multi = routes
        return t

    @classmethod
    def leaf_spine(cls, racks, n_spines: int, *, nic: float = 1.0,
                   uplink: Optional[float] = None,
                   oversubscription: float = 1.0) -> "Topology":
        """Leaf switches fully meshed to ``n_spines`` spines.

        Each leaf l holds one uplink ``leaf<l>.up<s>`` and one downlink
        ``leaf<l>.down<s>`` per spine s, each of capacity ``uplink``
        (default ``len(rack) * nic / (oversubscription * n_spines)``).
        A flow picks its spine by ECMP-style static hashing of the host
        pair, so the route is deterministic and rate integration exact.
        """
        if n_spines < 1:
            raise ValueError("need at least one spine")
        groups = cls._rack_names(racks, prefix="l")
        t = cls(f"leaf_spine_{n_spines}")
        leaf_of: dict[str, int] = {}
        for l, hosts in enumerate(groups):
            cap = uplink if uplink is not None else \
                len(hosts) * nic / (oversubscription * n_spines)
            for s in range(n_spines):
                t.add_link(f"leaf{l}.up{s}", cap)
                t.add_link(f"leaf{l}.down{s}", cap)
            for h in hosts:
                t.add_host(h, nic_in_cap=nic, nic_out_cap=nic)
                leaf_of[h] = l
        def routes(s: str, d: str) -> Optional[list[tuple[str, ...]]]:
            """Per-spine via-link candidates (None = same leaf)."""
            ls, ld = leaf_of[s], leaf_of[d]
            if ls == ld:
                return None
            # one candidate per spine; path() hash-picks index
            # ecmp_choice(s, d, n_spines), exactly the old static route
            return [(f"leaf{ls}.up{sp}", f"leaf{ld}.down{sp}")
                    for sp in range(n_spines)]

        t._multi = routes
        return t

    @classmethod
    def fat_tree(cls, k: int, *, nic: float = 1.0) -> "Topology":
        """k-ary fat-tree (k even): k pods of k/2 edge + k/2 agg switches,
        (k/2)^2 cores, k^3/4 hosts named ``p<pod>e<edge>h<i>``.

        All links have capacity ``nic`` (full bisection).  Core c attaches
        to agg ``c // (k/2)`` of every pod; ECMP hashing picks the agg
        (intra-pod) or core (inter-pod) per host pair.
        """
        if k < 2 or k % 2:
            raise ValueError("fat_tree needs even k >= 2")
        half = k // 2
        t = cls(f"fat_tree_{k}")
        where: dict[str, tuple[int, int]] = {}     # host -> (pod, edge)
        for p in range(k):
            for e in range(half):
                for a in range(half):
                    t.add_link(f"p{p}.e{e}a{a}.up", nic)
                    t.add_link(f"p{p}.e{e}a{a}.down", nic)
                for i in range(half):
                    h = f"p{p}e{e}h{i}"
                    t.add_host(h, nic_in_cap=nic, nic_out_cap=nic)
                    where[h] = (p, e)
            for a in range(half):
                for c in range(a * half, (a + 1) * half):
                    t.add_link(f"p{p}.a{a}c{c}.up", nic)
                    t.add_link(f"p{p}.a{a}c{c}.down", nic)
        def routes(s: str, d: str) -> Optional[list[tuple[str, ...]]]:
            """Clos via-link candidates (None = same edge switch)."""
            (ps, es), (pd, ed) = where[s], where[d]
            if (ps, es) == (pd, ed):                # same edge switch
                return None
            if ps == pd:                            # intra-pod: one per agg
                return [(f"p{ps}.e{es}a{a}.up", f"p{ps}.e{ed}a{a}.down")
                        for a in range(half)]
            # inter-pod: one candidate per core c (agg = c // half);
            # path() hash-picks index ecmp_choice(s, d, half*half)
            return [(f"p{ps}.e{es}a{c // half}.up",
                     f"p{ps}.a{c // half}c{c}.up",
                     f"p{pd}.a{c // half}c{c}.down",
                     f"p{pd}.e{ed}a{c // half}.down")
                    for c in range(half * half)]

        t._multi = routes
        return t
