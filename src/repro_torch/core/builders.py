"""MXDAG builders: the paper's worked examples plus parametric generators.

Every figure the paper argues from is constructible here so benchmarks and
tests can validate the claims numerically:

- :func:`fig1_jobs`       — Fig. 1 / Fig. 4(a): two flows leaving host A.
- :func:`fig2a`           — Fig. 2(a): symmetric topology, asymmetric
                            compute times t1/t2.
- :func:`fig2b`           — Fig. 2(b): Wukong-style asymmetric topology
                            with flows f1..f6 (+ the b1/b2/b3 coflow
                            groupings of Fig. 2(b1..b3)).
- :func:`fig3`            — Fig. 3: 4-node DAG with critical path A→B→C
                            used for the three pipelining cases.
- :func:`ddl`             — Fig. 6: layer-wise data-parallel training
                            (BP → push → pull → FP with a parameter server).
- :func:`mapreduce_pair`  — Fig. 7: two map-reduce jobs sharing a host and
                            a NIC.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence

from repro_torch.core.cluster import Cluster
from repro_torch.core.fabric import Topology
from repro_torch.core.graph import MXDAG
from repro_torch.core.task import MXTask, compute, flow


# ----------------------------------------------------------------------
# Fig. 1 / Fig. 4(a)
# ----------------------------------------------------------------------
def fig1_jobs() -> MXDAG:
    """Job X of Fig. 4(a): a@A fans out f1→B and f3→C; b@B sends f2→C;
    c@C joins f2 and f3.  Critical path A→f1→b→f2→c."""
    g = MXDAG("fig1_jobX")
    a = g.add(compute("a", 1.0, "A"))
    b = g.add(compute("b", 1.0, "B"))
    c = g.add(compute("c", 1.0, "C"))
    f1 = g.add(flow("f1", 1.0, "A", "B"))
    f2 = g.add(flow("f2", 1.0, "B", "C"))
    f3 = g.add(flow("f3", 1.0, "A", "C"))
    g.add_edge(a, f1)
    g.add_edge(a, f3)
    g.add_edge(f1, b)
    g.add_edge(b, f2)
    g.add_edge(f2, c)
    g.add_edge(f3, c)
    return g


# ----------------------------------------------------------------------
# Fig. 2(a): symmetric topology, asymmetric compute times
# ----------------------------------------------------------------------
def fig2a(t1: float = 3.0, t2: float = 1.0, fsize: float = 1.0) -> MXDAG:
    """Fig. 2(a): symmetric flows feeding asymmetric compute times."""
    g = MXDAG("fig2a")
    a = g.add(compute("a", 0.0, "A"))
    b = g.add(compute("b", t1, "B"))
    c = g.add(compute("c", t2, "C"))
    d = g.add(compute("d", 1.0, "D"))
    f1 = g.add(flow("f1", fsize, "A", "B"))
    f2 = g.add(flow("f2", fsize, "A", "C"))
    f3 = g.add(flow("f3", fsize, "B", "D"))
    f4 = g.add(flow("f4", fsize, "C", "D"))
    g.add_edge(a, f1)
    g.add_edge(a, f2)
    g.add_edge(f1, b)
    g.add_edge(f2, c)
    g.add_edge(b, f3)
    g.add_edge(c, f4)
    g.add_edge(f3, d)
    g.add_edge(f4, d)
    return g


def fig2a_coflows() -> list[set[str]]:
    """The Fig. 2(c) grouping: broadcast {f1,f2}, aggregation {f3,f4}."""
    return [{"f1", "f2"}, {"f3", "f4"}]


# ----------------------------------------------------------------------
# Fig. 2(b): Wukong-derived asymmetric topology
# ----------------------------------------------------------------------
def fig2b() -> MXDAG:
    """A→f1→B→f2→E; C broadcasts f3→D, f4→E; D→f5→F; E→f6→F; F joins.

    The optimal schedule delays f4 to give f3 the full C-egress bandwidth,
    which cascades so f5 and f6 do not share F's ingress (§2.2).
    """
    g = MXDAG("fig2b")
    a = g.add(compute("a", 1.0, "A"))
    b = g.add(compute("b", 1.0, "B"))
    c = g.add(compute("c", 1.0, "C"))
    d = g.add(compute("d", 1.0, "D"))
    e = g.add(compute("e", 1.0, "E"))
    f = g.add(compute("f", 1.0, "F"))
    f1 = g.add(flow("f1", 1.0, "A", "B"))
    f2 = g.add(flow("f2", 1.0, "B", "E"))
    f3 = g.add(flow("f3", 1.0, "C", "D"))
    f4 = g.add(flow("f4", 1.0, "C", "E"))
    f5 = g.add(flow("f5", 1.0, "D", "F"))
    f6 = g.add(flow("f6", 1.0, "E", "F"))
    g.add_edge(a, f1)
    g.add_edge(f1, b)
    g.add_edge(b, f2)
    g.add_edge(c, f3)
    g.add_edge(c, f4)
    g.add_edge(f3, d)
    g.add_edge(f2, e)
    g.add_edge(f4, e)
    g.add_edge(d, f5)
    g.add_edge(e, f6)
    g.add_edge(f5, f)
    g.add_edge(f6, f)
    return g


def fig2b_coflows(variant: str) -> list[set[str]]:
    """The three ambiguous groupings of Fig. 2(b1), (b2), (b3)."""
    if variant == "b1":    # broadcast from C + aggregation at F
        return [{"f3", "f4"}, {"f5", "f6"}]
    if variant == "b2":    # aggregation at E
        return [{"f2", "f4"}]
    if variant == "b3":    # all flows between {B,C} and {D,E}
        return [{"f2", "f3", "f4"}]
    raise ValueError(variant)


# ----------------------------------------------------------------------
# Fig. 3: pipelineability cases
# ----------------------------------------------------------------------
def fig3(unit: float = 0.25) -> MXDAG:
    """4-host DAG with critical path a→f1→b→f2→c and a side branch
    a→f3→d→f4→c.  All of a, f1, f3, d, f4 are pipelineable with ``unit``.
    """
    g = MXDAG("fig3")
    a = g.add(compute("a", 1.0, "A", unit=unit))
    b = g.add(compute("b", 2.0, "B"))
    c = g.add(compute("c", 1.0, "C"))
    d = g.add(compute("d", 0.5, "D", unit=unit))
    f1 = g.add(flow("f1", 1.0, "A", "B", unit=unit))
    f2 = g.add(flow("f2", 1.0, "B", "C"))
    f3 = g.add(flow("f3", 1.0, "A", "D", unit=unit))
    f4 = g.add(flow("f4", 0.5, "D", "C", unit=unit))
    g.add_edge(a, f1)
    g.add_edge(a, f3)
    g.add_edge(f1, b)
    g.add_edge(b, f2)
    g.add_edge(f2, c)
    g.add_edge(f3, d)
    g.add_edge(d, f4)
    g.add_edge(f4, c)
    return g


def fig3_case(case: int) -> MXDAG:
    """Return Fig. 3 with the pipelining choice of the given case applied.

    0: baseline (no pipelining);  1: pipeline flow4 only (non-critical);
    2: + pipeline flow1 (critical, helps);  3: + pipeline flow3 (critical,
    hurts: f1 and f3 now share A's egress NIC from t≈0)."""
    g = fig3()
    if case >= 1:
        g.set_pipelined("d", "f4", True)
    if case >= 2:
        g.set_pipelined("a", "f1", True)
    if case >= 3:
        g.set_pipelined("a", "f3", True)
    return g


# ----------------------------------------------------------------------
# Fig. 6: data-parallel distributed training (worker + parameter server)
# ----------------------------------------------------------------------
def ddl(n_layers: int = 4, *,
        bp: Sequence[float] | float = 1.0,
        fp: Sequence[float] | float = 1.0,
        push: Sequence[float] | float = 1.0,
        pull: Sequence[float] | float = 1.0,
        unit_frac: Optional[float] = None,
        worker: str = "W", ps: str = "PS", job: str = "job0",
        placed: bool = True, name: Optional[str] = None) -> MXDAG:
    """One boundary iteration of layer-wise data-parallel training.

    BP runs top layer → layer 0 on the worker GPU; each BP_i releases
    push_i (worker→PS) then pull_i (PS→worker); FP of the *next* iteration
    runs layer 0 → top and FP_i requires pull_i and FP_{i-1}.  This is the
    MXDAG of Fig. 6; MXDAG scheduling recovers ByteScheduler's
    lower-layer-first flow priority (§4.1.1).

    ``placed=False`` makes the parameter-server side a scheduling
    decision: push destinations / pull sources are left unbound (each
    layer's push→pull edge keeps its handoff on one host, so the
    scheduler may keep one PS or shard it per layer); the worker stays
    bound — it is where the GPU is.

    :param n_layers: number of model layers.
    :param bp: per-layer backward-pass times (scalar broadcasts).
    :param fp: per-layer forward-pass times (scalar broadcasts).
    :param push: per-layer gradient push sizes (scalar broadcasts).
    :param pull: per-layer parameter pull sizes (scalar broadcasts).
    :param unit_frac: when set, every task gets ``unit = unit_frac *
        size`` (enables pipelining experiments).
    :param worker: the GPU host name.
    :param ps: the parameter-server host name (ignored when
        ``placed=False``).
    :param job: job label stamped on every task.
    :param placed: ``False`` leaves the PS side logical (see above).
    :param name: when set, names the graph and prefixes every task name
        with ``"{name}."`` — required when several ddl jobs share a
        cluster (multi-job task names must be globally unique).
    :returns: the iteration's MXDAG.
    """
    def seq(x, default):
        """Broadcast a scalar to per-layer values (lists pass through)."""
        if isinstance(x, (int, float)):
            return [float(x)] * n_layers
        return [float(v) for v in x]

    bp, fp = seq(bp, 1.0), seq(fp, 1.0)
    push, pull = seq(push, 1.0), seq(pull, 1.0)
    uf = unit_frac
    pre = f"{name}." if name else ""

    g = MXDAG(name or f"ddl{n_layers}")
    bps = [g.add(compute(f"{pre}BP{i}", bp[i], worker, proc="gpu",
                         job=job))
           for i in range(n_layers)]
    fps = [g.add(compute(f"{pre}FP{i}", fp[i], worker, proc="gpu",
                         job=job))
           for i in range(n_layers)]
    ps_host = ps if placed else None
    pushes = [g.add(flow(f"{pre}push{i}", push[i], worker, ps_host,
                         job=job,
                         unit=None if uf is None else uf * push[i]))
              for i in range(n_layers)]
    pulls = [g.add(flow(f"{pre}pull{i}", pull[i], ps_host, worker,
                        job=job,
                        unit=None if uf is None else uf * pull[i]))
             for i in range(n_layers)]
    # BP chain: top layer first
    for i in range(n_layers - 1, 0, -1):
        g.add_edge(bps[i], bps[i - 1])
    for i in range(n_layers):
        g.add_edge(bps[i], pushes[i])
        g.add_edge(pushes[i], pulls[i])
        g.add_edge(pulls[i], fps[i])
    # FP chain: layer 0 first
    for i in range(n_layers - 1):
        g.add_edge(fps[i], fps[i + 1])
    return g


# ----------------------------------------------------------------------
# Fig. 7: two map-reduce jobs sharing a host and a NIC
# ----------------------------------------------------------------------
def mapreduce_pair() -> tuple[MXDAG, MXDAG]:
    """Job1: long map a@Ha + short map b@Hb feeding reduce r1@Hr.
    Job2: map d@Hb (shares Hb's compute slot with b) feeding r2@Hr2 via
    f3 (shares Hb's egress NIC with f2)."""
    j1 = MXDAG("job1")
    a = j1.add(compute("a", 3.0, "Ha", job="job1"))
    b = j1.add(compute("b", 1.0, "Hb", job="job1"))
    f1 = j1.add(flow("f1", 1.0, "Ha", "Hr", job="job1"))
    f2 = j1.add(flow("f2", 1.0, "Hb", "Hr", job="job1"))
    r1 = j1.add(compute("r1", 1.0, "Hr", job="job1"))
    j1.add_edge(a, f1)
    j1.add_edge(b, f2)
    j1.add_edge(f1, r1)
    j1.add_edge(f2, r1)

    j2 = MXDAG("job2")
    d = j2.add(compute("d", 1.0, "Hb", job="job2"))
    f3 = j2.add(flow("f3", 1.0, "Hb", "Hr2", job="job2"))
    r2 = j2.add(compute("r2", 1.0, "Hr2", job="job2"))
    j2.add_edge(d, f3)
    j2.add_edge(f3, r2)
    return j1, j2


# ----------------------------------------------------------------------
# oversubscribed-fabric scenario (multi-tier topology; beyond the paper's
# single-switch figures — the regime where co-scheduling matters most)
# ----------------------------------------------------------------------
def oversubscribed_fanin(n_senders: int = 4, *,
                         oversubscription: float = 4.0,
                         flow_size: float = 1.0,
                         critical_flow_size: Optional[float] = None,
                         critical_compute: float = 8.0,
                         other_compute: float = 1.0,
                         job: str = "job0",
                         placed: bool = True) -> tuple[MXDAG, Cluster]:
    """Cross-rack fan-in on an oversubscribed two-tier core.

    ``n_senders`` hosts in rack 0 each send one flow to a distinct host in
    rack 1; all flows contend on rack 0's shared uplink (capacity
    ``n_senders / oversubscription``).  Flow 0 feeds a *long* compute —
    the critical path — while the rest feed short ones.  Fair sharing
    splits the uplink evenly and delays the critical flow by a factor of
    ``n_senders``; MXDAG priority co-scheduling gives it the whole uplink
    first.

    :param n_senders: hosts per rack (= flows crossing the core).
    :param oversubscription: core ratio; uplink capacity is
        ``n_senders / oversubscription``.
    :param flow_size: size of every non-critical flow.
    :param critical_flow_size: size of the critical flow ``f0``
        (default: ``flow_size``).  Making it *larger* than the rest is
        the configuration that separates DAG-aware from DAG-blind
        schedulers: smallest-bottleneck-first coflow ordering then
        schedules the critical flow *last* (it only sees bytes), while
        slack-driven co-scheduling still sends it first.
    :param critical_compute: duration of the compute fed by ``f0``.
    :param other_compute: duration of every other consumer.
    :param job: job label stamped on every task.
    :param placed: ``False`` keeps the data where it lives (flow
        sources stay on the rack-0 senders) but leaves the consuming
        compute tasks — and hence the flow destinations — logical: a
        placement-aware scheduler may pull the consumers into rack 0
        and never cross the oversubscribed core at all.
    :returns: ``(graph, cluster)``.
    """
    rack0 = [f"s{i}" for i in range(n_senders)]
    rack1 = [f"d{i}" for i in range(n_senders)]
    topo = Topology.two_tier([rack0, rack1],
                             oversubscription=oversubscription)
    g = MXDAG(f"fanin{n_senders}_{oversubscription:g}to1")
    for i in range(n_senders):
        fsize = critical_flow_size if i == 0 \
            and critical_flow_size is not None else flow_size
        f = g.add(flow(f"f{i}", fsize, f"s{i}",
                       f"d{i}" if placed else None, job=job))
        size = critical_compute if i == 0 else other_compute
        c = g.add(compute(f"c{i}", size,
                          f"d{i}" if placed else None, job=job))
        g.add_edge(f, c)
    return g, Cluster.from_topology(topo)


# ----------------------------------------------------------------------
# fat-tree cross-pod shuffle (placement/routing demonstration scenario)
# ----------------------------------------------------------------------
def fat_tree_shuffle(k: int = 8, *, stride: int = 2,
                     map_time: float = 1.0, reduce_time: float = 1.0,
                     shuffle_bytes: float = 1.0,
                     placed: bool = True) -> tuple[MXDAG, Cluster]:
    """Sparse cross-pod shuffle on a full-bisection ``fat_tree(k)``.

    The first ``k³/32`` hosts (exactly pod 0 for ``k=8``: hosts 0..15)
    run mappers; each mapper i shuffles
    ``shuffle_bytes`` split over ``stride`` flows to reducers
    ``i..i+stride-1`` (mod n) on the *next* ``k²/8`` hosts.  Sparse
    shuffles make the fabric, not the NICs, the binding constraint:
    static ECMP hashes several large flows onto the same core link
    (deterministically — crc32), halving their rates, while every NIC
    carries exactly ``shuffle_bytes``.  ``placed=False`` leaves the
    reducers logical: a placement-aware scheduler pulls each reducer
    next to its mappers and never pays the core collisions.

    :param k: fat-tree arity (``k³/4`` hosts, ``k³/32`` mappers).
    :param stride: flows per mapper (shuffle sparsity).
    :param map_time: each mapper's compute time.
    :param reduce_time: each reducer's compute time.
    :param shuffle_bytes: total bytes each mapper emits, split evenly
        over its ``stride`` flows.
    :param placed: ``False`` leaves the reducers logical (see above).
    :returns: ``(graph, cluster)``.
    """
    if stride < 1:
        raise ValueError("stride must be >= 1")
    topo = Topology.fat_tree(k)
    hosts = topo.hosts()
    n = len(hosts) // 8
    g = MXDAG(f"ft{k}_shuffle_s{stride}" + ("" if placed else "_logical"))
    senders, receivers = hosts[:n], hosts[n:2 * n]
    reduces = [g.add(compute(f"r{j}", reduce_time,
                             receivers[j] if placed else None))
               for j in range(n)]
    for i, s in enumerate(senders):
        m = g.add(compute(f"m{i}", map_time, s))
        for jj in range(stride):
            j = (i + jj) % n
            f = g.add(flow(f"s{i}_{j}", shuffle_bytes / stride, s,
                           receivers[j] if placed else None))
            g.add_edge(m, f)
            g.add_edge(f, reduces[j])
    return g, Cluster.from_topology(topo)


# ----------------------------------------------------------------------
# deep serial chain (recursion-depth / event-trickle stress scenario)
# ----------------------------------------------------------------------
def serial_chain(n_tasks: int, *, size: float = 1.0, host: str = "H",
                 pipelined: bool = False, unit: Optional[float] = None,
                 job: str = "job0") -> MXDAG:
    """A single path of ``n_tasks`` compute tasks on one host.

    The degenerate DAG shape that stresses depth-sensitive code:
    recursive path enumeration (``paths_between``/``copaths`` crashed
    with RecursionError beyond ~1000 tasks before being rewritten
    iteratively), the analytic passes' level count (one task per
    level), and the DES event trickle (every completion is its own
    event — the regime the ddl builder hits at 1024 layers).
    """
    if n_tasks < 1:
        raise ValueError("need n_tasks >= 1")
    g = MXDAG(f"chain{n_tasks}")
    prev = None
    for i in range(n_tasks):
        t = g.add(compute(f"t{i:06d}", size, host, unit=unit, job=job))
        if prev is not None:
            g.add_edge(prev, t, pipelined=pipelined)
        prev = t
    return g


# ----------------------------------------------------------------------
# Graphene-style random layered DAG (cluster-scale synthetic workload)
# ----------------------------------------------------------------------
def random_layered(n_tasks: int = 20000, *, n_hosts: int = 256,
                   min_width: int = 64, max_width: int = 256,
                   fanout: int = 2, seed: int = 0,
                   job: str = "job0", name: Optional[str] = None,
                   host_prefix: str = "h") -> MXDAG:
    """Random layered MXDAG of roughly ``n_tasks`` tasks (Graphene scale).

    Graphene ("Do the Hard Stuff First", Grandl et al.) schedules
    production DAGs with tens of thousands of vertices; this generator
    produces comparable synthetic inputs: a chain of stages whose widths
    and task sizes are drawn from a seeded RNG, where every task reads
    from ``fanout`` tasks of the previous stage through an explicit
    shuffle flow.  The randomness is *stage-structured*, mirroring
    production DAGs: each layer draws its width (within
    ``[min_width, max_width]``), one compute size and one flow size
    (stages run many clones of one task), and a random rotation of the
    strided producer→consumer shuffle — rather than sampling every edge
    independently, which would desynchronize every flow completion into
    its own rate-reallocation event and bears no resemblance to staged
    cluster jobs.  Tasks are spread over ``n_hosts`` hosts (one CPU slot
    each); the graph is a pure function of its arguments.

    Stage widths follow production shape: jobs start wide (ingest) and
    narrow through aggregation stages, with occasional re-expansions
    (a new wide input joining).  Mostly non-increasing widths also keep
    the simulation event-dense rather than event-degenerate: a stage no
    wider than its producer keeps per-consumer fan-in the binding
    constraint, so stage flows finish in a bounded number of waves
    instead of splintering into per-flow completion events.

    Total task count is computes + flows ≈ ``n_tasks`` (one compute
    contributes ``1 + fanout`` tasks beyond the first layer).

    :param n_tasks: approximate total task count (computes + flows).
    :param n_hosts: hosts to spread tasks over (one CPU slot each).
    :param min_width: narrowest stage width (computes per layer).
    :param max_width: widest stage width; also the first layer's width.
    :param fanout: producers each consumer reads from (flows per task).
    :param seed: RNG seed — the graph is a pure function of arguments.
    :param job: job label stamped on every task.
    :param name: when set, names the graph and prefixes every task name
        with ``"{name}."`` (multi-job uniqueness, as in :func:`ddl`).
    :param host_prefix: hosts are ``f"{host_prefix}{i}"`` — lets small
        layered jobs land on a shared pool's hosts.
    :returns: the layered MXDAG.
    """
    if n_tasks < 2 or fanout < 1 or min_width < 1 \
            or max_width < min_width or n_hosts < max_width:
        raise ValueError("need n_tasks >= 2, fanout >= 1, "
                         "1 <= min_width <= max_width <= n_hosts")
    rng = random.Random(seed)
    pre = f"{name}." if name else ""
    g = MXDAG(name or f"layered{n_tasks}_s{seed}")
    hosts = [f"{host_prefix}{i}" for i in range(n_hosts)]
    prev: list[MXTask] = []
    total = 0
    layer = 0
    width = 0
    while total < n_tasks:
        if not prev or rng.random() < 0.15:
            width = max_width                    # ingest / re-expansion
        elif rng.random() < 0.5:
            pass                                 # plateau: width persists
        else:
            width = rng.randint(min_width, width)   # aggregation narrows
        csize = round(rng.uniform(0.5, 2.0), 6)
        fsize = round(rng.uniform(0.25, 1.0), 6)
        rot = rng.randrange(len(prev)) if prev else 0
        cur: list[MXTask] = []
        for i in range(width):
            if total >= n_tasks:
                break
            c = g.add(compute(f"{pre}L{layer}c{i}", csize, hosts[i],
                              job=job))
            total += 1
            cur.append(c)
            if prev:
                for j in range(min(fanout, len(prev))):
                    k = (rot + i * fanout + j) % len(prev)
                    p = prev[k]
                    f = g.add(flow(f"{pre}L{layer}c{i}f{k}", fsize,
                                   p.host, c.host, job=job))
                    total += 1
                    g.add_edge(p, f)
                    g.add_edge(f, c)
        if not cur:
            break
        prev = cur
        layer += 1
    return g


# ----------------------------------------------------------------------
# generic map-reduce generator (used by tests/benchmarks beyond the paper)
# ----------------------------------------------------------------------
def mapreduce(name: str, n_map: int, n_reduce: int, *,
              map_time: float = 1.0, shuffle_time: float = 1.0,
              reduce_time: float = 1.0, hosts_per_side: int | None = None,
              unit_frac: Optional[float] = None, job: str | None = None,
              host_prefix: str | None = None,
              placed: bool = True) -> MXDAG:
    """n_map mappers shuffling all-to-all into n_reduce reducers.

    :param name: graph name and default job label / host prefix.
    :param n_map: number of mappers.
    :param n_reduce: number of reducers.
    :param map_time: each mapper's compute time.
    :param shuffle_time: total bytes each mapper emits (split evenly
        over its ``n_reduce`` flows).
    :param reduce_time: each reducer's compute time.
    :param hosts_per_side: wrap mappers/reducers onto this many hosts
        per side (default: one host per task).
    :param unit_frac: when set, every task gets ``unit = unit_frac *
        size`` (enables pipelining experiments).
    :param job: job label; defaults to ``name``.
    :param host_prefix: lets multiple jobs share the same physical
        hosts (multi-job scheduling experiments); default: per-job
        private hosts.
    :param placed: ``False`` leaves every compute task logical and
        every shuffle flow's endpoints unbound (they follow their
        mapper/reducer via ``MXDAG.bind`` inference) — the scheduler
        chooses the hosts.
    :returns: the shuffle MXDAG.
    """
    job = job or name
    hp = host_prefix if host_prefix is not None else name
    g = MXDAG(name)
    nm_hosts = hosts_per_side or n_map
    nr_hosts = hosts_per_side or n_reduce

    def mh(i: int) -> str | None:
        """Mapper ``i``'s host (None when building logical tasks)."""
        return f"{hp}.M{i % nm_hosts}" if placed else None

    def rh(j: int) -> str | None:
        """Reducer ``j``'s host (None when building logical tasks)."""
        return f"{hp}.R{j % nr_hosts}" if placed else None

    maps = [g.add(compute(f"{name}.m{i}", map_time, mh(i), job=job,
                          unit=None if unit_frac is None
                          else unit_frac * map_time))
            for i in range(n_map)]
    reduces = [g.add(compute(f"{name}.r{j}", reduce_time, rh(j), job=job))
               for j in range(n_reduce)]
    for i, m in enumerate(maps):
        for j, r in enumerate(reduces):
            f = g.add(flow(f"{name}.s{i}_{j}", shuffle_time / n_reduce,
                           mh(i), rh(j), job=job,
                           unit=None if unit_frac is None
                           else unit_frac * shuffle_time / n_reduce))
            g.add_edge(m, f)
            g.add_edge(f, r)
    return g


# ----------------------------------------------------------------------
# online arrival stream (multi-job service workload source)
# ----------------------------------------------------------------------
JOB_SHAPES = ("mapreduce", "ddl", "fanin", "layered")


def pool_cluster(n_hosts: int = 8, *, host_prefix: str = "pool",
                 procs: Optional[dict] = None,
                 nic: float = 1.0) -> Cluster:
    """The shared host pool :func:`poisson_jobs` streams land on.

    ``2 * n_hosts`` homogeneous hosts — ``{host_prefix}.M{i}`` (mapper /
    worker side) and ``{host_prefix}.R{i}`` (reducer / parameter-server
    side) — each with a small CPU pool and one GPU slot (the ddl shape
    runs its BP/FP chain on a GPU).

    :param n_hosts: hosts per side.
    :param host_prefix: must match the stream's ``host_prefix``.
    :param procs: per-host processor pools (default
        ``{"cpu": 4, "gpu": 1}``).
    :param nic: per-direction NIC bandwidth.
    :returns: the homogeneous cluster.
    """
    hosts = [f"{host_prefix}.M{i}" for i in range(n_hosts)] \
        + [f"{host_prefix}.R{i}" for i in range(n_hosts)]
    return Cluster.homogeneous(hosts, procs=procs or {"cpu": 4, "gpu": 1},
                               nic=nic)


def poisson_jobs(rate: float, horizon: float, seed: int = 0, *,
                 mix: Sequence[str] = JOB_SHAPES, n_hosts: int = 8,
                 host_prefix: str = "pool",
                 ) -> list[tuple[float, MXDAG]]:
    """Seeded Poisson arrival stream of small jobs on one shared pool.

    Inter-arrival gaps are ``Exp(rate)``; each arrival draws a shape
    uniformly from ``mix`` and sizes it from the same seeded RNG, so the
    stream is a pure function of its arguments — the online benchmark
    and the admission tests share one reproducible workload source.
    Shapes (all on :func:`pool_cluster`'s hosts, so concurrent jobs
    contend for the same NICs and processor pools):

    - ``"mapreduce"`` — a small all-to-all shuffle (2–4 × 2–4);
    - ``"fanin"`` — 4–8 mappers aggregating into one long reducer on
      ``{host_prefix}.R0`` (the oversubscribed aggregation hot spot);
    - ``"ddl"`` — a 2–5 layer training iteration on one worker/PS pair;
    - ``"layered"`` — a 24–48 task random layered DAG over the mapper
      side.

    Task names are prefixed with the per-arrival job name
    (``j00017m`` …), so any subset of the stream merges collision-free.

    :param rate: mean arrivals per unit time.
    :param horizon: stop drawing arrivals at this time.
    :param seed: stream RNG seed.
    :param mix: shapes to draw from (subset of :data:`JOB_SHAPES`).
    :param n_hosts: pool hosts per side (match :func:`pool_cluster`).
    :param host_prefix: pool host name prefix.
    :returns: ``[(arrival_time, graph), ...]`` in arrival order.
    """
    if rate <= 0 or horizon <= 0:
        raise ValueError("need rate > 0 and horizon > 0")
    if not mix or any(s not in JOB_SHAPES for s in mix):
        raise ValueError(f"mix must be a non-empty subset of "
                         f"{JOB_SHAPES}, got {mix!r}")
    rng = random.Random(seed)
    out: list[tuple[float, MXDAG]] = []
    t = 0.0
    i = 0
    while True:
        t += rng.expovariate(rate)
        if t >= horizon:
            break
        shape = mix[rng.randrange(len(mix))]
        nm = f"j{i:05d}{shape[0]}"
        if shape == "mapreduce":
            g = mapreduce(nm, rng.randint(2, 4), rng.randint(2, 4),
                          map_time=round(rng.uniform(0.5, 2.0), 6),
                          shuffle_time=round(rng.uniform(0.5, 2.0), 6),
                          reduce_time=round(rng.uniform(0.25, 1.0), 6),
                          hosts_per_side=n_hosts,
                          host_prefix=host_prefix, job=nm)
        elif shape == "fanin":
            g = mapreduce(nm, rng.randint(4, 8), 1,
                          map_time=round(rng.uniform(0.25, 1.0), 6),
                          shuffle_time=round(rng.uniform(1.0, 2.0), 6),
                          reduce_time=round(rng.uniform(2.0, 4.0), 6),
                          hosts_per_side=n_hosts,
                          host_prefix=host_prefix, job=nm)
        elif shape == "ddl":
            k = rng.randrange(n_hosts)
            g = ddl(rng.randint(2, 5), name=nm, job=nm,
                    worker=f"{host_prefix}.M{k}",
                    ps=f"{host_prefix}.R{k}",
                    bp=round(rng.uniform(0.25, 1.0), 6),
                    fp=round(rng.uniform(0.25, 1.0), 6),
                    push=round(rng.uniform(0.5, 1.5), 6),
                    pull=round(rng.uniform(0.5, 1.5), 6))
        else:       # layered
            g = random_layered(rng.randint(24, 48), name=nm, job=nm,
                               n_hosts=n_hosts, min_width=2,
                               max_width=min(4, n_hosts), fanout=2,
                               seed=rng.randrange(1 << 30),
                               host_prefix=f"{host_prefix}.M")
        out.append((t, g))
        i += 1
    return out
