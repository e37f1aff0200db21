"""The collectives of the grid's model group (``launch.mesh``): tensor and
expert parallelism, the port's counterpart of what GSPMD and
``shard_map`` insert on the JAX package's "model" axis.

A tensor replicated over the model group (the residual stream, a block's
normed input, the router's probabilities) carries the same value and the
same whole gradient on every rank of the group.  Where it enters work
that each rank does on its own slice (local heads, local columns, local
experts), each rank's backward gives only a part of its gradient:
``enter`` is the identity forward and the group's all-reduce of the
gradient backward.  Where that work leaves as a part of a sum (a
row-parallel projection, the local experts' scatter-add), ``combine``
sums the parts over the group forward (``"psum"``: one all-reduce;
``"psum_scatter"``: a reduce-scatter over the tokens, then an
all-gather, as JAX's ``moe_combine``) and passes the replicated gradient
through backward.  The pair is Megatron's f and g.  A weight that is
split over the group but used whole is gathered at use
(``sync.shard.gathered_at_use``).

Decode over a cache split along its sequence (``launch.sharding.
cache_block``) adds two forward-only pieces: ``gather_heads``, which
gathers a call's per-head tensors (q, k, v, MLA's latent query) over the
model group, so that a rank can write and score every head of its rows;
and ``softmax_merge``, which joins the ranks' partial softmaxes over
their rows into the softmax over every row.

Every collective is noted on the model comm's ``log`` (``(kind, key)``),
which ``launch.train`` keeps per step beside ``GradSync.log``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sync import shard

COMBINES = ("psum", "psum_scatter")


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, key, x):
        ctx.comm, ctx.key = comm, key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        ctx.comm.all_reduce(g)
        ctx.comm.note("all-reduce", ctx.key)
        return None, None, g


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, key, how: str, y):
        y = y.contiguous()
        if how == "psum":
            out = y.clone()
            comm.all_reduce(out)
            comm.note("all-reduce", key)
            return out
        T = y.shape[0]
        if T % comm.world:
            raise ValueError(f"moe_combine psum_scatter: {T} tokens do not "
                             f"split over {comm.world} model ranks")
        part = y.new_empty((T // comm.world,) + tuple(y.shape[1:]))
        comm.reduce_scatter(part.view(-1), y.view(-1)).wait()
        comm.note("reduce-scatter", key)
        out = shard.gather(comm, part, 0)
        comm.note("all-gather", key)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None, None, g


class Tp:
    """The model group ``comm`` of a rank, as the layers use it."""

    def __init__(self, comm: shard.Comm):
        self.comm = comm
        self.size, self.rank = comm.world, comm.rank

    def enter(self, x: torch.Tensor, key) -> torch.Tensor:
        """``x`` (replicated) into per-rank work: its gradient summed over
        the group."""
        return _Enter.apply(self.comm, key, x)

    def combine(self, y: torch.Tensor, key, how: str = "psum"
                ) -> torch.Tensor:
        """The sum over the group of each rank's part ``y``, replicated;
        ``how`` as ``RunConfig.moe_combine`` (``"psum_scatter"`` splits
        ``y``'s first axis)."""
        if how not in COMBINES:
            raise ValueError(f"moe_combine {how!r}: want one of {COMBINES}")
        return _Combine.apply(self.comm, key, how, y)


def gather_heads(comm: shard.Comm, t: torch.Tensor, key: str
                 ) -> torch.Tensor:
    """Every rank's heads of ``t`` [B, S, heads, ...] (this rank's) in
    rank order along the heads axis: the whole tensor, as one process
    computes it.  Forward only (decode)."""
    out = shard.gather(comm, t.contiguous(), 2)
    comm.note("all-gather", key)
    return out


def softmax_merge(comm: shard.Comm, m: torch.Tensor, l: torch.Tensor,
                  o: torch.Tensor, key: str = "attn.merge") -> torch.Tensor:
    """The softmax-weighted output over the rows of every rank of
    ``comm``, from each rank's partial over its own rows: its running max
    ``m`` and denominator ``l`` [B,H,S] and unnormalised output ``o``
    [B,S,H,hd_v], all fp32.  The global max is all-reduced (max); each
    rank's ``l`` and ``o`` are rescaled by exp(m − max) and all-reduced
    (sum, in one buffer); out comes o / l, fp32, on every rank.  A rank
    whose rows are all masked holds m = −1e30 and l = o = 0, so it adds
    nothing.  Forward only (decode)."""
    mg = m.contiguous().clone()
    comm.all_reduce(mg, op=dist.ReduceOp.MAX)
    comm.note("all-reduce", key)
    a = torch.exp(m - mg)
    n = l.numel()
    buf = torch.cat([(l * a).reshape(-1),
                     (o * a.transpose(1, 2)[..., None]).reshape(-1)])
    comm.all_reduce(buf)
    comm.note("all-reduce", key)
    lg = buf[:n].view(l.shape).transpose(1, 2)[..., None]
    return buf[n:].view(o.shape) / lg


def step_log(model, cache=None, index: int = 0) -> dict:
    """(kind, key) → how many of the model group's collectives one
    training step of ``model`` (built on a grid, remat on, one
    microbatch) makes, keys as ``launch.train``'s ``model_log`` has them;
    with ``cache`` (``Model.init_cache``'s), what one
    ``Model.decode_step`` at ``index`` makes instead (``_decode_log``).

    A part that runs on its slice combines once in the forward and
    enters once (its input's gradient all-reduced in the backward): MLA
    enters three tensors (the low-rank query, the latents, the rope key),
    cross-attention two (the query's input and the encoder's states),
    expert parallelism the gates too.  Remat recomputes a repeat only as
    far as its backward needs: every combine again but a last one that
    only the residual add reads (the last block's FFN's).  A tensor
    gathered at use is gathered in the forward and again in the
    recompute, one collective a tensor, and reduce-scattered once; the
    MTP block runs without remat.  ``chip_smoke.py`` and the tests hold
    the logs to it."""
    from collections import Counter
    if cache is not None:
        return _decode_log(model, cache.layout, index)
    log = Counter()
    enters = {"attn": 3 if model.cfg.attn_type == "mla" else 1,
              "xattn": 2, "mlp": 1, "moe": 1}
    scatter = model.run.moe_combine == "psum_scatter"

    def repeat(blocks, key, remat: bool):
        parts = []
        for b in blocks:
            log["all-gather", key] += (1 + remat) * len(b.at_use)
            log["reduce-scatter", key] += len(b.at_use)
            for part, on in (("attn", b.tp_attn), ("xattn", b.tp_xattn),
                             ("mlp", b.tp_mlp),
                             ("moe", b.ep or b.tp_shared)):
                if on:
                    parts.append(part)
                    log["all-reduce", part] += enters[part]
            if b.ep:
                log["all-reduce", "moe.gate"] += 1
        last = blocks[-1]
        tail = last.tp_mlp or last.ep or last.tp_shared
        for i, part in enumerate(parts):
            n = 1 + (remat and not (tail and i == len(parts) - 1))
            if part == "moe" and scatter:
                log["reduce-scatter", part] += n
                log["all-gather", part] += n
            else:
                log["all-reduce", part] += n

    for si, seg in enumerate(model.segments_spec):
        for r in range(seg.repeats):
            repeat(list(model.segments[si]), (si, r), True)
    if model.cfg.encoder_layers:
        for r in range(model.cfg.encoder_layers):
            repeat([model.encoder], ("encoder", r), True)
    if model.cfg.mtp:
        repeat([model.mtp.block], ("mtp",), False)
        if model.mtp.place.model is not None:
            log["all-gather", ("mtp",)] += 1
            log["reduce-scatter", ("mtp",)] += 1
    tied, mtp = model.cfg.tie_embeddings, model.cfg.mtp
    uses = {"embed": 1 + tied + mtp, "head": 0 if tied else 1 + mtp}
    for name, n in uses.items():
        p = "lm_head" if name == "head" else name
        if n and p in model.shards and \
                model.shards.placements[p].model is not None:
            log["all-gather", (name,)] += n
            log["reduce-scatter", (name,)] += n
    return {k: v for k, v in log.items() if v}


def _decode_log(model, layout, index: int) -> dict:
    """The model group's collectives of one ``decode_step`` at ``index``
    on a cache laid out as ``layout`` (``launch.sharding.CacheBlock``),
    forward only: each tensor gathered at use once; each part on its
    slice combined once; a GQA block on its heads gathers the call's k
    and v (the cache holds every head of its rows); past index 0 on a
    split T, a block on its heads gathers its query (MLA: the latent
    query and the rope query, joined) and the merge all-reduces twice
    (on this group where it splits T; where the batch stays whole T
    splits over the world, whose collectives are not logged here)."""
    from collections import Counter
    log = Counter()
    if model.tp is None:
        return {}
    split = index > 0 and layout is not None and layout.t_comm is not None
    merge_here = split and layout.t_comm is model.tp.comm
    mla = model.cfg.attn_type == "mla"
    scatter = model.run.moe_combine == "psum_scatter"
    for si, seg in enumerate(model.segments_spec):
        for r in range(seg.repeats):
            for spec, b in zip(seg.pattern, model.segments[si]):
                log["all-gather", (si, r)] += len(b.at_use)
                if spec.mixer == "attn" and b.tp_attn:
                    log["all-reduce", "attn"] += 1
                    if not mla:
                        log["all-gather", "attn.kv"] += 2
                    if split:
                        log["all-gather", "attn.q"] += 1
                if spec.mixer == "attn" and merge_here:
                    log["all-reduce", "attn.merge"] += 2
                if b.tp_xattn:
                    log["all-reduce", "xattn"] += 1
                if b.tp_mlp:
                    log["all-reduce", "mlp"] += 1
                if b.ep or b.tp_shared:
                    if scatter:
                        log["reduce-scatter", "moe"] += 1
                        log["all-gather", "moe"] += 1
                    else:
                        log["all-reduce", "moe"] += 1
    tied = model.cfg.tie_embeddings
    for name, n in {"embed": 1 + tied, "head": 0 if tied else 1}.items():
        p = "lm_head" if name == "head" else name
        if n and p in model.shards and \
                model.shards.placements[p].model is not None:
            log["all-gather", (name,)] += n
    return {k: v for k, v in log.items() if v}
