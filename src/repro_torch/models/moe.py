"""Mixture-of-Experts blocks: the router, capacity-bounded dispatch, the
expert FFNs on the grouped-matmul kernel K3, and the combine.

One process runs the single-device path of the JAX package's
``moe_apply`` (``mesh=None``: one expert shard, no cross-shard combine);
on a grid of ranks (``launch.mesh``) each rank of the model group runs
its ``shard_map`` body: its own experts, then the combine over the
group (``moe_apply``).  On a sequence split over the model group
(``RunConfig.seq_shard``, ``sync.seq``) the ranks' rows are gathered
first, as JAX's ``shard_map`` takes the sequence whole: every rank routes
the whole sequence as one call, runs its own experts on it, and keeps its
rows of the sum.  Each expert
takes at most ``_capacity(T)`` of the T tokens in a call; assignments past
that are dropped, in the order of a stable sort by expert id (so by token
within an expert), as there.  Parameters keep the JAX names and layouts;
the router is fp32 in every model dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import operator
from typing import Iterator

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, normal

FP32_PARAMS = ("router",)


def moe_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Shape of each parameter of one MoE block (``FP32_PARAMS`` are fp32,
    the rest in the model dtype)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    shapes = {"router": (d, E), "w_in": (E, d, f), "w_gate": (E, d, f),
              "w_out": (E, f, d)}
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * f
        shapes.update(shared_in=(d, sf), shared_gate=(d, sf),
                      shared_out=(sf, d))
    return shapes


def moe_draws(generator: torch.Generator, cfg: ArchConfig, *, device=None
              ) -> Iterator[tuple[str, torch.Tensor]]:
    """One block's parameters as fp32 draws (normal × scale), (name,
    tensor) one at a time in the order the JAX ``moe_init`` lists them,
    each drawn when it is asked for; the caller casts those not in
    ``FP32_PARAMS``.  A caller that copies each into its place (the copy
    casts) holds one fp32 draw at a time: an expert stack of deepseek-v3
    is 15.0 GB in fp32."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    kw = dict(dtype=torch.float32, device=device)
    yield "router", dense_init(generator, d, E, **kw)
    yield "w_in", normal(generator, (E, d, f), 1.0 / math.sqrt(d), **kw)
    yield "w_gate", normal(generator, (E, d, f), 1.0 / math.sqrt(d), **kw)
    yield "w_out", normal(generator, (E, f, d), 1.0 / math.sqrt(f), **kw)
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * f
        yield "shared_in", dense_init(generator, d, sf, **kw)
        yield "shared_gate", dense_init(generator, d, sf, **kw)
        yield "shared_out", dense_init(generator, sf, d, **kw)


def moe_init(generator: torch.Generator, cfg: ArchConfig, *,
             dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    """One block's parameters, drawn as the JAX ``moe_init`` draws them."""
    return {name: w if name in FP32_PARAMS else w.to(dtype)
            for name, w in moe_draws(generator, cfg, device=device)}


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens
                      * cfg.n_experts_per_tok / cfg.n_experts))
    return max(8, -(-c // 8) * 8)          # >= 8, a multiple of 8


@dataclasses.dataclass
class Routing:
    """Where a call's T tokens go.  probs [T,E] fp32; ids and gates [T,k]
    (top-k, gates renormalised); tok, gate and valid [E,C]: the token in
    each expert slot, its gate and whether the slot is used (an unused slot
    points at token 0 with gate 0); counts [E]: assignments per expert
    before the capacity cut; aux: the Switch load-balance loss."""
    probs: torch.Tensor
    ids: torch.Tensor
    gates: torch.Tensor
    tok: torch.Tensor
    gate: torch.Tensor
    valid: torch.Tensor
    counts: torch.Tensor
    aux: torch.Tensor

    @property
    def dropped(self) -> torch.Tensor:
        """Assignments that found their expert full (a 0-d tensor)."""
        return (self.counts - self.valid.sum(dim=1)).sum()

    @property
    def margins(self) -> torch.Tensor:
        """Per token, its k-th router probability less its (k+1)-th: how
        far the top-k choice is from a tie."""
        k = self.ids.shape[1]
        top = torch.topk(self.probs, k + 1, dim=-1).values
        return top[:, k - 1] - top[:, k]


_recorders: list[list[Routing]] = []


@contextlib.contextmanager
def recorded_routes():
    """Collect every ``Routing`` made while inside, in call order (for
    checks of drops and near-ties; serving records nothing)."""
    seen: list[Routing] = []
    _recorders.append(seen)
    try:
        yield seen
    finally:
        _recorders.remove(seen)


def route(x2: torch.Tensor, router: torch.Tensor, cfg: ArchConfig) -> Routing:
    """x2: [T,d] → the fp32 router's top-k and the capacity-bounded slots."""
    T = x2.shape[0]
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    C = _capacity(T, cfg)
    dev = x2.device

    probs = torch.softmax(x2.float() @ router, dim=-1)          # [T,E]
    gates, ids = torch.topk(probs, k, dim=-1)                   # [T,k]
    gates = gates / gates.sum(dim=-1, keepdim=True)

    # load-balance aux (Switch-style)
    assign = torch.zeros((T, E), dtype=torch.float32, device=dev)
    assign.scatter_add_(1, ids, torch.full(ids.shape, 1.0 / k, device=dev))
    aux = E * torch.sum(assign.mean(dim=0) * probs.mean(dim=0))

    # sort assignments by expert id; stable, as jnp.argsort, so a full
    # expert keeps its lowest-numbered tokens and drops the rest
    flat_ids = ids.reshape(-1)                                  # [T*k]
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    sorted_tok = order // k
    sorted_gate = gates.reshape(-1)[order]

    edges = torch.searchsorted(sorted_ids,
                               torch.arange(E + 1, device=dev))
    starts, counts = edges[:-1], edges[1:] - edges[:-1]
    cols = torch.arange(C, device=dev)
    valid = cols[None, :] < torch.clamp(counts, max=C)[:, None]  # [E,C]
    slot = torch.where(valid, starts[:, None] + cols[None, :], 0)
    tok = sorted_tok[slot]
    gate = torch.where(valid, sorted_gate[slot], 0.0)
    r = Routing(probs, ids, gates, tok, gate, valid, counts, aux)
    for seen in _recorders:
        seen.append(r)
    return r


def _experts(x2: torch.Tensor, tok: torch.Tensor, gate: torch.Tensor,
             w_gate: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """The experts of the banks ``w_*`` [n, ...] on their slots ``tok``
    and ``gate`` [n, C] of the tokens ``x2`` [T, d]: the gated outputs
    summed into [T, d] (``index_add_``), in the banks' dtype.  The FFN
    runs through ``ops.grouped_matmul`` (K3 on the card): three products,
    ``silu(x@w_gate) * (x@w_in)`` then ``@ w_out``."""
    xe = x2[tok]                                                # [n,C,d]
    h = F.silu(ops.grouped_matmul(xe, w_gate)) \
        * ops.grouped_matmul(xe, w_in)
    ye = ops.grouped_matmul(h, w_out)                           # [n,C,d]
    ye = ye * gate[..., None].to(ye.dtype)
    y = torch.zeros(x2.shape, dtype=ye.dtype, device=x2.device)
    return y.index_add_(0, tok.reshape(-1), ye.reshape(-1, x2.shape[1]))


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared expert on ``x`` (its columns where ``p`` holds them)."""
    return (F.silu(x @ p["shared_gate"]) * (x @ p["shared_in"])) \
        @ p["shared_out"]


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *, tp=None,
              combine: str = "psum", ep: bool = False,
              shared_tp: bool = False, seq=None):
    """x: [B,S,d] → (y [B,S,d] in x's dtype, aux loss, a 0-d fp32 tensor).

    The expert FFN runs through ``ops.grouped_matmul`` (K3 on the card,
    ``_experts``).

    On a grid's model group ``tp`` (``sync.model_axis.Tp``), as JAX's
    ``shard_map`` body: with ``ep`` each rank holds experts ``rank·E/ep …
    (rank+1)·E/ep`` (``p``'s banks are its slice), routes the whole of
    its data shard's tokens (the same routing and aux loss on every rank)
    and dispatches to its own experts only; with ``shared_tp`` the shared
    expert runs on its columns.  Those parts are summed over the group by
    ``tp.combine`` (``combine``: ``"psum"`` or ``"psum_scatter"``).

    On a sequence split over the model group (``seq``, a
    ``sync.seq.Seq``; x holds this rank's rows) see ``_split_apply``:
    ``ep`` says whether ``p``'s banks are the rank's slice; ``tp``,
    ``combine`` and ``shared_tp`` are not read."""
    if seq is not None:
        return _split_apply(p, x, cfg, seq, ep)
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    r = route(x2, p["router"], cfg)
    tok, gate = r.tok, r.gate
    x_in = tp.enter(x2, "moe") if ep or shared_tp else x2
    if ep:
        # the gates of the local experts' slots: their gradient, and so
        # the router's through them, is this rank's part of the sum
        n = p["w_in"].shape[0]
        lo = tp.rank * n
        tok = tok[lo:lo + n]
        gate = tp.enter(gate, "moe.gate")[lo:lo + n]

    y = _experts(x_in if ep else x2, tok, gate, p["w_gate"], p["w_in"],
                 p["w_out"])

    # the terms of y: each rank's part of the group's sum, or whole
    terms = {True: [], False: []}
    terms[ep].append(y)
    if "shared_in" in p:
        terms[shared_tp].append(_shared(p, x_in if shared_tp else x2))
    parts, whole = (functools.reduce(operator.add, terms[k])
                    if terms[k] else None for k in (True, False))
    if parts is not None:
        parts = tp.combine(parts, "moe", combine)
        y = parts if whole is None else whole + parts
    else:
        y = whole
    return y.reshape(B, S, d), r.aux


def _split_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, seq,
                 ep: bool):
    """``moe_apply`` on this rank's rows x [B, rows, d] of a sequence
    split over the model group ``seq.comm`` of m ranks, as JAX's
    ``shard_map`` body runs under ``seq_shard``: the rows are gathered
    (``seq.gather_rows``) and the whole [B·L, d] routed as one call, so
    that the capacity, the stable order by token (b-major) and the aux
    loss are one process's on every rank.  Rank k runs experts ``k·E/m …
    (k+1)·E/m`` on their slots (``ep``: the banks are that slice, else
    whole and sliced here), and its partial [B, L, d]
    leaves through ``seq.scatter_rows``: the group's sum at its rows.
    Each rank's gradients are its part: its experts' slots (the router's
    through their gates) and 1/m of the aux loss (``seq.once``); the
    group's sum of them is one process's.  The shared expert runs whole
    on the rank's rows."""
    B, rows, d = x.shape
    m, E = seq.comm.world, cfg.n_experts
    if E % m:
        raise ValueError(f"seq_shard: {E} experts do not split over {m} "
                         f"model ranks")
    n = E // m
    lo = seq.comm.rank * n
    x2 = seq.gather_rows(x, "seq.moe").reshape(-1, d)
    r = route(x2, p["router"], cfg)
    banks = [w if ep else w[lo:lo + n]
             for w in (p["w_gate"], p["w_in"], p["w_out"])]
    y = _experts(x2, r.tok[lo:lo + n], r.gate[lo:lo + n], *banks)
    y = seq.scatter_rows(y.reshape(B, -1, d), "seq.moe")
    if "shared_in" in p:
        y = y + _shared(p, x)
    return y, seq.once(r.aux)
