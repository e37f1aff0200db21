"""Mixture-of-Experts blocks on one device: the router, capacity-bounded
dispatch, the expert FFNs on the grouped-matmul kernel K3, and the combine.

The single-device path of the JAX package's ``moe_apply`` (``mesh=None``:
one expert shard, no ``shard_map``, no cross-shard combine).  Each expert
takes at most ``_capacity(T)`` of the T tokens in a call; assignments past
that are dropped, in the order of a stable sort by expert id (so by token
within an expert), as there.  Parameters keep the JAX names and layouts;
the router is fp32 in every model dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """x: [B,S,d] → (y [B,S,d] in x's dtype, aux loss, a 0-d fp32 tensor).

    The expert FFN runs through ``ops.grouped_matmul`` (K3 on the card):
    three products, ``silu(x@w_gate) * (x@w_in)`` then ``@ w_out``.
    """
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    r = route(x2, p["router"], cfg)

    xe = x2[r.tok]                                              # [E,C,d]
    h = F.silu(ops.grouped_matmul(xe, p["w_gate"])) \
        * ops.grouped_matmul(xe, p["w_in"])
    ye = ops.grouped_matmul(h, p["w_out"])                      # [E,C,d]
    ye = ye * r.gate[..., None].to(ye.dtype)
    y = torch.zeros((x2.shape[0], d), dtype=ye.dtype, device=x.device)
    y.index_add_(0, r.tok.reshape(-1), ye.reshape(-1, d))

    if "shared_in" in p:
        hs = F.silu(x2 @ p["shared_gate"]) * (x2 @ p["shared_in"])
        y = y + hs @ p["shared_out"]
    return y.reshape(B, S, d), r.aux
