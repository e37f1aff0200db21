"""GQA attention, train/prefill and decode (KV cache).

The core dot-product attention has two implementations selectable per run
(``RunConfig.attn_impl``):

- ``"kernel"`` — the hand-written CUDA flash-attention kernel K1 through
  ``repro_torch.kernels.ops`` (its plain version on CPU tensors).  It
  takes causal self-attention over a whole sequence: the training/prefill
  case, and a cached call at index 0, where the cache mask reduces to
  causal attention over the first S rows (one-call prefill).
- ``"plain"`` — the masked einsum formulation (GQA grouped without
  repeating K/V, fp32 scores, ``-1e30`` masking).  Decode always runs it.

MLA (deepseek-v3) and cross-attention wait for later slices of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import Params, apply_rope, normal

NEG_INF = -1e30
IMPLS = ("kernel", "plain")


# ----------------------------------------------------------------------
# core scaled-dot-product attention with GQA grouping
# ----------------------------------------------------------------------
def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool,
         q_positions: Optional[torch.Tensor] = None,
         k_valid_len: Optional[torch.Tensor] = None,
         impl: str = "plain",
         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] with H % K == 0.  Returns [B,S,H,hd_v].

    ``q_positions`` ([S] or [B,S]) anchors causal masking for decode;
    ``k_valid_len`` ([B]) masks cache slots beyond the current length.
    """
    if impl not in IMPLS:
        raise ValueError(f"attn_impl {impl!r} is not one of {IMPLS}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    if impl == "kernel" and causal and S == T and k_valid_len is None:
        return _kops.flash_attention(q, k, v, causal=True, scale=scale)

    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    k_pos = torch.arange(T, device=q.device)
    mask = None
    if causal:
        q_pos = (torch.arange(S, device=q.device) if q_positions is None
                 else q_positions)
        if q_pos.dim() == 1:
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
        else:
            mask = (q_pos[:, :, None] >= k_pos[None, None, :])[:, None, None]
    if k_valid_len is not None:
        lm = (k_pos[None, :] < k_valid_len[:, None])[:, None, None, None]
        mask = lm if mask is None else mask & lm
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


# ----------------------------------------------------------------------
# GQA block
# ----------------------------------------------------------------------
def gqa_shapes(cfg: ArchConfig) -> dict[str, tuple[tuple[int, int], float]]:
    """name → (shape, init scale) of the projections."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    return {"wq": ((d, H * hd), s), "wk": ((d, K * hd), s),
            "wv": ((d, K * hd), s),
            "wo": ((H * hd, d), 1.0 / math.sqrt(H * hd))}


def gqa_init(generator: torch.Generator, cfg: ArchConfig, *,
             dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    return {name: normal(generator, shape, scale, dtype, device)
            for name, (shape, scale) in gqa_shapes(cfg).items()}


def gqa_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict[str, torch.Tensor]] = None,
              cache_index: Optional[int] = None,
              causal: bool = True,
              use_rope: bool = True,
              impl: str = "kernel"):
    """Self-attention.  Returns (out, cache).

    Train/prefill: cache is None, full sequence.
    Decode: cache = {"k": [B,Tmax,K,hd], "v": ...}; x is [B,S,d] written at
    rows ``cache_index .. cache_index+S`` (a Python int).  The port writes
    the cache in place and returns the same dict.
    """
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)

    if use_rope:
        if positions is not None:
            pos = positions
        elif cache is not None:
            pos = cache_index + torch.arange(S, device=x.device)
        else:
            pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_fraction)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rotary_fraction)

    if cache is None:
        out = sdpa(q, k, v, causal=causal, q_positions=positions, impl=impl)
        return out.reshape(B, S, H * hd) @ p["wo"], None

    idx = int(cache_index)
    T = cache["k"].shape[1]
    if not 0 <= idx <= T - S:
        raise IndexError(f"cache rows {idx}..{idx + S} exceed its {T} rows")
    cache["k"][:, idx:idx + S] = k
    cache["v"][:, idx:idx + S] = v
    if idx == 0:
        # index 0: the cache mask is causal attention over the first S rows,
        # so the kernel path takes the whole prompt in one call
        out = sdpa(q, cache["k"][:, :S].to(q.dtype),
                   cache["v"][:, :S].to(q.dtype), causal=causal, impl=impl)
    else:
        k_valid = torch.full((B,), idx + S, dtype=torch.int32,
                             device=x.device)
        out = sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                   causal=causal,
                   q_positions=idx + torch.arange(S, device=x.device),
                   k_valid_len=k_valid, impl=impl)
    return out.reshape(B, S, H * hd) @ p["wo"], cache


def gqa_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None
                   ) -> dict[str, torch.Tensor]:
    K, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, K, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=dtype,
                             device=device)}
