"""Attention: GQA (grouped-query) and MLA (multi-head latent), train/prefill,
decode (KV cache) and cross-attention.

The core dot-product attention has two implementations selectable per run
(``RunConfig.attn_impl``):

- ``"kernel"`` — the hand-written CUDA flash-attention kernel K1 through
  ``repro_torch.kernels.ops`` (its plain version on CPU tensors).  It
  takes self-attention over a whole sequence, causal or not: the
  training/prefill case, whisper's encoder, and a cached call at index 0,
  where the cache mask reduces to causal attention over the first S rows
  (one-call prefill).  The JAX package sends only the causal case to its
  Pallas kernel and the non-causal one to its einsum path: the same
  function.
- ``"plain"`` — the masked einsum formulation (GQA grouped without
  repeating K/V, fp32 scores, ``-1e30`` masking).  Decode and
  cross-attention always run it.

MLA's cache holds only the compressed latents (kv_lora + rope dims a
token).  Its decode runs attention in the latent space (the *absorbed*
form); its train path and its one-call prefill expand the latents to
per-head k and v and run the kernel at qk head dim 192 / v head dim 128.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import Params, apply_rope, normal, rmsnorm

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

    if impl == "kernel" and S == T and k_valid_len is None:
        return _kops.flash_attention(q, k, v, causal=causal, scale=scale)

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
              kv_src: Optional[torch.Tensor] = None,
              causal: bool = True,
              use_rope: bool = True,
              impl: str = "kernel"):
    """Self- or cross-attention.  Returns (out, cache).

    Train/prefill: cache is None, full sequence.
    Decode: cache = {"k": [B,Tmax,K,hd], "v": ...}; x is [B,S,d] written at
    rows ``cache_index .. cache_index+S`` (a Python int).  The port writes
    the cache in place and returns the same dict.
    Cross-attention: ``kv_src`` [B,T,d] (encoder states) gives the keys
    and values; no RoPE, no causal mask, no cache.
    """
    if kv_src is not None and cache is not None:
        raise ValueError("cross-attention takes no cache")
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if kv_src is not None:
        T = kv_src.shape[1]
        k = (kv_src @ p["wk"]).reshape(B, T, K, hd)
        v = (kv_src @ p["wv"]).reshape(B, T, K, hd)
        out = sdpa(q, k, v, causal=False, impl=impl)
        return out.reshape(B, S, H * hd) @ p["wo"], None
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


# ----------------------------------------------------------------------
# MLA block (deepseek-v3)
# ----------------------------------------------------------------------
def mla_shapes(cfg: ArchConfig
               ) -> dict[str, tuple[tuple[int, ...], Optional[float]]]:
    """name → (shape, init scale) of the MLA parameters; a scale of None is
    an RMSNorm weight (ones).  With ``q_lora_rank`` the query goes through
    a low-rank ``wq_a``/``q_norm``/``wq_b``, else one ``wq``."""
    d, H = cfg.d_model, cfg.n_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, ql, kl = cfg.v_head_dim, cfg.q_lora_rank, cfg.kv_lora_rank
    if ql:
        shapes = {"wq_a": ((d, ql), 1.0 / math.sqrt(d)),
                  "q_norm": ((ql,), None),
                  "wq_b": ((ql, H * (nope + rope_d)), 1.0 / math.sqrt(ql))}
    else:
        shapes = {"wq": ((d, H * (nope + rope_d)), 1.0 / math.sqrt(d))}
    shapes.update({
        "wkv_a": ((d, kl + rope_d), 1.0 / math.sqrt(d)),
        "kv_norm": ((kl,), None),
        "wkv_b": ((kl, H * (nope + vd)), 1.0 / math.sqrt(kl)),
        "wo": ((H * vd, d), 1.0 / math.sqrt(H * vd))})
    return shapes


def mla_init(generator: torch.Generator, cfg: ArchConfig, *,
             dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    return {name: torch.ones(shape, dtype=dtype, device=device)
            if scale is None else normal(generator, shape, scale, dtype,
                                         device)
            for name, (shape, scale) in mla_shapes(cfg).items()}


def _mla_q(p: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor):
    """(qn [B,S,H,nope], qr [B,S,H,rope] with RoPE applied)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
        q = (cq @ p["wq_b"]).reshape(B, S, H, nope + rope_d)
    else:
        q = (x @ p["wq"]).reshape(B, S, H, nope + rope_d)
    qn, qr = q[..., :nope], q[..., nope:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _mla_naive(qn, qr, ckv, kr, wk_b, wv_b, *, positions, impl):
    """Attention with the latents expanded to per-head k and v: k = [kn ;
    kr broadcast over heads] (contiguous, as K1 takes it), q = [qn ; qr],
    scale 1/√(nope + rope).  Returns [B,S,H,vd]."""
    B, T, H, rope_d = kr.shape[0], kr.shape[1], qn.shape[2], kr.shape[2]
    kn = torch.einsum("btl,lhn->bthn", ckv, wk_b)
    v = torch.einsum("btl,lhv->bthv", ckv, wv_b)
    k = torch.cat([kn, kr[:, :, None].expand(B, T, H, rope_d)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    return sdpa(q, k, v, causal=True, q_positions=positions, impl=impl)


def _mla_absorbed(qn, qr, ckv, kr, wk_b, wv_b, *, index: int):
    """Attention in the latent space over the cache rows ``:index+S``:
    q_lat = qn·wk_bᵀ, scores in fp32 (the JAX package's
    ``preferred_element_type``) over the latent and rope caches, the causal
    mask with -1e30, ctx over the latents in the model dtype, then wv_b.
    Rows past index+S are masked in JAX, so they are left out here.
    Returns [B,S,H,vd]."""
    S = qn.shape[1]
    nope, rope_d = qn.shape[-1], qr.shape[-1]
    T = index + S
    ckv, kr = ckv[:, :T].to(qn.dtype), kr[:, :T].to(qr.dtype)
    q_lat = torch.einsum("bshn,lhn->bshl", qn, wk_b)         # [B,S,H,kl]
    scores = (torch.einsum("bshl,btl->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshr,btr->bhst", qr.float(), kr.float()))
    scores = scores / math.sqrt(nope + rope_d)
    k_pos = torch.arange(T, device=qn.device)
    q_pos = index + torch.arange(S, device=qn.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btl->bshl", probs.to(ckv.dtype), ckv)
    return torch.einsum("bshl,lhv->bshv", ctx, wv_b.to(ctx.dtype))


def mla_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict[str, torch.Tensor]] = None,
              cache_index: Optional[int] = None,
              impl: str = "kernel"):
    """Returns (out, cache).  The cache holds the *compressed* latents:
    {"ckv": [B,Tmax,kv_lora], "kr": [B,Tmax,rope_d]}, written in place at
    rows ``cache_index .. cache_index+S`` (a Python int).

    No cache: the naive path (latents expanded per head; K1 on the
    "kernel" path).  A cached call at index 0 (one-call prefill) writes
    the latents and runs the same naive path over them, where the JAX
    package runs its absorbed path over the S tokens: the same function.
    At index > 0 the absorbed decode runs in the latent space."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, kl = cfg.v_head_dim, cfg.kv_lora_rank

    if cache is not None:
        pos = cache_index + torch.arange(S, device=x.device)
    elif positions is not None:
        pos = positions
    else:
        pos = torch.arange(S, device=x.device)
    qn, qr = _mla_q(p, x, cfg, pos)

    kv_a = x @ p["wkv_a"]
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :kl], cfg.norm_eps)
    kr = apply_rope(kv_a[..., None, kl:], pos, cfg.rope_theta)[:, :, 0]

    wkv_b = p["wkv_b"].reshape(kl, H, nope + vd)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]

    if cache is None:
        out = _mla_naive(qn, qr, ckv, kr, wk_b, wv_b, positions=pos,
                         impl=impl)
        return out.reshape(B, S, H * vd) @ p["wo"], None

    idx = int(cache_index)
    T = cache["ckv"].shape[1]
    if not 0 <= idx <= T - S:
        raise IndexError(f"cache rows {idx}..{idx + S} exceed its {T} rows")
    cache["ckv"][:, idx:idx + S] = ckv
    cache["kr"][:, idx:idx + S] = kr
    if idx == 0:
        out = _mla_naive(qn, qr, cache["ckv"][:, :S].to(x.dtype),
                         cache["kr"][:, :S].to(x.dtype), wk_b, wv_b,
                         positions=pos, impl=impl)
    else:
        out = _mla_absorbed(qn, qr, cache["ckv"], cache["kr"], wk_b, wv_b,
                            index=idx)
    return out.reshape(B, S, H * vd) @ p["wo"], cache


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None
                   ) -> dict[str, torch.Tensor]:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device)}
