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

On a grid of ranks (``launch.mesh``) a rank's decode cache is its block
of JAX's ``cache_shardings`` (``launch.sharding.cache_block``): its rows
of the batch, and of the cache's T where the rule splits it, with every
KV head (MLA: the latents, which have none).  Its ``layout`` (a
``launch.sharding.CacheBlock``) tells where its rows sit.  The rank writes the rows of a call that fall
in its block.  A one-call prefill at index 0 attends over the call's
fresh k and v (K1, on the rank's heads).  Past index 0 each rank scores
every head's query (gathered over the model group where the rank
computed only its own heads) against its own rows, ``sdpa_partial``'s
running max, denominator and unnormalised output, and
``sync.model_axis.softmax_merge`` joins the ranks' partials; the rank
keeps its heads' slice for its row-parallel ``wo``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import Params, apply_rope, normal, rmsnorm
from repro_torch.sync import model_axis

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

    The "kernel" path takes self-attention over a whole sequence (S ==
    T, causal or not) and a causal query block that is the last S rows
    of the T keys (a rank's rows of a sequence split over the model
    group, against the keys of every row up to its last): K1 with the
    query offset T − S.  There ``q_positions``, where given, are those
    rows' positions, T − S onwards; the plain path reads them.
    """
    if impl not in IMPLS:
        raise ValueError(f"attn_impl {impl!r} is not one of {IMPLS}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    if impl == "kernel" and k_valid_len is None and (
            S == T or (causal and S < T)):
        # the offset is named only where there is one
        kw = {"q_offset": T - S} if S != T else {}
        return _kops.flash_attention(q, k, v, causal=causal, scale=scale,
                                     **kw)

    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    mask = _mask(S, T, q.device, causal, q_positions, k_valid_len)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def _mask(S: int, T: int, device, causal: bool,
          q_positions: Optional[torch.Tensor],
          k_valid_len: Optional[torch.Tensor], t0: int = 0):
    """The plain path's mask over scores [B,K,G,S,T] (broadcast), or
    None: causal on the queries' positions against the key rows' global
    positions ``t0 .. t0+T``, and rows at or past ``k_valid_len``."""
    k_pos = t0 + torch.arange(T, device=device)
    mask = None
    if causal:
        q_pos = (torch.arange(S, device=device) if q_positions is None
                 else q_positions)
        if q_pos.dim() == 1:
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
        else:
            mask = (q_pos[:, :, None] >= k_pos[None, None, :])[:, None, None]
    if k_valid_len is not None:
        lm = (k_pos[None, :] < k_valid_len[:, None])[:, None, None, None]
        mask = lm if mask is None else mask & lm
    return mask


def _partial(scores: torch.Tensor, mask: Optional[torch.Tensor]):
    """(running max, denominator, weights) of fp32 ``scores`` over their
    last axis, masked at -1e30; a masked weight is 0 even where every
    row is masked (there the max is -1e30 and exp(0) would weigh each
    masked row 1)."""
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return m, p.sum(dim=-1), p


def sdpa_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 t0: int, causal: bool,
                 q_positions: Optional[torch.Tensor] = None,
                 k_valid_len: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None):
    """``sdpa``'s plain masked path over a block of key rows k, v [B,T,K,
    hd] that starts at global row ``t0``, stopped before the softmax's
    division: (m, l [B,H,S]: each query's max score and its sum of
    exp(score − m); o [B,S,H,hd_v]: the exp-weighted sum of v), all
    fp32, for ``sync.model_axis.softmax_merge``.  The mask takes global
    positions and ``k_valid_len`` as ``sdpa``'s; a query whose rows here
    are all masked gets m = −1e30 and l = o = 0."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    m, l, p = _partial(scores, _mask(S, T, q.device, causal, q_positions,
                                     k_valid_len, t0))
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return (m.reshape(B, H, S), l.reshape(B, H, S),
            o.reshape(B, S, H, v.shape[-1]))


def _write(cache: dict, new: dict, idx: int, t0: int) -> None:
    """Rows ``idx .. idx+S`` of each ``new`` tensor [B,S,...] into the
    rows of a cache block that starts at global row ``t0`` that they
    fall on."""
    T = next(iter(cache.values())).shape[1]
    S = next(iter(new.values())).shape[1]
    lo, hi = max(idx, t0), min(idx + S, t0 + T)
    if lo < hi:
        for name, t in new.items():
            cache[name][:, lo - t0:hi - t0] = t[:, lo - idx:hi - idx]


def _check_rows(idx: int, S: int, T: int) -> None:
    if not 0 <= idx <= T - S:
        raise IndexError(f"cache rows {idx}..{idx + S} exceed its {T} rows")


def _my_heads(t: torch.Tensor, heads, n: int) -> torch.Tensor:
    """This rank's ``n`` heads (axis 2) of a tensor over every head of
    the model group ``heads``."""
    return t.narrow(2, heads.rank * n, n)


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
              impl: str = "kernel",
              layout=None, heads=None, seq=None):
    """Self- or cross-attention.  Returns (out, cache).

    Train/prefill: cache is None, full sequence.  On a sequence split over
    the model group (``seq``, a ``sync.seq.Seq``; causal, no cache) x
    holds this rank's rows, at ``positions`` in the whole (``seq``'s
    where None): RoPE at those positions, and the queries attend to the
    k and v of every row up to their last, gathered over the group
    (``seq.keys``), through K1 with the query offset ``seq.start`` on
    the "kernel" path.  Cross-attention on a split sequence: the rank's
    rows query the whole ``kv_src`` (every rank holds it), as without a
    split.
    Decode: cache = {"k": [B,Tmax,K,hd], "v": ...}; x is [B,S,d] written at
    rows ``cache_index .. cache_index+S`` (a Python int).  The port writes
    the cache in place and returns the same dict.  On a grid ``layout``
    says where the cache's rows sit, and ``heads`` is the model group's
    comm where ``p`` holds this rank's heads only (module docstring).
    Cross-attention: ``kv_src`` [B,T,d] (encoder states) gives the keys
    and values; no RoPE, no causal mask, no cache.
    """
    if kv_src is not None and cache is not None:
        raise ValueError("cross-attention takes no cache")
    if seq is not None and kv_src is None:
        if cache is not None or not causal:
            raise ValueError("a split sequence takes causal self-attention "
                             "or cross-attention, without a cache")
        if positions is None:
            positions = seq.positions(x.device)
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
        if seq is not None:
            # this rank's queries, the keys of every row up to its last
            k, v = seq.keys(k, v)
        out = sdpa(q, k, v, causal=causal, q_positions=positions, impl=impl)
        return out.reshape(B, S, H * hd) @ p["wo"], None

    idx = int(cache_index)
    t0 = layout.t0 if layout is not None else 0
    _check_rows(idx, S, layout.max_len if layout is not None
                else cache["k"].shape[1])
    new = {"k": k, "v": v}
    if heads is not None:
        # the cache holds every head of its rows
        new = {n: model_axis.gather_heads(heads, t, "attn.kv")
               for n, t in new.items()}
    _write(cache, new, idx, t0)
    q_pos = idx + torch.arange(S, device=x.device)
    k_valid = torch.full((B,), idx + S, dtype=torch.int32, device=x.device)
    if idx == 0:
        # index 0: the cache mask is causal attention over the first S rows,
        # so the kernel path takes the whole prompt in one call
        out = sdpa(q, k, v, causal=causal, impl=impl)
    elif layout is None or layout.t_comm is None:
        ck, cv = cache["k"], cache["v"]
        if heads is not None:
            ck, cv = _my_heads(ck, heads, K), _my_heads(cv, heads, K)
        out = sdpa(q, ck.to(q.dtype), cv.to(q.dtype), causal=causal,
                   q_positions=q_pos, k_valid_len=k_valid, impl=impl)
    else:
        qa = (q if heads is None
              else model_axis.gather_heads(heads, q, "attn.q"))
        m, l, o = sdpa_partial(qa, cache["k"].to(q.dtype),
                               cache["v"].to(q.dtype), t0=t0,
                               causal=causal, q_positions=q_pos,
                               k_valid_len=k_valid)
        out = model_axis.softmax_merge(layout.t_comm, m, l, o).to(q.dtype)
        if heads is not None:
            out = _my_heads(out, heads, H)
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


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _mla_q(p: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, enter=_same):
    """(qn [B,S,H,nope], qr [B,S,H,rope] with RoPE applied)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
        q = (enter(cq) @ p["wq_b"]).reshape(B, S, H, nope + rope_d)
    else:
        q = (enter(x) @ p["wq"]).reshape(B, S, H, nope + rope_d)
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


def _mla_absorbed_split(qn, qr, ckv, kr, wk_b, wv_b, *, index: int,
                        layout, heads):
    """``_mla_absorbed`` over a rank's block of the latent cache (rows
    from ``layout.t0``): every head's latent and rope query (gathered
    over the model group ``heads`` where the rank computed its own
    heads) scored against the block's rows in fp32, the causal mask on
    global positions, the weighted latents merged over
    ``layout.t_comm`` (``softmax_merge``), then this rank's heads
    through wv_b.  Returns [B,S,H,vd] of its heads."""
    S = qn.shape[1]
    nope, rope_d = qn.shape[-1], qr.shape[-1]
    H, kl = qn.shape[2], wk_b.shape[0]
    q_lat = torch.einsum("bshn,lhn->bshl", qn, wk_b)         # [B,S,H,kl]
    if heads is not None:
        q = model_axis.gather_heads(
            heads, torch.cat([q_lat, qr], dim=-1), "attn.q")
        q_lat, qr = q[..., :kl], q[..., kl:]
    ckv, kr = ckv.to(qn.dtype).float(), kr.to(qr.dtype).float()
    scores = (torch.einsum("bshl,btl->bhst", q_lat.float(), ckv)
              + torch.einsum("bshr,btr->bhst", qr.float(), kr))
    scores = scores / math.sqrt(nope + rope_d)
    k_pos = layout.t0 + torch.arange(ckv.shape[1], device=qn.device)
    q_pos = index + torch.arange(S, device=qn.device)
    m, l, p = _partial(scores, (q_pos[:, None] >= k_pos[None, :])[None, None])
    o = torch.einsum("bhst,btl->bshl", p, ckv)
    ctx = model_axis.softmax_merge(layout.t_comm, m, l, o)
    if heads is not None:
        ctx = _my_heads(ctx, heads, H)
    return torch.einsum("bshl,lhv->bshv", ctx.to(qn.dtype),
                        wv_b.to(qn.dtype))


def mla_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict[str, torch.Tensor]] = None,
              cache_index: Optional[int] = None,
              impl: str = "kernel", enter=None,
              layout=None, heads=None):
    """Returns (out, cache).  The cache holds the *compressed* latents:
    {"ckv": [B,Tmax,kv_lora], "kr": [B,Tmax,rope_d]}, written in place at
    rows ``cache_index .. cache_index+S`` (a Python int).

    No cache: the naive path (latents expanded per head; K1 on the
    "kernel" path).  A cached call at index 0 (one-call prefill) writes
    the latents and runs the same naive path over them, where the JAX
    package runs its absorbed path over the S tokens: the same function.
    At index > 0 the absorbed decode runs in the latent space; over a
    rank's block of a split cache (``layout``, ``heads`` as
    ``gqa_apply``'s), merged over the ranks.

    On a grid's model group ``p`` holds this rank's heads (``wq_b`` or
    ``wq``, ``wkv_b`` and ``wo``'s rows) and ``cfg`` their count; the
    latents and the low-rank query are the whole model's, and ``enter``
    (``sync.model_axis.Tp.enter``) takes each into the heads' work, so
    that its gradient sums the ranks' parts.  ``out`` is then this
    rank's part of the projection, for the caller to combine."""
    enter = enter or _same
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
    qn, qr = _mla_q(p, x, cfg, pos, enter)

    kv_a = x @ p["wkv_a"]
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :kl], cfg.norm_eps)
    kr = apply_rope(kv_a[..., None, kl:], pos, cfg.rope_theta)[:, :, 0]

    wkv_b = p["wkv_b"].reshape(kl, H, nope + vd)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]

    if cache is None:
        out = _mla_naive(qn, qr, enter(ckv), enter(kr), wk_b, wv_b,
                         positions=pos, impl=impl)
        return out.reshape(B, S, H * vd) @ p["wo"], None

    idx = int(cache_index)
    _check_rows(idx, S, layout.max_len if layout is not None
                else cache["ckv"].shape[1])
    # the latents are every head's: each rank computes them whole
    _write(cache, {"ckv": ckv, "kr": kr}, idx,
           layout.t0 if layout is not None else 0)
    if idx == 0:
        out = _mla_naive(qn, qr, enter(ckv), enter(kr), wk_b, wv_b,
                         positions=pos, impl=impl)
    elif layout is None or layout.t_comm is None:
        out = _mla_absorbed(qn, qr, cache["ckv"], cache["kr"], wk_b, wv_b,
                            index=idx)
    else:
        out = _mla_absorbed_split(qn, qr, cache["ckv"], cache["kr"], wk_b,
                                  wv_b, index=idx, layout=layout,
                                  heads=heads)
    return out.reshape(B, S, H * vd) @ p["wo"], cache


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None
                   ) -> dict[str, torch.Tensor]:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device)}
