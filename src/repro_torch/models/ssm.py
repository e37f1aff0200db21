"""Mamba2 / SSD (state-space duality) blocks: the chunked scan, the one-call
prefill into a decode cache, and the single-step decode recurrence.

The chunked SSD algorithm (arXiv:2405.21060 §6) splits the sequence into
chunks of length Q: a quadratic attention-like intra-chunk term, which runs
on the hand-written kernel K2 on the card (``kernels.ops.ssd_chunked``),
plus a linear inter-chunk state recurrence.  Parameters keep the JAX
package's names and layouts; ``A_log``, ``D`` and ``dt_bias`` are fp32 in
every model dtype, as there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, normal, rmsnorm

FP32_PARAMS = ("A_log", "D", "dt_bias")


def ssm_dims(cfg: ArchConfig) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return {"d_inner": d_in, "n_heads": nh, "head_dim": cfg.ssm_head_dim,
            "n_groups": cfg.ssm_n_groups, "d_state": cfg.ssm_state,
            "conv_dim": d_in + 2 * cfg.ssm_n_groups * cfg.ssm_state}


def ssm_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Shape of each parameter of one block (dtype: ``FP32_PARAMS`` are
    fp32, the rest in the model dtype)."""
    dims = ssm_dims(cfg)
    d, d_in, nh = cfg.d_model, dims["d_inner"], dims["n_heads"]
    proj_out = 2 * d_in + 2 * dims["n_groups"] * dims["d_state"] + nh
    return {"in_proj": (d, proj_out),          # z, xBC, dt
            "conv_w": (cfg.ssm_conv, dims["conv_dim"]),
            "conv_b": (dims["conv_dim"],),
            "A_log": (nh,), "D": (nh,), "dt_bias": (nh,),
            "norm_w": (d_in,),
            "out_proj": (d_in, d)}


def ssm_init(generator: torch.Generator, cfg: ArchConfig, *,
             dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    """One block's parameters, drawn as the JAX ``ssm_init`` draws them."""
    shapes = ssm_shapes(cfg)
    (d, proj_out), (W, conv_dim) = shapes["in_proj"], shapes["conv_w"]
    nh, d_in = shapes["A_log"][0], shapes["norm_w"][0]
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, d, proj_out, dtype=dtype,
                              device=device),
        "conv_w": normal(generator, (W, conv_dim), 1.0 / math.sqrt(W),
                         dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, d_in, cfg.d_model, dtype=dtype,
                               device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None, seq=None):
    """Depthwise causal conv1d.  x: [B,L,C]; w: [W,C].  Returns (y, new
    state [B,W-1,C]): the state carries the last W-1 inputs for decode.
    On a split sequence (``seq``, a ``sync.seq.Seq``) the W-1 rows before
    this rank's first are its left neighbour's last (``seq.halo``)."""
    W = w.shape[0]
    if seq is not None:
        pad = seq.halo(x[:, x.shape[1] - (W - 1):])
    elif state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [B,L+W-1,C]
    L = x.shape[1]
    y = xp[:, 0:L] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + L] * w[i]
    return F.silu(y + b), xp[:, -(W - 1):]


def ssm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              cache: Optional[dict[str, torch.Tensor]] = None,
              chunk: Optional[int] = None, seq=None):
    """Mamba2 block on x [B,L,d].  Returns (y [B,L,d], cache).

    - no cache: the chunked scan over the sequence from a zero state, with
      the chunk ``min(chunk or cfg.ssm_chunk, L)``, which must divide L (as
      JAX's ``ssd_chunked`` asserts);
    - cache {"conv": [B,W-1,C], "state": [B,H,P,N]} and L > 1: the one-call
      prefill, at any L.  The whole chunks run as one chunked scan from the
      cache's state and conv tail, and the L mod chunk tokens left as one
      shorter chunk from the state that scan ends in (two K2 launches where
      L > chunk is not a multiple of it); the final state and the new conv
      tail are written into the cache in place (the JAX package prefills
      token by token);
    - cache and L == 1: the single-step recurrence, in place;
    - ``seq`` (a ``sync.seq.Seq``; no cache): x is this rank's rows of a
      sequence split over the grid's model group, which the chunk must
      divide: the conv takes its halo from the left neighbour and the scan
      the state its ranks hand on (``ops.ssd_chunked``).
    """
    dims = ssm_dims(cfg)
    B_, L, _ = x.shape
    d_in, nh, hd = dims["d_inner"], dims["n_heads"], dims["head_dim"]
    G, N = dims["n_groups"], dims["d_state"]

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + dims["conv_dim"]]
    dt_raw = zxbcdt[..., -nh:]

    conv_state = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state,
                                 seq)

    xs = xBC[..., :d_in].reshape(B_, L, nh, hd)
    Bm = xBC[..., d_in:d_in + G * N].reshape(B_, L, G, N)
    Cm = xBC[..., d_in + G * N:].reshape(B_, L, G, N)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())                      # [H], negative

    if cache is None:
        Q = min(chunk or cfg.ssm_chunk, L)
        y, final = ops.ssd_chunked(xs, dt, A, Bm, Cm, Q, seq=seq)
    elif L > 1:
        Q = chunk or cfg.ssm_chunk
        whole = L - L % Q
        ys, final = [], cache["state"]
        for lo, hi, q in ((0, whole, Q), (whole, L, L - whole)):
            if hi > lo:
                y, final = ops.ssd_chunked(
                    xs[:, lo:hi], dt[:, lo:hi], A, Bm[:, lo:hi],
                    Cm[:, lo:hi], q, init_state=final)
                ys.append(y)
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    else:
        # single-step recurrence: S = exp(dt*A) S + dt * B ⊗ x ; y = C·S
        s = cache["state"].float()                          # [B,H,P,N]
        hpg = nh // G
        Bh = Bm[:, 0].float().repeat_interleave(hpg, dim=1)  # [B,H,N]
        Ch = Cm[:, 0].float().repeat_interleave(hpg, dim=1)
        dt0 = dt[:, 0]                                      # [B,H]
        xe = xs[:, 0].float()                               # [B,H,P]
        dec = torch.exp(dt0 * A)                            # [B,H]
        final = s * dec[..., None, None] \
            + torch.einsum("bhn,bhp,bh->bhpn", Bh, xe, dt0)
        y = torch.einsum("bhn,bhpn->bhp", Ch, final)[:, None].to(x.dtype)
    if cache is not None:
        cache["state"].copy_(final)
        cache["conv"].copy_(new_conv)

    y = y + (p["D"].float()[:, None] * xs.float()).to(y.dtype)
    y = y.reshape(B_, L, d_in)
    y = rmsnorm(p["norm_w"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], cache


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> dict[str, torch.Tensor]:
    """The conv tail in the model dtype, the SSD state in fp32."""
    dims = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, dims["conv_dim"]),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dims["n_heads"], dims["head_dim"],
                              dims["d_state"]), dtype=torch.float32,
                             device=device),
    }
