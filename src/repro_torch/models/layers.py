"""Shared model layers: init helpers, RMSNorm, RoPE, MLP variants, the
cross-entropy loss.

Plain functions on tensors, with parameters as dicts of tensors in the JAX
package's layouts (dense weights ``[d_in, d_out]``, used as ``x @ W``), so
parameters map one to one.  Random draws take an explicit
``torch.Generator``; ``jax.random`` numbers cannot be reproduced, so parity
tests load the reference's own parameters instead.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------
def normal(generator: torch.Generator, shape, scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """fp32 standard normal × scale, cast to dtype (the JAX init recipe).
    Scaled in place: one fp32 tensor of the shape, not two."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(generator, (d_in, d_out), scale, dtype, device)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return normal(generator, (vocab, d), 0.02, dtype, device)


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------
def _rmsnorm_raw(w: torch.Tensor, x: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(dt)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the JAX package's analytic backward:

        x̂ = x·rsqrt(mean x² + eps);  y = x̂·w
        dw = Σ_batch g·x̂
        dx = rsqrt(·) · ( g·w − x̂ · mean(g·w·x̂, -1) )

    in fp32, with dx returned in x's dtype and dw in w's, so a bf16
    activation's cotangent stays bf16 through the norm."""

    @staticmethod
    def forward(ctx, w, x, eps):
        ctx.save_for_backward(w, x)
        ctx.eps = eps
        return _rmsnorm_raw(w, x, eps)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()
        ih = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                         + ctx.eps)
        xhat = xf * ih
        dw = torch.sum((gf * xhat).reshape(-1, x.shape[-1]), dim=0)
        gw = gf * wf
        dx = ih * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
        return dw.to(w.dtype), dx.to(x.dtype), None


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm with fp32 internals; output in x's dtype, and a backward
    that returns dx in x's dtype (``_RMSNorm``)."""
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        return _RMSNorm.apply(w, x, eps)
    return _rmsnorm_raw(w, x, eps)


# ----------------------------------------------------------------------
# rotary position embeddings (full and partial/2d)
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].

    Rotates interleaved (even, odd) pairs, as the JAX package does.  With
    fraction < 1 only the first ``fraction`` of head dims rotate (chatglm3's
    2d RoPE); the rest pass through.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    inv = rope_freqs(hd, theta, fraction, device=x.device)      # [rot/2]
    ang = positions[..., None].float() * inv                    # [...,S,rot/2]
    cos = torch.cos(ang)[..., None, :]                          # [...,S,1,r/2]
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ----------------------------------------------------------------------
# MLP variants
# ----------------------------------------------------------------------
def mlp_shapes(d: int, ff: int, kind: str
               ) -> dict[str, tuple[tuple[int, int], float]]:
    """name → (shape, init scale) of an MLP's weights."""
    out = {"w_out": ((ff, d), 1.0 / math.sqrt(ff))}
    if kind == "swiglu":
        out["w_in"] = ((d, ff), 1.0 / math.sqrt(d))
        out["w_gate"] = ((d, ff), 1.0 / math.sqrt(d))
    elif kind in ("relu2", "gelu"):
        out["w_in"] = ((d, ff), 1.0 / math.sqrt(d))
    else:
        raise ValueError(kind)
    return out


def mlp_init(generator: torch.Generator, d: int, ff: int, kind: str,
             dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    return {name: normal(generator, shape, scale, dtype, device)
            for name, (shape, scale) in mlp_shapes(d, ff, kind).items()}


def mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["w_in"]))
    elif kind == "gelu":
        h = F.gelu(x @ p["w_in"], approximate="tanh")  # jax.nn.gelu default
    else:
        raise ValueError(kind)
    return h @ p["w_out"]


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE; logits [..., V] (any dtype, reduced in fp32), labels
    int [...], optional mask [...] of weights.

    The label logit is read with a gather, not a [.., V] one-hot: the same
    value without an fp32 one-hot of the logits' size (3 GB at internvl2's
    vocabulary of 92553, B 4 × S 2048)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
