"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each is the straightforward fp32 formulation of what its kernel computes.
The kernel wrappers in ``repro_torch.kernels.ops`` run these for tensors on
the CPU; on the card they are what a kernel is held against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """q: [B,H,S,hd]; k,v: [B,K,T,hd|hd_v].  Plain softmax attention in fp32."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)
