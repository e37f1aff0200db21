"""Public wrappers around the hand-written kernels, in the model's layout.

A wrapper dispatches on the device of the tensors it is given: on the CPU
it runs the kernel's plain version (``repro_torch.kernels.ref``); on a CUDA
tensor it launches the kernel or raises, and never falls back.  Each
wrapper counts its launches in a plain integer attribute (``.launches``),
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k: [B,T,K,hd]; v: [B,T,K,hd_v] → [B,S,H,hd_v] (GQA).

    Forward only: the recompute backward of the JAX wrapper waits for the
    training slice, so a CUDA input that requires grad raises.
    """
    if q.device.type == "cpu":
        o = _ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     scale=scale)
        return o.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {q.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward on CUDA yet (ROADMAP Queue 1, "
            "training slice); call it under torch.inference_mode()")
    o = _fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """The chunked SSD scan with its intra-chunk term on K2.

    xh: [B,L,H,P], dt: [B,L,H] (post-softplus, fp32), A: [H] (negative,
    fp32), Bm/Cm: [B,L,G,N] with H % G == 0; init_state: [B,H,P,N] or None
    for zeros.  Returns (y [B,L,H,P] in xh's dtype, final state [B,H,P,N]
    fp32).  L must be a multiple of ``chunk``.  The inter-chunk recurrence
    and its correction are linear and cheap, and stay plain PyTorch.
    Forward only: a CUDA input that requires grad raises.
    """
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk <= 0 or L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc = L // chunk
    if xh.device.type == "cpu":
        y_intra, states, cum = _ref.ssd_intra_chunk_ref(
            *_ref.to_chunks(xh, dt, A, Bm, Cm, chunk))
    elif xh.device.type == "cuda":
        if any(t.requires_grad for t in (xh, dt, A, Bm, Cm)):
            raise NotImplementedError(
                "ssd_chunked has no backward on CUDA yet (ROADMAP Queue 1, "
                "training slice); call it under torch.inference_mode()")
        y_intra, states, cum = _ssd.ssd_intra_chunk_fwd(xh, dt, A, Bm, Cm,
                                                        chunk)
        ssd_chunked.launches += 1
    else:
        raise ValueError(f"ssd_chunked runs on cpu or cuda, not {xh.device}")

    states = states.reshape(Bsz, H, nc, N, P)
    cum = cum.reshape(Bsz, H, nc, chunk)
    chunk_decay = torch.exp(cum[..., -1])                   # [B,H,nc]
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    prev = []                                               # state entering c
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[..., c, None, None] + states[:, :, c].transpose(
            -1, -2)
    prev = torch.stack(prev, dim=2)                         # [B,H,nc,P,N]

    # y_inter[b,c,q,h] = exp(cum) · (C of h's group) · prev[b,h,c]; the
    # group's C is contracted once per head group, not repeated per head
    hpg = H // G
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).float()
    y_inter = torch.einsum("bcqgn,bgjcpn->bcqgjp", Cc,
                           prev.reshape(Bsz, G, hpg, nc, P, N))
    decay_from_start = torch.exp(cum).permute(0, 2, 3, 1)   # [B,nc,Q,H]
    y_inter = y_inter.reshape(Bsz, nc, chunk, H, P) \
        * decay_from_start[..., None]
    y_intra = y_intra.reshape(Bsz, H, nc, chunk, P).permute(0, 2, 3, 1, 4)
    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y.to(xh.dtype), s


ssd_chunked.launches = 0


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E,C,d]; w: [E,d,f] → [E,C,f] in x's dtype, summed in fp32: the
    per-expert products of the MoE layer, on K3.

    The JAX wrapper's ``block_c/block_f/block_d`` tile the TPU kernel; K3
    picks its own tiles, so the port takes none.  Forward only: a CUDA
    input that requires grad raises while grad mode is on (the experts'
    weights are parameter slices, which keep ``requires_grad`` under
    ``torch.inference_mode()``).
    """
    if x.device.type == "cpu":
        return _ref.gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_matmul has no backward on CUDA yet (ROADMAP Queue 1, "
            "training slice); call it under torch.inference_mode()")
    out = _gmm.gmm_fwd(x, w)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
