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
from repro_torch.kernels import ref as _ref


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
