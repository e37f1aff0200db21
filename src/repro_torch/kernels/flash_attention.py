"""K1, flash attention forward, as a hand-written CUDA kernel for Hopper.

The source is ``csrc/flash_attention.cu``; its header says which TPU kernel
it replaces, what bounds it on the card and how it is laid out.  This
module builds it at first use through ``repro_torch.kernels.nvcc`` (into
its own hash-keyed directory), binds it with ``ctypes`` and launches it on
PyTorch's current stream.  Nothing here runs at import time: the CPU tests
import this module on machines with no compiler and no card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import nvcc as _nvcc
from repro_torch.kernels import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# the C interface (name: argument types, result type); flash_attention_fwd
# takes q, k, v, o; dtype, B, S, T, H, K, hd, hdv; the 12 element strides;
# scale, causal, q_off, stream
C_FUNCTIONS = {
    "flash_attention_fwd": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                            + [ctypes.c_longlong] * 12
                            + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p], ctypes.c_int),
    "flash_attention_load_kernels": ([], ctypes.c_int),
    "flash_attention_tiling": ([ctypes.c_int] * 3, ctypes.c_char_p),
    "flash_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def build() -> _nvcc.Build:
    """Compile the kernel library once per process (and once per source)."""
    return _nvcc.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built and bound, every kernel in it loaded onto
    the current card (so that no served launch pays for loading one)."""
    lib = _nvcc.load(SOURCE, C_FUNCTIONS)
    err = lib.flash_attention_load_kernels()
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"loading the flash attention kernels failed: "
                           f"error {err} ({msg})")
    return lib


def tiling(hd: int, hdv: int, dtype: torch.dtype) -> str:
    """The tiling the kernel runs for these head dims, as the source's own
    dispatch names it (builds the library)."""
    return _library().flash_attention_tiling(_DTYPE_CODES[dtype], hd,
                                             hdv).decode()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, q_offset: int = 0) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"q, k and v must share one dtype of "
                            f"{list(_DTYPE_CODES)}; {name} is {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dimension, got shape {tuple(t.shape)} and "
                             f"strides {t.stride()}")
        d = t.shape[-1]
        if d % 8 or not 0 < d <= MAX_HEAD_DIM:
            raise ValueError(f"{name} head dim {d} must be a multiple of 8 "
                             f"up to {MAX_HEAD_DIM}")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"bf16 {name} must start on 16 bytes with "
                             f"strides in multiples of 8 elements (the "
                             f"kernel copies 16-byte rows), got strides "
                             f"{t.stride()}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[-1] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if B > 65535 or H > 65535 or S > 65535 * 64:
        raise ValueError(f"batch {B} and heads {H} must be at most 65535, "
                         f"and S {S} at most {65535 * 64}")
    _ref.check_q_offset(S, k.shape[1], causal, q_offset)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Launch K1.  q: [B,S,H,hd]; k: [B,T,K,hd]; v: [B,T,K,hd_v] on one card.
    ``q_offset``: the key position of query row 0, for the causal mask
    (query row i sees keys 0 .. q_offset + i).

    Returns o [B,S,H,hd_v] in q's dtype.  Raises on any input the kernel
    does not take and on a launch the card refuses.
    """
    _check(q, k, v, causal, q_offset)
    B, S, H, hd = q.shape
    T, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        lib = _library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, T, H, K, hd, hdv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), int(bool(causal)), int(q_offset), stream)
    if err:
        raise RuntimeError(
            f"flash attention launch failed: error {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    return o
