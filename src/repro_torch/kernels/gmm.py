"""K3, the grouped (per-expert) matrix product, as a hand-written CUDA kernel.

The source is ``csrc/gmm.cu``; its header says which TPU kernel it
replaces, what bounds it on the card and how it is laid out.  This module
builds it at first use through ``repro_torch.kernels.nvcc`` (into its own
hash-keyed directory), binds it with ``ctypes`` and launches it on
PyTorch's current stream.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import nvcc as _nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmm.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C interface (name: argument types, result type); gmm_fwd takes x, w,
# out; dtype, E, C, d, f; stream
C_FUNCTIONS = {
    "gmm_fwd": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                + [ctypes.c_void_p], ctypes.c_int),
    "gmm_load_kernels": ([], ctypes.c_int),
    "gmm_tiling": ([ctypes.c_int] * 2, ctypes.c_char_p),
    "gmm_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def build() -> _nvcc.Build:
    """Compile the kernel library once per process (and once per source)."""
    return _nvcc.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built and bound, every kernel in it loaded onto
    the current card and each bf16 tiling set up (so that no served launch
    pays for either)."""
    lib = _nvcc.load(SOURCE, C_FUNCTIONS)
    err = lib.gmm_load_kernels()
    if err:
        msg = lib.gmm_error_string(err).decode()
        raise RuntimeError(f"loading the grouped matmul kernels failed: error "
                           f"{err} ({msg})")
    return lib


def tiling(C: int, dtype: torch.dtype) -> str:
    """The tiling the kernel runs for C rows per expert, as the source's
    own dispatch names it (builds the library)."""
    return _library().gmm_tiling(_DTYPE_CODES[dtype], C).decode()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
        if t.dtype != x.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"x and w must share one dtype of "
                            f"{list(_DTYPE_CODES)}; {name} is {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be 3-d and contiguous, got shape "
                             f"{tuple(t.shape)} and strides {t.stride()}")
    E, C, d = x.shape
    if w.shape[0] != E or w.shape[1] != d:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if any(n % 8 or n <= 0 for n in (C, d, w.shape[2])):
        raise ValueError(f"C, d and f must be positive multiples of 8, got "
                         f"x {tuple(x.shape)}, w {tuple(w.shape)}")
    if not 0 < E <= 65535:
        raise ValueError(f"{E} experts: from 1 to 65535")


def gmm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K3.  x: [E,C,d]; w: [E,d,f], contiguous, one dtype (fp32 or
    bf16) → [E,C,f] in x's dtype, summed in fp32.  Raises on any input the
    kernel does not take and on a launch the card refuses."""
    _check(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        lib = _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          _DTYPE_CODES[x.dtype], E, C, d, f, stream)
    if err:
        raise RuntimeError(f"grouped matmul launch failed: error {err} "
                           f"({lib.gmm_error_string(err).decode()})")
    return out
