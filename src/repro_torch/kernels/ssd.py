"""K2, the SSD intra-chunk term (Mamba2), as a hand-written CUDA kernel.

The source is ``csrc/ssd.cu``; its header says which TPU kernel it
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_STATE = 256
# the C interface (name: argument types, result type);
# ssd_intra_chunk_fwd takes 8 pointers, 8 ints, 12 element strides, stream
C_FUNCTIONS = {
    "ssd_intra_chunk_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                            + [ctypes.c_longlong] * 12 + [ctypes.c_void_p],
                            ctypes.c_int),
    "ssd_load_kernels": ([], ctypes.c_int),
    "ssd_path": ([ctypes.c_int] * 4, ctypes.c_char_p),
    "ssd_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def build(flags: tuple[str, ...] = ()) -> _nvcc.Build:
    """Compile the kernel library once per process (and once per source
    and flags; ``("-DSSD_SPLIT_PIECES=2",)`` builds the bf16 path with two
    bf16 pieces of each fp32 operand instead of three)."""
    return _nvcc.build(SOURCE, flags)


@functools.cache
def library(flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library, built and bound, every kernel in it loaded onto
    the current card (so that no served launch pays for loading one)."""
    lib = _nvcc.load(SOURCE, C_FUNCTIONS, flags)
    err = lib.ssd_load_kernels()
    if err:
        raise RuntimeError(f"loading the SSD kernels failed: error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    return lib


def path(dtype: torch.dtype, Q: int, P: int, N: int) -> str:
    """What the kernel runs for this dtype, chunk, head dim and state dim,
    as the source's own dispatch names it (builds the library)."""
    return library().ssd_path(_DTYPE_CODES[dtype], Q, P, N).decode()


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
    for name, t in named[1:3]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (named[0],) + named[3:]:
        if t.dtype != x.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"x, Bm and Cm must share one dtype of "
                            f"{list(_DTYPE_CODES)}; {name} is {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dimension, got shape {tuple(t.shape)} and "
                             f"strides {t.stride()}")
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, L, H) or tuple(A.shape) != (H,)
            or not A.is_contiguous() or tuple(Bm.shape[:2]) != (B, L)
            or Cm.shape != Bm.shape):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if H % G:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")
    if not 0 < P <= MAX_HEAD_DIM or not 0 < N <= MAX_STATE:
        raise ValueError(f"head dim {P} must be at most {MAX_HEAD_DIM} and "
                         f"state dim {N} at most {MAX_STATE}")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} and heads {H} must be at most 65535")


def ssd_intra_chunk_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                        lib: ctypes.CDLL | None = None):
    """Launch K2.  x: [B,L,H,P]; dt: [B,L,H] fp32; A: [H] fp32; Bm, Cm:
    [B,L,G,N]; x, Bm and Cm in one dtype, read through their strides.

    Returns (y [B*H,nc,Q,P], state [B*H,nc,N,P], cum [B*H,nc,Q]), fp32,
    with Q = chunk and nc = L // Q: the layout of the Pallas kernel and of
    ``ref.ssd_intra_chunk_ref``.  ``lib`` is ``library()`` unless a
    variant's (``library(flags)``) is given.  Raises on any input the
    kernel does not take and on a launch the card refuses.
    """
    _check(x, dt, A, Bm, Cm, chunk)
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = L // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B * H, nc, chunk, P), **f32)
    state = torch.empty((B * H, nc, N, P), **f32)
    cum = torch.empty((B * H, nc, chunk), **f32)
    with torch.cuda.device(x.device):
        lib = lib or library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_intra_chunk_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), cum.data_ptr(),
            _DTYPE_CODES[x.dtype], B, nc, chunk, H, G, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2), stream)
    if err:
        raise RuntimeError(f"SSD launch failed: error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    return y, state, cum
