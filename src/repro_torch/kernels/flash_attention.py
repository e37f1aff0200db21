"""K1, flash attention forward, as a hand-written CUDA kernel for Hopper.

The source is ``csrc/flash_attention.cu``; its header says which TPU kernel
it replaces, what bounds it on the card and how it is laid out.  This
module builds it with ``nvcc`` at first use into ``_build/<hash>/`` beside
this file (keyed by a hash of the source and flags, so an edit rebuilds),
loads it with ``ctypes`` and launches it on PyTorch's current stream.
Nothing here runs at import time: the CPU tests import this module on
machines with no compiler and no card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was on disk
    log: str            # nvcc's output: ptxas registers, shared memory, spills


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if not (home / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "flash-attention kernel is built from source")
    return str(home / "bin" / "nvcc")


@functools.cache
def build() -> Build:
    """Compile the kernel library once per process (and once per source)."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / key / "libflash_attention.so"
    if out.exists():
        return Build(out, 0.0, "")
    compiler = nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [compiler, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: concurrent builders never see half a file
    return Build(out, seconds, proc.stdout + proc.stderr)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[-1] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} and heads {H} must be at most 65535")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Launch K1.  q: [B,S,H,hd]; k: [B,T,K,hd]; v: [B,T,K,hd_v] on one card.

    Returns o [B,S,H,hd_v] in q's dtype.  Raises on any input the kernel
    does not take and on a launch the card refuses.
    """
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, T, H, K, hd, hdv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), int(bool(causal)), stream)
    if err:
        raise RuntimeError(
            f"flash attention launch failed: error {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    return o
