"""Build a hand-written CUDA kernel with ``nvcc`` and load it with ``ctypes``.

Every kernel source in ``csrc/`` has a plain C interface.  ``build`` compiles
one source at first use into ``_build/<hash>/lib<stem>.so`` beside this file,
keyed by a hash of the source and the flags (so an edit rebuilds, and each
kernel keeps its own directory).  A missing compiler or a failed build
raises: nothing falls back to a plain version.  Nothing here runs at import
time: the CPU tests import this module on machines with no compiler and no
card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was on disk
    log: str            # nvcc's output: ptxas registers, shared memory, spills


def compiler() -> str:
    """Path of the CUDA compiler: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if not (home / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels are built from source")
    return str(home / "bin" / "nvcc")


@functools.cache
def build(source: Path, flags: tuple[str, ...] = ()) -> Build:
    """Compile ``source`` once per process (and once per source and flags);
    ``flags`` are added to ``NVCC_FLAGS`` (a variant's ``-D`` defines)."""
    flags = NVCC_FLAGS + tuple(flags)
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / key / f"lib{source.stem}.so"
    if out.exists():
        return Build(out, 0.0, "")
    nvcc = compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} with code "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent build never sees half a file
    return Build(out, seconds, proc.stdout + proc.stderr)


def load(source: Path, functions: dict,
         flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library of ``source`` (with ``flags``), each of
    ``functions`` (its name: argument types, result type) bound with those
    types."""
    lib = ctypes.CDLL(str(build(source, tuple(flags)).path))
    for name, (argtypes, restype) in functions.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib

