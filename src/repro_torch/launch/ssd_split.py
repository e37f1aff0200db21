"""K2's bf16 path at each split depth: into how many bf16 pieces its fp32
operands (M = (C·Bᵀ)∘L∘dt for y, W = B·exp(cum_end − cum)·dt for the state)
must be cut for the products with the exact bf16 x to hold the checks.

    PYTHONPATH=src python -m repro_torch.launch.ssd_split [--pieces 1 2 3]

Builds the kernel library once per depth (``-DSSD_SPLIT_PIECES=n``, one
nvcc each, started together) and, at mamba2-130m's serving prefill shape
(x, B and C as strided views of one packed tensor, as the Mamba2 block
hands them over), prints for each depth y's and the state's max |d| from
the plain version (``ref.ssd_intra_chunk_ref``), the worst |d| / (tol +
tol |want|) at the bf16 tolerance (2e-2, what y is held to) and at the fp32
one (1e-4, what the state is held to through ``ops.ssd_chunked``'s final
state), and the kernel's time by CUDA events, all on one card.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.kernels import ref
from repro_torch.kernels import ssd
from repro_torch.launch import serve

B, L, H, G, P, N, Q = serve.SSM_BATCH, serve.SSM_PROMPT, 24, 1, 64, 128, 256
TOLS = {"bf16 2e-2": 2e-2, "fp32 1e-4": 1e-4}


def _inputs(gen: torch.Generator, dev):
    hp, gn = H * P, G * N
    packed = torch.randn((B, L, hp + 2 * gn), generator=gen,
                         device=dev).to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, L, H), generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    return (packed[..., :hp].reshape(B, L, H, P), dt, A,
            packed[..., hp:hp + gn].reshape(B, L, G, N),
            packed[..., hp + gn:].reshape(B, L, G, N))


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pieces", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args(argv)
    dev = _device.resolve(None)
    flags = {n: (f"-DSSD_SPLIT_PIECES={n}",) for n in args.pieces}
    with ThreadPoolExecutor() as pool:      # one nvcc per depth, together
        list(pool.map(ssd.build, flags.values()))
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.inference_mode():
        x, dt, A, Bm, Cm = _inputs(gen, dev)
        want = ref.ssd_intra_chunk_ref(*ref.to_chunks(x, dt, A, Bm, Cm, Q))
        for n, fl in flags.items():
            lib = ssd.library(fl)
            got = ssd.ssd_intra_chunk_fwd(x, dt, A, Bm, Cm, Q, lib=lib)
            parts = []
            for name, g, w in zip(("y", "state"), got, want):
                d = (g - w).abs()
                worst = ", ".join(
                    f"{k} {(d / (t + t * w.abs())).max().item():.4f}"
                    for k, t in TOLS.items())
                parts.append(f"{name} max|d| {d.max().item():.4e} (max|want| "
                             f"{w.abs().max().item():.4e}; worst |d| / (tol + "
                             f"tol |want|): {worst})")
            ms = _time_ms(lambda: ssd.ssd_intra_chunk_fwd(x, dt, A, Bm, Cm, Q,
                                                          lib=lib))
            print(f"K2 bf16, {n} piece(s) "
                  f"[{lib.ssd_path(1, Q, P, N).decode()}], B{B} L{L} H{H} "
                  f"G{G} P{P} N{N} Q{Q} on {torch.cuda.get_device_name(0)}: "
                  f"{'; '.join(parts)}; {ms:.4f} ms")
            del got


if __name__ == "__main__":
    main()
