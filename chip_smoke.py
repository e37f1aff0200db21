#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases (each raises on failure):
1. box: the card's name and power limit, CUDA and nvcc versions, and the
   build of every hand-written kernel from the sources in this checkout
   (K1, K2 and K3, one nvcc each, started together), with ptxas's
   registers and spills;
2. K1 (flash attention, CUDA) against its plain PyTorch version on the card
   at the serving prefill shape and at GQA, MQA, non-causal, small and
   unequal head-dim and fp32 shapes, and at the edges of its tensor-core
   tilings (S one under and over a 64-row tile, hd 8 and 40, hd_v 256, MLA's
   192/128 at S 1024, GQA 4:1 at the serving shape), and at internvl2-2b's
   training shape (GQA 2:1, S 2048), each with the tiling it ran; and its
   time beside the plain version, ``F.scaled_dot_product_attention`` (a
   yardstick only) and its bound;
3. on a small input (the smoke config, fp32), the one-call prefill through
   K1 against token-by-token decode on the plain path;
4. serve deepseek-7b at full width (bf16, random weights from seed 0):
   4 requests, prompt 1024, 32 generated tokens; the prompt prefills in one
   call through K1 (30 launches, one per layer), decode runs the plain
   path (0 launches); the kernel-path prefill logits are held against the
   plain bf16 path's and an fp32 reference's on the same weights; each
   serving phase (4, 7, 10) warms up with a short request, times TTFT on
   the first full-size prefill, and prints a second prefill's time beside
   it;
5. K2 (the SSD intra-chunk term, CUDA; bf16 on the tensor cores) against
   its plain PyTorch version on the card at the mamba2-130m serving prefill
   shape, Q 8, a prompt shorter than a chunk, two groups of two heads, a
   slow decay, in bf16 and fp32, and at the edges of the bf16 path (Q 64,
   65, 232 and 255; one, two and 24 heads a group; N 64 and 256; P 32 and
   128; a view off 16-byte alignment; the longest chunk it takes at the
   serving N and P, 640, and one tile longer), each with the path it ran; its
   wrapper ``ops.ssd_chunked`` (K2 and the inter-chunk recurrence, as the
   main path calls it) at the serving shape, from a zero and from a random
   state, against the same call on CPU copies (its plain route) and
   against the sequential recurrence on the card; and K2's time beside
   the plain version and its bound;
6. SSD duality at full width (mamba2-130m, 2 × 512 tokens, and 2 × 300: a
   chunk and a remainder of 44, two K2 launches a layer): the one-call
   prefill through K2 against token-by-token decode on the sequential
   recurrence, in fp32 (logits and the final caches) and in bf16 (each
   side's logits against the fp32 model on the same weights, and the two
   sides against each other);
7. serve mamba2-130m at full width (bf16, random weights from seed 0):
   8 requests, prompt 4096, 32 generated tokens; the prompt prefills in
   one call through K2 (24 launches, one per layer), decode runs the
   single-step recurrence (0 launches); the last-position prefill logits
   are reported against an fp32 model on the same weights (bf16 serving
   is judged end to end at phase 6's 2 × 512, and K2's wrapper at this
   shape in phase 5);
8. K3 (the grouped matmul of the MoE experts, CUDA, wgmma fed by TMA in
   bf16) against its plain PyTorch version on the card at the four
   olmoe-1b-7b serving shapes (prefill and decode, x@w_gate / x@w_in and
   h@w_out) in bf16, at the prefill and decode shapes in fp32, at the three
   shapes of tests/test_kernels.py in both types, and at the edges of its
   two bf16 tilings (C 16, 24, 64, 72, 136, 648; d 136; f 72), each with
   the tiling it ran; its time at the four serving shapes beside the plain
   version, ``torch.bmm`` (a yardstick only) and its bound, and the host
   time per call of its wrapper, of its C launch function alone and of
   ``torch.bmm`` (where the wrapper's nears the kernel's time, that timing
   measures the host);
9. on a small input (the olmoe smoke config, fp32, nothing dropped), the
   one-call prefill through K1 and K3 against token-by-token decode on the
   plain attention path;
10. serve olmoe-1b-7b at full width (bf16, random weights from seed 0):
   4 requests, prompt 1024, 32 generated tokens; the prompt prefills in
   one call, attention through K1 (16 launches), each layer's experts
   through K3 (48 launches: three products a layer), and every decode
   step runs K3 48 times and K1 never; the share of prefill assignments
   that found their expert full is printed per layer;
11. the MoE layer at full width: layer 0 of that model on its own inputs
   (4 × 1024 tokens, capacity 640; 4 × 1, the decode step; 1 × 512 at
   capacity factor 0.5, where experts overflow) on the card against the
   same call on CPU copies (its plain route): identical routing (a token
   whose top-k differs is allowed only at a margin below NEAR_TIE, and is
   left out, with the experts it touches, and counted) and y within
   bf16's tolerance, with the least router top-k margin printed.

12. gradients: K1, K2 and K3 through their ``autograd.Function``s on the
   card (forward on the kernel, backward recomputing the plain version),
   in bf16 and fp32 at two small shapes each and at the shapes phases 14
   and 15 give K2 and K1, forward and every input gradient against
   autograd through the plain version on the card, one launch counted per
   forward;
13. one step of ``launch.train.make_train_step`` on the deepseek-7b,
   mamba2-130m and olmoe-1b-7b smoke configs in fp32 on the card against
   CPU copies: loss, every gradient and the parameters after AdamW;
14. train mamba2-130m at full width (bf16, remat, B 8 × S 4096) through
   ``runtime.run_training`` with the CLI's schedule: 30 steps, a
   checkpoint every 10, a failure injected at step 15; K2 forward (twice a
   layer a step: remat recomputes it) with the plain recompute backward;
15. train internvl2-2b's language model at full width (bf16, remat, text
   only, B 4 × S 2048): 12 steps, a checkpoint every 4, a failure at step
   6, with the CLI's AdamW at peak lr 1e-3; K1 forward twice a layer a
   step.
   Each full-width run prints its median step time, tokens/s, MFU, peak
   memory, launches a step, first and last loss and restarts, and checks
   one restart, a falling loss, finite losses, that the steps replayed
   from the checkpoint give the first pass's losses, and that the loss on
   a held-out batch fell by more than REPLAY_TOL of itself.  The launches
   of both runs count in the JSON line, beside the serving paths'.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.  With no
CUDA device, or without the port's package beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gmm as gmm_kernel  # noqa: E402
from repro_torch.kernels import nvcc, ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernel  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.runtime import LoopConfig, StepMonitor  # noqa: E402
from repro_torch.runtime import run_training  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:15
# bf16 logits after 30 layers carry the rounding of the whole stack, so the
# prefill logits are judged against an fp32 reference on the same weights:
# the kernel path may be no farther from it than the plain bf16 path (x1.25
# for noise), and the two bf16 paths must agree within twice that error
KERNEL_VS_PLAIN_ERR = 1.25
AGREE_VS_PLAIN_ERR = 2.0

SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = (
    serve.FULL_ARCH, serve.FULL_BATCH, serve.FULL_PROMPT, serve.FULL_GEN)
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN = (
    serve.SSM_ARCH, serve.SSM_BATCH, serve.SSM_PROMPT, serve.SSM_GEN)
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN = (
    serve.MOE_ARCH, serve.MOE_BATCH, serve.MOE_PROMPT, serve.MOE_GEN)
TRAIN_ARCH = "internvl2-2b"         # the GQA training path (SSM: SSM_ARCH)
# every kernel wrapper; each serving run sets all counts to 0 before it
# and holds each to what that path must launch
WRAPPERS = {"K1": ops.flash_attention, "K2": ops.ssd_chunked,
            "K3": ops.grouped_matmul}
# K2 against its plain version: tests/test_kernels.py:95, elementwise
# |d| <= atol + rtol * |want| (y and the state reach ~1e2, and fp32 sums
# in another order move them by ~1e-6 relative)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the one-call prefill (chunked, K2) against token-by-token decode (the
# sequential recurrence) in fp32: chunked vs sequential,
# tests/test_kernels.py:113, elementwise atol = rtol
DUALITY_TOL = 1e-3
DUALITY_BATCH, DUALITY_PROMPT = 2, 512
# a prompt that is no multiple of the chunk: 256 + 44, prefilled as the
# whole chunk and the remainder, two K2 launches a layer
RAGGED_PROMPT = 300
# In bf16 the two sides of the duality carry bf16 rounding compounded over
# 24 random layers (each ~0.214 relative norm from the fp32 model on the
# same bf16-valued weights), so each is judged against that model, as
# phase 4 judges K1: the one-call prefill through K2 may be no farther from
# fp32 than the token-by-token recurrence (x KERNEL_VS_PLAIN_ERR).  The two
# sides share most of that rounding, so they are held to each other more
# tightly: a relative norm of at most BF16_DUALITY_AGREE, 1.3x the
# 6.1256e-2 that seeded inputs gave on an NVIDIA H100 80GB HBM3, 700 W.
BF16_DUALITY_AGREE = 0.08
# K3 in fp32 against its plain version (cuBLAS's fp32 product): an fp32
# sum of d products carries rounding that scales with its terms, not with
# the result, and two correct summation orders differ by up to 4.4e-4
# (NVIDIA H100 80GB HBM3, 700 W) at d 2048 where the result is near 0 (at
# C 8 cuBLAS splits the sum over d, K3 does not).  So in fp32 the
# tolerance's absolute part is scaled by max|want|, as the repo's bf16
# model tests scale theirs; TF32's 10-bit mantissa would still miss it
# (by an error of ~3e-2 here, estimated, not measured).
# The unscaled ratio is printed beside it.
# Two routes of one MoE layer (the card's and the CPU's) sum the fp32
# router product in another order, ~1e-7 apart: a token whose k-th and
# (k+1)-th router probabilities are closer than NEAR_TIE may take either
# expert.  Such a token, if its choice differs, is left out with every
# expert it touches, and counted; any other difference fails.
NEAR_TIE = 1e-6


@dataclasses.dataclass(frozen=True)
class SsdCase:
    name: str
    B: int
    L: int
    H: int
    G: int
    P: int
    N: int
    Q: int
    dtype: torch.dtype
    a_scale: float = 1.0     # A = -a_scale * linspace(1, 16, H)
    misalign: int = 0        # leading columns that move the views off 16 B


SSD_PREFILL = SsdCase("prefill mamba2-130m", SSM_BATCH, SSM_PROMPT, 24, 1,
                      64, 128, 256, torch.bfloat16)
SSD_CASES = [
    SSD_PREFILL,
    SsdCase("prefill, fp32", 2, 1024, 24, 1, 64, 128, 256, torch.float32),
    SsdCase("slow decay", 2, 1024, 24, 1, 64, 128, 256, torch.float32, 0.01),
    SsdCase("Q 8 (smoke chunk)", 2, 64, 8, 1, 16, 16, 8, torch.float32),
    SsdCase("Q 8, bf16", 2, 64, 8, 1, 16, 16, 8, torch.bfloat16),
    SsdCase("prompt 100 < chunk", 2, 100, 24, 1, 64, 128, 100,
            torch.bfloat16),
    SsdCase("G 2, hpg 2", 2, 512, 4, 2, 64, 128, 256, torch.float32, 0.01),
    SsdCase("G 2, hpg 2, bf16", 2, 512, 4, 2, 64, 128, 256, torch.bfloat16),
    # the bf16 tensor-core path's edges: Q one 64-row tile, one row over,
    # the remainder of a 1000-token prompt, one row under a chunk; one, two
    # and 24 heads a group; N 64 and 256; P 32 and 128; views off 16-byte
    # alignment (staged element by element); the longest chunk it takes at
    # the serving N and P, and one tile longer (the CUDA-core kernel)
    SsdCase("Q 64", 2, 512, 8, 1, 64, 128, 64, torch.bfloat16),
    SsdCase("Q 65, hpg 2", 2, 390, 8, 4, 64, 128, 65, torch.bfloat16),
    SsdCase("Q 232 (1000 mod 256)", SSM_BATCH, 232, 24, 1, 64, 128, 232,
            torch.bfloat16),
    SsdCase("Q 255, hpg 1", 2, 510, 8, 8, 64, 128, 255, torch.bfloat16),
    SsdCase("hpg 24, G 2", 2, 512, 48, 2, 64, 128, 256, torch.bfloat16),
    SsdCase("N 64", 2, 1024, 24, 1, 64, 64, 256, torch.bfloat16),
    SsdCase("N 256", 2, 1024, 24, 1, 64, 256, 256, torch.bfloat16),
    SsdCase("P 32", 2, 1024, 24, 1, 32, 128, 256, torch.bfloat16),
    SsdCase("P 128, N 256", 2, 1024, 12, 1, 128, 256, 256, torch.bfloat16,
            0.01),
    SsdCase("view off 16 B", 2, 1000, 24, 1, 64, 128, 250, torch.bfloat16,
            misalign=1),
    SsdCase("Q 640", 1, 1280, 24, 1, 64, 128, 640, torch.bfloat16, 0.01),
    SsdCase("Q 704", 1, 1408, 24, 1, 64, 128, 704, torch.bfloat16, 0.01),
]


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    B: int
    S: int
    H: int
    K: int
    hd: int
    hdv: int
    causal: bool
    dtype: torch.dtype


PREFILL = Case("prefill deepseek-7b", SERVE_BATCH, SERVE_PROMPT, 32, 32, 128,
               128, True, torch.bfloat16)
CASES = [
    PREFILL,
    Case("gqa 2:1, ragged S", 2, 1000, 8, 4, 64, 64, True, torch.bfloat16),
    Case("mqa", 2, 512, 8, 1, 128, 128, True, torch.bfloat16),
    Case("non-causal", 2, 384, 4, 4, 128, 128, False, torch.bfloat16),
    Case("hd 16", 2, 200, 4, 2, 16, 16, True, torch.bfloat16),
    Case("hd 24 / hd_v 16", 2, 64, 4, 4, 24, 16, True, torch.bfloat16),
    Case("hd 192 / hd_v 128", 1, 256, 4, 4, 192, 128, True, torch.bfloat16),
    # the tensor-core tilings' edges: S = T one under and over a 64-row q
    # and KV tile; head dims that pad to the MMA's k; the widest hd_v; MLA's
    # 192/128 at a prompt's length; GQA 4:1 at the serving shape
    Case("S 127", 2, 127, 4, 4, 128, 128, True, torch.bfloat16),
    Case("S 129", 2, 129, 4, 2, 128, 128, True, torch.bfloat16),
    Case("S 129, non-causal", 2, 129, 4, 4, 64, 64, False, torch.bfloat16),
    Case("hd 8", 2, 200, 4, 2, 8, 8, True, torch.bfloat16),
    Case("hd 40", 2, 200, 4, 4, 40, 40, True, torch.bfloat16),
    Case("hd 256 / hd_v 256", 2, 300, 4, 2, 256, 256, True, torch.bfloat16),
    Case("hd 64 / hd_v 256", 1, 200, 4, 4, 64, 256, False, torch.bfloat16),
    Case("hd 192 / hd_v 128, S 1024", 1, 1024, 16, 16, 192, 128, True,
         torch.bfloat16),
    Case("gqa 4:1, serving shape", SERVE_BATCH, SERVE_PROMPT, 32, 8, 128,
         128, True, torch.bfloat16),
    # internvl2-2b's training forward (phase 15): GQA 2:1 at S 2048
    Case("train internvl2-2b", 4, 2048, 16, 8, 128, 128, True,
         torch.bfloat16),
    Case("fp32", 2, 300, 4, 2, 128, 128, True, torch.float32),
    Case("fp32 hd 256, non-causal", 1, 130, 2, 1, 256, 256, False,
         torch.float32),
]


@dataclasses.dataclass(frozen=True)
class GmmCase:
    name: str
    E: int
    C: int
    d: int
    f: int
    dtype: torch.dtype


# olmoe-1b-7b serving: 64 experts, d_model 2048, expert d_ff 1024; the
# prefill's capacity is 640 slots (4 x 1024 tokens), a decode step's 8
GMM_PREFILL = GmmCase("prefill x@w_gate, x@w_in", 64, 640, 2048, 1024,
                      torch.bfloat16)
GMM_DECODE = GmmCase("decode x@w_gate, x@w_in", 64, 8, 2048, 1024,
                     torch.bfloat16)
GMM_PATH = [GMM_PREFILL,
            GmmCase("prefill h@w_out", 64, 640, 1024, 2048, torch.bfloat16),
            GMM_DECODE,
            GmmCase("decode h@w_out", 64, 8, 1024, 2048, torch.bfloat16)]
GMM_CASES = GMM_PATH + [
    dataclasses.replace(GMM_PREFILL, name="prefill, fp32",
                        dtype=torch.float32),
    dataclasses.replace(GMM_DECODE, name="decode, fp32", dtype=torch.float32),
] + [GmmCase(f"E{E} C{C} d{d} f{f}", E, C, d, f, dt)   # tests/test_kernels.py
     for E, C, d, f in ((2, 16, 32, 32), (4, 64, 128, 64), (3, 32, 96, 48))
     for dt in (torch.bfloat16, torch.float32)] + [
    # the two bf16 tilings' edges: C 16, 24 and 64 on the 64-row tiling
    # (64 its last count), C 72 the first on the 128 x 256 one; C one row
    # group over a 128-row tile and over the prefill's capacity; d past a
    # 64-deep step, f past the first 64-wide box of a tile
    GmmCase("C 16", 8, 16, 2048, 1024, torch.bfloat16),
    GmmCase("C 24", 8, 24, 2048, 1024, torch.bfloat16),
    GmmCase("C 64", 8, 64, 2048, 1024, torch.bfloat16),
    GmmCase("C 72", 8, 72, 2048, 1024, torch.bfloat16),
    GmmCase("C 136", 8, 136, 1024, 2048, torch.bfloat16),
    GmmCase("C 648", 4, 648, 2048, 1024, torch.bfloat16),
    GmmCase("d 136", 4, 256, 136, 256, torch.bfloat16),
    GmmCase("f 72", 4, 256, 512, 72, torch.bfloat16)]


def zero_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def counts() -> dict[str, int]:
    return {name: w.launches for name, w in WRAPPERS.items()}


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(warmup):
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


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of fn, enqueued back to back without a
    synchronise (the device works behind): when it nears the device time
    per call, a CUDA-event timing of the same calls measures the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def attention_inputs(c: Case, gen: torch.Generator):
    """q [B,S,H,hd]; k, v as the first S rows of a longer cache (strided),
    the way the one-call prefill hands them to the kernel."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(c.dtype)
    q = randn(c.B, c.S, c.H, c.hd)
    k = randn(c.B, c.S + 32, c.K, c.hd)[:, :c.S]
    v = randn(c.B, c.S + 32, c.K, c.hdv)[:, :c.S]
    return q, k, v


def plain_attention(q, k, v, causal):
    o = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


def attention_bound_ms(c: Case) -> tuple[float, str]:
    """Least time for the work: each input read once, the output written
    once; products over the causal pairs only where causal."""
    elem = torch.finfo(c.dtype).bits // 8
    nbytes = elem * (c.B * c.S * c.H * (c.hd + c.hdv)
                     + c.B * c.S * c.K * (c.hd + c.hdv))
    pairs = c.S * (c.S + 1) // 2 if c.causal else c.S * c.S
    flops = 2 * c.B * c.H * pairs * (c.hd + c.hdv)
    peak = BF16_FLOP_PER_S if c.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_inputs(c: SsdCase, gen: torch.Generator):
    """x [B,L,H,P] and Bm/Cm [B,L,G,N] as strided views of one packed
    tensor, the way the Mamba2 block hands them to K2; dt = softplus of a
    normal draw, fp32.  ``c.misalign`` leading columns of the packed tensor
    move the views, and their row stride, off 16-byte alignment."""
    hp, gn, m = c.H * c.P, c.G * c.N, c.misalign
    packed = torch.randn((c.B, c.L, m + hp + 2 * gn), generator=gen,
                         device="cuda").to(c.dtype)
    dt = F.softplus(torch.randn((c.B, c.L, c.H), generator=gen,
                                device="cuda"))
    A = -c.a_scale * torch.linspace(1.0, 16.0, c.H, device="cuda")
    x = packed[..., m:m + hp].reshape(c.B, c.L, c.H, c.P)
    Bm = packed[..., m + hp:m + hp + gn].reshape(c.B, c.L, c.G, c.N)
    Cm = packed[..., m + hp + gn:].reshape(c.B, c.L, c.G, c.N)
    return x, dt, A, Bm, Cm


def ssd_bound_ms(c: SsdCase) -> tuple[float, str]:
    """Least time for K2's work: x, dt, A, B, C read once and y, state, cum
    written once; the causal half of C·Bᵀ once per group, of (C·Bᵀ∘L)(x·dt)
    per head, and the state product per head, at the peak for the inputs'
    type."""
    elem = torch.finfo(c.dtype).bits // 8
    nc = c.L // c.Q
    nbytes = (elem * c.B * c.L * (c.H * c.P + 2 * c.G * c.N)
              + 4 * (c.B * c.L * c.H + c.H)
              + 4 * c.B * c.H * (c.L * c.P + nc * c.N * c.P + c.L))
    pairs = c.Q * (c.Q + 1) // 2
    flops = 2 * c.B * nc * (c.G * pairs * c.N
                            + c.H * (pairs * c.P + c.Q * c.N * c.P))
    peak = BF16_FLOP_PER_S if c.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gmm_bound_ms(c: GmmCase) -> tuple[float, str]:
    """Least time for K3's work: x and w read once, out written once, and
    2·E·C·d·f operations at the peak for the inputs' type."""
    elem = torch.finfo(c.dtype).bits // 8
    nbytes = elem * c.E * (c.C * c.d + c.d * c.f + c.C * c.f)
    flops = 2 * c.E * c.C * c.d * c.f
    peak = BF16_FLOP_PER_S if c.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def compare(got: torch.Tensor, want: torch.Tensor,
            tol: float) -> tuple[float, float]:
    """max|d| and the worst |d| / (tol + tol |want|), inf on a shape
    mismatch or a non-finite difference: within tolerance where <= 1."""
    if got.shape != want.shape:
        return math.inf, math.inf
    want = want.to(got.device).float()
    d = (got.float() - want).abs()
    err, worst = d.max().item(), (d / (tol + tol * want.abs())).max().item()
    return err, worst if math.isfinite(err) else math.inf


def worst_scaled(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The worst |d| / (tol max|want| + tol |want|), as phase 8 judges fp32
    K3: within tolerance where <= 1; inf on a shape or non-finite miss."""
    if got.shape != want.shape:
        return math.inf
    want = want.to(got.device).float()
    d = (got.float() - want).abs()
    worst = (d / (tol * want.abs().max() + tol * want.abs())).max().item()
    return worst if math.isfinite(d.max().item()) else math.inf


def ptxas_lines(log: str) -> list[str]:
    """Registers and spills from ``-Xptxas -v``, one line per kernel
    instance, each after its (mangled) name."""
    out, name = [], "?"
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        elif "spill" in line or "registers" in line:
            out.append(f"{name}: {line.split(':')[-1].strip()}")
    return out


# ----------------------------------------------------------------------
def phase_box() -> str:
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print("nvcc:", sh(nvcc.compiler(), "--version").splitlines()[-1])
    kernels = (fa, ssd_kernel, gmm_kernel)
    with ThreadPoolExecutor() as pool:      # one nvcc per source, together
        builds = list(pool.map(lambda m: m.build(), kernels))
    for mod, b in zip(kernels, builds):
        print(f"build {mod.SOURCE.name}: {b.seconds:.2f} s -> "
              f"{b.path.parent.name}/{b.path.name}")
        for line in ptxas_lines(b.log):
            print("  ptxas:", line)
    return card


def phase_k1() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    with torch.inference_mode():
        for c in CASES:
            q, k, v = attention_inputs(c, gen)
            out = ops.flash_attention(q, k, v, causal=c.causal)
            want = plain_attention(q, k, v, c.causal)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOL[c.dtype]
            print(f"K1 {c.name:26s} B{c.B} S{c.S} H{c.H} K{c.K} "
                  f"hd{c.hd}/{c.hdv} {str(c.dtype)[6:]:8s} "
                  f"causal={c.causal} [{fa.tiling(c.hd, c.hdv, c.dtype)}]: "
                  f"max|d| {err:.3e} (tol {TOL[c.dtype]:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at {c.name}: {err}")
            errs[c.name] = err

        q, k, v = attention_inputs(PREFILL, gen)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
        plain_ms = time_ms(lambda: plain_attention(q, k, v, True))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(PREFILL)
    print(f"K1 at the prefill shape: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"sdpa (yardstick) {library_ms:.4f} ms ({ms / library_ms:.2f}x); "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.2f}% of bound")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:30",
            "max_abs_err": errs[PREFILL.name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_small(arch: str) -> None:
    """The repo's decode == prefill check on a small input (fp32, smoke
    config): the one-call prefill through the kernels against
    token-by-token decode on the plain attention path, over the same cache
    rows.  The smoke configs' capacity factor 16 drops nothing, so an MoE
    layer routes each token alike both ways."""
    cfg = configs.get_smoke(arch)
    B, S = 2, 40
    model, tokens = serve.setup(cfg, B, S, "cuda", dtype=torch.float32,
                                seed=1)
    with torch.inference_mode(), moe.recorded_routes() as seen:
        one_call, _ = model.decode_step(model.init_cache(B, S), tokens, 0)
        model.run = dataclasses.replace(model.run, attn_impl="plain")
        cache = model.init_cache(B, S)
        by_token = torch.cat([model.decode_step(cache, tokens[:, t:t + 1], t)[0]
                              for t in range(S)], dim=1)
    err = (one_call - by_token).abs().max().item()
    moe_note = ""
    if seen:
        dropped = sum(int(r.dropped) for r in seen)
        margin = min(r.margins.min().item() for r in seen)
        moe_note = (f"; MoE: {dropped} assignments dropped, least router "
                    f"top-k margin {margin:.3e}")
        if dropped:
            raise AssertionError(f"{cfg.name} dropped assignments at "
                                 f"capacity factor {cfg.capacity_factor}")
    print(f"small input ({cfg.name}, fp32): one-call prefill through the "
          f"kernels vs token-by-token plain decode: max|d| {err:.3e} (tol "
          f"1e-04){moe_note}")
    if not err <= 1e-4:
        raise AssertionError(f"one-call prefill and decode disagree: {err}")


def last_prefill_logits(model: Model, prompts) -> torch.Tensor:
    cache = model.init_cache(prompts.shape[0], prompts.shape[1])
    _, logits, _ = serve.prefill(model, cache, prompts)
    return logits[:, -1].float()


def fp32_copy(model: Model, run: RunConfig | None = None) -> Model:
    """An fp32 model on the same (bf16-valued) weights."""
    m = Model(model.cfg, run or model.run, dtype=torch.float32,
              device="cuda")
    with torch.inference_mode():
        for p32, p in zip(m.parameters(), model.parameters()):
            p32.copy_(p)
    return m


@dataclasses.dataclass
class Served:
    model: Model
    prompts: torch.Tensor
    last_logits: torch.Tensor       # kernel path, last prompt position, fp32
    launches: dict[str, int]        # per kernel, prefill and decode


def serve_run(arch: str, batch: int, prompt: int, gen: int,
              want: dict[str, tuple[int, int]]) -> Served:
    """Serve ``arch`` at full width (bf16, random weights from seed 0):
    ``batch`` prompts of ``prompt`` tokens prefilled in one call, then
    ``gen - 1`` greedy decode steps.  ``want`` maps a kernel of
    ``WRAPPERS`` to the launches the prefill and each decode step must
    make (every other kernel: none); tokens and logits are checked, the
    times and peak memory printed."""
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    model, prompts = serve.setup(cfg, batch, prompt, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    types = sorted({str(p.dtype)[6:] for p in model.parameters()})
    print(f"serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e6:.3f} M parameters ({', '.join(types)}), built "
          f"in {time.perf_counter() - t0:.1f} s")

    n_dec = gen - 1
    with torch.inference_mode():
        # warm-up request (cuBLAS handles, allocator), not counted
        serve.generate(model, prompts[:, :64], 2)
        cache = model.init_cache(batch, prompt + gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        zero_counts()
        t0 = time.perf_counter()
        tok, logits, cache = serve.prefill(model, cache, prompts)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        prefill_launches = counts()

        zero_counts()
        t0 = time.perf_counter()
        rest, cache = serve.decode(model, cache, tok, prompt, n_dec)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = counts()
        peak = torch.cuda.max_memory_allocated()

        tokens = torch.cat([tok, rest], dim=1)
        last_logits, _ = model.decode_step(cache, rest[:, -1:],
                                           prompt + gen - 1)
        # the same prefill again, on the cache left (attention rewrites
        # rows 0..prompt, an SSM block starts from the state left, at the
        # same cost): printed beside TTFT, which is the first full-size one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.prefill(model, cache, prompts)
        torch.cuda.synchronize()
        second_prefill = time.perf_counter() - t0
    bad = []
    for name in WRAPPERS:
        per_prefill, per_step = want.get(name, (0, 0))
        got = (prefill_launches[name], decode_launches[name])
        print(f"{name} launches: prefill {got[0]} (want {per_prefill}), "
              f"decode {got[1]} over {n_dec} steps (want {per_step} a step)")
        if got != (per_prefill, per_step * n_dec):
            bad.append(name)
    if bad:
        raise AssertionError(f"the serving path of {cfg.name} did not launch "
                             f"{bad} as it must")
    if tuple(tokens.shape) != (batch, gen) \
            or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    if not (torch.isfinite(logits).all()
            and torch.isfinite(last_logits).all()):
        raise AssertionError("non-finite logits")
    print("logits finite: prefill [B,P,V] and the last decode step")

    print(f"serve {cfg.name}: TTFT {1e3 * ttft:.2f} ms (prefill {batch}x"
          f"{prompt}), decode {1e3 * decode_s / n_dec:.3f} ms/token step, "
          f"decode {batch * n_dec / decode_s:.1f} tokens/s, end to end "
          f"{batch * gen / (ttft + decode_s):.1f} generated tokens/s, peak "
          f"memory {peak / 2**30:.3f} GiB")
    print(f"serve {cfg.name}: a second prefill of the same prompts "
          f"{1e3 * second_prefill:.2f} ms (TTFT above: the first)")
    print("sample:", tokens[0, :16].tolist())
    return Served(model, prompts, logits[:, -1].float(),
                  {name: prefill_launches[name] + decode_launches[name]
                   for name in WRAPPERS})


def phase_serve() -> dict:
    run = serve_run(SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                    {"K1": (configs.get(SERVE_ARCH).n_layers, 0)})
    model, kern_last = run.model, run.last_logits
    with torch.inference_mode():
        model.run = dataclasses.replace(model.run, attn_impl="plain")
        plain_last = last_prefill_logits(model, run.prompts)
        ref_last = last_prefill_logits(
            fp32_copy(model, RunConfig(attn_impl="plain")), run.prompts)

    rel_k, rel_p, rel_kp = (rel_err(kern_last, ref_last),
                            rel_err(plain_last, ref_last),
                            rel_err(kern_last, plain_last))
    agree = (kern_last.argmax(-1) == plain_last.argmax(-1)).float().mean()
    print(f"prefill last-position logits (max|logit| "
          f"{ref_last.abs().max().item():.4e}): relative error to the fp32 "
          f"reference: kernel path {rel_k:.4e}, plain path {rel_p:.4e}; "
          f"kernel vs plain {rel_kp:.4e}, max|d| "
          f"{(kern_last - plain_last).abs().max().item():.4e}, argmax "
          f"agreement {agree.item():.4f}")
    if not (rel_k <= KERNEL_VS_PLAIN_ERR * rel_p
            and rel_kp <= AGREE_VS_PLAIN_ERR * rel_p):
        raise AssertionError(
            "the kernel path's prefill logits are less accurate than the "
            "plain bf16 path's, or disagree with them by more than twice the "
            "plain path's own bf16 error")
    return run.launches


def phase_k2() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    with torch.inference_mode():
        for c in SSD_CASES:
            x, dt, A, Bm, Cm = ssd_inputs(c, gen)
            got = ssd_kernel.ssd_intra_chunk_fwd(x, dt, A, Bm, Cm, c.Q)
            want = ref.ssd_intra_chunk_ref(*ref.to_chunks(x, dt, A, Bm, Cm,
                                                          c.Q))
            torch.cuda.synchronize()
            tol, parts, ok = SSD_TOL[c.dtype], [], True
            for name, g, w in zip(("y", "state", "cum"), got, want):
                err, worst = compare(g, w, tol)
                ok = ok and worst <= 1.0
                parts.append(f"{name} {err:.3e}")
                errs[c.name] = max(errs.get(c.name, 0.0), err)
            print(f"K2 {c.name:20s} B{c.B} L{c.L} H{c.H} G{c.G} P{c.P} "
                  f"N{c.N} Q{c.Q} {str(c.dtype)[6:]:8s} "
                  f"[{ssd_kernel.path(c.dtype, c.Q, c.P, c.N)}]: max|d| "
                  f"{', '.join(parts)} (tol {tol:.0e} abs + rel) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"at {c.name}")
            del got, want

        # the wrapper the main path calls, as it calls it: K2 on the
        # model's strided tensors, then the inter-chunk recurrence
        c = SSD_PREFILL
        x, dt, A, Bm, Cm = ssd_inputs(c, gen)
        on_cpu = [t.cpu() for t in (x, dt, A, Bm, Cm)]
        s0 = torch.randn((c.B, c.H, c.P, c.N), generator=gen, device="cuda")
        bad = []
        for init in (None, s0):
            got = ops.ssd_chunked(x, dt, A, Bm, Cm, c.Q, init_state=init)
            plain = ops.ssd_chunked(*on_cpu, c.Q, init_state=None
                                    if init is None else init.cpu())
            seq = ref.ssd_sequential_ref(x, dt, A, Bm, Cm, init)
            torch.cuda.synchronize()
            for against, want, tols in (
                    ("its plain route (CPU)", plain,
                     (SSD_TOL[c.dtype], SSD_TOL[torch.float32])),
                    ("the sequential recurrence", seq,
                     (SSD_TOL[c.dtype], DUALITY_TOL))):
                parts = []
                for name, g, w, tol in zip(("y", "final state"), got, want,
                                           tols):
                    err, worst = compare(g, w, tol)
                    parts.append(f"{name} {err:.3e} (max|want| "
                                 f"{w.abs().max().item():.3e}, worst |d| / "
                                 f"(tol + tol |want|) {worst:.3f}, tol "
                                 f"{tol:.0e})")
                    if against.startswith("its plain"):
                        errs[c.name] = max(errs[c.name], err)
                    if not worst <= 1.0:
                        bad.append(f"{name} vs {against}, "
                                   f"init={init is not None}")
                print(f"ssd_chunked {c.name} B{c.B} L{c.L} Q{c.Q} "
                      f"{str(c.dtype)[6:]}, init state "
                      f"{'random' if init is not None else 'zero'}, vs "
                      f"{against}: max|d| {', '.join(parts)}")
            del got, plain, seq
        if bad:
            raise AssertionError(f"ssd_chunked disagrees at {c.name}: {bad}")

        chunked = ref.to_chunks(x, dt, A, Bm, Cm, c.Q)
        ms = time_ms(lambda: ssd_kernel.ssd_intra_chunk_fwd(
            x, dt, A, Bm, Cm, c.Q))
        plain_ms = time_ms(lambda: ref.ssd_intra_chunk_ref(*chunked))
    bound_ms, bound_by = ssd_bound_ms(c)
    print(f"K2 at the prefill shape: {ms:.4f} ms; plain {plain_ms:.4f} ms "
          f"(on its own chunked layout); no single PyTorch call computes "
          f"it; bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.2f}% of bound")
    return {"name": "ssd_intra_chunk_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:28",
            "max_abs_err": errs[c.name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_duality(S: int) -> None:
    """State-space duality at full width: the one-call prefill (the chunked
    scan through K2) against token-by-token decode (the sequential
    recurrence), over the same prompts of S tokens, in fp32 (logits and
    final caches) and in bf16 (logits, each against the fp32 model and each
    other).  The one-call prefill must launch K2 once a layer for the whole
    chunks and once more for a remainder."""
    cfg = configs.get(SSM_ARCH)
    B = DUALITY_BATCH
    want_launches = cfg.n_layers * ((S >= cfg.ssm_chunk)
                                    + (S % cfg.ssm_chunk > 0))
    model, tokens = serve.setup(cfg, B, S, "cuda", seed=1)
    bad = []

    def both_ways(m: Model):
        with torch.inference_mode():
            ops.ssd_chunked.launches = 0
            one_call, chunked = m.decode_step(m.init_cache(B, S), tokens, 0)
            launches = ops.ssd_chunked.launches
            seq = m.init_cache(B, S)
            t0 = time.perf_counter()
            by_token = torch.cat([m.decode_step(seq, tokens[:, t:t + 1],
                                                t)[0] for t in range(S)],
                                 dim=1)
            torch.cuda.synchronize()
        print(f"duality {cfg.name} {str(m.dtype)[6:]} B{B} S{S}: K2 "
              f"launches in the one-call prefill {launches} (want "
              f"{want_launches}); {S} token-by-token steps at "
              f"{1e3 * (time.perf_counter() - t0) / S:.3f} ms each")
        if launches != want_launches:
            bad.append(f"{str(m.dtype)[6:]} launches")
        return one_call.float(), chunked, by_token.float(), seq

    one_call, chunked, by_token, seq = both_ways(fp32_copy(model))
    checks = [("logits", one_call, by_token)] + [
        (f"{name} (all layers)", chunked[0][0]["ssm"][name],
         seq[0][0]["ssm"][name]) for name in ("state", "conv")]
    for name, got, want in checks:
        err, worst = compare(got, want, DUALITY_TOL)
        print(f"duality {cfg.name} fp32 B{B} S{S}, {name}: max|d| "
              f"{err:.3e}, relative norm {rel_err(got, want):.3e}, max|want| "
              f"{want.abs().max().item():.3e}, worst |d| / (tol + tol "
              f"|want|) {worst:.3f} (tol {DUALITY_TOL:.0e}) "
              f"{'ok' if worst <= 1.0 else 'FAIL'}")
        if not worst <= 1.0:
            bad.append(name)
    del chunked, seq, by_token

    kern, _, plain, _ = both_ways(model)
    rel_k, rel_p, rel_kp = (rel_err(kern, one_call), rel_err(plain, one_call),
                            rel_err(kern, plain))
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"duality {cfg.name} bf16 B{B} S{S}, logits at every position, "
          f"relative error to the fp32 model: one-call through K2 "
          f"{rel_k:.4e} (limit {KERNEL_VS_PLAIN_ERR} x token-by-token), "
          f"token-by-token {rel_p:.4e}; one-call vs token-by-token "
          f"{rel_kp:.4e} (limit {BF16_DUALITY_AGREE}), argmax agreement "
          f"{agree:.4f}")
    if not (rel_k <= KERNEL_VS_PLAIN_ERR * rel_p
            and rel_kp <= BF16_DUALITY_AGREE):
        bad.append("bf16 logits")
    if bad:
        raise AssertionError(f"one-call prefill and token-by-token decode "
                             f"disagree: {bad}")


def phase_serve_ssm() -> dict:
    run = serve_run(SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN,
                    {"K2": (configs.get(SSM_ARCH).n_layers, 0)})
    with torch.inference_mode():
        ref_last = last_prefill_logits(fp32_copy(run.model), run.prompts)
    bf16_last = run.last_logits
    agree = (bf16_last.argmax(-1) == ref_last.argmax(-1)).float().mean()
    print(f"prefill last-position logits (max|logit| "
          f"{ref_last.abs().max().item():.4e}): bf16 against an fp32 model "
          f"on the same weights: relative norm "
          f"{rel_err(bf16_last, ref_last):.4e}, max|d| "
          f"{(bf16_last - ref_last).abs().max().item():.4e}, argmax "
          f"agreement {agree.item():.4f} (reported: bf16 is judged at "
          f"phase 6's shape, K2's wrapper at this one in phase 5)")
    return run.launches


def phase_k3() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}

    def inputs(c: GmmCase):
        return (torch.randn((c.E, c.C, c.d), generator=gen,
                            device="cuda").to(c.dtype),
                torch.randn((c.E, c.d, c.f), generator=gen,
                            device="cuda").to(c.dtype))

    with torch.inference_mode():
        for c in GMM_CASES:
            x, w = inputs(c)
            got = gmm_kernel.gmm_fwd(x, w)
            want = ref.gmm_ref(x, w)
            torch.cuda.synchronize()
            tol = TOL[c.dtype]
            err, worst = compare(got, want, tol)
            scale = want.abs().max().item()
            scaled = worst_scaled(got, want, tol)
            ok = (worst if c.dtype == torch.bfloat16 else scaled) <= 1.0
            print(f"K3 {c.name:26s} E{c.E} C{c.C} d{c.d} f{c.f} "
                  f"{str(c.dtype)[6:]:8s} [{gmm_kernel.tiling(c.C, c.dtype)}]"
                  f": max|d| {err:.3e}, max|want| "
                  f"{scale:.3e}, worst |d| / (tol + tol |want|) {worst:.3f}, "
                  f"/ (tol max|want| + tol |want|) {scaled:.3f} (tol "
                  f"{tol:.0e}, judged by the "
                  f"{'first' if c.dtype == torch.bfloat16 else 'second'}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at {c.name}")
            errs[c.name] = err
            del x, w, got, want

        timed = {}
        for c in GMM_PATH:
            x, w = inputs(c)
            timed[c.name] = (
                time_ms(lambda: ops.grouped_matmul(x, w)),
                time_ms(lambda: ref.gmm_ref(x, w)),
                time_ms(lambda: torch.bmm(x, w)),
                *gmm_bound_ms(c))
            ms, plain_ms, library_ms, bound_ms, bound_by = timed[c.name]
            print(f"K3 at the {c.name} shape (E{c.E} C{c.C} d{c.d} "
                  f"f{c.f}): {ms:.4f} ms; plain {plain_ms:.4f} ms; torch.bmm "
                  f"(yardstick) {library_ms:.4f} ms ({ms / library_ms:.2f}x); "
                  f"bound {bound_ms:.4f} ms "
                  f"({bound_by}), {100 * bound_ms / ms:.2f}% of bound")
            del x, w
        # host time per call, after every device timing: run between two
        # device timings, its 200-call bursts at full load slowed the next
        # one, the kernel and its plain version alike
        # (the C launch function alone, through ctypes into a preallocated
        # output: what the wrapper's checks and allocation leave)
        lib = gmm_kernel._library()
        stream = torch.cuda.current_stream().cuda_stream
        for c in GMM_PATH:
            x, w = inputs(c)
            out = torch.empty((c.E, c.C, c.f), dtype=c.dtype, device="cuda")
            args = (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    gmm_kernel._DTYPE_CODES[c.dtype], c.E, c.C, c.d, c.f,
                    stream)
            wrapper_us = host_us(lambda: ops.grouped_matmul(x, w))
            c_us = host_us(lambda: lib.gmm_fwd(*args))
            bmm_us = host_us(lambda: torch.bmm(x, w))
            print(f"K3 at the {c.name} shape: host time per call: "
                  f"ops.grouped_matmul {wrapper_us:.1f} us, gmm_fwd alone "
                  f"{c_us:.1f} us, torch.bmm {bmm_us:.1f} us")
            del x, w, out
    ms, plain_ms, library_ms, bound_ms, bound_by = timed[GMM_PREFILL.name]
    return {"name": "gmm_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:23",
            "max_abs_err": max(errs[c.name] for c in GMM_PATH), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_serve_moe() -> tuple[dict, Served]:
    cfg = configs.get(MOE_ARCH)
    L = cfg.n_layers
    run = serve_run(MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN,
                    {"K1": (L, 0), "K3": (3 * L, 3 * L)})
    # the same prefill once more, its routings recorded (not timed)
    model, prompts = run.model, run.prompts
    with torch.inference_mode(), moe.recorded_routes() as seen:
        serve.prefill(model, model.init_cache(MOE_BATCH, MOE_PROMPT),
                      prompts)
        drops = [int(r.dropped) for r in seen]
    T = MOE_BATCH * MOE_PROMPT
    slots = T * cfg.n_experts_per_tok
    C = moe._capacity(T, cfg)
    print(f"serve {cfg.name}: capacity {C} slots per expert (factor "
          f"{cfg.capacity_factor}, {T} tokens in the one-call prefill); "
          f"share of the {slots} prefill assignments dropped per layer: "
          f"{[round(n / slots, 4) for n in drops]}; all layers "
          f"{sum(drops) / (slots * len(drops)):.4f}")
    if len(drops) != L:
        raise AssertionError(f"{len(drops)} MoE routings in the prefill, "
                             f"want {L}")
    return run.launches, run


def routing_agreement(r: moe.Routing, want: moe.Routing) -> tuple:
    """Compare two routings of the same tokens (``r`` on the card, ``want``
    on the CPU).  A token whose top-k differs is allowed only as a
    near-tie (margin below NEAR_TIE in ``want``); it and every expert it
    touches on either side are then left out.  Returns (flipped tokens,
    touched experts, tokens compared, {field: identical on the rest},
    whether every flip was a near-tie)."""
    ids = r.ids.cpu()
    flipped = (ids != want.ids).any(dim=1)
    near_ties = bool((want.margins[flipped] < NEAR_TIE).all())
    touched = torch.zeros(want.counts.shape[0], dtype=torch.bool)
    touched[ids[flipped].reshape(-1)] = True
    touched[want.ids[flipped].reshape(-1)] = True
    same = {name: torch.equal(getattr(r, name).cpu()[~touched],
                              getattr(want, name)[~touched])
            for name in ("tok", "valid", "counts")}
    same["ids"] = torch.equal(ids[~flipped], want.ids[~flipped])
    rows = ~(touched[want.ids].any(dim=1) | touched[ids].any(dim=1))
    return flipped, touched, rows, same, near_ties


def phase_moe_layer(run: Served) -> None:
    """Layer 0's MoE on its own inputs (the prompts' hidden states after
    block 0's attention) on the card against the same call on CPU copies,
    which runs K3's plain version."""
    model, cfg = run.model, run.model.cfg
    k = cfg.n_experts_per_tok
    bp = model.segments[0][0].at(0)
    with torch.inference_mode():
        x = model.embed[run.prompts].to(model.dtype)
        out, _ = attn.gqa_apply(bp["attn"], rmsnorm(bp["ln1"], x,
                                                    cfg.norm_eps), cfg)
        h = rmsnorm(bp["ln2"], x + out, cfg.norm_eps)
        p_cpu = {name: v.cpu() for name, v in bp["moe"].items()}
    bad = []
    for what, xs, factor in (
            ("B 4 S 1024", h, cfg.capacity_factor),
            ("B 4 S 1 (a decode step)", h[:, -1:], cfg.capacity_factor),
            ("B 1 S 512", h[:1, :512], 0.5)):
        c = dataclasses.replace(cfg, capacity_factor=factor)
        B, S, d = xs.shape
        T = B * S
        with torch.inference_mode(), moe.recorded_routes() as seen:
            y, aux = moe.moe_apply(bp["moe"], xs, c)
            want_y, want_aux = moe.moe_apply(p_cpu, xs.cpu(), c)
            torch.cuda.synchronize()
        r, want_r = seen
        flipped, touched, rows, same, near_ties = routing_agreement(r,
                                                                    want_r)
        if not near_ties:
            bad.append(f"{what}: routing differs beyond near-ties")
        if not rows.any():
            bad.append(f"{what}: every token was left out")
            continue
        yg, yw = y.cpu().float().reshape(-1, d), want_y.float().reshape(-1, d)
        scale = yw.abs().max().item()
        d_y = (yg - yw).abs()[rows]
        worst = (d_y / (TOL[torch.bfloat16] * (scale + yw.abs()[rows]))
                 ).max().item()
        # a flipped token moves 1/(kT) of the load between two experts,
        # which moves aux by at most E/(kT)
        aux_ok = abs(aux.item() - want_aux.item()) <= 1e-5 * abs(
            want_aux.item()) + int(flipped.sum()) * c.n_experts / (k * T)
        print(f"MoE layer 0, {what} (T {T}), capacity factor {factor} "
              f"(C {moe._capacity(T, c)}): dropped {int(r.dropped)} of "
              f"{T * k} assignments (CPU {int(want_r.dropped)}); least "
              f"router top-k margin {want_r.margins.min().item():.3e}; "
              f"near-tie tokens that routed otherwise: {int(flipped.sum())} "
              f"(left out with {int(touched.sum())} experts, "
              f"{int((~rows).sum())} tokens); routing identical {same}; y "
              f"max|d| {d_y.max().item():.3e} (max|y| {scale:.3e}), worst "
              f"|d| / (tol max|y| + tol |y|) {worst:.3f} (tol "
              f"{TOL[torch.bfloat16]:.0e}); aux {aux.item():.6f} vs "
              f"{want_aux.item():.6f}")
        if not (all(same.values()) and worst <= 1.0 and aux_ok):
            bad.append(what)
    if bad:
        raise AssertionError(f"the MoE layer on the card disagrees with its "
                             f"plain route: {bad}")


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
# the kernels' gradients: (kernel, shape) at two small shapes each and at
# the shapes the full-width training runs give K1 and K2 (phases 14-15),
# in bf16 and fp32.  K1: (B, S, H, K, hd), causal; K2: (B, L, H, G, P, N,
# Q); K3: (E, C, d, f), C 72 on the 128 x 256 tiling
GRAD_SHAPES = [("K1", (2, 128, 4, 2, 64)), ("K1", (1, 200, 4, 4, 128)),
               ("K1", (4, 2048, 16, 8, 128)),
               ("K2", (2, 64, 8, 1, 16, 16, 8)),
               ("K2", (1, 512, 4, 2, 64, 128, 256)),
               ("K2", (8, 4096, 24, 1, 64, 128, 256)),
               ("K3", (4, 64, 128, 64)), ("K3", (8, 72, 256, 128))]
# a small training step on the card against CPU copies: 1e-4 of each
# tensor's max (fp32 sums in another order)
STEP_TOL = 1e-4
STEP_SEQ, STEP_BATCH = 32, 2
# replayed steps against the first pass (bf16, atomics in the embedding's
# backward): relative.  A run has learned when its held-out loss
# (train.held_out_loss) fell by more than this share, the difference the
# script accepts between two runs of the same steps
REPLAY_TOL = 1e-3


def grad_case(kernel: str, shape: tuple, dtype: torch.dtype,
              gen: torch.Generator):
    """Leaf inputs on the card, the wrapper (through its Function) and the
    plain version, each returning a tuple of outputs."""
    def randn(*sh, dt=dtype):
        return torch.randn(sh, generator=gen, device="cuda").to(dt)

    if kernel == "K1":
        B, S, H, K, hd = shape
        ins = [randn(B, S, H, hd), randn(B, S, K, hd), randn(B, S, K, hd)]
        return (ins, ops.flash_attention,
                lambda *t: (ops.flash_attention(*t, causal=True),),
                ops._plain_attention(True, None))
    if kernel == "K2":
        B, L, H, G, P, N, Q = shape
        ins = [randn(B, L, H, P),
               F.softplus(randn(B, L, H, dt=torch.float32)),
               -torch.linspace(1.0, 16.0, H, device="cuda"),
               randn(B, L, G, N), randn(B, L, G, N)]
        return (ins, ops.ssd_chunked,
                lambda *t: ops._SsdIntraChunk.apply(*t, Q),
                ops._plain_intra_chunk(Q))
    E, C, d, f = shape
    return ([randn(E, C, d), randn(E, d, f)], ops.grouped_matmul,
            lambda *t: (ops.grouped_matmul(*t),),
            lambda x, w: (ref.gmm_ref(x, w),))


def phase_grads() -> None:
    gen = torch.Generator(device="cuda").manual_seed(12)
    bad = []
    for kernel, shape in GRAD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            ins, wrapper, kern, plain = grad_case(kernel, shape, dtype, gen)
            ins = [t.requires_grad_() for t in ins]
            before = wrapper.launches
            got = kern(*ins)
            launched = wrapper.launches - before
            want = plain(*ins)
            cots = [torch.randn(w.shape, generator=gen, device="cuda")
                    .to(w.dtype) for w in want]
            g_got = torch.autograd.grad(got, ins, cots)
            g_want = torch.autograd.grad(want, ins, cots)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            worst = {"out": max(worst_scaled(a, b, tol)
                                for a, b in zip(got, want))}
            worst.update({f"d{i}": worst_scaled(a, b, tol)
                          for i, (a, b) in enumerate(zip(g_got, g_want))})
            ok = launched == 1 and max(worst.values()) <= 1.0
            print(f"grad {kernel} {shape} {str(dtype)[6:]:8s}: launches "
                  f"{launched} (want 1); worst |d| / (tol max|want| + tol "
                  f"|want|), tol {tol:.0e}: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
                  + (" ok" if ok else " FAIL"))
            if not ok:
                bad.append(f"{kernel} {shape} {dtype}")
    if bad:
        raise AssertionError(f"kernel gradients disagree with autograd "
                             f"through the plain versions: {bad}")


class _KeepGrads:
    """Wraps an optimizer: keeps a CPU copy of the gradients it is handed."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {k: g.detach().float().cpu() for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def phase_small_train() -> None:
    """One train step of each served family's smoke config in fp32, the
    card against CPU copies.  An AdamW step moves an element by about lr
    whatever its gradient's size, so where a CPU gradient is within the
    gradient tolerance of 0 its sign is undetermined: such elements may
    differ by up to 2 lr, and are counted."""
    bad = []
    for arch in (SERVE_ARCH, SSM_ARCH, MOE_ARCH):
        cfg = configs.get_smoke(arch)
        run = RunConfig()
        out = {}
        for dev in ("cuda", "cpu"):
            model = Model(cfg, run, dtype=torch.float32, device=dev)
            if dev == "cuda":
                model.init(torch.Generator(device="cuda").manual_seed(13))
                weights = {k: v.cpu() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(weights)
            opt = _KeepGrads(train.cli_optimizer(10))
            state = {"params": model, "opt": opt.init(model)}
            batch = SyntheticLM(DataConfig(cfg.vocab_size, STEP_SEQ,
                                           STEP_BATCH, seed=13),
                                dev).batch_at(0)
            zero_counts()
            state, metrics = train.make_train_step(model, opt, run)(state,
                                                                    batch)
            out[dev] = (float(metrics["loss"]), opt.grads,
                        {k: v.detach().cpu() for k, v in
                         model.named_parameters()}, counts())
        loss, grads, params, launches = out["cuda"]
        want_loss, want_grads, want_params, _ = out["cpu"]
        lr = train.cli_optimizer(10).cfg.lr(1)
        g_worst = max(worst_scaled(grads[k], want_grads[k], STEP_TOL)
                      for k in want_grads)
        p_worst, loose = 0.0, 0
        for k, want in want_params.items():
            d = (params[k] - want).abs()
            lim = STEP_TOL * want.abs().max() + STEP_TOL * want.abs()
            g = want_grads[k].abs()
            zeroish = g <= STEP_TOL * g.max()
            over = d > lim
            loose += int((over & zeroish).sum())
            p_worst = max(p_worst, (d / lim)[~zeroish].max().item()
                          if (~zeroish).any() else 0.0)
            if (d[over & zeroish] > 2 * lr * 1.01).any():
                p_worst = math.inf
        L = cfg.n_layers
        want_launches = {"K1": 2 * L if cfg.n_heads else 0,
                         "K2": 2 * L if cfg.ssm_state else 0,
                         "K3": 6 * L if cfg.n_experts else 0}
        ok = (abs(loss - want_loss) <= STEP_TOL * abs(want_loss)
              and g_worst <= 1.0 and p_worst <= 1.0
              and launches == want_launches)
        print(f"train step {cfg.name} fp32 B{STEP_BATCH} S{STEP_SEQ}, card "
              f"vs CPU: loss {loss:.6f} vs {want_loss:.6f}; worst |d| / "
              f"(tol max + tol |want|), tol {STEP_TOL:.0e}: gradients "
              f"{g_worst:.3f}, parameters after AdamW {p_worst:.3f} "
              f"({loose} elements whose gradient is within tolerance of 0 "
              f"moved otherwise, by at most 2 lr = {2 * lr:.2e}); launches "
              f"{launches} (want {want_launches}: remat runs each forward "
              f"twice) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(cfg.name)
    if bad:
        raise AssertionError(f"the train step on the card disagrees with "
                             f"its CPU copy: {bad}")


class _StepTimes(StepMonitor):
    """The loop's per-step seconds, by step, replays included."""

    def __init__(self):
        super().__init__()
        self.times: dict[int, list[float]] = {}

    def record(self, step, seconds):
        self.times.setdefault(step, []).append(seconds)
        return super().record(step, seconds)


def phase_train(arch: str) -> dict[str, int]:
    """Full-width training through ``run_training`` with a restart."""
    r = train.FULL_RUNS[arch]
    cfg = configs.get(arch)
    run = RunConfig()
    t0 = time.perf_counter()
    model = Model(cfg, run, dtype=torch.bfloat16, device="cuda")
    opt = r.optimizer()
    data = SyntheticLM(DataConfig(cfg.vocab_size, r.seq, r.batch), "cuda")
    step_fn = train.make_train_step(model, opt, run)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    print(f"train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {n_params / 1e6:.3f} M parameters, "
          f"bf16, remat; AdamW peak lr {r.peak_lr}, warmup "
          f"{train.CLI_WARMUP}, decay {train.CLI_DECAY}; B {r.batch} x S "
          f"{r.seq}, {r.steps} steps, a "
          f"checkpoint every {r.ckpt_every}, failure at step "
          f"{r.fail_at_step}; built in {time.perf_counter() - t0:.1f} s; "
          f"{shutil.disk_usage(ckpt_dir).free / 2**30:.1f} GiB free for "
          f"checkpoints")
    monitor, losses = _StepTimes(), []
    # the initial state as run_training's init_state makes it, for the
    # held-out loss before the run
    model.init(torch.Generator(device="cuda").manual_seed(0))
    held_before = train.held_out_loss(model, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        summary = run_training(
            LoopConfig(total_steps=r.steps, ckpt_dir=ckpt_dir,
                       ckpt_every=r.ckpt_every, keep=1,
                       fail_at_step=r.fail_at_step),
            train_step=step_fn,
            init_state=lambda: train.init_train_state(
                model, opt, run, torch.Generator(device="cuda").manual_seed(0)),
            batch_at=data.batch_at, monitor=monitor,
            on_step=lambda step, m: losses.append((step, float(m["loss"]))))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    held_after = train.held_out_loss(model, data)

    steps_run = len(losses)
    first_pass = [monitor.times[s][0] for s in range(1, r.steps)]
    step_s = statistics.median(first_pass)
    tokens = r.batch * r.seq
    flops = train.model_flops(cfg, ShapeConfig("train", r.seq, r.batch,
                                               "train"))
    L = cfg.n_layers
    want = {"K1": 2 * L * steps_run if cfg.n_heads else 0,
            "K2": 2 * L * steps_run if cfg.ssm_state else 0, "K3": 0}
    seen, replays = {}, []
    for step, loss in losses:
        if step in seen:
            replays.append((step, seen[step], loss))
        seen[step] = loss
    hist = summary["loss_history"]
    replay_err = max((abs(b - a) / abs(a) for _, a, b in replays),
                     default=math.inf)
    print(f"train {cfg.name}: step {1e3 * step_s:.3f} ms (median of steps "
          f"1-{r.steps - 1}, first pass; step 0 "
          f"{1e3 * monitor.times[0][0]:.3f} ms), {tokens / step_s:.1f} "
          f"tokens/s, MFU {flops / step_s / BF16_FLOP_PER_S:.4f} "
          f"(model_flops {flops:.4e} over step time and the dense bf16 peak "
          f"{BF16_FLOP_PER_S:.3e}), peak memory {peak / 2**30:.3f} GiB; "
          f"run wall {wall:.1f} s for {steps_run} steps (checkpoints "
          f"included)")
    print(f"train {cfg.name}: launches {launches} over {steps_run} steps "
          f"(want {want}: 2 x {L} a step, remat); loss {hist[0]:.4f} -> "
          f"{hist[-1]:.4f}; restarts {summary['restarts']}; replayed steps "
          f"{[s for s, _, _ in replays]}: largest relative loss difference "
          f"{replay_err:.3e} (tol {REPLAY_TOL:.0e})")
    print(f"train {cfg.name}: losses {[round(l, 4) for _, l in losses]}")
    held_drop = (held_before - held_after) / held_before
    print(f"train {cfg.name}: held-out batch (step {train.HELD_OUT_STEP} "
          f"of the stream) loss {held_before:.4f} before the run, "
          f"{held_after:.4f} after: fell by {held_drop:.3e} of it (must "
          f"exceed {REPLAY_TOL:.0e})")
    bad = []
    if summary["restarts"] != 1:
        bad.append("restarts")
    if not hist[-1] < hist[0]:
        bad.append("loss did not fall")
    if not held_drop > REPLAY_TOL:
        bad.append("held-out loss did not fall")
    if not all(math.isfinite(l) for _, l in losses):
        bad.append("non-finite loss")
    if not replays or replay_err > REPLAY_TOL:
        bad.append("replayed losses")
    if launches != want:
        bad.append("launches")
    del model, opt, step_fn, data
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"training {cfg.name} failed: {bad}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = phase_box()
    k1 = phase_k1()
    phase_small(SERVE_ARCH)
    launches = Counter(phase_serve())       # each main path's launches
    k2 = phase_k2()
    phase_duality(DUALITY_PROMPT)
    phase_duality(RAGGED_PROMPT)
    launches.update(phase_serve_ssm())
    k3 = phase_k3()
    phase_small(MOE_ARCH)
    moe_launches, run = phase_serve_moe()
    launches.update(moe_launches)
    phase_moe_layer(run)
    del run
    torch.cuda.empty_cache()
    phase_grads()
    phase_small_train()
    launches.update(phase_train(SSM_ARCH))
    launches.update(phase_train(TRAIN_ARCH))
    kernels = dict(zip(WRAPPERS, (k1, k2, k3)))
    for name, kern in kernels.items():
        kern["launches"] = launches[name]
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{k: kern[k] for k in order}
                                  for kern in kernels.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
