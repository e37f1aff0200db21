#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases (each raises on failure):
1. box: the card's name and power limit, CUDA and nvcc versions, and the
   build of every hand-written kernel from the sources in this checkout;
2. K1 (flash attention, CUDA) against its plain PyTorch version on the card
   at the serving prefill shape and at GQA, MQA, non-causal, small and
   unequal head-dim and fp32 shapes, and its time beside the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only) and its bound;
3. on a small input (the smoke config, fp32), the one-call prefill through
   K1 against token-by-token decode on the plain path;
4. serve deepseek-7b at full width (bf16, random weights from seed 0):
   4 requests, prompt 1024, 32 generated tokens; the prompt prefills in one
   call through K1 (30 launches, one per layer), decode runs the plain
   path (0 launches); the kernel-path prefill logits are held against the
   plain bf16 path's and an fp32 reference's on the same weights.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.  With no
CUDA device, or without the port's package beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402

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
    Case("fp32", 2, 300, 4, 2, 128, 128, True, torch.float32),
    Case("fp32 hd 256, non-causal", 1, 130, 2, 1, 256, 256, False,
         torch.float32),
]


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


# ----------------------------------------------------------------------
def phase_box() -> str:
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print("nvcc:", sh(fa.nvcc(), "--version").splitlines()[-1])
    b = fa.build()
    print(f"build flash_attention.cu: {b.seconds:.2f} s -> {b.path.name}")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
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
                  f"causal={c.causal}: max|d| {err:.3e} "
                  f"(tol {TOL[c.dtype]:.0e}) {'ok' if ok else 'FAIL'}")
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
          f"sdpa (yardstick) {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / ms:.2f}% of bound")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:30",
            "max_abs_err": errs[PREFILL.name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_small() -> None:
    """The repo's decode == prefill check on a small input (fp32, smoke
    config): the one-call prefill through K1 against token-by-token decode
    on the plain path, over the same cache rows."""
    cfg = configs.get_smoke(SERVE_ARCH)
    B, S = 2, 40
    model, tokens = serve.setup(cfg, B, S, "cuda", dtype=torch.float32,
                                seed=1)
    with torch.inference_mode():
        one_call, _ = model.decode_step(model.init_cache(B, S), tokens, 0)
        model.run = dataclasses.replace(model.run, attn_impl="plain")
        cache = model.init_cache(B, S)
        by_token = torch.cat([model.decode_step(cache, tokens[:, t:t + 1], t)[0]
                              for t in range(S)], dim=1)
    err = (one_call - by_token).abs().max().item()
    print(f"small input ({cfg.name}, fp32): one-call prefill through K1 vs "
          f"token-by-token plain decode: max|d| {err:.3e} (tol 1e-04)")
    if not err <= 1e-4:
        raise AssertionError(f"one-call prefill and decode disagree: {err}")


def last_prefill_logits(model: Model, prompts) -> torch.Tensor:
    cache = model.init_cache(prompts.shape[0], prompts.shape[1])
    _, logits, _ = serve.prefill(model, cache, prompts)
    return logits[:, -1].float()


def phase_serve() -> dict:
    cfg = configs.get(SERVE_ARCH)
    t0 = time.perf_counter()
    model, prompts = serve.setup(cfg, SERVE_BATCH, SERVE_PROMPT, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")

    with torch.inference_mode():
        # warm-up request (cuBLAS handles, allocator), not counted
        serve.generate(model, prompts[:, :64], 2)
        cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        tok, logits, cache = serve.prefill(model, cache, prompts)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        prefill_launches = ops.flash_attention.launches

        ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        rest, cache = serve.decode(model, cache, tok, SERVE_PROMPT,
                                   SERVE_GEN - 1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = ops.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()

        tokens = torch.cat([tok, rest], dim=1)
        last_logits, _ = model.decode_step(cache, rest[:, -1:],
                                           SERVE_PROMPT + SERVE_GEN - 1)
        print(f"K1 launches: prefill {prefill_launches} (want "
              f"{cfg.n_layers}), decode {decode_launches} (want 0)")
        if prefill_launches != cfg.n_layers or decode_launches != 0:
            raise AssertionError("the serving path did not run K1 once per "
                                 "layer in prefill and never in decode")
        if tuple(tokens.shape) != (SERVE_BATCH, SERVE_GEN) \
                or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"bad generated tokens {tokens.shape}")
        if not (torch.isfinite(logits).all()
                and torch.isfinite(last_logits).all()):
            raise AssertionError("non-finite logits")
        print("logits finite: prefill [B,P,V] and the last decode step")

        kern_last = logits[:, -1].float()
        del cache, logits
        model.run = dataclasses.replace(model.run, attn_impl="plain")
        plain_last = last_prefill_logits(model, prompts)
        # fp32 reference on the same (bf16-valued) weights, plain path
        ref = Model(cfg, RunConfig(attn_impl="plain"),
                    dtype=torch.float32, device="cuda")
        for p_ref, p in zip(ref.parameters(), model.parameters()):
            p_ref.copy_(p)
        ref_last = last_prefill_logits(ref, prompts)
        del ref

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    rel_k, rel_p, rel_kp = (rel(kern_last, ref_last), rel(plain_last, ref_last),
                            rel(kern_last, plain_last))
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

    n_dec = SERVE_GEN - 1
    print(f"serve: TTFT {1e3 * ttft:.2f} ms (prefill {SERVE_BATCH}x"
          f"{SERVE_PROMPT}), decode {1e3 * decode_s / n_dec:.3f} ms/token "
          f"step, decode {SERVE_BATCH * n_dec / decode_s:.1f} tokens/s, "
          f"end to end {SERVE_BATCH * SERVE_GEN / (ttft + decode_s):.1f} "
          f"generated tokens/s, peak memory {peak / 2**30:.3f} GiB")
    print("sample:", tokens[0, :16].tolist())
    return {"launches": prefill_launches + decode_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = phase_box()
    kernel = phase_k1()
    phase_small()
    kernel.update(phase_serve())
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
