"""Where a full-width serving run's device time goes: torch.profiler over
one prefill and a few decode steps of a run chip_smoke.py drives
(``serve.FULL_*``: deepseek-7b, 4 prompts of 1024; ``serve.SSM_*``:
mamba2-130m, 8 prompts of 4096; ``serve.MOE_*``: olmoe-1b-7b, 4 prompts of
1024; ``serve.MLA_*``: deepseek-v3-671b cut to 2 layers, 4 prompts of
1024; ``serve.ENC_*``: whisper-large-v3, 4 requests of 1500 frames and
prompts of 128, the encoder run once before the phases; bf16, random
weights from seed 0).

    python -m repro_torch.launch.profile_serve                      # deepseek-7b
    python -m repro_torch.launch.profile_serve --arch mamba2-130m
    python -m repro_torch.launch.profile_serve --arch olmoe-1b-7b
    python -m repro_torch.launch.profile_serve --arch deepseek-v3-671b
    python -m repro_torch.launch.profile_serve --arch whisper-large-v3

Each phase runs on the same cache, first without the profiler, for its
wall time (the least of ``WALL_RUNS`` runs), and later under it, for the
device time of its kernels; all unprofiled runs come first.  The
profiler's own host work slows eager dispatch, so the wall time under it
would understate how busy the device is.
Prints, per phase, both wall times, the summed kernel time, the busy
share (kernel time over the unprofiled wall time; 1 - busy is the idle
share) and the top operators by device time.  Needs a CUDA device.

With ``--first`` it profiles instead the first full-size prefill after
the short warm-up request, the one ``chip_smoke.py`` times as TTFT, and
lists operators and CUDA runtime calls by host time: what that prefill
pays for once (kernels loaded lazily, memory allocated) shows there.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve

DECODE_STEPS = 8
WALL_RUNS = 3
ROWS = 16           # operators listed per phase
RUNS = {serve.FULL_ARCH: (serve.FULL_BATCH, serve.FULL_PROMPT),
        serve.SSM_ARCH: (serve.SSM_BATCH, serve.SSM_PROMPT),
        serve.MOE_ARCH: (serve.MOE_BATCH, serve.MOE_PROMPT),
        serve.MLA_ARCH: (serve.MLA_BATCH, serve.MLA_PROMPT),
        serve.ENC_ARCH: (serve.ENC_BATCH, serve.ENC_PROMPT)}


def _device_us(prof) -> float:
    """Summed time of the device's kernels in the trace (µs); operator rows
    are left out, since their device time is their kernels'."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _timed(fn) -> float:
    """Wall seconds of fn up to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=serve.FULL_ARCH, choices=sorted(RUNS))
    ap.add_argument("--first", action="store_true",
                    help="profile the first full-size prefill by host time")
    args = ap.parse_args(argv)
    arch = args.arch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card's device time; "
                           "no CUDA device is available")
    B, P = RUNS[arch]
    model, requests = serve.setup(serve.full_config(arch), B, P, "cuda")
    prompts = requests["tokens"]
    # each prefill below runs on the cache the last one left: attention
    # rewrites rows 0..P, an SSM block starts from the state left there,
    # at the same cost
    with torch.inference_mode():
        serve.generate(model, dict(requests, tokens=prompts[:, :64]),
                       2)                                    # warm-up
        enc_out = serve.encode(model, requests)
        cache = model.init_cache(B, P + DECODE_STEPS + 1)
        if args.first:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_wall = _timed(lambda: serve.prefill(model, cache,
                                                         prompts, enc_out))
            print(f"[first prefill] wall {1e3 * prof_wall:.3f} ms under the "
                  f"profiler, device kernels "
                  f"{_device_us(prof) / 1e3:.3f} ms")
            print(prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=ROWS,
                max_name_column_width=60))
            return
        tok = serve.prefill(model, cache, prompts, enc_out)[0]
        phases = {
            "prefill": lambda: serve.prefill(model, cache, prompts, enc_out),
            f"decode x{DECODE_STEPS}":
                lambda: serve.decode(model, cache, tok, P, DECODE_STEPS,
                                     enc_out),
        }
        if enc_out is not None:
            phases = {"encode": lambda: serve.encode(model, requests),
                      **phases}
        # every unprofiled run comes before the first profiled one, so that
        # no wall time is taken after the profiler has been started
        walls = {name: min(_timed(fn) for _ in range(WALL_RUNS))
                 for name, fn in phases.items()}
        for name, fn in phases.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_wall = _timed(fn)
            dev_ms = _device_us(prof) / 1e3
            print(f"[{name}] wall {1e3 * walls[name]:.3f} ms "
                  f"({1e3 * prof_wall:.3f} ms under the profiler), device "
                  f"kernels {dev_ms:.3f} ms, busy share "
                  f"{dev_ms / (1e3 * walls[name]):.4f}")
            print(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=ROWS,
                max_name_column_width=60))


if __name__ == "__main__":
    main()
