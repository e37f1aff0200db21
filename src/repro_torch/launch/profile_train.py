"""Where a full-width training step's device time goes: torch.profiler over
one step of a run ``chip_smoke.py`` drives (``train.FULL_RUNS``:
mamba2-130m, B 8 × S 4096; internvl2-2b's language model, B 4 × S 2048;
bf16, remat, random weights from seed 0, the CLI's AdamW).

    python -m repro_torch.launch.profile_train                    # mamba2-130m
    python -m repro_torch.launch.profile_train --arch internvl2-2b

After ``WARM_STEPS`` steps, the step's wall time is taken without the
profiler (the least of ``WALL_RUNS`` steps), then one step runs under it
(as in ``profile_serve``: the profiler's own host work slows eager
dispatch).  Prints both wall times, the summed kernel time, the busy share
(kernel time over the unprofiled wall; 1 - busy is the idle share), the
top operators by device time, and the time of the kernels' forward
launches and of their plain recompute backwards.  Then it saves the train
state once (``checkpoint.ckpt``, under ``TMPDIR``) and restores it, and
prints both times: what each checkpoint and a restart add to a run's wall.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.profile_serve import _device_us, _timed
from repro_torch.models import Model

WARM_STEPS = 2
WALL_RUNS = 3
ROWS = 24


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m",
                    choices=sorted(train.FULL_RUNS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card's device time; "
                           "no CUDA device is available")
    r = train.FULL_RUNS[args.arch]
    run = RunConfig()
    model = Model(configs.get(args.arch), run, device="cuda")
    opt = r.optimizer()
    state = train.init_train_state(
        model, opt, run, torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(DataConfig(model.cfg.vocab_size, r.seq, r.batch),
                       "cuda")
    step_fn = train.make_train_step(model, opt, run)
    step = 0

    def one_step():
        nonlocal state, step
        state, _ = step_fn(state, data.batch_at(step))
        step += 1

    for _ in range(WARM_STEPS):
        one_step()
    wall = min(_timed(one_step) for _ in range(WALL_RUNS))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = _timed(one_step)
    dev_ms = _device_us(prof) / 1e3
    print(f"[train step {args.arch} B{r.batch} S{r.seq}] wall "
          f"{1e3 * wall:.3f} ms ({1e3 * prof_wall:.3f} ms under the "
          f"profiler), device kernels {dev_ms:.3f} ms, busy share "
          f"{dev_ms / (1e3 * wall):.4f}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=ROWS,
                                    max_name_column_width=60))
    for what, keys in (("K1 forward", ("flash_fwd",)),
                       ("K2 forward", ("ssd_",)),
                       ("K3 forward", ("gmm_",))):
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in keys)]
        if evs:
            print(f"{what}: {sum(e.count for e in evs)} launches, "
                  f"{sum(e.self_device_time_total for e in evs) / 1e3:.3f} "
                  f"ms")
    named = {e.key: e for e in prof.key_averages()}
    for key in ("_FlashAttentionBackward", "_SsdIntraChunkBackward",
                "_GroupedMatmulBackward"):
        for name, e in named.items():
            if key in name:
                print(f"{name}: {e.count} calls, device time (with "
                      f"children) {e.device_time_total / 1e3:.3f} ms")

    d = tempfile.mkdtemp(prefix="profile_train_ckpt_")
    try:
        t0 = time.perf_counter()
        path = ckpt.save(d, step, state)
        t1 = time.perf_counter()
        ckpt.restore(d, step, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(os.path.join(path, "arrays.npz"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"checkpoint of the train state: {size / 1e9:.2f} GB, save "
          f"{t1 - t0:.2f} s, restore {t2 - t1:.2f} s")


if __name__ == "__main__":
    main()
