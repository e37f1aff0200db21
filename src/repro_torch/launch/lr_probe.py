"""How a full-width training run's loss moves with AdamW's peak lr and the
parameters' dtype: a run of ``train.FULL_RUNS`` (its arch, batch, sequence
and steps; the CLI's schedule and decay, ``train.cli_optimizer``), without
checkpoints, from the same weights (seed 0) and batches for every setting.

    python -m repro_torch.launch.lr_probe --arch internvl2-2b \\
        --lrs 3e-3 2e-3 1e-3 --fp32 3e-3

For each setting prints every step's lr and loss, and the held-out loss
(``train.held_out_loss``) before and after the run.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models import Model


def probe(arch: str, lr: float, dtype: torch.dtype) -> None:
    r = train.FULL_RUNS[arch]
    cfg = configs.get(arch)
    run = RunConfig()
    model = Model(cfg, run, dtype=dtype, device="cuda")
    opt = train.cli_optimizer(r.steps, lr)
    state = train.init_train_state(
        model, opt, run, torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab_size, r.seq, r.batch), "cuda")
    before = train.held_out_loss(model, data)
    step_fn = train.make_train_step(model, opt, run)
    losses = []
    for step in range(r.steps):
        state, metrics = step_fn(state, data.batch_at(step))
        losses.append(float(metrics["loss"]))
    after = train.held_out_loss(model, data)
    lrs = [float(opt.cfg.lr(step + 1)) for step in range(r.steps)]
    print(f"[{arch} B{r.batch} S{r.seq} {str(dtype)[6:]} peak lr {lr:g}] "
          f"held-out loss {before:.4f} -> {after:.4f} "
          f"({(before - after) / before:+.3e} of it); losses "
          f"{[round(x, 4) for x in losses]}; lr a step "
          f"{[float(f'{x:.3g}') for x in lrs]}", flush=True)
    del state, model, opt, step_fn
    torch.cuda.empty_cache()


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-2b",
                    choices=sorted(train.FULL_RUNS))
    ap.add_argument("--lrs", type=float, nargs="*", default=[train.CLI_LR],
                    help="peak lrs to run with bf16 parameters")
    ap.add_argument("--fp32", type=float, nargs="*", default=[],
                    help="peak lrs to run with fp32 parameters")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lr_probe trains at full width; no CUDA device "
                           "is available")
    for lr in args.lrs:
        probe(args.arch, lr, torch.bfloat16)
    for lr in args.fp32:
        probe(args.arch, lr, torch.float32)


if __name__ == "__main__":
    main()
