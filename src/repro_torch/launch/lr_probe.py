"""How a full-width training run's loss moves with AdamW's peak lr, the
parameters' dtype and the moments' storage: a run of ``train.FULL_RUNS``
(its arch, batch, sequence and steps; the CLI's schedule and decay,
``train.cli_optimizer``), without checkpoints, from the same weights (seed
0) and batches for every setting.

    python -m repro_torch.launch.lr_probe --arch internvl2-2b \\
        --lrs 3e-3 2e-3 1e-3 --fp32 3e-3
    python -m repro_torch.launch.lr_probe --arch olmoe-1b-7b \\
        --lrs 1e-3 5e-4 --moments-depth 8

``--lrs`` runs bf16 parameters with the run's moments (int8 where the run
sets ``opt_8bit``), ``--fp32`` fp32 parameters, ``--warmup`` other warm-up
lengths than the run's (each with every lr of ``--lrs``).  ``--moments-depth N``
also runs each of ``--lrs`` on the first N layers of the arch, once with
int8 and once with fp32 moments: a depth at which both states fit (at 8
of olmoe-1b-7b's 16 layers the state is ~42 GB with fp32 moments).  For
each setting prints every step's lr and loss, the held-out loss
(``train.held_out_loss``) before the run and after each step, and the
peak memory.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models import Model


def probe(arch: str, lr: float, dtype: torch.dtype, state_8bit: bool,
          layers: Optional[int] = None, warmup: Optional[int] = None,
          steps: Optional[int] = None) -> None:
    r = train.FULL_RUNS[arch]
    if steps is not None:
        r = dataclasses.replace(r, steps=steps)
    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    run = RunConfig(opt_8bit=state_8bit)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, run, dtype=dtype, device="cuda")
    warmup = r.warmup if warmup is None else warmup
    opt = train.cli_optimizer(r.steps, lr, state_8bit=state_8bit,
                              warmup=warmup)
    state = train.init_train_state(
        model, opt, run, torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab_size, r.seq, r.batch), "cuda")
    before = train.held_out_loss(model, data)
    step_fn = train.make_train_step(model, opt, run)
    losses, held = [], []
    for step in range(r.steps):
        state, metrics = step_fn(state, data.batch_at(step))
        losses.append(float(metrics["loss"]))
        held.append(train.held_out_loss(model, data))
    after = held[-1]
    lrs = [float(opt.cfg.lr(step + 1)) for step in range(r.steps)]
    moments = "int8" if state_8bit else "fp32"
    print(f"[{arch} {cfg.n_layers} layers B{r.batch} S{r.seq} "
          f"{str(dtype)[6:]} {moments} moments, peak lr {lr:g}, warmup "
          f"{warmup}] held-out loss {before:.4f} -> {after:.4f} "
          f"({(before - after) / before:+.3e} of it), after each step "
          f"{[round(x, 4) for x in held]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
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
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a setting runs (default: the run's)")
    ap.add_argument("--warmup", type=int, nargs="*", default=[],
                    help="warm-up lengths to run each of --lrs with")
    ap.add_argument("--moments-depth", type=int, default=None,
                    help="also run each of --lrs at this many layers with "
                         "int8 and with fp32 moments")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lr_probe trains at full width; no CUDA device "
                           "is available")
    r = train.FULL_RUNS[args.arch]
    n = args.steps
    for lr in args.lrs:
        probe(args.arch, lr, torch.bfloat16, r.opt_8bit, steps=n)
    for lr in args.fp32:
        probe(args.arch, lr, torch.float32, r.opt_8bit, steps=n)
    for warmup in args.warmup:
        for lr in args.lrs:
            probe(args.arch, lr, torch.bfloat16, r.opt_8bit, warmup=warmup,
                  steps=n)
    if args.moments_depth is not None:
        for lr in args.lrs:
            for state_8bit in (True, False):
                probe(args.arch, lr, torch.bfloat16, state_8bit,
                      args.moments_depth, steps=n)


if __name__ == "__main__":
    main()
