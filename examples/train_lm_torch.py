"""End-to-end training driver on one CUDA card: the PyTorch port's twin of
``examples/train_lm.py``.

The deepseek-7b architecture scaled to ~20M params, trained for 240 steps
on the synthetic pipeline (bf16, remat, attention through the flash
attention kernel K1 with its recompute backward), with checkpoint/restart
fault tolerance: a simulated failure at step 120 restarts the loop from
the checkpoint of step 119.

Run:  python examples/train_lm_torch.py [--steps 240] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch import device as _device  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    init_train_state, make_train_step,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.runtime import LoopConfig, StepMonitor, run_training  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()
    dev = _device.resolve(args.device)

    # deepseek-7b family at ~20M params
    cfg = dataclasses.replace(
        configs.get("deepseek-7b"), name="deepseek-20m",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
        d_ff=1024, vocab_size=4096)
    n = cfg.param_counts()["total"]
    print(f"arch: {cfg.name} ({n/1e6:.1f}M params) on {dev}")
    print("MXDAG sync plan: arrives with multi-GPU sync (ROADMAP Queue 1 "
          "item 5); one card has no gradient collective to order, so the "
          "step runs in barrier mode")

    run = RunConfig(sync_mode="barrier", remat=True, microbatches=1)
    model = Model(cfg, run, device=dev)
    opt = AdamW(AdamWConfig(
        lr=cosine_schedule(1e-3, warmup=20, total=args.steps),
        weight_decay=0.01))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                  global_batch=8), dev)

    step_fn = make_train_step(model, opt, run)
    monitor = StepMonitor()

    def on_step(step, metrics):
        if step % 20 == 0 or step == args.steps - 1:
            print(f"  step {step:4d}  loss {float(metrics['loss']):.4f}")

    t0 = time.monotonic()
    summary = run_training(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=60, fail_at_step=120),   # injected failure!
        train_step=step_fn,
        init_state=lambda: init_train_state(
            model, opt, run, torch.Generator(dev).manual_seed(0)),
        batch_at=data.batch_at,
        monitor=monitor,
        on_step=on_step)
    dt = time.monotonic() - t0
    first, last = summary["loss_history"][0], summary["loss_history"][-1]
    print(f"\ndone: {args.steps} steps in {dt:.0f}s, "
          f"restarts={summary['restarts']} (failure injected at step 120, "
          f"resumed from checkpoint), loss {first:.3f} -> {last:.3f}")
    assert summary["restarts"] == 1 and last < first


if __name__ == "__main__":
    main()
