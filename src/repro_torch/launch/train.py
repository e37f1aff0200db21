"""Training step assembly and CLI driver: the port of the JAX package's
``repro.launch.train``.

``make_train_step`` wires ``Model.loss`` → gradients → ``AdamW.update``
into one function on the train state ``{"params": model, "opt": {...}}``;
with ``RunConfig.microbatches`` k > 1 the batch is split in k and the
gradients are summed in fp32.  On the card attention runs K1 and Mamba2
blocks K2 forward, MoE experts K3, each with the recompute backward of
``kernels.ops``.

    python -m repro_torch.launch.train --arch mamba2-130m --steps 200   # card
    python -m repro_torch.launch.train --device cpu --smoke --steps 3

``--sync-mode`` defaults to ``barrier``, where the JAX CLI's default is
``bucketed``: on one card there is no gradient collective for an MXDAG
plan to order, and the bucketed layer-wise sync waits for multi-GPU sync
(ROADMAP Queue 1 item 5), so ``bucketed`` raises.  JAX's ``--mesh`` has no
counterpart on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule


CLI_LR, CLI_WARMUP, CLI_DECAY = 3e-3, 20, 0.1


def cli_optimizer(steps: int, peak_lr: float = CLI_LR) -> AdamW:
    """The CLI's AdamW: a cosine from ``peak_lr`` after ``CLI_WARMUP``
    steps, weight decay ``CLI_DECAY``."""
    return AdamW(AdamWConfig(
        lr=cosine_schedule(peak_lr, warmup=CLI_WARMUP, total=steps),
        weight_decay=CLI_DECAY))


@dataclasses.dataclass(frozen=True)
class FullRun:
    """A full-width training run on one card (bf16, remat, text only), as
    ``chip_smoke.py``, ``profile_train`` and ``lr_probe`` drive it."""
    arch: str
    batch: int
    seq: int
    steps: int
    ckpt_every: int
    fail_at_step: int
    peak_lr: float = CLI_LR

    def optimizer(self) -> AdamW:
        return cli_optimizer(self.steps, self.peak_lr)


# mamba2-130m through K2, the CLI's default arch, with the CLI's AdamW;
# internvl2-2b's language model through K1, the largest GQA model whose
# training state (bf16 parameters and gradients, fp32 moments: 12 B a
# parameter) fits one card, at peak lr 1e-3: of 3e-3, 2e-3 and 1e-3 only
# 1e-3 lowers the held-out loss in 12 steps, in fp32 as in bf16
# (``lr_probe``, PERF.md §6)
FULL_RUNS = {r.arch: r for r in (
    FullRun("mamba2-130m", 8, 4096, 30, 10, 15),
    FullRun("internvl2-2b", 4, 2048, 12, 4, 6, peak_lr=1e-3))}


# a batch of the stream that no run here trains on (runs take steps from
# 0): the loss on it before and after a run shows whether the run learned,
# free of the batch-to-batch spread of the training losses
HELD_OUT_STEP = 10**6


def held_out_loss(model: Model, data: SyntheticLM) -> float:
    """``model.loss`` on the stream's batch at ``HELD_OUT_STEP``, without
    gradients."""
    with torch.no_grad():
        return float(model.loss(data.batch_at(HELD_OUT_STEP))[0])


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) / 2·N·tokens (inference), N = active params."""
    n = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token


def make_train_step(model: Model, optimizer: AdamW, run: RunConfig):
    names = [name for name, _ in model.named_parameters()]

    def grad_fn(params: Model, batch: dict):
        loss, metrics = params.loss(batch)
        # a parameter the batch does not reach (internvl2's vis_proj on
        # text) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, list(params.parameters()),
                                    materialize_grads=True)
        return dict(zip(names, grads)), {k: v.detach()
                                         for k, v in metrics.items()}

    def compute_grads(params: Model, batch: dict):
        """Optionally accumulated over microbatches: peak activation
        memory scales 1/k while the fp32 gradient sums stay whole."""
        k = run.microbatches
        if k <= 1:
            return grad_fn(params, batch)
        B = batch["tokens"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} "
                             f"microbatches")
        gsum, metrics_all = None, []
        for i in range(k):
            mb = {key: x.reshape(k, B // k, *x.shape[1:])[i]
                  for key, x in batch.items()}
            g, metrics = grad_fn(params, mb)
            if gsum is None:
                gsum = {n: x.float() for n, x in g.items()}
            else:
                for n, x in g.items():
                    gsum[n].add_(x.float())
            metrics_all.append(metrics)
            del g
        grads = {n: x / k for n, x in gsum.items()}
        metrics = {key: torch.mean(torch.stack([m[key] for m in metrics_all]))
                   for key in metrics_all[0]}
        return grads, metrics

    def train_step(state: dict, batch: dict):
        grads, metrics = compute_grads(state["params"], batch)
        new_opt = optimizer.update(grads, state["opt"], state["params"])
        return {"params": state["params"], "opt": new_opt}, metrics

    return train_step


def init_train_state(model: Model, optimizer: AdamW, run: RunConfig,
                     generator: torch.Generator) -> dict:
    """Fill ``model`` from ``generator`` and pair it with fresh optimizer
    state: ``{"params": model, "opt": {"step", "m", "v"}}``."""
    if run.grad_compression:
        raise NotImplementedError(
            "fp8 gradient compression is not ported yet (ROADMAP Queue 1 "
            "item 4)")
    model.init(generator)
    return {"params": model, "opt": optimizer.init(model)}


# ----------------------------------------------------------------------
def main(argv: Optional[list[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mamba2-130m")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=CLI_LR)
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--sync-mode", default="barrier",
                   choices=["bucketed", "barrier"],
                   help="barrier (default here; the JAX CLI defaults to "
                        "bucketed): one card has no gradient collective to "
                        "order, and bucketed sync waits for multi-GPU sync "
                        "(ROADMAP Queue 1 item 5)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    run = RunConfig(sync_mode=args.sync_mode, remat=True)
    model = Model(cfg, run, device=dev)
    opt = cli_optimizer(args.steps, args.lr)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), dev)

    from repro_torch.runtime import LoopConfig, StepMonitor, run_training

    step_fn = make_train_step(model, opt, run)
    monitor = StepMonitor()

    def on_step(step, metrics):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}")

    t0 = time.monotonic()
    summary = run_training(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every),
        train_step=step_fn,
        init_state=lambda: init_train_state(
            model, opt, run, torch.Generator(dev).manual_seed(0)),
        batch_at=data.batch_at,
        monitor=monitor,
        on_step=on_step)
    dt = time.monotonic() - t0
    print(f"done: {summary['final_step'] + 1} steps in {dt:.1f}s on {dev}, "
          f"restarts={summary['restarts']}, "
          f"loss {summary['loss_history'][0]:.3f} -> "
          f"{summary['loss_history'][-1]:.3f}")
    return summary


if __name__ == "__main__":
    main()
