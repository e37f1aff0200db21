"""Training step assembly and CLI driver: the port of the JAX package's
``repro.launch.train``.

``make_train_step`` wires ``Model.loss`` → gradients → the gradient sync
across data-parallel ranks → (optional fp8 error-feedback compression) →
``AdamW.update`` into one function on the train state ``{"params": model,
"opt": {...}[, "err": {...}]}``; with ``RunConfig.microbatches`` k > 1 the
batch is split in k and the gradients are summed in fp32.
``RunConfig.opt_8bit`` is read where the optimizer is made
(``AdamWConfig(state_8bit=...)``, as JAX's dry run pairs them),
``grad_compression`` here.  On the card attention runs K1 and Mamba2
blocks K2 forward, MoE experts K3, each with the recompute backward of
``kernels.ops``.

``RunConfig.sync_mode`` picks how the gradients are averaged over the
ranks (``sync.overlap``): ``bucketed`` (the CLI's default, as JAX's)
reduces each layer's inside the backward as soon as that layer's backward
is done, ``barrier`` all of them after it; ``sync.plan.plan_sync`` chooses
between them from the step's MXDAG.  One process is a world of one.

    python -m repro_torch.launch.train --arch mamba2-130m --steps 200   # card
    python -m repro_torch.launch.train --device cpu --smoke --steps 3
    torchrun --nproc_per_node=2 -m repro_torch.launch.train --device cpu --smoke

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) each rank
runs on ``cuda:<LOCAL_RANK>`` with NCCL, or on the CPU with gloo, and
takes its ``B / world`` rows of every global batch; rank 0 prints and
writes the checkpoints.  ``--mesh DxM``, as JAX's, lays the ranks on a
data × model grid (``launch.mesh``; D·M must be ``WORLD_SIZE``): each
data row of M ranks takes ``B / D`` rows and splits the model over its
ranks as JAX's rule does (``launch.sharding``)::

    torchrun --nproc_per_node=2 -m repro_torch.launch.train --mesh 1x2

``RunConfig.fsdp`` (``sync.shard``) shards the parameters, their
gradients, the moments and the error accumulator over the ranks of the
group: build the ``Model`` over that group (``Model(cfg, run,
group=group)``) and pass the same group here.  As JAX's CLI, the CLI sets
no ``fsdp``; a program sets it in the ``RunConfig`` it builds.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import Model
from repro_torch.models.model import seq_length
from repro_torch.optim import AdamW, AdamWConfig, compression, \
    cosine_schedule
from repro_torch.sync import overlap


CLI_LR, CLI_WARMUP, CLI_DECAY = 3e-3, 20, 0.1


def cli_optimizer(steps: int, peak_lr: float = CLI_LR,
                  state_8bit: bool = False,
                  warmup: int = CLI_WARMUP) -> AdamW:
    """The CLI's AdamW: a cosine from ``peak_lr`` after ``warmup`` steps
    (the CLI's ``CLI_WARMUP``), weight decay ``CLI_DECAY``."""
    return AdamW(AdamWConfig(
        lr=cosine_schedule(peak_lr, warmup=warmup, total=steps),
        weight_decay=CLI_DECAY, state_8bit=state_8bit))


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
    opt_8bit: bool = False
    warmup: int = CLI_WARMUP

    def run_config(self) -> RunConfig:
        return RunConfig(opt_8bit=self.opt_8bit)

    def optimizer(self) -> AdamW:
        return cli_optimizer(self.steps, self.peak_lr,
                             state_8bit=self.opt_8bit, warmup=self.warmup)


# mamba2-130m through K2, the CLI's default arch, with the CLI's AdamW;
# internvl2-2b's language model through K1, the largest GQA model whose
# training state (bf16 parameters and gradients, fp32 moments: 12 B a
# parameter) fits one card, at peak lr 1e-3: of 3e-3, 2e-3 and 1e-3 only
# 1e-3 lowers the held-out loss in 12 steps, in fp32 as in bf16
# (``lr_probe``, PERF.md §6); olmoe-1b-7b through K1 and K3 with int8
# moments (fp32 ones would make its state ~83 GB), B 4 × S 2048 (K3's
# capacity 1280), 40 steps at peak lr 1e-4 after a 2-step warm-up: the
# reference's int8 moments blow up by step 10 at peak 1e-3 or 5e-4
# (warm-up 20) and at 1e-3 (warm-up 2), while 1e-4 lowers the held-out
# loss by 4.4-7.1e-3 of itself in 40 steps, where 24 steps gave 0.7-2.8e-3
# from run to run (``lr_probe``, PERF.md §6).  A run saves every
# ``ckpt_every`` steps and not after its last step (``chip_smoke.py`` drills
# a restart, not a resume): mamba2-130m after steps 9, 19 and 29,
# internvl2-2b after 6 only (22.7 GB), olmoe-1b-7b after 20 only (41.6
# GB), and each restarts from the last save before its failure
FULL_RUNS = {r.arch: r for r in (
    FullRun("mamba2-130m", 8, 4096, 30, 10, 15),
    FullRun("internvl2-2b", 4, 2048, 12, 7, 8, peak_lr=1e-3),
    FullRun("olmoe-1b-7b", 4, 2048, 40, 21, 22, peak_lr=1e-4,
            opt_8bit=True, warmup=2))}


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


def make_train_step(model: Model, optimizer: AdamW, run: RunConfig,
                    group: Optional[dist.ProcessGroup] = None, *,
                    grid=None):
    """``train_step(state, batch) -> (state, metrics)`` over the
    data-parallel ranks of ``group`` (None: one process).  Each rank takes
    its contiguous ``B / world`` rows of the global ``batch``; its
    gradients are averaged over the ranks (``sync.overlap.GradSync``: in
    bucketed mode each repeat's inside the backward, the rest after it; in
    barrier mode all after it) before compression and the optimizer, and
    the metrics are averaged too.  ``train_step.syncs`` holds the last
    call's ``GradSync`` objects (one a microbatch), whose ``log`` shows
    when each collective was issued.  Under ``run.fsdp`` the model must be
    built over ``group``: its sharded gradients are reduce-scattered into
    the rank's rows, and compression and the optimizer update those
    rows.

    ``grid`` (a ``launch.mesh.Grid``, in place of ``group``): the model
    must be built on it.  The batch's rows split over its data group (its
    world under ``batch_axes="all"``), and the ``GradSync`` runs over that
    group only; the model group's collectives (tensor and expert
    parallelism, gathers at use) run inside the forward and backward, and
    ``train_step.model_log`` holds the last call's, as ``(kind, key)``.
    Under ``run.seq_shard`` a batch whose sequence the model group splits
    (``Model.seq_split`` of its ``seq_length``: a vision prefix counted,
    the model's own decision) splits its rows over the grid's data group
    only, as JAX's ``seq_shard`` drops "model" from the batch's axes: a
    model group's ranks take the same rows and each its piece of the
    sequence, and their gradients, parts of one, are summed over the
    group and averaged over the data rows."""
    names = [name for name, _ in model.named_parameters()]
    if grid is not None or model.grid is not None:
        if model.grid is not grid or group is not None:
            raise ValueError("grid: build the Model on the grid that "
                             "make_train_step takes, with no group")
        if run != model.run:
            raise ValueError("grid: step with the Model's RunConfig")
        comm = model.data_comm
        group = comm.group
    elif run.fsdp != model.run.fsdp or (run.fsdp
                                        and not model.shards.over(group)):
        raise ValueError("fsdp: build the Model with the RunConfig and "
                         "over the process group that make_train_step "
                         "takes")
    else:
        comm = group
    rank, world = (0, 1) if group is None else (group.rank(), group.size())
    model_comm = model.tp.comm if model.tp is not None else model.seq_comm
    model_log = model_comm.log if model_comm is not None else None
    # where seq_shard splits a length (``Model.seq_split`` of its
    # ``seq_length``), the rows go over the data group alone; the closures
    # keep no reference to the model
    seq_m = model.seq_comm.world if model.seq_comm is not None else None
    cfg = model.cfg
    seq_rows = model.grid.data if seq_m is not None else None

    def grad_fn(params: Model, batch: dict, mean_over: int):
        sync = overlap.GradSync(comm, mean_over)
        train_step.syncs.append(sync)
        loss, metrics = params.loss(batch, sync)
        # a parameter the batch does not reach (internvl2's vis_proj on
        # text) gets a zero gradient, as under jax.grad
        plist = list(params.parameters())
        grads = torch.autograd.grad(loss, plist, materialize_grads=True)
        grads = sync.finish(plist, grads)
        return dict(zip(names, grads)), {k: v.detach()
                                         for k, v in metrics.items()}

    def compute_grads(params: Model, batch: dict, mean_over: int):
        """Optionally accumulated over microbatches: peak activation
        memory scales 1/k while the fp32 gradient sums stay whole."""
        k = run.microbatches
        if k <= 1:
            return grad_fn(params, batch, mean_over)
        B = batch["tokens"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} "
                             f"microbatches")
        gsum, metrics_all = None, []
        for i in range(k):
            mb = {key: x.reshape(k, B // k, *x.shape[1:])[i]
                  for key, x in batch.items()}
            g, metrics = grad_fn(params, mb, mean_over)
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
        B, S = batch["tokens"].shape
        r, w = rank, world
        if seq_m is not None and seq_length(cfg, batch) % seq_m == 0:
            r, w = seq_rows.rank, seq_rows.world
        if B % w:
            raise ValueError(f"batch {B} does not split over {w} "
                             f"data-parallel ranks")
        b = B // w
        batch = {key: x[r * b:(r + 1) * b] for key, x in batch.items()}
        train_step.syncs = []
        if model_log is not None:
            del model_log[:]
        grads, metrics = compute_grads(state["params"], batch, w)
        metrics = overlap.all_mean(metrics, group)
        if model_log is not None:
            train_step.model_log = list(model_log)

        new_state = dict(state)
        if run.grad_compression:
            g8, scales, new_err = compression.compress_tree(
                grads, state["err"], state["params"].shards)
            del grads
            grads = compression.decompress_tree(g8, scales)
            new_state["err"] = new_err
        new_state["opt"] = optimizer.update(grads, state["opt"],
                                            state["params"])
        return new_state, metrics

    train_step.syncs = []
    train_step.model_log = []
    return train_step


def init_train_state(model: Model, optimizer: AdamW, run: RunConfig,
                     generator: torch.Generator) -> dict:
    """Fill ``model`` from ``generator`` and pair it with fresh optimizer
    state: ``{"params": model, "opt": {"step", "m", "v"}}``, and a zero
    error accumulator ``"err"`` under ``run.grad_compression``.  Under
    ``run.fsdp``, or on a grid, each rank draws every tensor whole and
    keeps its slice (``Model.init``), one repeat's tensor at a time, so
    that the state is the one-process run's, sliced."""
    model.init(generator)
    state = {"params": model, "opt": optimizer.init(model)}
    if run.grad_compression:
        state["err"] = compression.init_error_state(model)
    return state


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
    p.add_argument("--sync-mode", default="bucketed",
                   choices=["bucketed", "barrier"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--mesh", default=None,
                   help="DxM: the ranks as a data x model grid, as JAX's "
                        "--mesh (D*M must be the world's size; default: "
                        "every rank a data rank)")
    args = p.parse_args(argv)

    dev = _device.resolve(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    sizes = mesh_lib.parse(args.mesh) if args.mesh else None
    if sizes is not None and math.prod(sizes) != world:
        raise ValueError(f"--mesh {args.mesh} needs {math.prod(sizes)} "
                         f"ranks; WORLD_SIZE is {world}")
    rank, group, grid = 0, None, None
    if world > 1:
        rank = int(os.environ["RANK"])
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", rank=rank, world_size=world,
                                    device_id=dev)
        else:
            dist.init_process_group("gloo", rank=rank, world_size=world)
        group = dist.group.WORLD
        if sizes is not None:
            grid = mesh_lib.make_grid(sizes, group)
    try:
        return _train(args, dev, rank, group, grid)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _train(args, dev: torch.device, rank: int,
           group: Optional[dist.ProcessGroup], grid=None) -> dict:
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    run = RunConfig(sync_mode=args.sync_mode, remat=True)
    if grid is not None:
        model = Model(cfg, run, device=dev, grid=grid)
    else:
        model = Model(cfg, run, device=dev, group=group)
    opt = cli_optimizer(args.steps, args.lr)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), dev)

    from repro_torch.runtime import LoopConfig, StepMonitor, run_training

    step_fn = (make_train_step(model, opt, run, grid=grid) if grid is not None
               else make_train_step(model, opt, run, group))
    monitor = StepMonitor()
    world = 1 if group is None else group.size()

    def on_step(step, metrics):
        if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
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
        on_step=on_step,
        group=group)
    dt = time.monotonic() - t0
    if rank == 0:
        layout = f" as a {args.mesh} grid" if grid is not None else ""
        print(f"done: {summary['final_step'] + 1} steps in {dt:.1f}s on "
              f"{world} x {dev}{layout}, sync {run.sync_mode}, "
              f"restarts={summary['restarts']}, "
              f"loss {summary['loss_history'][0]:.3f} -> "
              f"{summary['loss_history'][-1]:.3f}")
    return summary


if __name__ == "__main__":
    main()
