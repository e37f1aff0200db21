"""Dry run of every (arch × shape) cell on the H100 without allocating a
byte: the port of the JAX package's ``launch/dryrun.py``.

For each cell this
  1. builds the port's ``Model`` under ``FakeTensorMode`` on a fake
     ``"cpu"`` device, in bf16 (the serving and training dtype), with the
     inputs of ``launch.specs`` at one rank's batch, ``max(1, global_batch
     // world)``;
  2. runs the cell's step on those fake tensors: train ``Model.loss`` →
     ``torch.autograd.grad`` → (fp8 error feedback under
     ``grad_compression``) → ``AdamW.update`` (int8 moments where
     ``opt_8bit``), prefill ``Model.forward``, decode ``Model.decode_step``
     on a fake cache at its last row;
  3. counts, in that one pass, the flops (``FlopCounterMode``), the HBM
     bytes (``_bytes_mode``: every operator's inputs and outputs, an upper
     bound on the traffic, as XLA's "bytes accessed" is) and the peak memory
     (``MemTracker``, split into parameters, gradients, optimizer state,
     activations and temporaries as they stand at the peak), and the
     bytes the rank's collectives put on its link: replicated, what a
     ``GradSync`` would all-reduce (train only: the gradients ×
     2(W−1)/W); sharded, those its stand-in collectives were asked for;
  4. fills a ``launch.roofline.Roofline`` on the ``H100`` and says whether
     the peak fits the card's 80 GB.

A FakeTensor reports its fake device, so each kernel wrapper of
``kernels.ops`` takes its CPU branch, the kernel's plain version: the
counted work is the plain version's (``PLAIN_NOTE``).  No kernel is built
and no device is touched.

Without a mesh the port's ranks are data-parallel; ``default_run`` takes
the JAX package's choice of ``fsdp`` (above 5 B parameters) and keeps
JAX's whole choice beside the port's (the batch over the data axis only:
JAX's ``batch_axes="all"`` needs its "model" axis).  A sharded cell is traced
as one rank of ``world`` (``sync.shard``): the model holds the rank's
rows, each repeat's rows are gathered into whole tensors before it runs
(again in remat's recompute), and the gradients are reduce-scattered
inside the backward by a ``GradSync``, all through ``_TracedRanks``, a
stand-in for the world's collectives that allocates what a real one
would and counts its bytes.  So the peak holds one repeat's gathered
rows and the sync's buffers.  A replicated cell is one rank without a
process group, as before.

On a grid (``--mesh 16x16``, JAX's production mesh) a cell is traced as
rank 0 of that grid (``launch.mesh``): it holds its slices of what JAX's
rule splits (``launch.sharding``), runs the model group's tensor and
expert parallelism (each collective counted by a ``_TracedRanks`` of that
group) and the data group's gradient sync, and takes JAX's
``batch_axes``.  A decode cell holds the rank's block of JAX's cache
layout (``Model.init_cache``: B over the data axes, T over "model", or
over every axis where B stays whole) and counts the gathers and the
softmax merge of its split attention on the model (or world) group.  A
train or prefill cell whose JAX choice is ``seq_shard`` is a skip unless
the caller names ``seq_shard`` (``--set seq_shard=True``), as JAX's
``lower_cell`` honours an explicit override: the rank then takes its
rows of the batch over the data axes and its piece of the sequence
(``sync.seq``; the archs of ``models.model.seq_shardable``), and its
halo, state, K/V, MoE row and loss collectives are counted on the model
group.
A decode cell runs unsplit there, as JAX's does (``seq_split``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \
      --shape prefill_32k --mesh 16x16 --set seq_shard=True
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.configs.base import (ArchConfig, RunConfig, SHAPES,
                                      ShapeConfig, applicable_shapes)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch.roofline import H100, Roofline
from repro_torch.launch.specs import decode_specs, input_specs
from repro_torch.launch.train import model_flops
from repro_torch.models import Model
from repro_torch.models.model import seq_length
from repro_torch.optim import AdamW, AdamWConfig, compression
from repro_torch.sync import shard
from repro_torch.sync.overlap import GradSync
from repro_torch.sync.plan import plan_sync

# the production scale of ``sync.plan``: 256 H100s
WORLD = 256
RESULTS = Path(__file__).resolve().parents[3] / "results_torch"
PLAIN_NOTE = ("counted on each kernel's plain version (kernels.ref): K1's "
              "scores are the full S x S where K1 skips the masked half, "
              "K2's C.B^T is taken once a head where K2 takes it once a "
              "head group, K3's product covers every capacity slot, as K3 "
              "does")
BYTES_NOTE = ("an upper bound: each operator's inputs and outputs, views "
              "excluded, as XLA's bytes accessed")
PEAK_NOTE = ("MemTracker on fake tensors: what PyTorch's allocator would "
             "hold at once, without the CUDA context, the allocator's "
             "rounding and fragmentation, or, replicated, the GradSync "
             "buckets of world > 1 (that trace is one rank without a "
             "process group; a sharded one holds its gathered rows and "
             "sync buffers); the split is the peak's own: a train step "
             "peaks early in its backward, where the gradients made so far "
             "(the head's) are all its gradients holds")
# MemTracker's categories, as the record names them
_SPLIT = {"Parameter": "parameters", "Gradient": "gradients",
          "Other": "optimizer", "Activation": "activations",
          "Temp": "temporaries"}


def default_run(cfg: ArchConfig, overrides: Optional[dict] = None,
                batch: Optional[int] = None,
                shape: Optional[ShapeConfig] = None,
                mesh: Optional[tuple[int, ...]] = None
                ) -> tuple[RunConfig, dict]:
    """(the port's RunConfig, what the JAX package's ``default_run`` would
    choose).  The port takes JAX's ``fsdp``, ``opt_8bit``, ``remat`` and
    ``microbatches`` (cut to a divisor of ``batch``, the rows of one
    rank).  Without a ``mesh`` the ranks are data-parallel only and
    ``batch_axes`` stays ``"dp"``; with one (its sizes, e.g. ``(16,
    16)``: a grid of ranks, ``launch.mesh``) the port takes JAX's
    ``batch_axes`` too, and the record reports JAX's ``seq_shard`` choice
    for ``shape`` (JAX's ``lower_cell`` turns it on where a batch spread
    over every axis does not fill the mesh), which the port takes only
    where ``overrides`` name it (``trace_cell``).
    For a train
    ``shape`` the sync mode is the one ``sync.plan.plan_sync`` picks for it
    at 256 H100s (under fsdp barrier mode keeps every repeat's whole
    gradients until the backward ends)."""
    n = cfg.param_counts()["total"]
    small = n < 1e9
    fsdp = n > 5e9
    jax_run = {"fsdp": fsdp, "opt_8bit": n > 2.5e10, "remat": True,
               "batch_axes": "all" if small else "dp",
               "microbatches": 1 if small else (2 if fsdp else 4)}
    mb = jax_run["microbatches"]
    if batch is not None:
        mb = math.gcd(mb, batch)
    run = RunConfig(fsdp=fsdp, opt_8bit=jax_run["opt_8bit"], remat=True,
                    microbatches=mb)
    if mesh is not None:
        run = dataclasses.replace(run, batch_axes=jax_run["batch_axes"])
        if shape is not None:
            jax_run["seq_shard"] = (jax_run["batch_axes"] == "all"
                                    and shape.global_batch
                                    % math.prod(mesh) != 0)
    if shape is not None and shape.kind == "train":
        run = dataclasses.replace(
            run, sync_mode=plan_sync(cfg, shape, chips=WORLD).mode)
    if overrides:
        run = dataclasses.replace(run, **overrides)
    return run, jax_run


def seq_split(shape: ShapeConfig, mesh: tuple[int, ...],
              cfg: Optional[ArchConfig] = None) -> bool:
    """Whether JAX's ``seq_shard`` splits the cell's input over "model":
    its ``_embed_inputs`` constrains only an input whose length (``cfg``'s
    vision prefix counted, as ``launch.specs`` feeds it) the "model" axis
    divides (``src/repro/models/model.py:342-343``), and a decode step's
    one token is divided by no "model" axis of more than one rank, so a
    decode cell runs unsplit."""
    n = 1 if shape.kind == "decode" else split_length(shape, cfg)
    return mesh[-1] > 1 and n % mesh[-1] == 0


def split_length(shape: ShapeConfig,
                 cfg: Optional[ArchConfig] = None) -> int:
    """The rows ``seq_shard`` splits in a train or prefill cell: the
    tokens and ``cfg``'s vision prefix (``models.model.seq_length`` of
    the cell's inputs, ``launch.specs.input_specs``, here of no rows)."""
    if cfg is None:
        return shape.seq_len
    return seq_length(cfg, input_specs(cfg, shape, 0))


def rank_batch(global_batch: int, mesh: tuple[int, ...],
               run: RunConfig, split: bool = False) -> int:
    """The rows one rank of a grid of ``mesh`` takes: the batch rule's
    (``launch.sharding.batch_spec``: the largest prefix of the data axes,
    every axis under ``batch_axes="all"``, that divides it); where
    ``seq_shard`` splits the sequence (``split``), its rows over the data
    axes alone, as JAX's constraint ``P(dp without "model", "model")``."""
    if split:
        data = math.prod(mesh[:-1])
        if global_batch % data:
            raise ValueError(f"seq_shard: a batch of {global_batch} does "
                             f"not split over {data} data ranks")
        return global_batch // data
    grid = mesh_lib.stand_in(mesh)
    spec = sharding.batch_spec((global_batch,), grid, run)
    return global_batch // math.prod(
        grid.shape[a] for a in sharding.axes_of(spec[0]))


def _bytes_mode():
    """A ``TorchDispatchMode`` whose ``total`` sums the bytes of the tensor
    inputs and outputs of every operator that moves data: not a view, not
    an allocation without a write, not a query of metadata (an operator
    that returns no tensor, as ``tensor.device``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    skip = {aten._unsafe_view.default, aten.empty.memory_format,
            aten.empty_strided.default, aten.new_empty.default,
            aten.new_empty_strided.default, aten.empty_like.default}

    class Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if outs and not func.is_view and func not in skip:
                self.total += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs)) + outs
                    if isinstance(t, torch.Tensor))
            return out

    return Bytes()


class _Loss(nn.Module):
    """``model.loss`` called through a module, so that ``MemTracker`` can
    tell the backward (temporaries) from the forward (activations)."""

    def __init__(self, model: Model, sync: Optional[GradSync] = None):
        super().__init__()
        self.model, self.sync = model, sync

    def forward(self, batch: dict) -> torch.Tensor:
        return self.model.loss(batch, self.sync)[0]


class _Done:
    """A finished collective's handle; it holds the collective's input
    until it is waited on, as a real handle does."""

    def __init__(self, inp: torch.Tensor):
        self.inp = inp

    def wait(self) -> None:
        self.inp = None


class _TracedRanks(shard.Comm):
    """Rank 0 of ``world`` ranks in a trace (whatever ``rank`` a grid's
    stand-in asks for): each collective leaves its output as allocated
    (nothing is communicated) and adds the bytes a ring puts on one rank's
    link, by kind, to ``bytes``."""

    def __init__(self, world: int, rank: int = 0):
        self.group, self.world, self.rank = None, world, 0
        self.bytes: dict[str, float] = {}

    def _count(self, kind: str, t: torch.Tensor, times: float) -> None:
        n = t.numel() * t.element_size() * times * (self.world - 1) / \
            self.world
        self.bytes[kind] = self.bytes.get(kind, 0.0) + n

    def all_gather(self, out, inp):
        self._count("all-gather", out, 1)

    def reduce_scatter(self, out, inp):
        self._count("reduce-scatter", inp, 1)
        return _Done(inp)

    def all_reduce(self, t, op=None, async_op=False):
        self._count("all-reduce", t, 2)
        return _Done(t) if async_op else None


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def trace_step(cfg: ArchConfig, run: RunConfig, shape: ShapeConfig,
               batch: int, *, world: int = 1,
               optimizer: Optional[AdamW] = None,
               text_only: bool = False,
               mesh: Optional[tuple[int, ...]] = None) -> dict:
    """Trace one step of ``shape.kind`` for one rank of ``world`` taking
    ``batch`` rows, in bf16 on fake tensors, and measure it.  ``optimizer``
    (train) defaults to ``AdamW`` with ``run.opt_8bit`` moments;
    ``text_only`` feeds tokens alone, as ``data.SyntheticLM`` does, with no
    frame or vision embeddings.  Under ``run.fsdp`` the rank is rank 0 of
    ``world`` (``_TracedRanks``): its rows of the sharded tensors, their
    gathers and a ``GradSync`` in ``run.sync_mode``.

    With ``mesh`` (a grid's sizes, ``launch.mesh``) the rank is rank 0 of
    that grid, each of its groups a ``_TracedRanks``: its slices of every
    tensor JAX's rule splits, the model group's collectives (counted by
    kind and, in ``model_collectives``, by what they serve, as
    ``launch.train``'s ``model_log`` records them) and the data group's
    ``GradSync``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    grid = None
    if mesh is not None:
        grid = mesh_lib.stand_in(mesh, comm=_TracedRanks)
        grid.model.log = []
        ranks = grid.world if run.batch_axes == "all" else grid.data
    else:
        ranks = _TracedRanks(world) if run.fsdp else None
    with FakeTensorMode():
        if grid is not None:
            model = Model(cfg, run, dtype=torch.bfloat16, device="cpu",
                          grid=grid)
        else:
            model = Model(cfg, run, dtype=torch.bfloat16, device="cpu",
                          group=ranks)
        params = list(model.parameters())
        state: dict = {}
        if shape.kind == "train":
            opt = optimizer or AdamW(AdamWConfig(state_8bit=run.opt_8bit))
            state = opt.init(model)
            # a constant the tracer can read (``int(state["step"])``)
            state["step"] = torch.tensor(0, dtype=torch.int32)
            if run.grad_compression:
                state["err"] = compression.init_error_state(model)
        state_bytes = _nbytes(tree_leaves(state))
        mem = MemTracker()
        mem.track_external(model, *tree_leaves(state))
        flops, nbytes = FlopCounterMode(display=False), _bytes_mode()
        with mem, flops, nbytes:
            if shape.kind != "decode":
                inputs = input_specs(cfg, shape, batch)
                if text_only:
                    inputs = {"tokens": inputs["tokens"]}
            if shape.kind == "train":
                # the module lives until the backward is done
                sync = GradSync(ranks) if ranks is not None else None
                loss_mod = _Loss(model, sync)
                loss = loss_mod(inputs)
                grads = torch.autograd.grad(loss, params, allow_unused=True,
                                            materialize_grads=True)
                del loss
                if sync is not None:
                    grads = sync.finish(params, grads)
                names = [n for n, _ in model.named_parameters()]
                grads = dict(zip(names, grads))
                if run.grad_compression:
                    g8, scales, state["err"] = compression.compress_tree(
                        grads, state["err"], model.shards)
                    grads = compression.decompress_tree(g8, scales)
                opt.update(grads, state, model)
                del grads
            elif shape.kind == "prefill":
                with torch.no_grad():
                    model.forward(inputs)
            else:
                with torch.no_grad():
                    # on a grid the cache is the global batch's block
                    tokens, cache, index = decode_specs(
                        model, cfg, shape, None if grid is not None
                        else batch)
                    if tokens.shape[0] != batch:
                        raise ValueError(
                            f"{tuple(mesh)}: the cache's rows "
                            f"{tokens.shape[0]}, the batch rule's {batch}")
                    enc_out = (torch.zeros(
                        (batch, cfg.max_source_positions, cfg.d_model),
                        dtype=torch.bfloat16) if cfg.encoder_layers
                        else None)
                    model.decode_step(cache, tokens, index, enc_out=enc_out)
        peak = mem.get_tracker_snapshot("peak")[torch.device("cpu")]
    param_bytes = _nbytes(params)
    if grid is not None:
        breakdown = dict(ranks.bytes)
        for kind, n in grid.model.bytes.items():
            breakdown[f"model {kind}"] = n
        if grid.world is not ranks:
            # a decode cache whose batch stays whole splits T over every
            # rank: its merge is the world's
            for kind, n in grid.world.bytes.items():
                breakdown[f"world {kind}"] = n
    elif ranks is not None:
        breakdown = dict(ranks.bytes)
    else:
        # GradSync all-reduces every gradient in its parameter's dtype; a
        # ring all-reduce puts 2(W-1)/W of the bytes on each rank's link
        coll = (2.0 * (world - 1) / world * param_bytes
                if shape.kind == "train" else 0.0)
        breakdown = {"all-reduce": coll} if coll else {}
    coll = sum(breakdown.values())
    # one rank's terms against one rank's 6·N·D (its rows and, where
    # seq_shard splits them, its piece of the sequence): chips 1
    seq = (model.seq_split(model.seq_length(inputs))
           if shape.kind != "decode" else None)
    mf = model_flops(cfg, dataclasses.replace(
        shape, global_batch=batch,
        seq_len=seq.rows if seq is not None else shape.seq_len))
    roof = Roofline(flops=flops.get_total_flops(), hbm_bytes=nbytes.total,
                    coll_bytes=coll, coll_breakdown=breakdown,
                    chips=1, model_flops=mf)
    split = {name: peak.get(key, 0) for key, name in _SPLIT.items()}
    extra = {}
    if grid is not None:
        counts: dict[str, int] = {}
        for kind, key in grid.model.log:
            name = f"{kind} {key}"
            counts[name] = counts.get(name, 0) + 1
        extra["model_collectives"] = counts
    return {"flops": roof.flops, "hbm_bytes": roof.hbm_bytes,
            "coll_bytes": coll, "peak_bytes": peak["Total"],
            "peak_split": split, "param_bytes": param_bytes,
            "state_bytes": state_bytes,
            "fits_80GB": peak["Total"] <= H100.hbm_bytes,
            "roofline": roof.to_dict(),
            "trace_s": time.perf_counter() - t0, **extra}


def trace_cell(arch: str, shape_name: str, *, world: int = WORLD,
               run_overrides: Optional[dict] = None,
               cfg: Optional[ArchConfig] = None,
               mesh: Optional[tuple[int, ...]] = None) -> dict:
    """The counterpart of the JAX package's ``lower_cell``: one rank's
    step of the cell at ``world`` data-parallel ranks, or on a grid of
    ``mesh`` (its sizes: ``(16, 16)`` is JAX's production mesh), measured,
    as a record.  A cell whose JAX choice on ``mesh`` needs ``seq_shard``
    and whose input it splits (``seq_split``) is a skip record naming it
    unless ``run_overrides`` name ``seq_shard``: JAX's ``lower_cell``
    takes an explicit choice as given, and so does the port, tracing the
    split where it is True (``seq_per_rank`` in the record).  ``cfg``
    replaces the arch's config (a smoke config in the tests)."""
    cfg = cfg or configs.get(arch)
    shape = SHAPES[shape_name]
    if mesh is not None:
        world = math.prod(mesh)
        run, jax_run = default_run(cfg, run_overrides, shape=shape,
                                   mesh=mesh)
        named = run_overrides is not None and "seq_shard" in run_overrides
        if jax_run["seq_shard"] and seq_split(shape, mesh, cfg) \
                and not named:
            return {"arch": arch, "shape": shape_name, "ok": False,
                    "mesh": "x".join(map(str, mesh)), "jax_run": jax_run,
                    "skipped": "JAX's choice here is seq_shard (sequence "
                               "parallelism over \"model\"), which the "
                               "port takes only when asked by name: "
                               "--set seq_shard=True traces it"}
        split = run.seq_shard and seq_split(shape, mesh, cfg)
        batch = rank_batch(shape.global_batch, mesh, run, split)
        run, _ = default_run(cfg, run_overrides, batch, shape, mesh)
    else:
        batch, split = max(1, shape.global_batch // world), False
        run, jax_run = default_run(cfg, run_overrides, batch, shape)
    m = trace_step(cfg, run, shape, batch, world=world, mesh=mesh)
    where = {"mesh": "x".join(map(str, mesh))} if mesh is not None else {}
    if split:
        where["seq_per_rank"] = split_length(shape, cfg) // mesh[-1]
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "world": world, **where, "global_batch": shape.global_batch,
        "batch_per_rank": batch, "seq_len": shape.seq_len,
        "dtype": "bfloat16", "hardware": H100.name,
        "run": {f.name: getattr(run, f.name)
                for f in dataclasses.fields(run)},
        "jax_run": jax_run,
        "params": cfg.param_counts()["total"],
        **m,
        "notes": {"counted": PLAIN_NOTE, "hbm_bytes": BYTES_NOTE,
                  "peak": PEAK_NOTE},
        "ok": True,
    }


# ----------------------------------------------------------------------
def results_path(out: Path, tag: str) -> Path:
    return Path(out) / f"dryrun_torch_{tag}.json"


def run_cells(archs, shapes, *, world: int = WORLD, tag: str = "baseline",
              out: Path = RESULTS, run_overrides: Optional[dict] = None,
              mesh: Optional[tuple[int, ...]] = None) -> dict:
    """Trace every applicable (arch × shape) cell, record a skip for
    ``long_500k`` on quadratic archs and an error for a cell that raised,
    and write the records, keyed ``arch|shape|w<world>`` (on a ``mesh``:
    ``arch|shape|<d>x<m>``), to ``dryrun_torch_<tag>.json`` under ``out``
    after each cell."""
    path = results_path(out, tag)
    path.parent.mkdir(parents=True, exist_ok=True)
    done = json.loads(path.read_text()) if path.exists() else {}
    for arch in archs:
        app = applicable_shapes(configs.get(arch))
        for shape_name in shapes:
            if shape_name not in app:
                done[f"{arch}|{shape_name}|skip"] = {
                    "arch": arch, "shape": shape_name, "ok": False,
                    "skipped": "long_500k needs sub-quadratic attention"}
                continue
            key = f"{arch}|{shape_name}|" + (
                "x".join(map(str, mesh)) if mesh else f"w{world}")
            print(f"[trace] {key} ...", flush=True)
            try:
                rec = trace_cell(arch, shape_name, world=world,
                                 run_overrides=run_overrides, mesh=mesh)
                if "skipped" in rec:
                    print(f"[skip] {key}: {rec['skipped']}", flush=True)
                    done[key] = rec
                    continue
                roof = rec["roofline"]
                bound = max(roof[k] for k in ("compute_s", "memory_s",
                                              "collective_s"))
                print(f"[ok] {key}: B {rec['batch_per_rank']} a rank, flops "
                      f"{rec['flops']:.4e}, bytes {rec['hbm_bytes']:.4e}, "
                      f"peak {rec['peak_bytes'] / 1e9:.3f} GB (fits 80 GB: "
                      f"{rec['fits_80GB']}), dominant {roof['dominant']} "
                      f"({bound:.4g} s); traced in {rec['trace_s']:.1f} s",
                      flush=True)
            except Exception as e:          # recorded, as the JAX dry run
                rec = {"arch": arch, "shape": shape_name, "world": world,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {key}: {type(e).__name__}: "
                      f"{str(e)[:200]}", flush=True)
            done[key] = rec
            path.write_text(json.dumps(done, indent=1))
    path.write_text(json.dumps(done, indent=1))
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true",
                   help="every arch and shape (the default without "
                        "--arch or --shape)")
    p.add_argument("--world", type=int, default=WORLD,
                   help="data-parallel ranks the global batch is split over")
    p.add_argument("--mesh", default=None,
                   help="DxM (or PxDxM): trace a rank of that grid, as "
                        "JAX's mesh (16x16 is its production mesh)")
    p.add_argument("--set", action="append", default=[],
                   help="RunConfig override, e.g. --set opt_8bit=True")
    p.add_argument("--tag", default="baseline")
    p.add_argument("--out", default=str(RESULTS))
    args = p.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"True": True, "False": False}.get(v, v) \
            if not v.lstrip("-").isdigit() else int(v)

    archs = [args.arch] if args.arch and not args.all \
        else sorted(configs.ARCHS)
    shapes = [args.shape] if args.shape and not args.all else list(SHAPES)
    mesh = mesh_lib.parse(args.mesh) if args.mesh else None
    recs = run_cells(archs, shapes, world=args.world, tag=args.tag,
                     out=Path(args.out), run_overrides=overrides or None,
                     mesh=mesh)
    print(f"wrote {results_path(Path(args.out), args.tag)}")
    return 0 if all(r.get("ok") or "skipped" in r
                    for r in recs.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
