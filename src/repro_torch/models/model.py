"""Model assembly: a config compiled into segments of stacked blocks.

A config is compiled into *segments*: maximal runs of a repeating layer
pattern.  Each segment's parameters are stacked on a leading repeat axis,
as in the JAX package, so parameters map one to one; the port loops over
the repeats where the JAX package scans.

Every architecture of the configs builds: attention + dense-FFN blocks
(deepseek-7b, chatglm3, deepseek-coder, nemotron, internvl2's language
model), Mamba2 blocks (mamba2-130m), MoE FFN blocks on one device
(olmoe-1b-7b, jamba-v0.1-52b), MLA attention after a first-dense split with
the multi-token-prediction head (deepseek-v3), and an encoder whose
states the decoder blocks cross-attend to (whisper).

Built on a grid of ranks (``Model(..., grid=)``, ``launch.mesh``), a rank
holds its slices of what the JAX package's sharding rule splits
(``launch.sharding``) and runs tensor and expert parallelism over the
grid's model group (``sync.model_axis``), as JAX's model runs on a mesh;
under ``RunConfig.seq_shard`` a stack of Mamba2, GQA attention and MoE
blocks (``seq_shardable``) splits its sequence over that group instead
(``sync.seq``).
Its decode cache is its block of JAX's ``cache_shardings``
(``launch.sharding.CacheBlock``): its batch rows and, where the rule
splits it, its rows of the cache's T, every head of them; attention
merges the ranks' partial softmaxes over their rows.

The Model exposes:
- ``init(generator)``               → fills the parameters, returns self
- ``loss(batch)``                   → (scalar loss, metrics) for train_step
- ``forward(batch)``                → logits (prefill)
- ``encode(batch)``                 → encoder states (whisper)
- ``init_cache(batch, max_len)``    → decode cache (nested lists of dicts;
                                       on a grid the rank's block of it)
- ``decode_step(caches, tokens, index, enc_out=None)`` → (logits, caches)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_init, mlp, mlp_init, mlp_shapes,
    rmsnorm,
)
from repro_torch.launch import sharding
from repro_torch.sync import model_axis, shard
from repro_torch.sync import seq as seq_lib


# ----------------------------------------------------------------------
# segment derivation (same as the JAX package's)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str           # "attn" | "mamba"
    ffn: str             # "dense" | "moe" | "none"
    causal: bool = True
    cross: bool = False  # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple[BlockSpec, ...]
    repeats: int


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def derive_segments(cfg: ArchConfig, *, cross: bool = False,
                    causal: bool = True) -> list[Segment]:
    def spec(i: int) -> BlockSpec:
        mixer = cfg.pattern[i % len(cfg.pattern)]
        if cfg.is_moe_layer(i):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        if mixer == "mamba":
            ffn = ffn if cfg.family == "hybrid" else \
                ("none" if cfg.d_ff == 0 else ffn)
        return BlockSpec(mixer=mixer, ffn=ffn, causal=causal, cross=cross)

    regions = []
    if cfg.first_dense_layers:
        regions.append((0, cfg.first_dense_layers))
        regions.append((cfg.first_dense_layers, cfg.n_layers))
    else:
        regions.append((0, cfg.n_layers))

    segments = []
    for (lo, hi) in regions:
        n = hi - lo
        if n <= 0:
            continue
        period = _lcm(len(cfg.pattern),
                      cfg.moe_layer_period if cfg.n_experts else 1)
        if n % period != 0:
            period = n
        pat = tuple(spec(lo + j) for j in range(period))
        segments.append(Segment(pattern=pat, repeats=n // period))
    return segments


# RunConfig fields the port reads (``opt_8bit`` and ``grad_compression``
# in ``launch.train``; ``fsdp`` shards the parameters over the
# data-parallel ranks, ``sync.shard``).  ``batch_axes`` and
# ``moe_combine`` place work on the JAX package's "model" mesh axis (the
# batch over every axis, the MoE combine's reduction): the port reads them
# on a grid of ranks (``launch.mesh``), whose model group is that axis.
# ``seq_shard`` (sequence parallelism over "model", ``sync.seq``) is read
# for the archs ``seq_shardable`` names
_READ = ("attn_impl", "ssm_chunk", "remat", "microbatches", "logits_fp32",
         "opt_8bit", "grad_compression", "sync_mode", "fsdp")
_ON_A_GRID = ("batch_axes", "moe_combine")
SYNC_MODES = ("barrier", "bucketed")
BATCH_AXES = ("dp", "all")


def seq_shardable(cfg: ArchConfig) -> bool:
    """Whether ``RunConfig.seq_shard`` is ported for ``cfg``: no MTP head
    and no MLA, every block a Mamba2 block or a GQA/MHA attention block,
    each with a dense FFN, a MoE FFN or none.  That takes mamba2-130m (its
    smoke config adds a dense FFN, pointwise as the block's projections),
    the dense decoders (deepseek-7b, chatglm3-6b, nemotron-4-15b,
    deepseek-coder-33b), internvl2-2b, whose vision prefix the split
    counts, whisper-large-v3, whose encoder runs whole on every rank and
    whose blocks cross-attend from a rank's rows, olmoe-1b-7b (attention
    and MoE: a MoE block routes the whole sequence gathered over the
    group, ``models.moe``) and jamba-v0.1-52b (Mamba2, attention and MoE
    blocks in one stack).  A stack with Mamba2 blocks takes no encoder
    and no vision prefix.  deepseek-v3-671b (MLA, the MTP head) is not
    ported."""
    if cfg.mtp or cfg.attn_type == "mla":
        return False
    mamba = any(spec.mixer == "mamba" for seg in derive_segments(cfg)
                for spec in seg.pattern)
    return not (mamba and (cfg.encoder_layers or cfg.vision_embed_dim))


def seq_length(cfg: ArchConfig, batch: dict) -> int:
    """The rows of the sequence ``RunConfig.seq_shard`` splits: the vision
    prefix's, where ``cfg`` takes the batch's, and the tokens', as JAX
    constrains x after the prefix is put in front of the tokens
    (``src/repro/models/model.py:332-353``)."""
    n = batch["tokens"].shape[1]
    if cfg.vision_embed_dim and "vision_embeds" in batch:
        n += batch["vision_embeds"].shape[1]
    return n


def _check_run(run: RunConfig, grid=None,
               cfg: Optional[ArchConfig] = None) -> None:
    """Any field the port does not read, set away from its default, raises
    rather than be ignored without a word: ``batch_axes`` and
    ``moe_combine`` without a ``grid`` (they need its model group), and
    ``seq_shard`` for an arch it is not ported for (``seq_shardable``;
    where it is, without a grid it splits nothing, as JAX's without a
    mesh)."""
    if run.sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode {run.sync_mode!r}: want one of "
                         f"{SYNC_MODES}")
    if run.batch_axes not in BATCH_AXES:
        raise ValueError(f"batch_axes {run.batch_axes!r}: want one of "
                         f"{BATCH_AXES}")
    if run.moe_combine not in model_axis.COMBINES:
        raise ValueError(f"moe_combine {run.moe_combine!r}: want one of "
                         f"{model_axis.COMBINES}")
    read = _READ + (_ON_A_GRID if grid is not None else ()) + (
        ("seq_shard",) if cfg is not None and seq_shardable(cfg) else ())
    unread = [f.name for f in dataclasses.fields(run)
              if f.name not in read and getattr(run, f.name) != f.default]
    if unread:
        raise NotImplementedError(
            f"RunConfig fields {unread} need the JAX package's \"model\" "
            f"mesh axis: batch_axes and moe_combine are read on a grid of "
            f"ranks (Model(..., grid=launch.mesh.make_grid(...))); "
            f"seq_shard is ported for stacks of Mamba2 and GQA attention "
            f"blocks with dense or MoE FFNs (a vision prefix or an "
            f"encoder allowed), not for MLA or the MTP head")


def _leaves(tree: dict) -> list:
    """The tensors of a nested dict, in order."""
    return [t for v in tree.values()
            for t in (_leaves(v) if isinstance(v, dict) else [v])]


def _rebuild(tree: dict, leaves) -> dict:
    """``tree`` with its tensors replaced, in order, from ``leaves``."""
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# the decode cache on a grid
# ----------------------------------------------------------------------
class Caches(list):
    """``Model.init_cache``'s nested lists of dicts, with the rank's
    ``layout`` (a sequence leaf's ``launch.sharding.CacheBlock``; None:
    one process, every row)."""

    def __init__(self, layout: Optional[sharding.CacheBlock]):
        super().__init__()
        self.layout = layout


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
_Place = sharding.Placement
_WHOLE = sharding.Placement()


class _Layout:
    """Where a model's ranks keep their slices: ``place(names, shape)``
    gives a tensor's ``sharding.Placement`` (the data group's under
    ``RunConfig.fsdp``, and the model group's on a grid), ``local`` its
    shape on this rank and ``slice`` this rank's slice of a whole
    tensor.  One process: every tensor whole."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, grid,
                 data: Optional[shard.Comm], model: Optional[shard.Comm]):
        self.cfg, self.run, self.grid = cfg, run, grid
        self.data, self.model = data, model

    def place(self, names, shape, lead: int = 0) -> sharding.Placement:
        """``lead``: the repeat axes a stacked tensor's ``shape`` starts
        with (``sharding.placement``)."""
        if self.grid is not None:
            return sharding.placement(names, shape, self.cfg, self.run,
                                      self.grid, lead)
        if self.data is not None and shard.shard_axis(
                names, shape, self.data.world) is not None:
            return _Place(data=True)
        return _WHOLE

    def local(self, place, shape) -> tuple[int, ...]:
        return place.local(shape, self.model.world if self.model else 1,
                           self.data.world if self.data else 1)

    def slice(self, place, full: torch.Tensor) -> torch.Tensor:
        if place.model is not None:
            full = shard.mine(self.model, full, place.model)
        return shard.mine(self.data, full) if place.data else full


class _Block(nn.Module):
    """One pattern position of a segment, every tensor stacked [R, ...];
    with ``repeats=None`` one block, unstacked (the MTP block).

    Parameter names follow the JAX pytree (``ln1``, ``attn.wq``, ...), so
    ``named_parameters`` maps onto the checkpoint keys.  Over a
    ``layout`` that splits tensors (``RunConfig.fsdp``, a grid) each such
    tensor holds this rank's slice; ``placed`` names them (``attn.wq``,
    ...) with their placements.

    On a grid's model group of ``tp`` ranks the block runs each part one
    of two ways.  Where JAX's spec splits it head- or hidden-aligned it
    runs on its slice: ``tp_attn`` (local query and KV heads: column-
    parallel ``wq``/``wk``/``wv`` or MLA's ``wq_b``/``wkv_b``, row-parallel
    ``wo``), ``tp_mlp`` (column-parallel ``w_in``/``w_gate``, row-parallel
    ``w_out``), ``ep`` (the local experts) and ``tp_shared`` (the shared
    expert, as the MLP).  Any other split tensor is gathered at use
    (``at_use``: local name → its model axis), as MLA's ``wq_a``/
    ``wkv_a`` and every Mamba2 tensor are."""

    def __init__(self, spec: BlockSpec, cfg: ArchConfig,
                 repeats: Optional[int], dtype: torch.dtype,
                 device: torch.device, layout: Optional[_Layout] = None):
        super().__init__()
        self.cfg = cfg
        self.layout = layout
        self.placed: dict[str, sharding.Placement] = {}
        lead = () if repeats is None else (repeats,)

        def empty(*shape, dtype=dtype, name=None):
            shape = lead + shape
            if layout is not None and name is not None:
                place = layout.place(name.split("."), shape, len(lead))
                if place:
                    self.placed[name] = place
                    shape = layout.local(place, shape)
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        def stacked(group, shapes):
            return nn.ParameterDict({
                name: empty(*shape, name=f"{group}.{name}")
                for name, (shape, _) in shapes.items()})

        def with_fp32(group, shapes, fp32):
            return nn.ParameterDict({
                name: empty(*shape, dtype=torch.float32
                            if name in fp32 else dtype,
                            name=f"{group}.{name}")
                for name, shape in shapes.items()})

        self.ln1 = empty(cfg.d_model, name="ln1")
        if spec.mixer == "attn":
            self.attn = stacked("attn", attn.mla_shapes(cfg)
                                if cfg.attn_type == "mla"
                                else attn.gqa_shapes(cfg))
        else:
            self.ssm = with_fp32("ssm", ssm.ssm_shapes(cfg), ssm.FP32_PARAMS)
        if spec.cross:
            self.ln_x = empty(cfg.d_model, name="ln_x")
            self.xattn = stacked("xattn", attn.gqa_shapes(cfg))
        if spec.ffn == "dense":
            self.ln2 = empty(cfg.d_model, name="ln2")
            self.mlp = stacked("mlp", mlp_shapes(cfg.d_model, cfg.d_ff,
                                                 cfg.mlp_type))
        elif spec.ffn == "moe":
            self.ln2 = empty(cfg.d_model, name="ln2")
            self.moe = with_fp32("moe", moe.moe_shapes(cfg), moe.FP32_PARAMS)
        self._plan_model_axis()

    def _plan_model_axis(self) -> None:
        """Which parts run on their slice, which gather at use."""
        cfg, placed = self.cfg, self.placed
        layout = self.layout
        tp = layout.model.world if layout and layout.model else 1
        self.tp_attn = self.tp_xattn = self.tp_mlp = False
        self.ep = self.tp_shared = False
        self.local_cfg = cfg
        if tp == 1:
            self.at_use: dict[str, int] = {}
            return

        def on(group, want: dict) -> bool:
            return all(name in getattr(self, group)
                       and placed.get(f"{group}.{name}", _WHOLE).model == ax
                       for name, ax in want.items())

        H, K = cfg.n_heads, cfg.n_kv_heads
        gqa = {"wq": -1, "wk": -1, "wv": -1, "wo": -2}
        # a sequence split over the model group (``sync.seq``) runs each
        # rank's rows on every head and the whole weights, gathered at use
        if hasattr(self, "attn") and not layout.run.seq_shard:
            if cfg.attn_type == "mla":
                q = "wq_b" if cfg.q_lora_rank else "wq"
                self.tp_attn = H % tp == 0 and on(
                    "attn", {q: -1, "wkv_b": -1, "wo": -2})
            else:
                self.tp_attn = H % tp == 0 and K % tp == 0 and on("attn",
                                                                  gqa)
        if hasattr(self, "xattn") and not layout.run.seq_shard:
            self.tp_xattn = H % tp == 0 and K % tp == 0 and on("xattn", gqa)
        if self.tp_attn or self.tp_xattn:
            self.local_cfg = dataclasses.replace(
                self.local_cfg, n_heads=H // tp,
                n_kv_heads=K // tp if cfg.attn_type != "mla" else K)
        if hasattr(self, "mlp") and not layout.run.seq_shard:
            self.tp_mlp = on("mlp", {name: -2 if name == "w_out" else -1
                                     for name in self.mlp})
        if hasattr(self, "moe"):
            # under seq_shard a rank runs its experts on the gathered
            # sequence (``moe._split_apply``), the shared expert whole
            self.ep = on("moe", {"w_in": -3, "w_gate": -3, "w_out": -3})
            self.tp_shared = not layout.run.seq_shard and \
                "shared_in" in self.moe and on(
                "moe", {"shared_in": -1, "shared_gate": -1,
                        "shared_out": -2})
        runs = {"attn": self.tp_attn, "xattn": self.tp_xattn,
                "mlp": self.tp_mlp}
        on_slice = set()
        for group, flag in runs.items():
            if flag:
                on_slice |= {f"{group}.{n}" for n in getattr(self, group)
                             if n not in ("wq_a", "wkv_a")}
        if self.ep:
            on_slice |= {"moe.w_in", "moe.w_gate", "moe.w_out"}
        if self.tp_shared:
            on_slice |= {"moe.shared_in", "moe.shared_gate",
                         "moe.shared_out"}
        self.at_use = {name: place.model for name, place in placed.items()
                       if place.model is not None and name not in on_slice}

    def init_repeat(self, generator: torch.Generator,
                    r: Optional[int]) -> None:
        """Draw repeat r's parameters (all of an unstacked block's: r None)
        as the JAX block init does.  Each MoE tensor is drawn in fp32 and
        copied (cast) into its stack before the next is drawn, so init
        holds one fp32 draw beside the parameters.  A split tensor keeps
        this rank's slice of the whole draw, so that every rank draws what
        one process would."""
        cfg, p = self.cfg, self.ln1
        kw = dict(dtype=p.dtype, device=p.device)

        def rows(t):
            return t if r is None else t[r]

        def fill(group, params, draws):
            for name, w in draws:
                place = self.placed.get(f"{group}.{name}")
                if place:
                    # the stack's repeat axis is not in the draw
                    w = self.layout.slice(place, w)
                rows(params[name]).copy_(w)
                del w               # freed before the next draw

        rows(self.ln1).fill_(1.0)
        if hasattr(self, "attn"):
            init = attn.mla_init if cfg.attn_type == "mla" else attn.gqa_init
            fill("attn", self.attn, init(generator, cfg, **kw).items())
        else:
            fill("ssm", self.ssm, ssm.ssm_init(generator, cfg, **kw).items())
        if hasattr(self, "xattn"):
            rows(self.ln_x).fill_(1.0)
            fill("xattn", self.xattn,
                 attn.gqa_init(generator, cfg, **kw).items())
        if hasattr(self, "mlp"):
            rows(self.ln2).fill_(1.0)
            fill("mlp", self.mlp, mlp_init(generator, cfg.d_model, cfg.d_ff,
                                           cfg.mlp_type, **kw).items())
        if hasattr(self, "moe"):
            rows(self.ln2).fill_(1.0)
            fill("moe", self.moe, moe.moe_draws(generator, cfg,
                                                device=p.device))

    def stacked(self) -> dict:
        """The parameters, stacked, as the nested dict the layer functions
        take (``attn`` → {``wq``, ...}, ``ln1``, ...)."""
        out = {name: dict(child.items())
               for name, child in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out

    def at(self, r: Optional[int]) -> dict:
        """Repeat r's parameters (an unstacked block's: r None) as the
        nested dict the layer functions take."""
        tree = self.stacked()
        if r is None:
            return tree
        return _rebuild(tree, (t[r] for t in _leaves(tree)))


class _Mtp(nn.Module):
    """The multi-token-prediction head's parameters, unstacked as in JAX:
    ``proj`` [2d, d], one attention + dense-FFN ``block`` and ``ln``."""

    SPEC = BlockSpec("attn", "dense")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, layout: Optional[_Layout] = None):
        super().__init__()
        d = cfg.d_model
        shape = (2 * d, d)
        self.place = (layout.place(("mtp", "proj"), shape)
                      if layout is not None else _WHOLE)
        if self.place:
            shape = layout.local(self.place, shape)
        self.layout = layout
        self.proj = nn.Parameter(torch.empty(shape, dtype=dtype,
                                             device=device))
        self.block = _Block(self.SPEC, cfg, None, dtype, device, layout)
        self.ln = nn.Parameter(torch.empty((d,), dtype=dtype, device=device))

    def init(self, generator: torch.Generator) -> None:
        d = self.ln.shape[0]
        w = dense_init(generator, 2 * d, d, dtype=self.ln.dtype,
                       device=self.ln.device)
        self.proj.copy_(self.layout.slice(self.place, w) if self.place
                        else w)
        self.block.init_repeat(generator, None)
        self.ln.fill_(1.0)


class Model(nn.Module):
    # whisper's encoder: non-causal self-attention (with RoPE, as in JAX)
    # and a dense FFN, stacked under ``encoder``
    ENC_SPEC = BlockSpec("attn", "dense", causal=False)

    def __init__(self, cfg: ArchConfig, run: RunConfig = RunConfig(), *,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None, group=None, grid=None):
        """``group`` (a process group, or a ``sync.shard.Comm``): the
        data-parallel ranks over which ``run.fsdp`` shards the parameters
        (``shards`` names them; ``make_train_step`` takes the same group).
        With ``run.fsdp`` and no group, the model is one process's, whole;
        without ``run.fsdp`` the group is not read.

        ``grid`` (a ``launch.mesh.Grid``, in place of ``group``): the
        rank's place on a data × model grid, as a JAX mesh.  Each tensor
        is split as JAX's rule splits it (``launch.sharding``): over the
        model group (tensor and expert parallelism, the vocabulary) and,
        under ``run.fsdp``, over the data group.  ``lm_head`` is padded to
        a multiple of the model group's size (``vocab``) and its pad
        columns masked, as JAX's.  ``run.batch_axes="all"`` makes every
        rank a data rank (parameters replicated, or split over the world
        under fsdp); ``run.moe_combine`` picks the experts' combine;
        ``run.seq_shard`` splits an input's sequence over the model group
        (``seq_split``, ``sync.seq``; the archs of ``seq_shardable``)."""
        super().__init__()
        self.cfg = cfg
        self.run = run
        self.dtype = dtype
        self.segments_spec = derive_segments(cfg)
        if cfg.encoder_layers:
            # decoder blocks cross-attend to the encoder's states
            self.segments_spec = [
                Segment(tuple(dataclasses.replace(s, cross=True)
                              for s in seg.pattern), seg.repeats)
                for seg in self.segments_spec]
        _check_run(run, grid, cfg)
        if grid is not None and group is not None:
            raise ValueError("Model: give a data-parallel group or a grid, "
                             "not both")
        dev = _device.resolve(device)
        d, V = cfg.d_model, cfg.vocab_size
        self.grid = grid
        every = grid is not None and run.batch_axes == "all"
        if grid is None:
            data = shard.as_comm(group) if run.fsdp else None
            model = None
        else:
            data = grid.world if every else grid.data
            model = grid.model if grid.tp > 1 and not every else None
            if model is not None and model.log is None:
                model.log = []
        # the batch's ranks: the grid's data group (its world under
        # batch_axes="all"), or the fsdp group
        self.data_comm = data
        # the model group over which run.seq_shard splits a sequence
        # (``seq_split``), whatever batch_axes
        self.seq_comm = (grid.model if run.seq_shard and grid is not None
                         and grid.tp > 1 else None)
        if self.seq_comm is not None and self.seq_comm.log is None:
            self.seq_comm.log = []
        self.tp = model_axis.Tp(model) if model is not None else None
        # JAX pads the head to its mesh's "model" size, batch_axes aside
        tp_pad = grid.tp if grid is not None else 1
        self.vocab = -(-V // tp_pad) * tp_pad
        layout = _Layout(cfg, run, grid, data, model)
        placed: dict[str, sharding.Placement] = {}
        self._top_at_use: dict[str, int] = {}

        def empty(*shape, name=None):
            if name is not None:
                place = layout.place((name,), shape)
                if place:
                    placed[name] = place
                    shape = layout.local(place, shape)
                    if place.model is not None:
                        self._top_at_use[name] = place.model
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        self.embed = empty(V, d, name="embed")
        self.final_norm = empty(d, name="final_norm")
        if not cfg.tie_embeddings:
            self.lm_head = empty(d, self.vocab, name="lm_head")
        if cfg.vision_embed_dim:
            self.vis_proj = empty(cfg.vision_embed_dim, d, name="vis_proj")
        self.segments = nn.ModuleList(
            nn.ModuleList(_Block(spec, cfg, seg.repeats, dtype, dev, layout)
                          for spec in seg.pattern)
            for seg in self.segments_spec)
        if cfg.encoder_layers:
            self.encoder = _Block(self.ENC_SPEC, cfg, cfg.encoder_layers,
                                  dtype, dev, layout)
            self.enc_norm = empty(d, name="enc_norm")
        if cfg.mtp:
            self.mtp = _Mtp(cfg, dtype, dev, layout)
        self.layout = layout
        blocks = [(prefix, m) for prefix, m in self.named_modules()
                  if isinstance(m, _Block)]
        placed.update({f"{prefix}.{name}": place for prefix, m in blocks
                       for name, place in m.placed.items()})
        if cfg.mtp and self.mtp.place:
            placed["mtp.proj"] = self.mtp.place
            if self.mtp.place.model is not None:
                self._top_at_use["mtp.proj"] = self.mtp.place.model
        self._placed = placed
        if grid is None:
            self.shards = shard.Shards(data, placed)
        else:
            self.shards = shard.GridShards(data, model, grid.world, placed)
        params = dict(self.named_parameters())
        self._sharded_ids = {id(params[n]) for n in self.shards.data_names}
        # id → model axis of every tensor gathered whole at use
        self._at_use = {id(params[f"{prefix}.{name}"]): ax
                        for prefix, m in blocks
                        for name, ax in m.at_use.items()}
        self._at_use.update({id(params[n]): ax
                             for n, ax in self._top_at_use.items()})
        # every tensor split over the model group: gathered at use, or run
        # on its slice (a rank's experts)
        self._model_split = {id(params[n]) for n, place in placed.items()
                             if place.model is not None}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def seq_length(self, batch: dict) -> int:
        """The rows of ``batch``'s sequence that ``seq_split`` takes: the
        vision prefix counted (``seq_length``)."""
        return seq_length(self.cfg, batch)

    def seq_split(self, length: int) -> Optional[seq_lib.Seq]:
        """How ``run.seq_shard`` splits an input of ``length`` rows
        (``seq_length``) over the grid's model group of m ranks: where m
        divides it (JAX's condition, ``src/repro/models/model.py:342-343``)
        rank k keeps rows ``[k·length/m, (k+1)·length/m)`` (a
        ``sync.seq.Seq``); else,
        or without ``seq_shard`` on a grid, None: nothing is split.  With
        Mamba2 blocks a split whose rows a rank the chunk does not divide,
        or fewer than the conv's W−1, raises; attention blocks take any
        split."""
        comm = self.seq_comm
        if comm is None or length % comm.world:
            return None
        split = seq_lib.Seq(comm, length)
        if not any(spec.mixer == "mamba" for seg in self.segments_spec
                   for spec in seg.pattern):
            return split
        chunk = min(self.run.ssm_chunk or self.cfg.ssm_chunk, length)
        halo = self.cfg.ssm_conv - 1
        if split.rows % chunk or split.rows < halo:
            raise ValueError(
                f"seq_shard: {length} rows over {comm.world} model ranks "
                f"leave {split.rows} a rank, which must be a multiple of "
                f"the chunk {chunk} and at least the conv's halo of {halo}")
        return split

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter as the JAX init does: norms with ones, the
        rest fp32 normal × scale cast to the model dtype, one repeat of a
        stacked block at a time (to bound the fp32 temporaries).  A split
        tensor keeps this rank's slice of the whole draw."""
        cfg, kw = self.cfg, dict(dtype=self.dtype, device=self.device)

        def put(name, w):
            place = self._placed.get(name)
            getattr(self, name).copy_(self.layout.slice(place, w)
                                      if place else w)

        put("embed", embed_init(generator, cfg.vocab_size, cfg.d_model,
                                **kw))
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            put("lm_head", dense_init(generator, cfg.d_model, self.vocab,
                                      **kw))
        if cfg.vision_embed_dim:
            put("vis_proj", dense_init(generator, cfg.vision_embed_dim,
                                       cfg.d_model, **kw))
        for seg, blocks in zip(self.segments_spec, self.segments):
            for r in range(seg.repeats):
                for block in blocks:
                    block.init_repeat(generator, r)
        if cfg.encoder_layers:
            for r in range(cfg.encoder_layers):
                self.encoder.init_repeat(generator, r)
            self.enc_norm.fill_(1.0)
        if cfg.mtp:
            self.mtp.init(generator)
        return self

    # ------------------------------------------------------------------
    def _apply_block(self, bp: dict, spec: BlockSpec, x, *,
                     positions=None, cache=None, cache_index=None,
                     layout: Optional[sharding.CacheBlock] = None,
                     enc_out=None, block: Optional[_Block] = None,
                     seq=None):
        """One block: (x, the block's MoE aux loss, or None).  On a grid
        ``block`` says which parts run on this rank's slice: those enter
        through ``tp.enter`` and leave through ``tp.combine``; ``layout``
        says where the cache's rows sit."""
        cfg, run, tp = self.cfg, self.run, self.tp
        tp_attn = block is not None and block.tp_attn
        lcfg = block.local_cfg if block is not None else cfg
        aux = None
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        if spec.mixer == "attn":
            c = cache.get("attn") if cache else None
            heads = tp.comm if tp_attn and c is not None else None
            if cfg.attn_type == "mla":
                enter = ((lambda t: tp.enter(t, "attn")) if tp_attn
                         else None)
                out, _ = attn.mla_apply(bp["attn"], h,
                                        lcfg if tp_attn else cfg,
                                        positions=positions, cache=c,
                                        cache_index=cache_index,
                                        impl=run.attn_impl, enter=enter,
                                        layout=layout, heads=heads)
            else:
                out, _ = attn.gqa_apply(bp["attn"],
                                        tp.enter(h, "attn") if tp_attn
                                        else h, lcfg if tp_attn else cfg,
                                        positions=positions, cache=c,
                                        cache_index=cache_index,
                                        causal=spec.causal,
                                        impl=run.attn_impl,
                                        layout=layout, heads=heads, seq=seq)
            if tp_attn:
                out = tp.combine(out, "attn")
        else:
            out, _ = ssm.ssm_apply(bp["ssm"], h, cfg,
                                   cache=cache.get("ssm") if cache else None,
                                   chunk=run.ssm_chunk or None, seq=seq)
        x = x + out
        if spec.cross and enc_out is not None:
            h = rmsnorm(bp["ln_x"], x, cfg.norm_eps)
            if block is not None and block.tp_xattn:
                out, _ = attn.gqa_apply(bp["xattn"], tp.enter(h, "xattn"),
                                        lcfg, kv_src=tp.enter(enc_out,
                                                              "xattn"),
                                        impl=run.attn_impl)
                out = tp.combine(out, "xattn")
            else:
                out, _ = attn.gqa_apply(bp["xattn"], h, cfg, kv_src=enc_out,
                                        impl=run.attn_impl, seq=seq)
            x = x + out
        if spec.ffn == "dense":
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            if block is not None and block.tp_mlp:
                x = x + tp.combine(mlp(bp["mlp"], tp.enter(h, "mlp"),
                                       cfg.mlp_type), "mlp")
            else:
                x = x + mlp(bp["mlp"], h, cfg.mlp_type)
        elif spec.ffn == "moe":
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            split = block is not None and (block.ep or block.tp_shared)
            y, aux = moe.moe_apply(bp["moe"], h, cfg,
                                   tp=tp if split else None,
                                   combine=run.moe_combine,
                                   ep=split and block.ep,
                                   shared_tp=split and block.tp_shared,
                                   seq=seq)
            x = x + y
        return x, aux

    def _rows(self, key: tuple, trees: list, r: Optional[int], sync=None,
              bucket: bool = False, seq=None) -> list[dict]:
        """Row r of each tensor of ``trees`` (the whole tensor: r None), in
        the trees' shape.  A sharded tensor's row is gathered whole across
        the ranks and its gradient reduce-scattered back into this rank's
        rows (``sync.shard.gathered``; by ``sync``, a ``GradSync``, where
        there is one); with ``bucket`` the other rows pass through
        ``sync``'s bucket, so that their gradients are reduced as soon as
        this repeat's backward is done.  On a grid a tensor that runs
        whole but is split over the model group is then gathered over it
        (``sync.shard.gathered_at_use``).  On a sequence split over the
        model group (``seq``) each rank's gradient is its rows' part: a
        gathered tensor's parts are summed, not averaged, and a tensor
        whole on every rank of a model group that splits parameters
        enters through ``tp.enter``, whose backward sums it over the
        group (under ``batch_axes="all"`` the data sync spans the grid's
        world, which sums them); a rank's experts take their whole
        gradient on their rank."""
        stacks = [t for tree in trees for t in _leaves(tree)]
        whole = [t for t in stacks if id(t) in self._sharded_ids]
        rest = [t for t in stacks if id(t) not in self._sharded_ids]
        got = {}
        if whole:
            got.update(zip(map(id, whole), shard.gathered(
                self.shards.data, sync, key, whole, r,
                now=self.run.sync_mode == "bucketed")))
        if rest:
            rows = (sync.bucket(key, rest, r) if bucket
                    else [t if r is None else t[r] for t in rest])
            got.update(zip(map(id, rest), rows))
        at_use = [t for t in stacks if id(t) in self._at_use]
        if at_use:
            got.update(zip(map(id, at_use), shard.gathered_at_use(
                self.tp.comm, key, [got[id(t)] for t in at_use],
                [self._at_use[id(t)] for t in at_use], mean=seq is None)))
        if seq is not None and self.tp is not None:
            for t in stacks:
                if id(t) not in self._model_split:
                    got[id(t)] = self.tp.enter(got[id(t)], key)
        rows = iter([got[id(t)] for t in stacks])
        return [_rebuild(tree, rows) for tree in trees]

    def _run_repeat(self, si: int, r: int, x, *, positions=None,
                    caches=None, cache_index=None, enc_out=None, sync=None,
                    bucketed: bool = False, seq=None):
        """Repeat r of segment si: each of its pattern's blocks in turn,
        on their parameters' rows r (``_rows``: the sharded ones gathered;
        the others, ``bucketed``, through ``sync``'s bucket, so that their
        gradients are reduced when this repeat's backward is done).
        Returns (x, the MoE blocks' summed aux loss, or None)."""
        blocks = self.segments[si]
        bps = self._rows((si, r), [block.stacked() for block in blocks],
                         r, sync, bucket=bucketed, seq=seq)
        total_aux = None
        for j, spec in enumerate(self.segments_spec[si].pattern):
            cache = None
            if caches is not None:
                cache = {name: {k: v[r] for k, v in c.items()}
                         for name, c in caches[si][j].items()}
            x, aux = self._apply_block(
                bps[j], spec, x, positions=positions,
                cache=cache, cache_index=cache_index,
                layout=caches.layout if caches is not None else None,
                enc_out=enc_out,
                block=blocks[j], seq=seq)
            if aux is not None:
                total_aux = aux if total_aux is None else total_aux + aux
        return x, total_aux

    def _run_segments(self, x, *, positions=None, caches=None,
                      cache_index=None, enc_out=None, sync=None, seq=None):
        """Loop each segment over its repeats.  Returns (x, the MoE blocks'
        summed aux loss: a 0-d fp32 tensor, or 0.0 without MoE blocks).
        Caches are written in place.  With ``run.remat`` and autograd
        recording, each repeat runs under ``torch.utils.checkpoint``, as
        JAX's ``jax.checkpoint`` wraps the scan body: its activations are
        recomputed in the backward.

        With ``run.sync_mode == "bucketed"``, a ``sync``
        (``sync.overlap.GradSync``) and autograd recording, each repeat's
        parameter gradients are reduced across the data-parallel ranks
        inside the backward, as soon as that repeat's backward is done
        (the JAX package's synced scan); otherwise ``sync.finish`` reduces
        them after the backward.  Under ``run.fsdp`` each repeat's sharded
        rows are gathered before it runs, again in remat's recompute, as
        JAX's FSDP re-gathers them (``sync.shard``).  ``seq``: x holds
        this rank's rows of a sequence split over the model group
        (``seq_split``)."""
        grad = caches is None and torch.is_grad_enabled()
        remat = self.run.remat and grad
        sync = sync if grad else None
        bucketed = sync is not None and self.run.sync_mode == "bucketed"
        kw = dict(positions=positions, caches=caches, cache_index=cache_index,
                  enc_out=enc_out, sync=sync, bucketed=bucketed, seq=seq)
        total_aux = 0.0
        for si, seg in enumerate(self.segments_spec):
            for r in range(seg.repeats):
                if remat:
                    x, aux = torch.utils.checkpoint.checkpoint(
                        self._run_repeat, si, r, x, use_reentrant=False,
                        **kw)
                else:
                    x, aux = self._run_repeat(si, r, x, **kw)
                if bucketed:
                    sync.mark(x, (si, r))
                if aux is not None:
                    total_aux = total_aux + aux
        return x, total_aux

    # ------------------------------------------------------------------
    def _encode_layer(self, r: int, x, sync=None, seq=None):
        bp, = self._rows(("encoder", r), [self.encoder.stacked()], r, sync,
                         seq=seq)
        return self._apply_block(bp, self.ENC_SPEC, x, block=self.encoder)[0]

    def encode(self, batch: dict, sync=None, seq=None) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings
        ``batch["audio_embeds"]`` [B, frames, d] (the conv front end is a
        stub, as in the JAX package); each layer under
        ``torch.utils.checkpoint`` where ``_run_segments`` would use it.
        ``sync``: the backward's ``GradSync`` (``loss``).  ``seq``: the
        decoder's split over the model group (``seq_split``); the encoder
        is not split (JAX's ``_encode`` carries no constraint): every rank
        of the group runs it whole on the same rows, and its parameters'
        gradients on a rank are that rank's rows' part, summed over the
        group as the decoder's are (``_rows``)."""
        x = batch["audio_embeds"].to(self.dtype)
        remat = self.run.remat and torch.is_grad_enabled()
        sync = sync if torch.is_grad_enabled() else None
        for r in range(self.cfg.encoder_layers):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._encode_layer, r, x, sync, seq, use_reentrant=False)
            else:
                x = self._encode_layer(r, x, sync, seq)
        norm = (self._whole("enc_norm", sync, seq) if seq is not None
                else self.enc_norm)
        return rmsnorm(norm, x, self.cfg.norm_eps)

    def _embed_inputs(self, batch: dict, sync=None, seq=None):
        """Token embedding, after the projected vision prefix if any.
        Returns (x, the prefix rows in x).  On a split sequence (``seq``)
        this rank's rows of ``[prefix; tokens]``, as JAX's ``seq_shard``
        constrains x: the prefix rows that fall in them projected, their
        tokens embedded (a rank may hold prefix rows only, tokens only, or
        both; every rank takes both parameters, whose collectives it
        shares with the group)."""
        tokens = batch["tokens"]
        vision = bool(self.cfg.vision_embed_dim) and "vision_embeds" in batch
        n = batch["vision_embeds"].shape[1] if vision else 0
        lo, hi = ((seq.start, seq.start + seq.rows) if seq is not None
                  else (0, n + tokens.shape[1]))
        tokens = tokens[:, max(lo - n, 0):max(hi - n, 0)]
        x = self._whole("embed", sync, seq)[tokens].to(self.dtype)
        if not vision:
            return x, 0
        v = batch["vision_embeds"][:, min(lo, n):min(hi, n)].to(
            self.dtype) @ self._whole("vis_proj", sync, seq)
        return torch.cat([v, x], dim=1), v.shape[1]

    def _whole(self, name: str, sync=None, seq=None) -> torch.Tensor:
        """Top-level parameter ``name`` as a use takes it: gathered where
        it is split (``_rows``)."""
        got, = self._rows((name,), [{"w": getattr(self, name)}], None, sync,
                          seq=seq)
        return got["w"]

    def _head(self, x, sync=None, seq=None):
        """Logits over ``vocab`` columns; on a grid whose model group pads
        the head, the pad columns are masked to -1e30 (JAX's ``_head``)."""
        norm = (self._whole("final_norm", sync, seq) if seq is not None
                else self.final_norm)
        x = rmsnorm(norm, x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ self._whole("embed", sync, seq).T
        head, = self._rows(("head",), [{"w": self.lm_head}], None, sync,
                           seq=seq)
        logits = x @ head["w"]
        if self.vocab != self.cfg.vocab_size:
            cols = torch.arange(self.vocab, device=logits.device)
            neg = torch.where(cols < self.cfg.vocab_size, 0.0, -1e30)
            logits = logits + neg.to(logits.dtype)
        return logits

    @staticmethod
    def _positions(x: torch.Tensor, seq=None) -> torch.Tensor:
        """The positions of x's rows in the whole sequence: on a split
        sequence (``seq``) this rank's, ``seq.start`` onwards."""
        if seq is not None:
            return seq.positions(x.device)
        return torch.arange(x.shape[1], device=x.device)

    # ------------------------------------------------------------------
    def forward(self, batch: dict) -> torch.Tensor:
        """Logits [B, L, vocab] for every row, a vision prefix's included
        (L: ``seq_length``); on a sequence split over the model group
        (``seq_split``) this rank's rows of them."""
        seq = self.seq_split(self.seq_length(batch))
        enc_out = (self.encode(batch, seq=seq) if self.cfg.encoder_layers
                   else None)
        x, _ = self._embed_inputs(batch, seq=seq)
        positions = self._positions(x, seq)
        x, _ = self._run_segments(x, positions=positions, enc_out=enc_out,
                                  seq=seq)
        return self._head(x, seq=seq)

    def loss(self, batch: dict, sync=None) -> tuple[torch.Tensor, dict]:
        """Next-token CE over the text region (after any vision prefix),
        plus ``router_aux_weight`` × the MoE blocks' aux loss, plus 0.3 ×
        the MTP head's CE where the config has one.  Returns (loss, {"ce",
        "aux", "loss"} and "mtp_ce" with MTP), 0-d fp32 tensors.  ``sync``
        (a ``sync.overlap.GradSync``) is the backward's gradient sync, which
        ``_run_segments`` wires in bucketed mode.

        On a sequence split over the model group (``seq_split``, the
        vision prefix counted) each rank sums the CE of its own text rows,
        whose labels it reads from the whole ``tokens`` (text row t's is
        token t+1, the next rank's first where t is the rank's last; the
        last token has none), over the batch's B·(S−1) labels, and the
        ranks' parts are summed (``sync.seq.Seq.total``): the loss is one
        process's, and each rank's gradients are its rows' part of it.  A
        rank without a labelled row (prefix rows only) adds an exact 0
        through its head, so that its backward still reaches every
        collective it shares with the group."""
        cfg = self.cfg
        sync = sync if torch.is_grad_enabled() else None
        tokens = batch["tokens"]
        seq = self.seq_split(self.seq_length(batch))
        enc_out = (self.encode(batch, sync, seq) if cfg.encoder_layers
                   else None)
        x, n_prefix = self._embed_inputs(batch, sync, seq)
        positions = self._positions(x, seq)
        x, aux = self._run_segments(x, positions=positions, enc_out=enc_out,
                                    sync=sync, seq=seq)
        h = x[:, n_prefix:]                       # text region only
        if seq is None:
            logits = self._head(h[:, :-1], sync)
            labels = tokens[:, 1:]
        else:
            # this rank's text rows are t0.. (the prefix has L − S rows)
            t0 = max(seq.start - (seq.length - tokens.shape[1]), 0)
            labels = tokens[:, t0 + 1:t0 + h.shape[1] + 1]
            logits = self._head(h[:, :labels.shape[1]], sync, seq)
        if self.run.logits_fp32:
            logits = logits.float()
        if seq is None:
            ce = cross_entropy(logits, labels)
        else:
            B, S = tokens.shape
            part = (cross_entropy(logits, labels)
                    * (labels.numel() / (B * (S - 1)))
                    if labels.numel() else logits.float().sum() * 0.0)
            ce = seq.total(part)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + cfg.router_aux_weight * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp:
            # predict t+2 from [h_t ; emb(t+1)] through one more block; its
            # aux loss is dropped and its logits are fp32, as in JAX
            mtp = self.mtp
            proj, bp = self._rows(("mtp",), [{"proj": mtp.proj},
                                             mtp.block.stacked()], None, sync)
            h_in = rmsnorm(mtp.ln, h[:, :-1], cfg.norm_eps)
            nxt = self._whole("embed", sync)[tokens[:, 1:]].to(self.dtype)
            z = torch.cat([h_in, nxt], dim=-1) @ proj["proj"]
            z, _ = self._apply_block(bp, mtp.SPEC, z,
                                     positions=positions[:z.shape[1]],
                                     block=mtp.block)
            mtp_ce = cross_entropy(self._head(z[:, :-1], sync).float(),
                                   tokens[:, 2:])
            loss = loss + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def cache_layout(self, batch_size: int, max_len: int
                     ) -> Optional[sharding.CacheBlock]:
        """Where this rank's block of a decode cache of ``batch_size`` ×
        ``max_len`` sits (None without a grid): JAX's rule on a
        sequence leaf ``[R, B, T]``.  A decode call's tokens are the
        cache's rows of the batch: where JAX's batch rule would lay the
        tokens out otherwise (a prefix of the data axes that alone
        divides B, or "model" under ``batch_axes="all"``), JAX's step
        reshards them to the cache's rows."""
        if self.grid is None:
            return None
        return sharding.cache_block(("k",), (1, batch_size, max_len),
                                    self.cfg, self.grid)

    def init_cache(self, batch_size: int, max_len: int) -> Caches:
        """caches[segment][pattern position] = {"attn": {"k", "v"}}, each
        [R, B, max_len, K, hd] in the model dtype (MLA: {"ckv", "kr"},
        [R, B, max_len, kv_lora] and [R, B, max_len, rope_d]), or {"ssm":
        {"conv", "state"}}: [R, B, W-1, conv_dim] in the model dtype and
        [R, B, H, P, N] in fp32 (an SSM cache does not grow with
        max_len).

        ``batch_size`` is the global batch, as JAX's ``init_cache`` takes
        it (its rule reads divisibility on it).  On a grid each leaf is
        this rank's block of JAX's ``cache_shardings``
        (``launch.sharding.cache_block``): B over the data axes where they
        divide it, T over "model" (every axis where B stays whole), every
        KV head; a dimension its axes do not divide stays whole.  The
        result's ``layout`` says which rows (``cache_layout``); a decode
        step takes tokens of the rank's rows of the batch.  One process
        (no grid): the whole cache, ``layout`` None."""
        caches = Caches(self.cache_layout(batch_size, max_len))
        meta = dict(dtype=self.dtype, device="meta")
        for si, seg in enumerate(self.segments_spec):
            seg_caches = []
            for j, spec in enumerate(seg.pattern):
                if spec.mixer == "attn":
                    init = (attn.mla_cache_init
                            if self.cfg.attn_type == "mla"
                            else attn.gqa_cache_init)
                    name, one = "attn", init(self.cfg, batch_size, max_len,
                                             **meta)
                else:
                    name, one = "ssm", ssm.ssm_cache_init(
                        self.cfg, batch_size, **meta)
                leaves = {}
                for k, v in one.items():
                    shape = (seg.repeats,) + tuple(v.shape)
                    if self.grid is not None:
                        shape = sharding.cache_block(
                            (str(si), str(j), name, k), shape, self.cfg,
                            self.grid).shape
                    leaves[k] = torch.zeros(shape, dtype=v.dtype,
                                            device=self.device)
                seg_caches.append({name: leaves})
            caches.append(seg_caches)
        return caches

    def decode_step(self, caches, tokens: torch.Tensor, index: int, *,
                    enc_out: Optional[torch.Tensor] = None):
        """tokens: [B,S] written at cache rows index..index+S (a Python int).
        ``enc_out`` (``encode``'s output) feeds every cross-attention block,
        recomputing its K/V at each call, as the JAX package does.

        S is 1 for a decode step; at index 0 a whole prompt prefills in one
        call.  Attention blocks run it through K1 on the "kernel" path; SSM
        blocks run the chunked scan through K2 from the cache's state (S a
        multiple of the chunk, or shorter than it) and leave the final
        state and conv tail in the cache, for any index.  MoE blocks run
        their experts on K3 with a capacity computed from the B·S tokens of
        the call, as JAX's ``forward`` over the same tokens does: where an
        expert overflows, a one-call prefill drops assignments that JAX's
        token-by-token decode (B tokens a call) keeps.  MLA blocks prefill
        at index 0 through K1 on the expanded latents and decode in the
        latent space.  An encoder-decoder model needs ``enc_out``: without
        it the cross-attention blocks would be skipped.

        On a grid ``caches`` is ``init_cache``'s (its ``layout``) and
        ``tokens`` (and ``enc_out``) hold this rank's rows of the batch;
        attention over a split T merges the ranks' partials."""
        if self.cfg.encoder_layers and enc_out is None:
            raise ValueError(f"{self.cfg.name} has an encoder: decode_step "
                             f"needs its enc_out (Model.encode)")
        if self.grid is not None:
            layout = caches.layout
            if layout is None:
                raise ValueError(f"{self.grid!r}: decode_step takes the "
                                 f"cache of Model.init_cache (its layout)")
            if tokens.shape[0] != layout.rows:
                raise ValueError(
                    f"{self.grid!r}: tokens of {tokens.shape[0]} rows; this "
                    f"rank's cache holds rows {layout.row0}.."
                    f"{layout.row0 + layout.rows} of {layout.batch}")
        x = self._whole("embed")[tokens].to(self.dtype)
        x, _ = self._run_segments(x, caches=caches, cache_index=index,
                                  enc_out=enc_out)
        return self._head(x), caches
