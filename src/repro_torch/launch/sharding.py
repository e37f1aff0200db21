"""The sharding rule: which mesh axes split each dimension of a parameter,
an optimizer moment, a batch or a decode cache.  The port's own copy of
the JAX package's ``launch/sharding.py`` rule (a copy, not an import),
and where a rank of the port's grid (``launch.mesh``) keeps its slice.

Strategy, as JAX's:
- TP over "model": attention heads and FFN hidden; EP over "model" for
  the MoE expert banks; the vocabulary over "model" for embed/lm_head.
- DP over ("pod", "data"): the batch; with ``RunConfig.fsdp`` also the
  parameters' non-TP dimension.
- Decode caches: the batch over dp where it divides, the cache sequence
  over "model" (and over every axis when the batch is 1).  A rank keeps
  its block of each leaf (``cache_block``) and the model attends over it
  (``models.attention``).

Every entry is divisibility-guarded (``_maybe``): a dimension the axis
does not divide stays replicated.  A spec is a tuple, one entry a
dimension: None, an axis name, or a tuple of axis names, as JAX's
``PartitionSpec`` lists them.  ``mesh`` is anything with JAX's mesh's
``shape`` (axis → size) and ``axis_names``: a ``launch.mesh.Grid``, or a
stand-in in the tests.

Where the port's rank keeps its slice (``placement``).  The "model" entry
stays on JAX's dimension: the layers run on it (column- and row-parallel
projections, local heads, local experts) or gather it at use.  The data
entries go on the second-to-last axis, as ``sync.shard``'s fsdp rule has
always put them, so that an int8 moment's per-row scales stay local to a
rank.  JAX puts them on the last axis of ``wo``, ``w_out``, ``out_proj``
and ``shared_out``, whose second-to-last axis carries "model": there the
port splits that axis over ("model", data), model outer, and guards the
product.  A rank's bytes are the spec's except where the two guards
differ (chatglm3-6b's ``w_out`` at 256 data ranks: ``sync.shard``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

from repro_torch.configs.base import ArchConfig, RunConfig

Spec = tuple


class Mesh:
    """Axis sizes with no ranks behind them, for the rule alone: ``(d,
    m)`` over ("data", "model"), ``(p, d, m)`` over ("pod", "data",
    "model")."""

    def __init__(self, sizes: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None):
        sizes = tuple(sizes)
        self.axis_names = tuple(axis_names or (
            ("data", "model") if len(sizes) == 2
            else ("pod", "data", "model")))
        self.shape = dict(zip(self.axis_names, sizes))


def dp_axes(mesh) -> tuple[str, ...]:
    """All data-parallel axes (everything except "model")."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _maybe(mesh, axes, dim: int):
    """axes if dim divides evenly, else None (replicate)."""
    return axes if axes and dim % _axsize(mesh, axes) == 0 else None


def param_spec_for(names: Sequence[str], shape: Sequence[int],
                   cfg: ArchConfig, run: RunConfig, mesh) -> Spec:
    """The spec of the parameter at key path ``names`` (e.g.
    ``("segments", "0", "0", "attn", "wq")``) of full ``shape``: JAX's
    ``param_spec_for``, branch for branch."""
    name = names[-1]
    nd = len(shape)
    if run.batch_axes == "all":
        # pure DP: parameters replicated, the batch over the whole mesh;
        # optionally FSDP over every axis
        if run.fsdp:
            for i, d in enumerate(shape):
                if d % _axsize(mesh, mesh.axis_names) == 0:
                    return tuple([None] * i + [tuple(mesh.axis_names)]
                                 + [None] * (nd - i - 1))
        return (None,) * nd
    dp = dp_axes(mesh)
    fsdp = dp if run.fsdp else None

    def spec(*entries):
        # leading None for stacked layer axes
        return tuple([None] * (nd - len(entries)) + list(entries))

    m = "model"
    if name == "embed":
        return (_maybe(mesh, m, shape[0]), None)
    if name == "lm_head":
        return (_maybe(mesh, fsdp, shape[0]), _maybe(mesh, m, shape[1]))
    if name == "vis_proj":
        return (None, _maybe(mesh, m, shape[1]))

    # MoE expert banks [.., E, d, f] / router [.., d, E]
    if "moe" in names:
        if name in ("w_in", "w_gate", "w_out"):
            return spec(_maybe(mesh, m, shape[-3]),
                        _maybe(mesh, fsdp, shape[-2]), None)
        if name == "router":
            return spec(_maybe(mesh, fsdp, shape[-2]), None)
        if name in ("shared_in", "shared_gate"):
            return spec(_maybe(mesh, fsdp, shape[-2]),
                        _maybe(mesh, m, shape[-1]))
        if name == "shared_out":
            return spec(_maybe(mesh, m, shape[-2]),
                        _maybe(mesh, fsdp, shape[-1]))

    # attention, head-aware: heads >= tp shard (aligned or flat), fewer
    # heads than tp replicate
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    q_ok = cfg.n_heads >= tp if cfg.n_heads else False
    kv_ok = cfg.n_kv_heads >= tp if cfg.n_kv_heads else False
    if name in ("wq", "wq_b", "wkv_b"):
        return spec(_maybe(mesh, fsdp, shape[-2]),
                    _maybe(mesh, m if q_ok else None, shape[-1]))
    if name in ("wk", "wv"):
        return spec(_maybe(mesh, fsdp, shape[-2]),
                    _maybe(mesh, m if kv_ok else None, shape[-1]))
    if name in ("wq_a", "wkv_a"):
        return spec(_maybe(mesh, fsdp, shape[-2]),
                    _maybe(mesh, m, shape[-1]))
    if name == "wo":
        return spec(_maybe(mesh, m if q_ok else None, shape[-2]),
                    _maybe(mesh, fsdp, shape[-1]))

    # dense MLP, the MTP projection, the SSM projections
    if name in ("w_in", "w_gate", "proj", "in_proj"):
        return spec(_maybe(mesh, fsdp, shape[-2]),
                    _maybe(mesh, m, shape[-1]))
    if name in ("w_out", "out_proj"):
        return spec(_maybe(mesh, m, shape[-2]),
                    _maybe(mesh, fsdp, shape[-1]))
    if name == "conv_w":
        return spec(None, _maybe(mesh, m, shape[-1]))
    if name in ("conv_b", "norm_w"):
        return spec(_maybe(mesh, m, shape[-1]))

    # norms, scalars, vectors: replicated
    return (None,) * nd


def opt_state_spec(names: Sequence[str], shape: Sequence[int],
                   cfg: ArchConfig, run: RunConfig, mesh) -> Spec:
    """An optimizer leaf's spec, its key path ``names`` as JAX's state
    lists it: ``("step",)``, or ``("m"|"v", <param path>)`` with ``"q"``
    or ``"s"`` last under int8 moments.  A moment follows its parameter;
    an int8 scale (last dimension 1) drops its last entry."""
    if names[0] == "step":
        return ()
    sub = list(names[1:])
    if sub and sub[-1] in ("q", "s"):
        sub = sub[:-1]
    entries = list(param_spec_for(sub, shape, cfg, run, mesh)) if sub else []
    if names[-1] == "s" and shape:
        entries = (entries + [None] * len(shape))[:len(shape)]
        entries[-1] = None
    return tuple((entries + [None] * len(shape))[:len(shape)])


def batch_spec(shape: Sequence[int], mesh,
               run: Optional[RunConfig] = None) -> Spec:
    """A batch leaf's spec: the largest prefix of the data axes (every
    axis under ``batch_axes="all"``) whose product divides its leading
    dimension."""
    if not shape:
        return ()
    dp = dp_axes(mesh) if run is None or run.batch_axes != "all" \
        else tuple(mesh.axis_names)
    axes, size = [], 1
    for a in dp:
        if shape[0] % (size * mesh.shape[a]) == 0:
            axes.append(a)
            size *= mesh.shape[a]
        else:
            break
    rest = (None,) * (len(shape) - 1)
    return ((tuple(axes),) + rest) if axes else (None,) + rest


# the decode-cache leaves with a sequence axis: [R, B, T, ...]
SEQ_LEAVES = ("k", "v", "ckv", "kr")


def cache_spec(names: Sequence[str], shape: Sequence[int], cfg: ArchConfig,
               mesh) -> Spec:
    """A decode cache leaf's spec ([R, B, T, ...] attention, [R, B, ...]
    SSM): B over the data axes where they divide it; T over "model", or
    over every axis where B stays whole (one long stream)."""
    dp = dp_axes(mesh)
    entries: list = [None] * len(shape)
    if names[-1] in SEQ_LEAVES:
        b_ax = _maybe(mesh, dp, shape[1])
        entries[1] = b_ax
        seq = ("model",) if b_ax else tuple(mesh.axis_names)
        entries[2] = _maybe(mesh, seq, shape[2])
    elif names[-1] in ("conv", "state"):
        entries[1] = _maybe(mesh, dp, shape[1])
    return tuple(entries)


def axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """One rank's shape of a tensor of ``shape`` laid out by ``spec``."""
    return tuple(d // _axsize(mesh, axes_of(e) or None)
                 for d, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def index_along(mesh, rank: int, axes: Sequence[str]) -> int:
    """Which block of a dimension split over ``axes`` the rank ``rank`` of
    ``mesh`` holds: its coordinates (ranks row-major over the mesh's
    axes, as JAX orders its devices) flattened over ``axes``, the first
    major, as JAX flattens a tuple entry of a spec."""
    coords, r = {}, rank
    for a in reversed(mesh.axis_names):
        coords[a], r = r % mesh.shape[a], r // mesh.shape[a]
    out = 0
    for a in axes:
        out = out * mesh.shape[a] + coords[a]
    return out


@dataclasses.dataclass(frozen=True)
class CacheBlock:
    """A grid rank's block of a decode-cache leaf of global shape
    ``full``: its ``shape``, the first global batch row (``row0``) and
    cache row (``t0``) it holds, the axes that split its T (``t_axes``,
    ``()``: whole) and the comm of the ranks over them (``t_comm``,
    ``Grid.over``; None: whole).  ``Model.init_cache``'s ``layout`` is a
    sequence leaf's ([R, B, T, ...]): its ``rows`` of the global
    ``batch``, its ``t_len`` of the cache's ``max_len`` rows."""
    full: tuple[int, ...]
    shape: tuple[int, ...]
    row0: int
    t0: int
    t_axes: tuple[str, ...]
    t_comm: Any = None

    @property
    def batch(self) -> int:
        return self.full[1]

    @property
    def rows(self) -> int:
        return self.shape[1]

    @property
    def max_len(self) -> int:
        return self.full[2]

    @property
    def t_len(self) -> int:
        return self.shape[2]


def cache_block(names: Sequence[str], shape: Sequence[int],
                cfg: ArchConfig, grid) -> CacheBlock:
    """The block of the cache leaf at ``names`` (global ``shape``) that
    ``grid``'s rank (a ``launch.mesh.Grid``) keeps under ``cache_spec``:
    B over the data axes where they divide it, T over "model" or, where
    B stays whole, over every axis; a dimension its axes do not divide
    stays whole (JAX's ``_maybe``), as do an SSM leaf's dimensions past
    B."""
    spec = cache_spec(names, shape, cfg, grid)
    local = local_shape(shape, spec, grid)
    b_axes = axes_of(spec[1]) if len(shape) > 1 else ()
    t_axes = axes_of(spec[2]) if names[-1] in SEQ_LEAVES else ()
    row0 = index_along(grid, grid.rank, b_axes) * local[1] if b_axes else 0
    t0 = index_along(grid, grid.rank, t_axes) * local[2] if t_axes else 0
    return CacheBlock(tuple(shape), local, row0, t0, t_axes,
                      grid.over(t_axes) if t_axes else None)


# ----------------------------------------------------------------------
# where the port's rank keeps its slice
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor's split on the port's grid: ``model`` the (negative) axis
    the model group splits, ``data`` whether the data group splits the
    second-to-last axis (inside the model split where both take it)."""
    model: Optional[int] = None
    data: bool = False

    def __bool__(self) -> bool:
        return self.model is not None or self.data

    def scale(self) -> "Placement":
        """The placement of an int8 scale of this tensor (last axis 1)."""
        return dataclasses.replace(
            self, model=None if self.model == -1 else self.model)

    def local(self, shape: Sequence[int], tp: int, dp: int
              ) -> tuple[int, ...]:
        out = list(shape)
        if self.model is not None:
            out[self.model] //= tp
        if self.data:
            out[-2] //= dp
        return tuple(out)


def placement(names: Sequence[str], shape: Sequence[int], cfg: ArchConfig,
              run: RunConfig, mesh, lead: int = 0) -> Placement:
    """Where a rank of ``mesh`` keeps its slice of the parameter at
    ``names``: JAX's "model" entry on its axis, the data entries (every
    axis under ``batch_axes="all"``) on the second-to-last, guarded by
    what that axis holds (module docstring).  ``lead``: the leading
    repeat axes of a stacked tensor.  A rank keeps every repeat, so
    where the second-to-last axis is a repeat axis (a stacked vector
    ``[R, d]``, which JAX's ``batch_axes="all"`` rule splits over the
    world where it divides R) the tensor stays whole on the data ranks:
    a vector a layer."""
    spec = param_spec_for(names, shape, cfg, run, mesh)
    nd = len(shape)
    split = run.batch_axes != "all" and mesh.shape.get("model", 1) > 1
    model = next((i - nd for i, e in enumerate(spec)
                  if "model" in axes_of(e) and split), None)
    data_axes = tuple(a for e in spec for a in axes_of(e)
                      if (a != "model" or run.batch_axes == "all")
                      and mesh.shape[a] > 1)
    data = False
    if data_axes and nd - 2 >= lead:
        n = shape[-2] // (mesh.shape["model"] if model == -2 else 1)
        data = n % _axsize(mesh, data_axes) == 0
    return Placement(model, data)
