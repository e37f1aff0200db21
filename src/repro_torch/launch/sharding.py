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
  over "model" (and over every axis when the batch is 1).

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
from typing import Optional, Sequence

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


def cache_spec(names: Sequence[str], shape: Sequence[int], cfg: ArchConfig,
               mesh) -> Spec:
    """A decode cache leaf's spec ([R, B, T, ...] attention, [R, B, ...]
    SSM): B over the data axes where they divide it; T over "model", or
    over every axis where B stays whole (one long stream)."""
    dp = dp_axes(mesh)
    entries: list = [None] * len(shape)
    if names[-1] in ("k", "v", "ckv", "kr"):
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
              run: RunConfig, mesh) -> Placement:
    """Where a rank of ``mesh`` keeps its slice of the parameter at
    ``names``: JAX's "model" entry on its axis, the data entries (every
    axis under ``batch_axes="all"``) on the second-to-last, guarded by
    what that axis holds (module docstring)."""
    spec = param_spec_for(names, shape, cfg, run, mesh)
    nd = len(shape)
    split = run.batch_axes != "all" and mesh.shape.get("model", 1) > 1
    model = next((i - nd for i, e in enumerate(spec)
                  if "model" in axes_of(e) and split), None)
    data_axes = tuple(a for e in spec for a in axes_of(e)
                      if (a != "model" or run.batch_axes == "all")
                      and mesh.shape[a] > 1)
    data = False
    if data_axes and nd >= 2:
        n = shape[-2] // (mesh.shape["model"] if model == -2 else 1)
        data = n % _axsize(mesh, data_axes) == 0
    return Placement(model, data)
