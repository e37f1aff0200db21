"""A grid of ranks with the JAX package's mesh axes: the port's counterpart
of ``repro.launch.mesh``.

JAX lays its devices on a mesh ``("data", "model")``, or ``("pod",
"data", "model")`` across pods, and GSPMD places work on its axes.  The
port lays ``torch.distributed`` ranks on the same grid, row-major as JAX's
device order: rank ``(pod·D + data)·M + model``.  A ``Grid`` holds three
``sync.shard.Comm``s of the calling rank:

- ``model``: the M consecutive ranks that share its data index (tensor
  and expert parallelism, the vocabulary split);
- ``data``: the ranks that share its model index, ordered by their
  combined (pod, data) index, as JAX's ``dp_axes`` flatten them (the
  batch split, ``RunConfig.fsdp``, the gradient sync);
- ``world``: every rank (``batch_axes="all"``; rank 0 writes).

``Grid.over(axes)`` names the comm over a spec entry's axes: a decode
cache's T is split over ``model``, or over ``world`` where the batch
stays whole (``launch.sharding.cache_block``).

``stand_in`` gives the same sizes and indices with no process group: the
dry run and the rule's tests read a rank of a 16×16 grid from it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.launch.sharding import dp_axes  # noqa: F401 (JAX's name)
from repro_torch.sync import shard

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...],
                                                        tuple[str, ...]]:
    """The shape and axes of JAX's ``make_production_mesh``: 16×16, or
    2×16×16 across two pods."""
    return ((2, 16, 16), POD_AXES) if multi_pod else ((16, 16), AXES)


def parse(text: str) -> tuple[int, ...]:
    """``"dxm"`` (or ``"pxdxm"``) → its sizes, as the CLIs' ``--mesh``."""
    sizes = tuple(int(x) for x in text.lower().split("x"))
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"--mesh {text!r}: want DxM or PxDxM")
    return sizes


class Grid:
    """One rank's place on a grid of ``shape`` over ``axis_names`` (the
    last is "model"), with its ``data``, ``model`` and ``world`` comms.
    ``shape`` maps each axis to its size, as a JAX mesh's does, so the
    port's sharding rule reads a ``Grid`` where JAX's reads a mesh."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 rank: int, *, data: shard.Comm, model: shard.Comm,
                 world: shard.Comm):
        if len(sizes) != len(axis_names) or axis_names[-1] != "model":
            raise ValueError(f"grid {tuple(sizes)} over {tuple(axis_names)}:"
                             f" want one size an axis, \"model\" last")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.rank = rank
        self.data, self.model, self.world = data, model, world

    @property
    def tp(self) -> int:
        return self.shape["model"]

    @property
    def dp(self) -> int:
        return n_chips(self) // self.tp

    def over(self, axes: Sequence[str]) -> Optional[shard.Comm]:
        """The comm of the ranks that split a decode cache's T over
        ``axes``: ``model`` for ("model",), ``world`` for every axis;
        None where the axes hold one rank (nothing is split)."""
        axes = tuple(axes)
        if math.prod(self.shape[a] for a in axes) == 1:
            return None
        if axes == ("model",):
            return self.model
        if axes == self.axis_names:
            return self.world
        raise ValueError(f"{self!r}: no comm over {axes}")

    def __repr__(self) -> str:
        sizes = "x".join(str(self.shape[a]) for a in self.axis_names)
        return f"Grid({sizes} {self.axis_names}, rank {self.rank})"


def n_chips(grid) -> int:
    return math.prod(grid.shape[a] for a in grid.axis_names)


def _axes_for(sizes: Sequence[int]) -> tuple[str, ...]:
    return AXES if len(sizes) == 2 else POD_AXES


def make_grid(sizes: Sequence[int], group=None,
              axis_names: Optional[Sequence[str]] = None) -> Grid:
    """The calling rank's ``Grid`` over the ranks of ``group`` (the
    default world), whose size must be the product of ``sizes``.  Every
    rank calls it: it makes one process group for each model row and
    each data column, in the same order everywhere, on the world's
    backend."""
    sizes = tuple(sizes)
    axis_names = tuple(axis_names or _axes_for(sizes))
    group = group or dist.group.WORLD
    world, rank = group.size(), group.rank()
    if math.prod(sizes) != world:
        raise ValueError(f"grid {'x'.join(map(str, sizes))} needs "
                         f"{math.prod(sizes)} ranks; the group has {world}")
    m = sizes[-1]
    d = world // m
    ranks = dist.get_process_group_ranks(group)
    mine_model = mine_data = None
    for i in range(d):                       # model rows: consecutive ranks
        g = dist.new_group([ranks[i * m + j] for j in range(m)])
        if i == rank // m:
            mine_model = g
    for j in range(m):                       # data columns
        g = dist.new_group([ranks[i * m + j] for i in range(d)])
        if j == rank % m:
            mine_data = g
    return Grid(sizes, axis_names, rank, data=shard.Comm(mine_data),
                model=shard.Comm(mine_model), world=shard.Comm(group))


class StandIn(shard.Comm):
    """A comm's size and rank without a process group: no collective may
    be called on it (the model is built on the meta device or traced)."""

    def __init__(self, world: int, rank: int = 0):
        self.group, self.world, self.rank = None, world, rank


def stand_in(sizes: Sequence[int], rank: int = 0,
             axis_names: Optional[Sequence[str]] = None,
             comm=StandIn) -> Grid:
    """Rank ``rank`` of a grid of ``sizes`` with ``comm(world, rank)``
    for each of its groups (``StandIn``, or the dry run's traced ranks)."""
    sizes = tuple(sizes)
    m = sizes[-1]
    world = math.prod(sizes)
    return Grid(sizes, tuple(axis_names or _axes_for(sizes)), rank,
                data=comm(world // m, rank // m), model=comm(m, rank % m),
                world=comm(world, rank))
