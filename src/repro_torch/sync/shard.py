"""Sharded training state (``RunConfig.fsdp``): which tensors each
data-parallel rank holds a slice of, and the collectives that gather them
for use and scatter their gradients back.  Without a grid of ranks
(``launch.mesh``) the port's counterpart of the JAX package's
``launch/sharding.py`` with ``fsdp`` on and a "model" axis of one; on a
grid, ``GridShards`` holds the model group's slices beside the data
group's, and ``gathered_at_use`` gathers a model-split tensor that a layer
uses whole.

The rule (``shard_axis``): the data entries of ``launch.sharding``'s copy
of JAX's rule, at a ``world`` × 1 mesh: the tensors JAX shards over its
data axes (attention ``wq``/``wk``/``wv``/``wo`` and MLA's
``wq_a``/``wq_b``/``wkv_a``/``wkv_b``, the MLP's ``w_in``/``w_gate``/
``w_out``, the MoE banks, router and shared expert, Mamba2's ``in_proj``
/``out_proj``, ``lm_head``, the MTP ``proj``), each on its second-to-last
axis, where both JAX's divisibility guard (``_maybe``) on JAX's axis and
the port's on its own pass: else the tensor stays replicated.
``embed`` stays replicated (JAX shards only its vocabulary, over
"model"), and so do ``vis_proj``, norms, vectors and ``conv_w``.

The axis.  JAX shards ``wo``, ``w_out``, ``out_proj`` and ``shared_out``
on their last axis; the port shards every tensor on its second-to-last.
The port's int8 moments keep one fp32 scale per last-axis row
(``optim.adamw._quant8``): a rank that holds whole rows holds every scale
of its rows, computed from its own elements, exactly as the unsharded
tensor's.  JAX gets the same numbers from GSPMD's cross-shard max; a rank
of the port would need a collective of its own for it.  The bytes a rank
holds are the same either way.  Where the two axes differ in divisibility
(chatglm3-6b's ``w_out`` [28, 13696, 4096] at 256 ranks) the port's guard
reads its own axis and the tensor stays replicated: ``replicated``
lists such tensors.

A rank's slice of a stacked tensor ``[R, ..., n, m]`` is ``[R, ..., n/W,
m]``: rows ``rank·n/W`` to ``(rank+1)·n/W`` of every repeat.  ``gather``
all-gathers one repeat's row (``all_gather_into_tensor``: contiguous for a
2-D row; a 3-D MoE row ``[E, n/W, m]`` lands as ``[W, E, n/W, m]`` and is
permuted once into ``[E, n, m]``), and the backward of ``gathered``
reduce-scatters the row's gradient (``reduce_scatter_tensor``) into the
rank's slice: at once without a ``GradSync``, else through it
(``sync.overlap``), which issues the reduce-scatter inside the backward in
bucketed mode and after it in barrier mode.
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.launch import sharding

# a config for the rule's data entries, which read no head count
_ANY_CFG = ArchConfig("any", "dense", 1, 1, 1, 1, 1, 1)


def shard_axis(names: Sequence[str], shape: Sequence[int],
               world: int) -> Optional[int]:
    """-2 where each of ``world`` ranks holds a slice of the tensor at key
    path ``names`` (e.g. ``("segments", "0", "0", "attn", "wq")``) of full
    ``shape`` along its second-to-last axis; None where it is
    replicated: the data entries of ``launch.sharding``'s rule at a
    ``world`` × 1 mesh, on the port's axis."""
    spec = sharding.param_spec_for(names, shape, _ANY_CFG,
                                   RunConfig(fsdp=True),
                                   sharding.Mesh((world, 1)))
    named = any("data" in sharding.axes_of(e) for e in spec)
    return -2 if named and len(shape) >= 2 and shape[-2] % world == 0 \
        else None


def local_shape(names: Sequence[str], shape: Sequence[int],
                world: int) -> tuple[int, ...]:
    """The shape of one rank's slice of the tensor (its own if
    replicated)."""
    shape = tuple(shape)
    if shard_axis(names, shape, world) is None:
        return shape
    return shape[:-2] + (shape[-2] // world, shape[-1])


class Comm:
    """The collectives of the ranks of ``group``: each call is the
    ``torch.distributed`` one on that group.  ``log``, where a caller sets
    it to a list, receives ``(kind, key)`` for each collective that
    ``note`` is told of (the grid's model group: ``Model``)."""

    log: Optional[list] = None

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.world, self.rank = group.size(), group.rank()

    def note(self, kind: str, key) -> None:
        if self.log is not None:
            self.log.append((kind, key))

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        dist.all_gather_into_tensor(out, inp, group=self.group)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor):
        """Issue the sum's reduce-scatter; returns its handle."""
        return dist.reduce_scatter_tensor(out, inp, group=self.group,
                                          async_op=True)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   async_op: bool = False):
        return dist.all_reduce(t, op=op, group=self.group,
                               async_op=async_op)


def as_comm(group) -> Optional[Comm]:
    """A ``Comm`` over ``group`` (a process group, or a ``Comm`` as it
    is); None for None (one process)."""
    if group is None or isinstance(group, Comm):
        return group
    return Comm(group)


def mine(comm: Comm, full: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """This rank's slice of the whole tensor ``full`` along ``axis`` (a
    view)."""
    k = full.shape[axis] // comm.world
    return full.narrow(axis, comm.rank * k, k)


def gather(comm: Comm, piece: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """The whole tensor of which every rank holds ``piece`` (slices along
    ``axis``, in rank order)."""
    W = comm.world
    # flat buffers: gloo wants the output as the inputs laid end to end
    buf = piece.new_empty(W * piece.numel())
    comm.all_gather(buf, piece.reshape(-1))
    ax = axis % piece.dim()
    shape = tuple(piece.shape)
    buf = buf.view((W,) + shape).movedim(0, ax)
    return buf.reshape(shape[:ax] + (W * shape[ax],) + shape[ax + 1:])


def scatter_layout(full: torch.Tensor, world: int,
                   axis: int = -2) -> torch.Tensor:
    """``full`` as ``[world, ·]``: row k holds rank k's slice along
    ``axis``, flattened (a view where the slices are contiguous, else a
    copy)."""
    ax = axis % full.dim()
    parts = full.unflatten(ax, (world, full.shape[ax] // world))
    return parts.movedim(ax, 0).reshape(world, -1)


def reduce_scatter_flat(comm: Comm, grads: Sequence[torch.Tensor],
                        axis: int = -2):
    """Issue one reduce-scatter of the sum of ``grads`` (one dtype, whole
    tensors) into this rank's slices: (flat output, handle)."""
    send = torch.cat([scatter_layout(g, comm.world, axis) for g in grads],
                     dim=1)
    out = send.new_empty(send.shape[1])
    return out, comm.reduce_scatter(out, send.view(-1))


def _sliced(shape: Sequence[int], world: int, axis: int) -> tuple:
    shape = list(shape)
    shape[axis] //= world
    return tuple(shape)


def slices_of(flat: torch.Tensor, shapes: Sequence[torch.Size],
              world: int, axis: int = -2) -> list[torch.Tensor]:
    """``flat`` (``reduce_scatter_flat``'s output) cut into this rank's
    slices of whole tensors of ``shapes``, each in its slice's shape."""
    shapes = [_sliced(s, world, axis) for s in shapes]
    sizes = [math.prod(s) for s in shapes]
    return [p.view(s) for p, s in zip(flat.split(sizes), shapes)]


class _Gather(torch.autograd.Function):
    """Slices of sharded tensors gathered whole (each along its axis of
    ``axes``); the backward reduce-scatters their gradients into the
    rank's slices (through ``sync`` where there is one; divided by the
    world with ``mean``: the model group's ranks hold the same whole
    gradient, not parts of a sum)."""

    @staticmethod
    def forward(ctx, comm: Comm, sync, key: tuple, slots: list, now: bool,
                axes: tuple, mean: bool, *pieces):
        ctx.comm, ctx.sync, ctx.key, ctx.slots = comm, sync, key, slots
        ctx.now, ctx.axes, ctx.mean = now, axes, mean
        if sync is not None:
            sync.gathered(key, slots)
        out = []
        for p, ax in zip(pieces, axes):
            out.append(gather(comm, p, ax))
            comm.note("all-gather", key)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        none = (None,) * 7
        if ctx.sync is not None:
            # the sync writes the reduced slices after the backward: an
            # unfinished buffer handed to autograd would be read by the
            # slicing's backward before the collective lands
            ctx.sync.scatter(ctx.key, ctx.slots, grads, ctx.now)
            return none + (None,) * len(grads)
        out = []
        for g, ax in zip(grads, ctx.axes):
            flat, work = reduce_scatter_flat(ctx.comm, [g], ax)
            ctx.comm.note("reduce-scatter", ctx.key)
            work.wait()
            if ctx.mean:
                flat.div_(ctx.comm.world)
            out.append(slices_of(flat, [g.shape], ctx.comm.world, ax)[0])
        return none + tuple(out)


def gathered(comm: Comm, sync, key: tuple, stacks: Sequence[torch.Tensor],
             r: Optional[int], now: bool = True) -> tuple:
    """Row ``r`` of each of ``stacks`` (each whole tensor: ``r`` None),
    gathered whole across the ranks; their gradients are reduce-scattered
    back into ``stacks``' slices: at once, or under a ``GradSync`` ``sync``
    by it, inside the backward (``now``) or after it."""
    slots = [(t, r) for t in stacks]
    rows = [t if r is None else t[r] for t in stacks]
    return _Gather.apply(comm, sync, key, slots, now, (-2,) * len(rows),
                         False, *rows)


def gathered_at_use(comm: Comm, key, pieces: Sequence[torch.Tensor],
                    axes: Sequence[int], mean: bool = True) -> tuple:
    """``pieces`` (slices along ``axes`` over the model group ``comm``)
    gathered whole for a use that needs the whole tensor; each gradient
    is reduce-scattered back at once and divided by the group's size, as
    every rank of the group computes the same whole gradient.  Without
    ``mean`` (a sequence split over the group, ``sync.seq``: each rank's
    gradient is its rows' part of the whole) the parts are summed."""
    return _Gather.apply(comm, None, key, [], True, tuple(axes), mean,
                         *pieces)


class Shards:
    """Which parameters of a model (by ``named_parameters`` name) each
    rank of ``comm`` holds a slice of.  Train-state dicts keyed by
    parameter name (moments, their int8 codes and scales, the error
    accumulator) hold slices of the same rows.  The methods that take a
    ``name`` (and ``leaf``: "q" or "s" for an int8 moment's codes or
    scales) read it only on a grid (``GridShards``)."""

    def __init__(self, comm: Optional[Comm], names: Iterable[str] = ()):
        self.comm = self.data = comm
        self.names = frozenset(names)
        self.data_names = self.names

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __bool__(self) -> bool:
        return bool(self.names)

    def over(self, group) -> bool:
        """Whether the ranks are ``group``'s (a process group or a
        ``Comm``; None: one process)."""
        if self.comm is None or group is None:
            return self.comm is group
        return group is self.comm or group is self.comm.group

    def mine(self, full: torch.Tensor, name: Optional[str] = None,
             leaf: Optional[str] = None) -> torch.Tensor:
        """This rank's rows of the whole tensor ``full`` (a view)."""
        return mine(self.comm, full)

    def whole_shape(self, piece: torch.Tensor, name: Optional[str] = None,
                    leaf: Optional[str] = None) -> tuple[int, ...]:
        shape = tuple(piece.shape)
        return shape[:-2] + (shape[-2] * self.comm.world, shape[-1])

    def whole(self, piece: torch.Tensor, name: Optional[str] = None,
              leaf: Optional[str] = None) -> torch.Tensor:
        """The whole tensor (a collective: every rank calls it)."""
        with torch.no_grad():
            return gather(self.comm, piece)

    def sq_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The squared global norm of ``grads`` (slices of the sharded
        tensors, whole replicated ones), the same on every rank: the
        slices' squares summed over the ranks, each replicated gradient
        counted once."""
        sq = {True: [], False: []}
        for name, g in grads.items():
            sq[name in self.names].append(_sq(g))
        ours = torch.stack(sq[True]).sum()
        self.comm.all_reduce(ours)
        return ours + sum(sq[False])

    def absmax(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """max|t| over the whole tensor of parameter ``name``: over every
        rank's slice where it is sharded."""
        m = torch.amax(torch.abs(t))
        if name in self.names:
            self.comm.all_reduce(m, op=dist.ReduceOp.MAX)
        return m

    def row_absmax(self, name: str, absmax: torch.Tensor) -> torch.Tensor:
        """``absmax`` (each last-axis row's max|·| of this rank's slice of
        parameter ``name``'s moment) over the whole row: here every rank
        holds whole rows."""
        return absmax


def _sq(g: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))


class GridShards(Shards):
    """Which parameters each rank of a grid (``launch.mesh``) holds a
    slice of, and where: ``placements`` maps a parameter's name to its
    ``launch.sharding.Placement``, the model group's axis and the data
    group's second-to-last axis (model outer where both split it).
    ``comm`` is the world's (rank 0 writes checkpoints)."""

    def __init__(self, data: Optional[Comm], model: Optional[Comm],
                 world: Comm, placements: Mapping[str, object]):
        self.placements = {n: p for n, p in placements.items() if p}
        super().__init__(world, self.placements)
        self.data, self.model = data, model
        self.data_names = frozenset(n for n, p in self.placements.items()
                                    if p.data)

    def _place(self, name, leaf):
        place = self.placements[name]
        return place.scale() if leaf == "s" else place

    def mine(self, full, name=None, leaf=None):
        place = self._place(name, leaf)
        if place.model is not None:
            full = mine(self.model, full, place.model)
        return mine(self.data, full) if place.data else full

    def whole_shape(self, piece, name=None, leaf=None):
        place = self._place(name, leaf)
        shape = list(piece.shape)
        if place.data:
            shape[-2] *= self.data.world
        if place.model is not None:
            shape[place.model] *= self.model.world
        return tuple(shape)

    def whole(self, piece, name=None, leaf=None):
        place = self._place(name, leaf)
        with torch.no_grad():
            if place.data:
                piece = gather(self.data, piece)
            if place.model is not None:
                piece = gather(self.model, piece, place.model)
            return piece

    def sq_norm(self, grads):
        """The slices' squares summed over the groups that split each
        tensor, each replicated gradient counted once."""
        parts = {(d, m): [] for d in (False, True) for m in (False, True)}
        for name, g in grads.items():
            place = self.placements.get(name)
            key = (False, False) if place is None else (
                place.data, place.model is not None)
            parts[key].append(_sq(g))
        zero = next(iter(grads.values())).new_zeros((), dtype=torch.float32)
        total = {k: torch.stack(v).sum() if v else zero.clone()
                 for k, v in parts.items()}
        over_model = torch.stack([total[True, True], total[False, True]])
        if self.model is not None:
            self.model.all_reduce(over_model)
        over_data = over_model[0] + total[True, False]
        if self.data is not None and self.data_names:
            self.data.all_reduce(over_data)
        return over_data + over_model[1] + total[False, False]

    def absmax(self, name, t):
        m = torch.amax(torch.abs(t))
        place = self.placements.get(name)
        if place is not None and place.model is not None:
            self.model.all_reduce(m, op=dist.ReduceOp.MAX)
        if place is not None and place.data:
            self.data.all_reduce(m, op=dist.ReduceOp.MAX)
        return m

    def row_absmax(self, name, absmax):
        """Over the model group where it splits the last axis (JAX's
        scale is the whole row's)."""
        place = self.placements.get(name)
        if place is not None and place.model == -1:
            self.model.all_reduce(absmax, op=dist.ReduceOp.MAX)
        return absmax


def replicated(model: torch.nn.Module) -> list[str]:
    """The parameters the rule would shard by name but the divisibility
    guard leaves whole at the model's world."""
    shards = model.shards
    if shards.comm is None:
        return []
    return [name for name, p in model.named_parameters()
            if name not in shards
            and shard_axis(name.split("."), p.shape, 1) is not None]
