"""Sharded training state (``RunConfig.fsdp``): which tensors each
data-parallel rank holds a slice of, and the collectives that gather them
for use and scatter their gradients back.  The port's counterpart of the
JAX package's ``launch/sharding.py`` with ``fsdp`` on and no model axis
(the port's ranks are data-parallel only); a copy of its rule, not an
import.

The rule (``shard_axis``): the tensors JAX shards over its data axes, by
the same names (attention ``wq``/``wk``/``wv``/``wo`` and MLA's
``wq_a``/``wq_b``/``wkv_a``/``wkv_b``, the MLP's ``w_in``/``w_gate``/
``w_out``, the MoE banks, router and shared expert, Mamba2's ``in_proj``
/``out_proj``, ``lm_head``, the MTP ``proj``), each on its second-to-last
axis, with JAX's divisibility guard (``_maybe``): a dimension the world
does not divide stays replicated.  ``embed`` stays replicated (JAX shards
only its vocabulary, over "model"), and so do ``vis_proj``, norms, vectors
and ``conv_w``.

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

# sharded over the data axes wherever they sit (``sharding.py:115-140``)
_NAMES = frozenset({"wq", "wq_b", "wk", "wv", "wkv_b", "wq_a", "wkv_a",
                    "wo", "w_in", "w_gate", "w_out", "proj", "in_proj",
                    "out_proj", "lm_head"})
# sharded only inside a MoE block (``sharding.py:86-101``)
_MOE_NAMES = frozenset({"router", "shared_in", "shared_gate", "shared_out"})


def shard_axis(names: Sequence[str], shape: Sequence[int],
               world: int) -> Optional[int]:
    """-2 where each of ``world`` ranks holds a slice of the tensor at key
    path ``names`` (e.g. ``("segments", "0", "0", "attn", "wq")``) of full
    ``shape`` along its second-to-last axis; None where it is
    replicated."""
    name = names[-1]
    wanted = name in _NAMES or (name in _MOE_NAMES and "moe" in names)
    if not wanted or len(shape) < 2 or shape[-2] % world:
        return None
    return -2


def local_shape(names: Sequence[str], shape: Sequence[int],
                world: int) -> tuple[int, ...]:
    """The shape of one rank's slice of the tensor (its own if
    replicated)."""
    shape = tuple(shape)
    if shard_axis(names, shape, world) is None:
        return shape
    return shape[:-2] + (shape[-2] // world, shape[-1])


class Comm:
    """The collectives of the data-parallel ranks of ``group``: each call
    is the ``torch.distributed`` one on that group."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.world, self.rank = group.size(), group.rank()

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


def mine(comm: Comm, full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the whole tensor ``full`` (a view)."""
    k = full.shape[-2] // comm.world
    return full.narrow(-2, comm.rank * k, k)


def gather(comm: Comm, piece: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which every rank holds ``piece`` (rows along
    the second-to-last axis, in rank order)."""
    W = comm.world
    # flat buffers: gloo wants the output as the inputs laid end to end
    buf = piece.new_empty(W * piece.numel())
    comm.all_gather(buf, piece.reshape(-1))
    buf = buf.view((W,) + tuple(piece.shape))
    lead, (n, m) = tuple(piece.shape[:-2]), piece.shape[-2:]
    if not lead:
        return buf.view(W * n, m)
    return buf.movedim(0, -3).reshape(lead + (W * n, m))


def scatter_layout(full: torch.Tensor, world: int) -> torch.Tensor:
    """``full`` as ``[world, ·]``: row k holds rank k's slice, flattened
    (a view where the slices are contiguous, else a copy)."""
    lead, (n, m) = tuple(full.shape[:-2]), full.shape[-2:]
    parts = full.reshape(lead + (world, n // world, m)).movedim(-3, 0)
    return parts.reshape(world, -1)


def reduce_scatter_flat(comm: Comm, grads: Sequence[torch.Tensor]):
    """Issue one reduce-scatter of the sum of ``grads`` (one dtype, whole
    tensors) into this rank's slices: (flat output, handle)."""
    send = torch.cat([scatter_layout(g, comm.world) for g in grads], dim=1)
    out = send.new_empty(send.shape[1])
    return out, comm.reduce_scatter(out, send.view(-1))


def slices_of(flat: torch.Tensor, shapes: Sequence[torch.Size],
              world: int) -> list[torch.Tensor]:
    """``flat`` (``reduce_scatter_flat``'s output) cut into this rank's
    slices of whole tensors of ``shapes``, each in its slice's shape."""
    shapes = [tuple(s[:-2]) + (s[-2] // world, s[-1]) for s in shapes]
    sizes = [math.prod(s) for s in shapes]
    return [p.view(s) for p, s in zip(flat.split(sizes), shapes)]


class _Gather(torch.autograd.Function):
    """Rows of sharded tensors gathered whole; the backward reduce-scatters
    their gradients into the rank's slices (through ``sync`` where there
    is one)."""

    @staticmethod
    def forward(ctx, comm: Comm, sync, key: tuple, slots: list, now: bool,
                *pieces):
        ctx.comm, ctx.sync, ctx.key, ctx.slots = comm, sync, key, slots
        ctx.now = now
        if sync is not None:
            sync.gathered(key, slots)
        return tuple(gather(comm, p) for p in pieces)

    @staticmethod
    def backward(ctx, *grads):
        none = (None,) * 5
        if ctx.sync is not None:
            # the sync writes the reduced slices after the backward: an
            # unfinished buffer handed to autograd would be read by the
            # slicing's backward before the collective lands
            ctx.sync.scatter(ctx.key, ctx.slots, grads, ctx.now)
            return none + (None,) * len(grads)
        out = []
        for g in grads:
            flat, work = reduce_scatter_flat(ctx.comm, [g])
            work.wait()
            out.append(slices_of(flat, [g.shape], ctx.comm.world)[0])
        return none + tuple(out)


def gathered(comm: Comm, sync, key: tuple, stacks: Sequence[torch.Tensor],
             r: Optional[int], now: bool = True) -> tuple:
    """Row ``r`` of each of ``stacks`` (each whole tensor: ``r`` None),
    gathered whole across the ranks; their gradients are reduce-scattered
    back into ``stacks``' slices: at once, or under a ``GradSync`` ``sync``
    by it, inside the backward (``now``) or after it."""
    slots = [(t, r) for t in stacks]
    rows = [t if r is None else t[r] for t in stacks]
    return _Gather.apply(comm, sync, key, slots, now, *rows)


class Shards:
    """Which parameters of a model (by ``named_parameters`` name) each
    rank of ``comm`` holds a slice of.  Train-state dicts keyed by
    parameter name (moments, their int8 codes and scales, the error
    accumulator) hold slices of the same rows."""

    def __init__(self, comm: Optional[Comm], names: Iterable[str] = ()):
        self.comm = comm
        self.names = frozenset(names)

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

    def mine(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole tensor ``full`` (a view)."""
        return mine(self.comm, full)

    def whole_shape(self, piece: torch.Tensor) -> tuple[int, ...]:
        shape = tuple(piece.shape)
        return shape[:-2] + (shape[-2] * self.comm.world, shape[-1])

    def whole(self, piece: torch.Tensor) -> torch.Tensor:
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
            sq[name in self.names].append(torch.square(
                torch.linalg.vector_norm(g, dtype=torch.float32)))
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


def replicated(model: torch.nn.Module) -> list[str]:
    """The parameters the rule would shard by name but the divisibility
    guard leaves whole at the model's world."""
    shards = model.shards
    if shards.comm is None:
        return []
    return [name for name, p in model.named_parameters()
            if name not in shards
            and shard_axis(name.split("."), p.shape, 1) is not None]
