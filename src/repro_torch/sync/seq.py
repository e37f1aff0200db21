"""Sequence parallelism over a grid's model group (``RunConfig.seq_shard``):
the port's counterpart of the JAX package's sharding constraint on the
embedded input, ``P(dp, "model", None)`` (``Model._embed_inputs``), and of
what GSPMD makes of a Mamba2 stack under it.

Rank k of the model group's m ranks keeps rows ``[k·S/m, (k+1)·S/m)`` of
the sequence, ``piece``.  A Mamba2 block runs its pointwise projections on
its rows.  Two things cross ranks:

- the causal conv reads W−1 rows before a rank's first: ``halo`` hands
  each rank the last W−1 rows of its left neighbour's conv input (zeros
  on rank 0), one all-gather of every rank's tail; the backward returns
  each tail's gradient to its owner, one reduce-scatter;
- the SSD state: each rank runs its own chunks from a zero state (K2
  once), and ``prefix`` gathers every rank's final state S_j and total
  decay D_j = exp(Σ dt·A) and returns the state entering rank k,
  Σ_{j<k} (Π_{j<i<k} D_i) S_j.  ``kernels.ops.ssd_chunked`` adds that
  state's part to its chunks' states, whence to y and the final state,
  as a scan from it would.

An attention block runs its projections and RoPE on its rows (at their
positions in the whole sequence).  Its queries attend causally to the
keys of every row up to their last: ``keys`` all-gathers every rank's k
and v rows (one all-gather of both) and hands back the rows ``[0,
start + rows)``, over which K1 runs with the query offset ``start``; the
backward reduce-scatters the gathered rows' gradients to their owners
(one reduce-scatter).

A MoE block routes the whole sequence as one call, as JAX's
``moe_apply`` enters its ``shard_map`` with the sequence whole:
``gather_rows`` all-gathers every rank's rows of its normed input (one
all-gather; the backward reduce-scatters the gradient to the rows'
owners), and each rank runs its own experts over the whole sequence;
``scatter_rows`` sums the ranks' partial outputs over the group and keeps
this rank's rows, JAX's psum and the reshard to the rows in one
reduce-scatter (the backward all-gathers).  The router's aux loss is the
same whole-sequence value on every rank: ``once`` passes 1/m of its
gradient to each rank, so that the group's sum counts it once.

``total`` sums each rank's part of the loss over the group forward and
passes the gradient through to every part backward, so that each rank's
parameter gradients are its rows' part of the whole.

Each function is an ``autograd.Function`` whose output every rank's graph
uses (rank 0's zeros included), so that every rank reaches its backward's
collective.  Each collective is noted on the comm's ``log``.
"""
from __future__ import annotations

import torch

from repro_torch.sync import shard


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, tail: torch.Tensor):
        ctx.comm = comm
        tails = shard.gather(comm, tail.contiguous()[None], 0)
        comm.note("all-gather", "seq.halo")
        if comm.rank == 0:
            return torch.zeros_like(tail)
        return tails[comm.rank - 1]

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        send = g.new_zeros((comm.world, g.numel()))
        if comm.rank > 0:
            send[comm.rank - 1] = g.reshape(-1)
        out = g.new_empty(g.numel())
        comm.reduce_scatter(out, send.view(-1)).wait()
        comm.note("reduce-scatter", "seq.halo")
        return None, out.view_as(g)


def _entering(states: torch.Tensor, decays: torch.Tensor,
              k: int) -> torch.Tensor:
    """Σ_{j<k} (Π_{j<i<k} D_i) S_j from every rank's ``states`` [m, B, H,
    P, N] and ``decays`` [m, B, H]."""
    p = torch.zeros_like(states[0])
    for j in range(k):
        p = p * decays[j][..., None, None] + states[j]
    return p


def _split(both: torch.Tensor, shapes) -> tuple:
    """Every rank's (state, decay) from their gathered rows [m, ·]."""
    m, n = both.shape[0], shapes[0].numel()
    return (both[:, :n].reshape((m,) + tuple(shapes[0])),
            both[:, n:].reshape((m,) + tuple(shapes[1])))


class _Prefix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, state: torch.Tensor,
                decay: torch.Tensor):
        ctx.comm, ctx.shapes = comm, (state.shape, decay.shape)
        both = shard.gather(comm, torch.cat([state.reshape(-1),
                                             decay.reshape(-1)])[None], 0)
        comm.note("all-gather", "seq.state")
        ctx.save_for_backward(both)
        return _entering(*_split(both, ctx.shapes), comm.rank)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        both, = ctx.saved_tensors
        with torch.enable_grad():
            leaf = both.detach().requires_grad_(True)
            out = _entering(*_split(leaf, ctx.shapes), comm.rank)
            if out.requires_grad:
                send, = torch.autograd.grad(out, leaf, g)
            else:                           # rank 0: nothing enters
                send = torch.zeros_like(leaf)
        mine = send.new_empty(send.shape[1])
        comm.reduce_scatter(mine, send.reshape(-1)).wait()
        comm.note("reduce-scatter", "seq.state")
        n = ctx.shapes[0].numel()
        return (None, mine[:n].view(ctx.shapes[0]),
                mine[n:].view(ctx.shapes[1]))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, key: str, x: torch.Tensor):
        ctx.comm, ctx.key = comm, key
        whole = shard.gather(comm, x.contiguous()[None], 0)
        comm.note("all-gather", key)
        return torch.cat(whole.unbind(0), dim=1)        # [B, m·rows, ...]

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        send = torch.stack(g.chunk(comm.world, dim=1))   # [m, B, rows, ...]
        mine = send.new_empty(send[0].shape)
        comm.reduce_scatter(mine.view(-1), send.reshape(-1)).wait()
        comm.note("reduce-scatter", ctx.key)
        return None, None, mine


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, key: str, y: torch.Tensor):
        ctx.comm, ctx.key = comm, key
        send = torch.stack(y.chunk(comm.world, dim=1))   # [m, B, rows, ...]
        mine = send.new_empty(send[0].shape)
        comm.reduce_scatter(mine.view(-1), send.reshape(-1)).wait()
        comm.note("reduce-scatter", key)
        return mine

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        whole = shard.gather(comm, g.contiguous()[None], 0)
        comm.note("all-gather", ctx.key)
        return None, None, torch.cat(whole.unbind(0), dim=1)


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world: int, t: torch.Tensor):
        ctx.world = world
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.world


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm: shard.Comm, part: torch.Tensor):
        out = part.detach().clone()
        comm.all_reduce(out)
        comm.note("all-reduce", "seq.loss")
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


class Seq:
    """A sequence of ``length`` rows split over the model group ``comm``:
    this rank's rows ``start`` to ``start + rows``."""

    def __init__(self, comm: shard.Comm, length: int):
        if length % comm.world:
            raise ValueError(f"a sequence of {length} does not split over "
                             f"{comm.world} model ranks")
        self.comm = comm
        self.length = length
        self.rows = length // comm.world
        self.start = comm.rank * self.rows
        self.last = comm.rank == comm.world - 1

    def piece(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of ``x`` along ``dim``."""
        return x.narrow(dim, self.start, self.rows)

    def halo(self, tail: torch.Tensor) -> torch.Tensor:
        """The left neighbour's ``tail`` [B, W−1, C] (the last W−1 rows of
        its conv input); zeros on rank 0."""
        return _Halo.apply(self.comm, tail)

    def prefix(self, state: torch.Tensor, decay: torch.Tensor
               ) -> torch.Tensor:
        """The SSD state [B, H, P, N] entering this rank's rows, from each
        rank's final ``state`` of a scan from zero and its total ``decay``
        [B, H] (both fp32)."""
        return _Prefix.apply(self.comm, state, decay)

    def positions(self, device=None) -> torch.Tensor:
        """This rank's rows' positions in the whole sequence."""
        return self.start + torch.arange(self.rows, device=device)

    def keys(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """The k and v [B, rows, K, ·] of every rank's rows up to this
        rank's last, ``[0, start + rows)``, gathered over the group (one
        all-gather of both); their gradients return to the rows'
        owners."""
        split = k.shape[-1]
        both = self.gather_rows(torch.cat([k, v], dim=-1), "seq.kv")
        both = both[:, :self.start + self.rows]
        return (both[..., :split].contiguous(),
                both[..., split:].contiguous())

    def gather_rows(self, x: torch.Tensor, key: str) -> torch.Tensor:
        """Every rank's rows of ``x`` [B, rows, ...] in rank order, [B, L,
        ...]; the backward reduce-scatters the gradient, summed over the
        group, to each rank's rows.  ``key`` names it on the log."""
        return _GatherRows.apply(self.comm, key, x)

    def scatter_rows(self, y: torch.Tensor, key: str) -> torch.Tensor:
        """This rank's rows of the sum over the group of each rank's
        partial ``y`` [B, L, ...]; the backward all-gathers the rows'
        gradients (every rank's partial reaches every row).  ``key``
        names it on the log."""
        return _ScatterRows.apply(self.comm, key, y)

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a value every rank of the group computes whole from the
        whole sequence: each rank's backward takes 1/m of its gradient, so
        that the group's sum of the parameters' gradients counts it
        once."""
        return _Once.apply(self.comm.world, t)

    def total(self, part: torch.Tensor) -> torch.Tensor:
        """The sum over the group of each rank's ``part`` (0-d); its
        gradient reaches every rank's part whole."""
        return _Total.apply(self.comm, part)
