"""Layer-wise overlapped gradient sync: the Fig. 6 schedule, realized on
``torch.distributed``.  The port of the JAX package's
``repro.sync.overlap``.

The JAX package's synced scan recomputes each layer in the reverse loop,
casts the layer's dparams to the parameter dtype and the activation
cotangent to the activation dtype, and sharding-constrains the dparams, so
that GSPMD reduces them across the data axis inside the loop, where XLA
overlaps the collective with the next (earlier) layer's backward.

The port keeps that arithmetic (PyTorch's gradients already carry their
tensor's dtype, so the bucket is bf16 on the wire in a bf16 model) and
replaces the constraint with an explicit collective:

- ``GradSync.bucket`` passes one repeat's parameter slices ``t[r]``
  through an identity ``autograd.Function``.  Autograd runs its backward
  once every gradient of those slices is summed, i.e. as soon as that
  repeat's backward is done, and before the repeat below it starts (the
  engine runs ready nodes latest-created first).  The backward flattens
  the gradients into one bucket per dtype and issues
  ``all_reduce(async_op=True)`` on it; the handle is kept, not waited on,
  so the compute stream runs on into the next repeat's backward.  Under
  ``torch.utils.checkpoint`` the Function's forward runs again in the
  recompute, but its backward, the only place a collective is issued,
  runs once.
- ``GradSync.finish``, after ``torch.autograd.grad`` returns, waits on
  the handles and writes each reduced bucket, divided by the world size,
  into row r of the stacked gradients (row r holds only repeat r's
  contribution), then reduces every gradient no bucket covered (the
  embeddings, the head, an encoder, the MTP block) in one bucket per
  dtype.  In barrier mode no bucket is issued, so that last reduction
  covers every gradient: one collective per dtype after the backward, the
  coflow-like baseline.

With no process group (one process, as the JAX package's 1×1 mesh) the
same structure runs and each collective is the identity.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


class _Bucket(torch.autograd.Function):
    """Identity over one repeat's parameter slices; its backward issues
    the repeat's bucket collective."""

    @staticmethod
    def forward(ctx, sync: "GradSync", key: tuple, slots: list, *slices):
        ctx.sync, ctx.key, ctx.slots = sync, key, slots
        return tuple(s.view_as(s) for s in slices)

    @staticmethod
    def backward(ctx, *grads):
        ctx.sync._issue(ctx.key, ctx.slots, grads)
        return (None, None, None) + grads


class GradSync:
    """The gradient sync of one backward across the data-parallel ranks
    of ``group`` (None: one process).

    ``log`` lists, in order: ``("backward", key)`` when repeat ``key``'s
    backward starts (a hook on its output), ``("issue", key)`` for each
    bucket collective a repeat issued inside the backward, ``("end",)``
    when ``finish`` starts (autograd has returned) and ``("after",)`` for
    each collective issued after the backward.  ``chip_smoke.py`` and the
    tests read it; it costs a list append per event."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.world = 1 if group is None else group.size()
        self.log: list[tuple] = []
        self._pending: list[tuple] = []      # (slots, flat, work)
        self._covered: set[int] = set()      # ids of bucketed stacks

    # -- inside the forward ---------------------------------------------
    def bucket(self, key: tuple, stacks: Sequence[torch.Tensor],
               r: int) -> tuple:
        """Rows ``r`` of ``stacks``, through the bucket Function: their
        gradients are reduced as soon as this repeat's backward is done."""
        slots = [(t, r) for t in stacks]
        self._covered.update(id(t) for t in stacks)
        return _Bucket.apply(self, key, slots, *(t[r] for t in stacks))

    def mark(self, x: torch.Tensor, key: tuple) -> None:
        """Log the start of repeat ``key``'s backward (``x``, its output,
        gets its gradient)."""
        x.register_hook(lambda g: self.log.append(("backward", key)))

    # -- inside the backward --------------------------------------------
    def _reduce(self, grads: Sequence[torch.Tensor]):
        """Flatten ``grads`` (one dtype) into one bucket and issue its
        sum across the group: (bucket, handle), or (None, None) with no
        group."""
        if self.group is None:
            return None, None                # one process: the identity
        flat = torch.cat([g.reshape(-1) for g in grads])
        return flat, dist.all_reduce(flat, group=self.group, async_op=True)

    def _issue(self, key: tuple, slots: list, grads: tuple) -> None:
        for idx in _by_dtype(grads):
            flat, work = self._reduce([grads[i] for i in idx])
            self._pending.append(([slots[i] for i in idx], flat, work))
            self.log.append(("issue", key))

    # -- after the backward ---------------------------------------------
    def finish(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The gradients of ``params`` averaged over the group: the
        buckets issued inside the backward written into their rows, every
        other gradient reduced here."""
        self.log.append(("end",))
        grads = list(grads)
        where = {id(p): i for i, p in enumerate(params)}
        for slots, flat, work in self._pending:
            if work is None:
                continue
            rows = [grads[where[id(t)]][r] for t, r in slots]
            for row, piece in zip(rows, self._averaged(flat, work, rows)):
                row.copy_(piece.view_as(row))
        self._pending = []
        rest = [i for i, p in enumerate(params)
                if id(p) not in self._covered]
        for idx in _by_dtype([grads[i] for i in rest]):
            whole = [grads[rest[i]] for i in idx]
            flat, work = self._reduce(whole)
            self.log.append(("after",))
            if work is None:
                continue
            for i, g, piece in zip(idx, whole,
                                   self._averaged(flat, work, whole)):
                grads[rest[i]] = piece.view_as(g)
        return grads

    def _averaged(self, flat, work, like) -> tuple:
        """Wait for ``flat``'s sum and return it over the world size, cut
        into pieces the sizes of ``like``."""
        work.wait()
        flat.div_(self.world)
        return flat.split([t.numel() for t in like])


def _by_dtype(tensors: Sequence[torch.Tensor]) -> list[list[int]]:
    """Indices of ``tensors`` grouped by dtype, in order of first use."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def all_mean(values: dict[str, torch.Tensor],
             group: Optional[dist.ProcessGroup]) -> dict[str, torch.Tensor]:
    """0-d fp32 metrics averaged over the group's ranks (one collective)."""
    if group is None:
        return values
    flat = torch.stack([values[k].float() for k in values])
    dist.all_reduce(flat, group=group)
    flat /= group.size()
    return dict(zip(values, flat.unbind()))
