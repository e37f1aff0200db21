"""Gradient compression with error feedback: the port of the JAX package's
``repro.optim.compression``.

Each gradient is cast to fp8 (e4m3) under one per-tensor absmax scale; the
quantisation residual stays in an fp32 error accumulator and is added back
the next step, so the compression is unbiased over time.  The pair
brackets a gradient sync:

    g8, scale, err = compress(g, err)     # local
    g8 = <reduce-scatter / all-reduce on fp8>
    g = decompress(g8, scale)

On one card there is no sync between them (multi-GPU sync is ROADMAP
Queue 1 item 5): the train step compresses and decompresses, as JAX's
does on a mesh of one.  Trees are dicts keyed by parameter name, as the
port's gradients are.  torch and ml_dtypes both cast to e4m3fn rounding
to nearest even; ``g32 / scale`` is at most ``F8_MAX`` by construction,
so e4m3fn's lack of an infinity never matters.
"""
from __future__ import annotations

import functools
from typing import Mapping

import torch
from torch import nn

F8 = torch.float8_e4m3fn
F8_MAX = 448.0

Tree = Mapping[str, torch.Tensor]


def init_error_state(params: nn.Module) -> dict[str, torch.Tensor]:
    """A zero fp32 accumulator for every parameter of ``params``."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.named_parameters()}


def compress_leaf(g: torch.Tensor, err: torch.Tensor, absmax=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g8, scale, new_err): ``g + err`` in fp8 under a per-tensor absmax
    scale (0-d fp32), and what the cast left out.  ``absmax(g32)`` gives
    max|g32| (default: over ``g32`` itself; a rank's slice of a sharded
    tensor takes the whole tensor's, ``sync.shard.Shards.absmax``)."""
    g32 = g.to(torch.float32) + err
    absmax = (torch.amax(torch.abs(g32)) if absmax is None
              else absmax(g32))
    # a divisor on the tensor's device: CUDA multiplies by the reciprocal
    # of a Python scalar divisor, one ulp off the quotient at times
    scale = torch.clamp(absmax, min=1e-12) / torch.tensor(
        F8_MAX, dtype=torch.float32, device=g32.device)
    g8 = (g32 / scale).to(F8)
    new_err = g32 - g8.to(torch.float32) * scale
    return g8, scale, new_err


def decompress_leaf(g8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return g8.to(torch.float32) * scale


def compress_tree(grads: Tree, err: Tree, shards=None
                  ) -> tuple[dict, dict, dict]:
    """``compress_leaf`` over every key: (g8, scale, new_err) trees.
    ``shards`` (``sync.shard.Shards``, under ``RunConfig.fsdp`` or on a
    grid of ranks): the parameters whose gradients and errors are this
    rank's slices, each scaled by the whole tensor's absmax (over the
    data group, the model group or both, as each is split), the same on
    every rank, as JAX's GSPMD takes it."""
    if grads.keys() != err.keys():
        raise KeyError(f"gradients and error state differ: "
                       f"{sorted(grads.keys() ^ err.keys())}")
    g8, scale, new_err = {}, {}, {}
    for name, g in grads.items():
        absmax = None
        if shards and name in shards:
            absmax = functools.partial(shards.absmax, name)
        g8[name], scale[name], new_err[name] = compress_leaf(g, err[name],
                                                             absmax)
    return g8, scale, new_err


def decompress_tree(g8: Tree, scale: Tree) -> dict[str, torch.Tensor]:
    return {name: decompress_leaf(q, scale[name]) for name, q in g8.items()}
