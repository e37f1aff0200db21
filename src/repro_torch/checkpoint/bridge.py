"""Weight bridge between the port's parameters and the JAX checkpoint layout.

The JAX package saves a flat ``{key: array}`` dict (``arrays.npz`` in a
``step_<N>/`` directory) whose keys are "/"-joined pytree key paths, e.g.
``segments/0/0/attn/wq`` of shape ``[R, d_in, d_out]``, with bf16 values
stored as their exact fp32 upcasts.  The port names its parameters after
the same paths ("." for "/"), so the mapping is one to one.

A model sharded under ``RunConfig.fsdp`` (``Model.shards``) is carried
whole all the same: ``to_flat`` gathers each sharded tensor (a collective:
every rank of the model's group calls it) and ``from_flat`` copies each
rank's rows of the whole array.  On a grid of ranks (``launch.mesh``) a
tensor split over the model group is carried whole the same way, in JAX's
layout: an ``lm_head`` padded to a multiple of the model group's size
(``Model.vocab``) is stored padded, as JAX stores it.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

SEP = "/"


def _key(name: str) -> str:
    return name.replace(".", SEP)


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of t, float types as fp32 (exact for bf16), in one
    device-to-host copy."""
    dtype = torch.float32 if t.is_floating_point() else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def whole(model: nn.Module, name: str, p: torch.Tensor) -> torch.Tensor:
    """Parameter ``name`` of ``model`` whole: gathered across the ranks
    where ``model.shards`` holds it sharded (a collective), else ``p``."""
    shards = getattr(model, "shards", None)
    return shards.whole(p, name) if shards and name in shards else p


def to_flat(model: nn.Module) -> dict[str, np.ndarray]:
    """Every parameter as an fp32 numpy array under its checkpoint key."""
    return {_key(name): host_copy(whole(model, name, p))
            for name, p in model.named_parameters()}


@torch.no_grad()
def from_flat(flat: Mapping[str, np.ndarray], model: nn.Module) -> nn.Module:
    """Fill ``model``'s parameters from a flat checkpoint dict (in place).

    Keys and shapes must match exactly; values are cast to each parameter's
    dtype (exact for bf16 values stored as fp32 upcasts)."""
    shards = getattr(model, "shards", None)
    params = {_key(name): (name, p) for name, p in model.named_parameters()}
    missing = sorted(params.keys() - flat.keys())
    extra = sorted(flat.keys() - params.keys())
    if missing or extra:
        raise KeyError(f"checkpoint keys do not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for key, (name, p) in params.items():
        arr = np.asarray(flat[key])
        mine = shards and name in shards
        shape = shards.whole_shape(p, name) if mine else tuple(p.shape)
        if arr.shape != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"parameter shape {shape}")
        src = torch.from_numpy(arr)
        # cast on the host, then copied
        p.copy_(shards.mine(src, name) if mine else src)
    return model


def load_npz(step_dir: str) -> dict[str, np.ndarray]:
    """Read the ``arrays.npz`` of one checkpoint step directory."""
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        return {k: data[k] for k in data.files}
