"""Weight bridge between the port's parameters and the JAX checkpoint layout.

The JAX package saves a flat ``{key: array}`` dict (``arrays.npz`` in a
``step_<N>/`` directory) whose keys are "/"-joined pytree key paths, e.g.
``segments/0/0/attn/wq`` of shape ``[R, d_in, d_out]``, with bf16 values
stored as their exact fp32 upcasts.  The port names its parameters after
the same paths ("." for "/"), so the mapping is one to one.
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


def to_flat(model: nn.Module) -> dict[str, np.ndarray]:
    """Every parameter as an fp32 numpy array under its checkpoint key."""
    return {_key(name): host_copy(p) for name, p in model.named_parameters()}


@torch.no_grad()
def from_flat(flat: Mapping[str, np.ndarray], model: nn.Module) -> nn.Module:
    """Fill ``model``'s parameters from a flat checkpoint dict (in place).

    Keys and shapes must match exactly; values are cast to each parameter's
    dtype (exact for bf16 values stored as fp32 upcasts)."""
    params = {_key(name): p for name, p in model.named_parameters()}
    missing = sorted(params.keys() - flat.keys())
    extra = sorted(flat.keys() - params.keys())
    if missing or extra:
        raise KeyError(f"checkpoint keys do not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for key, p in params.items():
        arr = np.asarray(flat[key])
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"parameter shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr).to(device=p.device, dtype=p.dtype))
    return model


def load_npz(step_dir: str) -> dict[str, np.ndarray]:
    """Read the ``arrays.npz`` of one checkpoint step directory."""
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        return {k: data[k] for k in data.files}
