"""Checkpointing: atomic, async-capable, in the JAX package's layout (the
port of ``repro.checkpoint.ckpt``).

Layout: ``<dir>/step_<N>/`` holding one ``arrays.npz`` ("/"-joined key
path → full array, bf16 stored as its exact fp32 upcast) and
``meta.json``.  Writes go to ``step_<N>.tmp``, then a rename: a crashed
writer never corrupts the latest checkpoint.  A tree is a nested dict
whose leaves are tensors or modules; a module's parameters sit under its
key with their names' "." read as "/" (``checkpoint.bridge``), and so do
the names that key a dict of tensors.  The train state ``{"params":
model, "opt": {"step", "m", "v"}}`` thus has JAX's key paths
(``params/segments/0/0/attn/wq``, ``opt/m/embed``, ``opt/step``): a
train state saved by either package restores into the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint import bridge

SEP = bridge.SEP


def _join(prefix: str, key: str) -> str:
    key = bridge._key(str(key))
    return f"{prefix}{SEP}{key}" if prefix else key


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, nn.Module):
        return {_join(prefix, k): v for k, v in bridge.to_flat(tree).items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: bridge.host_copy(tree)}
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, _join(prefix, k)))
        return flat
    raise TypeError(f"cannot checkpoint {type(tree).__name__} at "
                    f"{prefix or 'the root'}")


def _write(directory: str, step: int, flat: dict[str, np.ndarray],
           meta: Optional[dict], keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep)
    return final


def save(directory: str, step: int, tree: Any,
         meta: Optional[dict] = None, keep: int = 3) -> str:
    """Atomic checkpoint write; prunes to the newest ``keep`` steps."""
    return _write(directory, step, _flatten(tree), meta, keep)


def save_async(directory: str, step: int, tree: Any,
               meta: Optional[dict] = None, keep: int = 3
               ) -> threading.Thread:
    """Snapshot to host memory now, write on a background thread (training
    continues while bytes hit disk)."""
    flat = _flatten(tree)           # copied off the device here, in order
    t = threading.Thread(target=_write,
                         args=(directory, step, flat, meta, keep),
                         daemon=True)
    t.start()
    return t


def _prune(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def _fill(tree: Any, data, prefix: str = "") -> None:
    if isinstance(tree, nn.Module):
        lead = _join(prefix, "")
        bridge.from_flat({k[len(lead):]: data[k] for k in data.files
                          if k.startswith(lead)}, tree)
    elif isinstance(tree, torch.Tensor):
        if prefix not in data:
            raise KeyError(f"checkpoint missing {prefix}")
        arr = data[prefix]
        if arr.shape != tuple(tree.shape):
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                             f"target {tuple(tree.shape)}")
        tree.copy_(torch.from_numpy(arr).to(device=tree.device,
                                            dtype=tree.dtype))
    else:
        for k, v in tree.items():
            _fill(v, data, _join(prefix, k))


def restore(directory: str, step: int, target: Any) -> Any:
    """Restore into ``target`` (a tree as ``save`` takes it) in place, each
    value cast to its leaf's dtype on its leaf's device; returns it.  A
    module's keys must match the checkpoint's exactly."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        _fill(target, data)
    return target


def read_meta(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
