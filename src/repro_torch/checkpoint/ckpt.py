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
train state saved by either package restores into the other; so do its
8-bit moments (``opt/m/<path>/q`` int8, ``.../s`` fp32) and the error
accumulator of gradient compression (``err/<path>``).

``save`` copies one array at a time off the device and into the npz, and
``restore`` reads one at a time: the host holds one array, not the tree
(an olmoe-1b-7b train state is ~41.5 GB of npz).  ``save_async`` takes
the whole snapshot first, as it must.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zipfile
from typing import Any, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint import bridge

SEP = bridge.SEP


def _join(prefix: str, key: str) -> str:
    key = bridge._key(str(key))
    return f"{prefix}{SEP}{key}" if prefix else key


def _leaves(tree: Any, prefix: str = ""
            ) -> Iterator[tuple[str, torch.Tensor]]:
    """(key, tensor) for every leaf of ``tree``, in order, uncopied."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield _join(prefix, name), p
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, _join(prefix, k))
    else:
        raise TypeError(f"cannot checkpoint {type(tree).__name__} at "
                        f"{prefix or 'the root'}")


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: bridge.host_copy(t) for key, t in _leaves(tree)}


def _savez(path: str, arrays: Iterable[tuple[str, np.ndarray]]) -> None:
    """``np.savez``'s layout, written one array at a time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


def _write(directory: str, step: int,
           arrays: Iterable[tuple[str, np.ndarray]],
           meta: Optional[dict], keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _savez(os.path.join(tmp, "arrays.npz"), arrays)
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
    arrays = ((key, bridge.host_copy(t)) for key, t in _leaves(tree))
    return _write(directory, step, arrays, meta, keep)


def save_async(directory: str, step: int, tree: Any,
               meta: Optional[dict] = None, keep: int = 3
               ) -> threading.Thread:
    """Snapshot to host memory now, write on a background thread (training
    continues while bytes hit disk)."""
    flat = _flatten(tree)           # copied off the device here, in order
    t = threading.Thread(target=_write,
                         args=(directory, step, flat.items(), meta, keep),
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


class _Under(Mapping):
    """The arrays of an open npz whose keys start with ``lead``, keyed by
    the rest, each read when it is asked for."""

    def __init__(self, data, lead: str):
        self.data, self.lead = data, lead
        self.names = {k[len(lead):] for k in data.files if k.startswith(lead)}

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self.names:
            raise KeyError(name)
        return self.data[self.lead + name]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


@torch.no_grad()
def _fill(tree: Any, data, prefix: str = "") -> None:
    if isinstance(tree, nn.Module):
        bridge.from_flat(_Under(data, _join(prefix, "")), tree)
    elif isinstance(tree, torch.Tensor):
        if prefix not in data:
            raise KeyError(f"checkpoint missing {prefix}")
        arr = data[prefix]
        if arr.shape != tuple(tree.shape):
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                             f"target {tuple(tree.shape)}")
        tree.copy_(torch.from_numpy(arr))
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
