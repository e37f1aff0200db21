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

A train state sharded under ``RunConfig.fsdp`` (its model's ``shards``,
``sync.shard``) is saved in the same layout, whole: each sharded leaf (a
parameter, and what a dict keys by its name: a moment, its int8 codes
and scales, the error accumulator) is gathered one leaf at a time, and
rank 0 of the model's group writes it.  Every rank of that group calls
``save`` (the gathers are collectives); the others write nothing.
``restore`` gives each rank its rows of each whole array.  So a checkpoint
written under ``fsdp`` has the keys, shapes and values of one written
without it, and restores into either, and into JAX.
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


def _shards(tree: Any):
    """The ``shards`` of the sharded model in ``tree``, or None."""
    if isinstance(tree, nn.Module):
        shards = getattr(tree, "shards", None)
        return shards if shards else None
    if isinstance(tree, dict):
        for v in tree.values():
            found = _shards(v)
            if found is not None:
                return found
    return None


def _leaves(tree: Any, prefix: str = "", shards=None, sharded=None
            ) -> Iterator[tuple[str, torch.Tensor]]:
    """(key, tensor) for every leaf of ``tree``, in order, uncopied; a
    sharded one (under a dict key that ``shards`` names: ``sharded`` is
    that parameter's name) gathered whole."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield _join(prefix, name), bridge.whole(tree, name, p)
    elif isinstance(tree, torch.Tensor):
        yield prefix, (shards.whole(tree, sharded, _leaf(prefix))
                       if sharded else tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, _join(prefix, k), shards,
                               sharded or _sharded(shards, k))
    else:
        raise TypeError(f"cannot checkpoint {type(tree).__name__} at "
                        f"{prefix or 'the root'}")


def _sharded(shards, key) -> Optional[str]:
    """``key`` where ``shards`` holds that parameter sharded."""
    return key if shards is not None and key in shards else None


def _leaf(prefix: str) -> str:
    """The last key of a leaf's path ("q" or "s" under int8 moments)."""
    return prefix.rsplit(SEP, 1)[-1]


def is_sharded(tree: Any) -> bool:
    """Whether ``tree`` holds a model sharded under ``RunConfig.fsdp``."""
    return _shards(tree) is not None


def _writer(tree: Any) -> bool:
    """Whether this process writes ``tree``: always, but under sharding
    only rank 0 of the model's group (of the world, on a grid)."""
    shards = _shards(tree)
    return shards is None or shards.comm.rank == 0


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: bridge.host_copy(t)
            for key, t in _leaves(tree, shards=_shards(tree))}


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
         meta: Optional[dict] = None, keep: int = 3) -> Optional[str]:
    """Atomic checkpoint write; prunes to the newest ``keep`` steps.  A
    sharded tree's every rank calls it; only rank 0 writes (the others
    return None)."""
    leaves = _leaves(tree, shards=_shards(tree))
    if not _writer(tree):
        for _ in leaves:            # take part in each gather
            pass
        return None
    arrays = ((key, bridge.host_copy(t)) for key, t in leaves)
    return _write(directory, step, arrays, meta, keep)


def save_async(directory: str, step: int, tree: Any,
               meta: Optional[dict] = None, keep: int = 3
               ) -> Optional[threading.Thread]:
    """Snapshot to host memory now, write on a background thread (training
    continues while bytes hit disk).  A sharded tree's every rank calls
    it; only rank 0 snapshots and writes (the others return None)."""
    if not _writer(tree):
        for _ in _leaves(tree, shards=_shards(tree)):
            pass
        return None
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
def _fill(tree: Any, data, prefix: str = "", shards=None,
          sharded=None) -> None:
    if isinstance(tree, nn.Module):
        bridge.from_flat(_Under(data, _join(prefix, "")), tree)
    elif isinstance(tree, torch.Tensor):
        if prefix not in data:
            raise KeyError(f"checkpoint missing {prefix}")
        arr = data[prefix]
        leaf = _leaf(prefix)
        shape = (shards.whole_shape(tree, sharded, leaf) if sharded
                 else tuple(tree.shape))
        if arr.shape != shape:
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                             f"target {shape}")
        src = torch.from_numpy(arr)
        tree.copy_(shards.mine(src, sharded, leaf) if sharded else src)
    else:
        for k, v in tree.items():
            _fill(v, data, _join(prefix, k), shards,
                  sharded or _sharded(shards, k))


def restore(directory: str, step: int, target: Any) -> Any:
    """Restore into ``target`` (a tree as ``save`` takes it) in place, each
    value cast to its leaf's dtype on its leaf's device; returns it.  A
    module's keys must match the checkpoint's exactly."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        _fill(target, data, shards=_shards(target))
    return target


def read_meta(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
