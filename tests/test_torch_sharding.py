"""The port's sharding rule (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), entry by entry, with no process
group: every arch at smoke and full width (JAX's ``Model.init`` under
``jax.eval_shape``, nothing allocated) on abstract (1,2), (2,2), (16,16)
and (2,16,16) meshes, with ``fsdp`` off and on and ``batch_axes`` "dp" and
"all": parameter, optimizer-state (fp32 and int8 moments), batch and
decode-cache specs; a rank's local shapes and bytes on a stand-in grid
(``launch.mesh.stand_in``) against the spec's; the head padded as JAX pads
it.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import sharding as jsharding
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.models import Model as TModel

# JAX's production meshes, single-pod and multi-pod, beside two small ones
MESHES = [(1, 2), (2, 2), tmesh.production_shape()[0],
          tmesh.production_shape(multi_pod=True)[0]]
RUNS = [dict(), dict(fsdp=True), dict(batch_axes="all"),
        dict(batch_axes="all", fsdp=True)]
ARCHS = sorted(tconfigs.ARCHS)


def _mesh(sizes):
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                       "model")
    return AbstractMesh(tuple(sizes), names)


def _entries(spec, nd):
    """A JAX PartitionSpec as the port's tuple: one entry a dimension."""
    out = [e if e is None or isinstance(e, str) else tuple(e)
           for e in tuple(spec)]
    return tuple(out + [None] * (nd - len(out)))


def _norm(spec):
    """Entries compared as tuples of axis names (JAX may keep a 1-tuple
    where the port keeps the name, or the reverse)."""
    return tuple(tsharding.axes_of(e) for e in spec)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, full, tp):
    cfg = (jconfigs.get if full else jconfigs.get_smoke)(arch)
    jm = JModel(cfg, JRunConfig(), mesh=_mesh((1, tp)), dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return cfg, shapes


def _names(path):
    return jsharding._path_names(path)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_are_jax_s(arch, full, sizes):
    """Every parameter's spec, and every moment's (fp32, int8 codes and
    scales), is JAX's, under each of ``RUNS``."""
    mesh = _mesh(sizes)
    cfg, shapes = _jax_params(arch, full, sizes[-1])
    tcfg = (tconfigs.get if full else tconfigs.get_smoke)(arch)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for kw in RUNS:
        jrun, trun = JRunConfig(**kw), TRunConfig(**kw)
        for path, leaf in flat:
            want = jsharding.param_spec_for(path, leaf.shape, cfg, jrun,
                                            mesh)
            got = tsharding.param_spec_for(_names(path), leaf.shape, tcfg,
                                           trun, mesh)
            assert _norm(got) == _norm(_entries(want, len(leaf.shape))), (
                _names(path), kw)
        for bits in (False, True):
            opt = JAdamW(JAdamWConfig(state_8bit=bits))
            ostate = jax.eval_shape(opt.init, shapes)
            want = jsharding.opt_state_shardings(ostate, shapes, cfg, jrun,
                                                 mesh)
            pairs = zip(jax.tree_util.tree_flatten_with_path(ostate)[0],
                        jax.tree_util.tree_leaves(want))
            for (path, leaf), sh in pairs:
                got = tsharding.opt_state_spec(_names(path), leaf.shape,
                                               tcfg, trun, mesh)
                assert _norm(got) == _norm(_entries(sh.spec,
                                                    len(leaf.shape))), (
                    _names(path), kw, bits)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_are_jax_s(arch, sizes):
    """Batch leaves of several sizes under both ``batch_axes``, and every
    decode-cache leaf at batch 1, 4 and 32, get JAX's spec."""
    mesh = _mesh(sizes)
    cfg = jconfigs.get_smoke(arch)
    batch = {f"b{b}": jax.ShapeDtypeStruct((b, 16), jnp.int32)
             for b in (1, 2, 4, 32, 256, 512)}
    batch["scalar"] = jax.ShapeDtypeStruct((), jnp.int32)
    for kw in RUNS:
        want = jsharding.batch_shardings(batch, mesh, JRunConfig(**kw))
        for key, leaf in batch.items():
            got = tsharding.batch_spec(leaf.shape, mesh, TRunConfig(**kw))
            assert _norm(got) == _norm(_entries(want[key].spec,
                                                len(leaf.shape))), key
    jm = JModel(cfg, JRunConfig(), dtype=jnp.bfloat16)
    for b in (1, 4, 32):
        cache = jax.eval_shape(lambda: jm.init_cache(b, 64))
        want = jsharding.cache_shardings(cache, cfg, mesh)
        for (path, leaf), sh in zip(
                jax.tree_util.tree_flatten_with_path(cache)[0],
                jax.tree_util.tree_leaves(want)):
            got = tsharding.cache_spec(_names(path), leaf.shape,
                                       tconfigs.get_smoke(arch), mesh)
            assert _norm(got) == _norm(_entries(sh.spec, len(leaf.shape))), (
                _names(path), b)


def _bytes(shape, dtype):
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_holds_the_spec_s_bytes(arch, full, sizes):
    """A rank of a stand-in grid (the port's ``Model`` on the meta device)
    holds each tensor whole-shaped as JAX's (checkpoint names and full
    shapes equal), and the spec's bytes of it: on the spec's own axes, or
    with the data entry moved to the second-to-last axis.  The only
    exceptions are tensors whose data entry JAX places on an axis that
    the data ranks divide while the port's axis is not divided, and
    stacked vectors ``[R, d]`` whose repeat axis carries JAX's data entry
    (``batch_axes="all"`` with fsdp, where the world divides R): a rank
    keeps every repeat.  There the port keeps the tensor whole over the
    data ranks."""
    mesh = _mesh(sizes)
    cfg, shapes = _jax_params(arch, full, sizes[-1])
    tcfg = (tconfigs.get if full else tconfigs.get_smoke)(arch)
    want = {".".join(_names(p)): leaf.shape
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for kw in RUNS:
        run = TRunConfig(**kw)
        grid = tmesh.stand_in(sizes)
        model = TModel(tcfg, run, device="meta", grid=grid)
        params = dict(model.named_parameters())
        assert params.keys() == want.keys()
        undivided = []
        for name, p in params.items():
            full_shape = tuple(want[name])
            spec = tsharding.param_spec_for(name.split("."), full_shape,
                                            tcfg, run, grid)
            local = tsharding.local_shape(full_shape, spec, grid)
            if model.shards.placements.get(name) is not None:
                assert model.shards.whole_shape(p, name) == full_shape, name
            else:
                assert tuple(p.shape) == full_shape, name
            if _bytes(p.shape, p.dtype) != _bytes(local, p.dtype):
                undivided.append(name)
                data = [i for i, e in enumerate(spec)
                        if set(tsharding.axes_of(e)) - {"model"}
                        or (run.batch_axes == "all" and e is not None)]
                stacked_vector = (name.split(".")[0] in ("segments",
                                                         "encoder")
                                  and len(full_shape) == 2)
                assert data and (data[0] != len(full_shape) - 2
                                 or stacked_vector), name
        assert set(undivided) == set(
            n for n in params if n not in model.shards.data_names
            and _data_split(tcfg, run, grid, n, want[n])), kw


def _data_split(cfg, run, grid, name, shape):
    """Whether JAX's spec splits the tensor over data axes of more than
    one rank."""
    spec = tsharding.param_spec_for(name.split("."), tuple(shape), cfg, run,
                                    grid)
    axes = {a for e in spec for a in tsharding.axes_of(e)}
    axes -= {"model"} if run.batch_axes != "all" else set()
    return math.prod(grid.shape[a] for a in axes) > 1


@pytest.mark.parametrize("arch,tp,padded", [
    ("internvl2-2b", 2, 92554), ("internvl2-2b", 16, 92560),
    ("whisper-large-v3", 2, 51866), ("whisper-large-v3", 16, 51872)])
def test_the_head_is_padded_as_jax_pads_it(arch, tp, padded):
    """The full vocabularies: 92553 → 92554 (tp 2) and 92560 (tp 16),
    51866 → 51872 at tp 16; JAX's head has the same shape, and each rank
    of the model group holds ``padded / tp`` columns."""
    _, shapes = _jax_params(arch, True, tp)
    assert shapes["lm_head"].shape[-1] == padded
    model = TModel(tconfigs.get(arch), device="meta",
                   grid=tmesh.stand_in((1, tp)))
    assert model.vocab == padded
    assert tuple(model.lm_head.shape) == (tconfigs.get(arch).d_model,
                                          padded // tp)
    # the embedding keeps the vocabulary (split where tp divides it)
    V = tconfigs.get(arch).vocab_size
    split = V % tp == 0
    assert model.embed.shape[0] == (V // tp if split else V)
    assert ("embed" in model.shards) == split
