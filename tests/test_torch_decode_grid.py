"""Decode on a data × model grid with JAX's cache layout
(``launch.sharding.cache_block``, ``Model.init_cache`` on a grid,
``sync.model_axis.softmax_merge``), on the CPU.  This file runs the rule,
the merge, the one-process pin, the dry run's decode cells and the (1,2)
grid; ``tests/test_torch_decode_grid_wide.py`` runs the (1,4) and (2,2)
grids with the harness below.

- Each cache leaf a rank allocates has the local shape of JAX's
  ``cache_shardings`` (``NamedSharding.shard_shape`` on an abstract
  mesh), for the ten archs' smoke and full configs on (1,2), (2,2),
  (16,16) and (2,16,16), at decode_32k's and long_500k's sizes and at
  a T no mesh of 16 divides (every sequence leaf whole there, pinned).
- ``softmax_merge`` over threads standing in for ranks: random partials,
  one rank all masked, against one softmax over the joined rows; and
  ``sdpa_partial`` merged against ``sdpa``.
- Gloo ranks (subprocesses on a ``file://`` store) serve the smoke
  configs in fp32 from JAX's seeded init: a one-call prefill of 7
  tokens into a cache of 16 rows, then 3 decode steps (rows 7, 8, 9: at
  the first some rank's block holds no valid row).  Every rank's logits
  equal the one-process port's over its rows (one call a data row) and
  JAX's ``decode_step`` (what ``make_serve_step`` wraps) jitted with the
  dry run's ``in_shardings`` (``cache_shardings`` for the cache) on an
  Auto-typed mesh of host devices in a subprocess, prefilled token by
  token as JAX's serve does, to 1e-4 of max|·| at every step; JAX's
  index maps put each rank's block where the port's layout says; each
  call's model-group collectives are ``model_axis.step_log``'s.
- One process stays as it was: a one-call prefill is bitwise the
  forward, no grid piece runs, and the prefill and two decode steps are
  bitwise what they are with ``sdpa`` as it stood before the split.
"""
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import sharding as jsharding
from repro.models import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import SHAPES, RunConfig, ShapeConfig
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.models import Model as TModel
from repro_torch.models import attention as tattn
from repro_torch.sync import model_axis, shard

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
P, T, STEPS = 7, 16, 3
MESHES = [(1, 2), (2, 2), tmesh.production_shape()[0],
          tmesh.production_shape(multi_pod=True)[0]]
ARCHS = sorted(tconfigs.ARCHS)

# (tag, arch, grid, global batch, RunConfig fields)
CELLS = [("deepseek-7b_1x2", "deepseek-7b", (1, 2), 4, {}),
         ("whisper-large-v3_1x2", "whisper-large-v3", (1, 2), 4, {}),
         ("deepseek-v3-671b_1x2", "deepseek-v3-671b", (1, 2), 4, {}),
         ("chatglm3-6b_1x4", "chatglm3-6b", (1, 4), 4, {}),
         ("deepseek-7b_1x4", "deepseek-7b", (1, 4), 4, {}),
         ("olmoe-1b-7b_2x2", "olmoe-1b-7b", (2, 2), 4, {}),
         ("jamba-v0.1-52b_2x2", "jamba-v0.1-52b", (2, 2), 4, {}),
         ("jamba-v0.1-52b_2x2_b1", "jamba-v0.1-52b", (2, 2), 1, {})]


def _mesh(sizes):
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                       "model")
    return AbstractMesh(tuple(sizes), names)


def _names(path):
    return jsharding._path_names(path)


# ----------------------------------------------------------------------
# the rule: a rank's blocks
# ----------------------------------------------------------------------
def _sizes(full):
    """(B, T) of the caches the rule is checked at: decode_32k's,
    long_500k's, and a T (60) that divides 2 and 4 but not 16."""
    if full:
        return [(SHAPES["decode_32k"].global_batch,
                 SHAPES["decode_32k"].seq_len),
                (SHAPES["long_500k"].global_batch,
                 SHAPES["long_500k"].seq_len), (128, 60)]
    return [(4, 16), (1, 16), (128, 64), (4, 60)]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_s_cache_blocks_are_jax_s(arch, full, sizes):
    """``Model.init_cache`` on a rank of a stand-in grid allocates every
    leaf at JAX's shard shape; its layout's rows and T offset are the
    rank's index along the spec's axes times the local size; a sequence
    leaf stays whole exactly where T does not divide its axes, and an SSM
    leaf is split over B only."""
    mesh = _mesh(sizes)
    jcfg = (jconfigs.get if full else jconfigs.get_smoke)(arch)
    tcfg = (tconfigs.get if full else tconfigs.get_smoke)(arch)
    jm = JModel(jcfg, JRunConfig(), dtype=jnp.bfloat16)
    n = math.prod(sizes)
    for B, Tn in _sizes(full):
        shapes = jax.eval_shape(lambda: jm.init_cache(B, Tn))
        want = jsharding.cache_shardings(shapes, jcfg, mesh)
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        for rank in (0, n - 1):
            grid = tmesh.stand_in(sizes, rank)
            model = TModel(tcfg, device="meta", grid=grid)
            caches = model.init_cache(B, Tn)
            got = [t for seg in caches for c in seg for d in c.values()
                   for t in d.values()]
            layout = caches.layout
            for (path, leaf), sh, t in zip(flat, jax.tree_util.tree_leaves(
                    want), got):
                names = _names(path)
                assert tuple(t.shape) == tuple(sh.shard_shape(leaf.shape)), (
                    names, B, Tn, rank)
                assert t.dtype == getattr(torch, str(leaf.dtype)), names
                spec = tsharding.cache_spec(names, leaf.shape, tcfg, grid)
                seq_whole = t.shape[2] == leaf.shape[2]
                if names[-1] in tsharding.SEQ_LEAVES:
                    size = math.prod(grid.shape[a] for a in (
                        ("model",) if spec[1] else grid.axis_names))
                    assert seq_whole == (Tn % size != 0 or size == 1), names
                else:
                    assert t.shape[2:] == leaf.shape[2:], names
            blk = tsharding.cache_block(("k",), (1, B, Tn), tcfg, grid)
            assert (layout.rows, layout.t_len) == blk.shape[1:]
            b_axes = tsharding.axes_of(tsharding.cache_spec(
                ("k",), (1, B, Tn), tcfg, grid)[1])
            # rank-major coordinates, as JAX orders a mesh's devices
            coords = np.unravel_index(rank, sizes)
            at = dict(zip(grid.axis_names, coords))

            def index(axes):
                out = 0
                for a in axes:
                    out = out * grid.shape[a] + int(at[a])
                return out
            assert layout.row0 == index(b_axes) * layout.rows
            assert layout.t0 == index(blk.t_axes) * layout.t_len
            assert (layout.t_comm is None) == (
                math.prod(grid.shape[a] for a in blk.t_axes) == 1)


def test_which_leaves_stay_whole():
    """Pins, on the full configs: at 16×16, decode_32k's T splits over
    "model" (B 128 over "data"), long_500k's over all 256 ranks (B 1
    whole), and a T of 60 nowhere; at (2,2) a batch of 1 splits T over
    the four ranks; SSM leaves never split T."""
    for arch, sizes, B, Tn, want in [
            ("deepseek-7b", (16, 16), 128, 32768, (8, 2048)),
            ("jamba-v0.1-52b", (16, 16), 1, 524288, (1, 2048)),
            ("deepseek-7b", (16, 16), 128, 60, (8, 60)),
            ("deepseek-v3-671b", (2, 16, 16), 128, 32768, (4, 2048)),
            ("chatglm3-6b", (2, 2), 1, 16, (1, 4))]:
        model = TModel(tconfigs.get(arch), device="meta",
                       grid=tmesh.stand_in(sizes))
        caches = model.init_cache(B, Tn)
        for seg in caches:
            for c in seg:
                for name, d in c.items():
                    for leaf in d.values():
                        if name == "attn":
                            assert tuple(leaf.shape[1:3]) == want, arch
                        else:
                            assert leaf.shape[1] == want[0], arch


# ----------------------------------------------------------------------
# the merge
# ----------------------------------------------------------------------
class _ThreadComm(shard.Comm):
    """Rank ``rank`` of ``world`` threads of this process: an all-reduce
    (sum or max) and an all-gather through shared slots and a barrier."""

    def __init__(self, shared, rank):
        self.world, self.rank, self.group = shared["world"], rank, None
        self.shared = shared

    def _everyone(self, t):
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = t.clone()
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_reduce(self, t, op=torch.distributed.ReduceOp.SUM,
                   async_op=False):
        got = self._everyone(t)
        if op == torch.distributed.ReduceOp.MAX:
            t.copy_(torch.stack(got).amax(dim=0))
        else:
            t.copy_(torch.stack(got).sum(dim=0))

    def all_gather(self, out, inp):
        out.copy_(torch.cat([g.reshape(-1) for g in self._everyone(inp)]))


def _on_threads(world, fn):
    """``fn(comm)`` on ``world`` threads, each with its ``_ThreadComm``;
    their results in rank order."""
    shared = {"world": world, "slots": [None] * world,
              "barrier": threading.Barrier(world)}
    out, errs = [None] * world, []

    def run(r):
        try:
            out[r] = fn(_ThreadComm(shared, r))
        except Exception as e:               # noqa: BLE001
            errs.append(e)
            shared["barrier"].abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return out


def test_softmax_merge_equals_one_softmax_over_the_joined_rows():
    """Random partials of three ranks, one of them all masked (m -1e30,
    l = o = 0): the merge is Σ exp(m_i − M) o_i / Σ exp(m_i − M) l_i on
    every rank, and each rank's notes name the merge."""
    g = torch.Generator().manual_seed(0)
    B, H, S, hd = 2, 3, 2, 5
    parts = []
    for r in range(3):
        m = torch.randn(B, H, S, generator=g) * 4
        l = torch.rand(B, H, S, generator=g) + 0.5
        o = torch.randn(B, S, H, hd, generator=g)
        if r == 1:
            m = torch.full((B, H, S), tattn.NEG_INF)
            l, o = torch.zeros_like(l), torch.zeros_like(o)
        parts.append((m, l, o))
    M = torch.stack([p[0] for p in parts]).amax(dim=0)
    w = [torch.exp(p[0] - M) for p in parts]
    num = sum(wi.transpose(1, 2)[..., None] * p[2] for wi, p in zip(w, parts))
    den = sum(wi * p[1] for wi, p in zip(w, parts))
    want = num / den.transpose(1, 2)[..., None]

    def merge(comm):
        comm.log = []
        out = model_axis.softmax_merge(comm, *parts[comm.rank])
        return out, comm.log
    for out, log in _on_threads(3, merge):
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        assert log == [("all-reduce", "attn.merge")] * 2


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_partial_attention_merged_is_sdpa(world, causal):
    """GQA (4 query heads on 2 KV heads) over 16 rows split ``world``
    ways, queries at rows 5..6 and the valid rows ending at 7: each
    rank's ``sdpa_partial`` over its block, merged, is ``sdpa``'s plain
    path over the whole cache, fp32, on every rank (the blocks past row
    7 hold no valid row)."""
    g = torch.Generator().manual_seed(1)
    B, S, H, K, hd, Tn = 2, 2, 4, 2, 8, 16
    q = torch.randn(B, S, H, hd, generator=g)
    k = torch.randn(B, Tn, K, hd, generator=g)
    v = torch.randn(B, Tn, K, 12, generator=g)
    pos = 5 + torch.arange(S)
    valid = torch.full((B,), 7, dtype=torch.int32)
    want = tattn.sdpa(q, k, v, causal=causal, q_positions=pos,
                      k_valid_len=valid, impl="plain")
    n = Tn // world

    def run(comm):
        t0 = comm.rank * n
        m, l, o = tattn.sdpa_partial(q, k[:, t0:t0 + n], v[:, t0:t0 + n],
                                     t0=t0, causal=causal, q_positions=pos,
                                     k_valid_len=valid)
        return model_axis.softmax_merge(comm, m, l, o)
    for out in _on_threads(world, run):
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# one process: as it was
# ----------------------------------------------------------------------
def _parent_sdpa(q, k, v, *, causal, q_positions=None, k_valid_len=None,
                 impl="plain", scale=None):
    """``models.attention.sdpa`` as it stood before the split cache (its
    mask inline), to pin the one-process path against."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if impl == "kernel" and S == T and k_valid_len is None:
        return tattn._kops.flash_attention(q, k, v, causal=causal,
                                           scale=scale)
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    k_pos = torch.arange(T, device=q.device)
    mask = None
    if causal:
        q_pos = (torch.arange(S, device=q.device) if q_positions is None
                 else q_positions)
        if q_pos.dim() == 1:
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
        else:
            mask = (q_pos[:, :, None] >= k_pos[None, None, :])[:, None, None]
    if k_valid_len is not None:
        lm = (k_pos[None, :] < k_valid_len[:, None])[:, None, None, None]
        mask = lm if mask is None else mask & lm
    if mask is not None:
        scores = torch.where(mask, scores, tattn.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-v3-671b",
                                  "chatglm3-6b"])
def test_one_process_decode_is_as_it_was(arch, dtype, monkeypatch):
    """Without a grid the cache has no layout and no grid piece runs
    (each patched to raise); the one-call prefill at index 0 is bitwise
    ``Model.forward`` over the prompt, on both attention paths; and the
    prefill and two decode steps after it (rows 9 and 10 of 12) give
    bitwise the logits they give with ``sdpa`` as it stood before the
    split cache (``_parent_sdpa``), each GQA decode step handing it the
    whole cache with the mask's positions as before."""
    def refuse(*a, **k):
        raise AssertionError("a grid piece ran in one process")
    for name in ("gather_heads", "softmax_merge"):
        monkeypatch.setattr(model_axis, name, refuse)
    monkeypatch.setattr(tattn, "sdpa_partial", refuse)
    cfg = tconfigs.get_smoke(arch)
    tokens = torch.randint(0, cfg.vocab_size, (3, 9),
                           generator=torch.Generator().manual_seed(0))
    seen = []

    def parent(q, k, v, **kw):
        if kw.get("k_valid_len") is not None:
            seen.append((k.shape[1], kw["q_positions"].tolist(),
                         kw["k_valid_len"].tolist()))
        return _parent_sdpa(q, k, v, **kw)

    def serve(m):
        caches = m.init_cache(3, 12)
        assert caches.layout is None
        out, caches = m.decode_step(caches, tokens, 0)
        out = [out]
        for i in (9, 10):
            out.append(m.decode_step(caches, tokens[:, i - 9:i - 8], i)[0])
        return out

    for impl in ("kernel", "plain"):
        m = TModel(cfg, RunConfig(attn_impl=impl), dtype=dtype,
                   device="cpu").init(torch.Generator().manual_seed(1))
        with torch.no_grad():
            got = serve(m)
            assert torch.equal(got[0], m.forward({"tokens": tokens})), impl
            with monkeypatch.context() as mp:
                mp.setattr(tattn, "sdpa", parent)
                want = serve(m)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (impl, i)
    if cfg.attn_type != "mla":
        n = len(seen) // 4
        assert n and seen == ([(12, [9], [10] * 3)] * n
                              + [(12, [10], [11] * 3)] * n) * 2, seen


# ----------------------------------------------------------------------
# the dry run's decode cells on a mesh
# ----------------------------------------------------------------------
def _smoke(arch):
    import dataclasses
    return dataclasses.replace(tconfigs.get_smoke(arch),
                               ssm_chunk=tconfigs.get(arch).ssm_chunk)


def test_mamba2_s_decode_cells_trace_unsplit_at_16x16():
    """JAX's ``seq_shard`` constrains only an input whose length the
    "model" axis divides, never a one-token decode: mamba2-130m's
    decode_32k and long_500k at 16×16 are traced (JAX's choice still
    reported), its prefill_32k stays a skip."""
    for name in ("decode_32k", "long_500k"):
        rec = dryrun.trace_cell("mamba2-130m", name, cfg=_smoke(
            "mamba2-130m"), mesh=(16, 16))
        assert rec["ok"] and rec["jax_run"]["seq_shard"], name
        assert rec["batch_per_rank"] == (8 if name == "decode_32k" else 1)
    assert dryrun.seq_split(SHAPES["prefill_32k"], (16, 16))
    assert not dryrun.seq_split(SHAPES["decode_32k"], (16, 16))
    rec = dryrun.trace_cell("mamba2-130m", "prefill_32k",
                            cfg=_smoke("mamba2-130m"), mesh=(16, 16))
    assert rec["ok"] is False and "seq_shard" in rec["skipped"]


@pytest.mark.parametrize("batch,kinds", [
    (4, {"model all-gather", "model all-reduce"}),
    (1, {"model all-gather", "world all-reduce"})])
def test_a_decode_cell_on_a_mesh_traces_the_rank_s_block(batch, kinds):
    """deepseek-7b's smoke decode on a (2,2) trace holds the rank's block
    (B 4: 2 rows and 8 of 16 cache rows; B 1: the row and 4 of 16) and
    counts its gathers and merge as the model group logs them
    (``step_log``); where B stays whole the merge is the world's.  Its
    peak is below a trace of the whole cache's."""
    cfg = tconfigs.get_smoke("deepseek-7b")
    shape = ShapeConfig("tiny_decode", T, batch, "decode")
    run = RunConfig()
    rows = dryrun.rank_batch(batch, (2, 2), run)
    got = dryrun.trace_step(cfg, run, shape, rows, mesh=(2, 2))
    assert kinds <= set(got["roofline"]["coll_breakdown"])
    model = TModel(cfg, run, device="meta", grid=tmesh.stand_in((2, 2)))
    want = {f"{kind} {key}": n for (kind, key), n in model_axis.step_log(
        model, model.init_cache(batch, T), T - 1).items()}
    assert got["model_collectives"] == want
    whole = dryrun.trace_step(cfg, run, shape, batch)
    assert got["peak_bytes"] < whole["peak_bytes"]


# ----------------------------------------------------------------------
# serving on gloo grids against one process and JAX
# ----------------------------------------------------------------------
_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.launch import sharding as shard_lib
from repro.launch.mesh import dp_axes
from repro.launch.serve import make_serve_step
from repro.models import Model

a = json.loads(sys.argv[1])
for tag, arch, sizes, B, kw in a["cells"]:
    n = int(np.prod(sizes))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = configs.get_smoke(arch)
    run = RunConfig(remat=False, attn_impl="xla", **kw)
    jm = Model(cfg, run, mesh=mesh, dp_axes=dp_axes(mesh), dtype=jnp.float32)
    src = f"{a['dir']}/{arch}"
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = ckpt.restore(f"{src}/params", 0, shapes)
    p_sh = shard_lib.param_shardings(shapes, cfg, run, mesh)
    params = jax.device_put(params, p_sh)
    tokens = np.load(f"{src}/tokens.npy")[:B]
    cache = jm.init_cache(B, a["T"])
    c_sh = shard_lib.cache_shardings(cache, cfg, mesh)
    cache = jax.device_put(cache, c_sh)
    one = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    t_sh = shard_lib.batch_shardings(one, mesh, run)
    i_sh = NamedSharding(mesh, P())
    put = lambda t: jax.device_put(jnp.asarray(t, jnp.int32), t_sh)
    idx = lambda i: jax.device_put(jnp.int32(i), i_sh)
    if cfg.encoder_layers:
        audio = np.load(f"{src}/audio.npy")[:B]
        enc = jax.jit(jm._encode)(params, {"audio_embeds": jnp.asarray(audio)})
        e_sh = shard_lib.batch_shardings(enc, mesh, run)
        step = jax.jit(lambda p, c, t, i, e: jm.decode_step(p, c, t, i,
                                                            enc_out=e),
                       in_shardings=(p_sh, c_sh, t_sh, i_sh, e_sh))
        call = lambda c, t, i: step(params, c, put(t), idx(i), enc)
        serve = None
    else:
        step = jax.jit(jm.decode_step, in_shardings=(p_sh, c_sh, t_sh, i_sh))
        call = lambda c, t, i: step(params, c, put(t), idx(i))
        serve = jax.jit(make_serve_step(jm),
                        in_shardings=(p_sh, c_sh, t_sh, i_sh))
    logits = []
    # prefill token by token (JAX's serve), then the decode steps
    for i in range(a["P"] + a["steps"]):
        if serve is not None and i >= a["P"]:
            nxt, _ = serve(params, cache, put(tokens[:, i:i + 1]), idx(i))
            np.save(f"{a['dir']}/jax_{tag}_next{i}.npy", np.asarray(nxt))
        out, cache = call(cache, tokens[:, i:i + 1], i)
        # back into the layout the step takes (GSPMD may hand a leaf out
        # laid otherwise)
        cache = jax.device_put(cache, c_sh)
        logits.append(np.asarray(out))
    np.save(f"{a['dir']}/jax_{tag}_logits.npy", np.concatenate(logits, 1))
    blocks = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(cache)[0],
            jax.tree_util.tree_leaves(c_sh)):
        name = "/".join(shard_lib._path_names(path))
        starts = sh.devices_indices_map(leaf.shape)
        blocks[name] = [[s.start or 0 for s in starts[d][:3]]
                        + [list(sh.shard_shape(leaf.shape))]
                        for d in mesh.devices.flat]
    with open(f"{a['dir']}/jax_{tag}_blocks.json", "w") as f:
        json.dump(blocks, f)
print("ok")
"""

_WORKER = r"""
import collections, datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh
from repro_torch.models import Model
from repro_torch.sync import model_axis

a = json.loads(sys.argv[1])
rank, sizes = a["rank"], tuple(a["sizes"])
dist.init_process_group("gloo", init_method=a["init"], rank=rank,
                        world_size=int(np.prod(sizes)),
                        timeout=datetime.timedelta(seconds=120))
grid = mesh.make_grid(sizes)
for tag, arch, _, B, kw in a["cells"]:
    cfg = configs.get_smoke(arch)
    src = f"{a['dir']}/{arch}"
    m = Model(cfg, RunConfig(**kw), dtype=torch.float32, device="cpu",
              grid=grid)
    bridge.from_flat(bridge.load_npz(f"{src}/params/step_00000000"), m)
    caches = m.init_cache(B, a["T"])
    lay = caches.layout
    rows = slice(lay.row0, lay.row0 + lay.rows)
    tokens = torch.from_numpy(np.load(f"{src}/tokens.npy")[:B][rows]).long()
    enc = None
    logs, want = [], []
    with torch.no_grad():
        if cfg.encoder_layers:
            audio = torch.from_numpy(np.load(f"{src}/audio.npy")[:B][rows])
            enc = m.encode({"audio_embeds": audio})
        out = []
        P = a["P"]
        calls = [(tokens[:, :P], 0)] + [
            (tokens[:, i:i + 1], i) for i in range(P, P + a["steps"])]
        for t, i in calls:
            if m.tp is not None:
                m.tp.comm.log = []
            logits, caches = m.decode_step(caches, t, i, enc_out=enc)
            out.append(logits.numpy())
            got = collections.Counter(
                f"{k} {key}" for k, key in (m.tp.comm.log if m.tp else []))
            logs.append(dict(got))
            want.append({f"{k} {key}": n for (k, key), n in
                         model_axis.step_log(m, caches, i).items()})
    np.savez(f"{a['out']}/{tag}_r{rank}.npz", prefill=out[0],
             steps=np.concatenate(out[1:], 1))
    leaves = {f"{si}/{j}/{name}/{k}": list(v.shape)
              for si, seg in enumerate(caches) for j, c in enumerate(seg)
              for name, d in c.items() for k, v in d.items()}
    with open(f"{a['out']}/{tag}_r{rank}.json", "w") as f:
        json.dump({"row0": lay.row0, "rows": lay.rows, "t0": lay.t0,
                   "t_len": lay.t_len, "leaves": leaves, "logs": logs,
                   "want_logs": want}, f)
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _ranks(tmp, sizes, cells, out):
    """``_WORKER`` on each rank of a grid of ``sizes``, each with its own
    timeout; a failed or hung rank fails the test."""
    n = math.prod(sizes)
    procs = []
    for rank in range(n):
        arg = json.dumps({"rank": rank, "sizes": list(sizes), "P": P,
                          "T": T, "steps": STEPS,
                          "init": "file://" + str(
                              tmp / ("store_" + "x".join(map(str, sizes)))),
                          "cells": cells, "dir": str(tmp), "out": str(out)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, arg], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=300)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, [
        "\n".join(line for line in e.splitlines()
                  if "Warning" not in line and "return func" not in line
                  )[-3000:] for e in errs]


def _one_process(arch, flat, tokens, audio, B, d):
    """The port's one-process fp32 serving of the batch's rows, one call
    a data row of the grid (``d`` of them where they split B): the
    prefill's logits [B, P, V] and the steps' [B, STEPS, V]."""
    cfg = tconfigs.get_smoke(arch)
    m = TModel(cfg, dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    t = torch.from_numpy(tokens[:B]).long()
    parts = {"prefill": [], "steps": []}
    with torch.no_grad():
        for c, rows in enumerate(t.chunk(d if B % d == 0 else 1)):
            n = rows.shape[0]
            enc = (m.encode({"audio_embeds": torch.from_numpy(
                audio[:B][c * n:(c + 1) * n])}) if cfg.encoder_layers
                else None)
            caches = m.init_cache(n, T)
            lg, caches = m.decode_step(caches, rows[:, :P], 0, enc_out=enc)
            parts["prefill"].append(lg.numpy())
            steps = []
            for i in range(P, P + STEPS):
                lg, caches = m.decode_step(caches, rows[:, i:i + 1], i,
                                           enc_out=enc)
                steps.append(lg.numpy())
            parts["steps"].append(np.concatenate(steps, 1))
    return {k: np.concatenate(v) for k, v in parts.items()}


def build(tmp, cells):
    """JAX's init of each arch of ``cells``, seeded tokens (and audio
    frames); JAX's sharded serving of each cell; the grids' ranks; the
    one-process runs they are held to."""
    for arch in sorted({c[1] for c in cells}):
        cfg = jconfigs.get_smoke(arch)
        jm = JModel(cfg, JRunConfig(remat=False, attn_impl="xla"),
                    dtype=jnp.float32)
        jckpt.save(str(tmp / arch / "params"), 0,
                   jm.init(jax.random.PRNGKey(3)))
        rng = np.random.default_rng(ARCHS.index(arch))
        np.save(tmp / arch / "tokens.npy", rng.integers(
            0, cfg.vocab_size, (4, P + STEPS)).astype(np.int32))
        if cfg.encoder_layers:
            np.save(tmp / arch / "audio.npy", rng.standard_normal(
                (4, cfg.max_source_positions, cfg.d_model)).astype(
                    np.float32))
    cells = [[tag, arch, list(g), B, kw] for tag, arch, g, B, kw in cells]
    res = subprocess.run(
        [sys.executable, "-c", _JAX, json.dumps({
            "cells": cells, "dir": str(tmp), "P": P, "T": T,
            "steps": STEPS})],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = tmp / "ranks"
    out.mkdir()
    for sizes in sorted({tuple(c[2]) for c in cells}):
        _ranks(tmp, sizes, [c for c in cells if tuple(c[2]) == sizes], out)
    one = {}
    for tag, arch, (d, _), B, _ in cells:
        flat = bridge.load_npz(str(tmp / arch / "params" / "step_00000000"))
        audio = (np.load(tmp / arch / "audio.npy")
                 if (tmp / arch / "audio.npy").exists() else None)
        one[tag] = _one_process(arch, flat, np.load(tmp / arch /
                                                    "tokens.npy"),
                                audio, B, d)
    return {"tmp": tmp, "out": out, "one": one}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return build(tmp_path_factory.mktemp("decode_grid"),
                 [c for c in CELLS if c[2] == (1, 2)])


def _cell(tag):
    return next(c for c in CELLS if c[0] == tag)


def _close(got, want, what):
    w = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, w, rtol=TOL,
                               atol=TOL * float(np.abs(w).max()),
                               err_msg=what)


def _rank_files(served, tag):
    _, _, sizes, _, _ = _cell(tag)
    for r in range(math.prod(sizes)):
        rec = json.loads((served["out"] / f"{tag}_r{r}.json").read_text())
        with np.load(served["out"] / f"{tag}_r{r}.npz") as z:
            rec.update(prefill=z["prefill"], steps=z["steps"])
        yield r, rec


def check_one_process(served, tag):
    """Every rank's prefill and decode-step logits equal the one-process
    port's over its rows."""
    one = served["one"][tag]
    for r, rec in _rank_files(served, tag):
        rows = slice(rec["row0"], rec["row0"] + rec["rows"])
        _close(rec["prefill"], one["prefill"][rows], f"{tag} rank {r}")
        _close(rec["steps"], one["steps"][rows], f"{tag} rank {r}")


def check_jax(served, tag):
    """Every rank's logits equal JAX's sharded decode over its rows (the
    prefill against JAX's token-by-token prefill); its next tokens, JAX's
    ``make_serve_step``'s; each rank's block sits where JAX's index map
    puts it; at the first decode step some rank holds no valid row."""
    _, arch, sizes, B, _ = _cell(tag)
    tmp = served["tmp"]
    jl = np.load(tmp / f"jax_{tag}_logits.npy")
    blocks = json.loads((tmp / f"jax_{tag}_blocks.json").read_text())
    idle = False
    for r, rec in _rank_files(served, tag):
        rows = slice(rec["row0"], rec["row0"] + rec["rows"])
        _close(rec["prefill"], jl[rows, :P], f"{tag} rank {r} prefill")
        _close(rec["steps"], jl[rows, P:], f"{tag} rank {r} steps")
        for i in range(P, P + STEPS):
            nxt = tmp / f"jax_{tag}_next{i}.npy"
            if nxt.exists():
                np.testing.assert_array_equal(
                    rec["steps"][:, i - P].argmax(-1), np.load(nxt)[rows, 0])
        for name, shape in rec["leaves"].items():
            jb = blocks[name][r]
            assert jb[3] == shape, (tag, name, r)
            assert jb[1] == rec["row0"], (tag, name, r)
            if name.split("/")[-1] in tsharding.SEQ_LEAVES:
                assert jb[2] == rec["t0"], (tag, name, r)
        idle |= rec["t0"] > P
    assert idle, tag


def check_logs(served, tag):
    """Each call's model-group collectives, on every rank, are what
    ``model_axis.step_log`` counts for it (prefill and decode)."""
    for r, rec in _rank_files(served, tag):
        assert rec["logs"] == rec["want_logs"], (tag, r)


TAGS_1x2 = [c[0] for c in CELLS if c[2] == (1, 2)]


@pytest.mark.parametrize("tag", TAGS_1x2)
def test_grid_decode_equals_one_process(served, tag):
    """``check_one_process``."""
    check_one_process(served, tag)


@pytest.mark.parametrize("tag", TAGS_1x2)
def test_grid_decode_equals_jax_on_its_mesh(served, tag):
    """``check_jax``."""
    check_jax(served, tag)


@pytest.mark.parametrize("tag", TAGS_1x2)
def test_grid_decode_logs_its_collectives(served, tag):
    """``check_logs``."""
    check_logs(served, tag)
