"""``RunConfig.seq_shard`` for the dense attention archs (deepseek-7b,
chatglm3-6b, nemotron-4-15b, deepseek-coder-33b): each rank's rows of a
sequence split over a grid's model group attend, through K1 with a query
offset, to the k and v of every row up to their last, gathered over the
group (``sync.seq``), on the CPU.

- K1's plain version with ``q_offset`` (``kernels.ref``, what
  ``ops.flash_attention`` runs on the CPU) against the plain masked path
  with ``q_positions`` and JAX's ``sdpa``, fp32 2e-5
  (``tests/test_kernels.py:15``): offset 0 bitwise as the parent's
  formulation, the last S rows of T, S no multiple of the kernel's 64-row
  block, GQA 32/2; its gradients against autograd through the masked
  path; ``sdpa``'s kernel path hands a causal query block that ends at
  the last key to K1 with the offset T − S.
- The K/V gather on threads standing in for ranks
  (``tests/test_torch_seq_shard.py``): the forward is the concatenation,
  the backward each rank's summed part.  An attention block on three
  pieces of a sequence gives the whole block's rows and gradients.
- Gloo ranks (subprocesses on a ``file://`` store) take a forward, one
  fp32 train step and AdamW of each arch's smoke config from JAX's seeded
  init on (1,2) and (1,4) grids, deepseek-7b also under
  ``batch_axes="all"`` and on (2,2) with ``fsdp``: logits (each rank its
  rows), loss and every gradient equal one process's to 1e-4 of max|·|
  (``tests/test_sync.py:55``), and the parameters after the step one
  process's AdamW step on those gradients
  (``tests/test_torch_fsdp_repeat_axis.py`` says why); on (1,2)
  deepseek-7b and chatglm3-6b equal JAX's ``Model`` with
  ``seq_shard=True`` on an Auto (1,2) mesh (a subprocess with
  ``--xla_force_host_platform_device_count``).  A cached call (a
  one-call prefill at index 0, then a decode step) on a (1,2) grid with
  ``seq_shard`` splits nothing, as JAX's ``decode_step``, and gives one
  process's logits.
"""
import json
import math
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.models import Model as JModel
from repro.models import attention as ja
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.models import attention as ta
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sync import seq as tseq
from test_torch_fsdp_repeat_axis import stepped
from test_torch_seq_shard import _on_threads

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
KTOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("deepseek-7b", "chatglm3-6b", "nemotron-4-15b",
         "deepseek-coder-33b")
JAX_ARCHS = ("deepseek-7b", "chatglm3-6b")
S = 16
# (tag, arch, grid, RunConfig fields, B)
CELLS = ([(f"{a}_1x2", a, (1, 2), {}, 2) for a in ARCHS]
         + [(f"{a}_1x4", a, (1, 4), {}, 2) for a in ARCHS]
         + [("deepseek-7b_1x2_all", "deepseek-7b", (1, 2),
             {"batch_axes": "all"}, 2),
            ("deepseek-7b_2x2_fsdp", "deepseek-7b", (2, 2),
             {"fsdp": True}, 4)])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, key="x", tol: float = TOL):
    w = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=key)


# ----------------------------------------------------------------------
# K1's plain version with a query offset
# ----------------------------------------------------------------------
# (B, S, T, H, K, hd): S == T at offset 0; else the last S rows of T
SHAPES = {"offset_0": (2, 24, 24, 4, 2, 16),
          "last_rows": (2, 16, 48, 4, 2, 16),
          "ragged": (2, 50, 130, 4, 4, 32),
          "gqa_32_2": (1, 20, 40, 32, 2, 16)}


def _qkv(case, seed=0):
    B, Sq, T, H, K, hd = SHAPES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, T, K, hd), (B, T, K, hd))]


def _parent_ref(q, k, v):
    """``ref.flash_attention_ref`` as it stood before the offset (causal,
    its mask counted from query row 0), in the model's layout."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    B, H, Sq, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.arange(Sq)[:, None] >= torch.arange(T)[None, :]
    s = torch.where(mask, s, ref.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).transpose(1, 2)


@pytest.mark.parametrize("case", list(SHAPES))
def test_offset_matches_the_masked_path_and_jax(case):
    """Query row i at position T − S + i: K1's plain version equals the
    plain masked path with those ``q_positions`` and JAX's ``sdpa``; at
    offset 0 it is the parent's formulation bit for bit."""
    q, k, v = _qkv(case)
    Sq, T = q.shape[1], k.shape[1]
    off = T - Sq
    pos = off + np.arange(Sq, dtype=np.int32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              q_offset=off)
    masked = ta.sdpa(_t(q), _t(k), _t(v), causal=True,
                     q_positions=_t(pos), impl="plain")
    want = ja.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, q_positions=jnp.asarray(pos), impl="xla")
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **KTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)
    if off == 0:
        assert torch.equal(got, _parent_ref(_t(q), _t(k), _t(v)))
        assert torch.equal(got, ops.flash_attention(_t(q), _t(k), _t(v)))


@pytest.mark.parametrize("case", ["last_rows", "ragged", "gqa_32_2"])
def test_offset_gradients_are_the_masked_path_s(case):
    """The offset wrapper's gradients (autograd through the plain
    version on the CPU) and its ``autograd.Function`` (the card's route,
    its kernel stood in for by the plain version) equal autograd through
    the masked path, for q, k and v; the Function counts one launch."""
    arrays = _qkv(case, seed=1)
    Sq, T = arrays[0].shape[1], arrays[1].shape[1]
    off = T - Sq
    pos = off + torch.arange(Sq)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (arrays[0].shape[0], Sq, arrays[0].shape[2], arrays[2].shape[-1]))
        .astype(np.float32))

    def grads(fn):
        leaves = [_t(a).clone().requires_grad_(True) for a in arrays]
        return torch.autograd.grad((fn(*leaves) * g).sum(), leaves)

    want = grads(lambda q, k, v: ta.sdpa(q, k, v, causal=True,
                                         q_positions=pos, impl="plain"))
    got = grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                                    q_offset=off))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **KTOL)

    seen = []

    def stand_in(q, k, v, causal, scale, q_offset=0):
        seen.append(q_offset)
        return ops._plain_attention(causal, scale, q_offset)(q, k, v)[0]

    real = tfa.flash_attention_fwd
    tfa.flash_attention_fwd = stand_in
    try:
        before = ops.flash_attention.launches
        got = grads(lambda q, k, v: ops._FlashAttention.apply(
            q, k, v, True, None, off))
        assert ops.flash_attention.launches == before + 1
    finally:
        tfa.flash_attention_fwd = real
    assert seen == [off]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **KTOL)


def test_sdpa_hands_the_last_rows_to_k1_with_their_offset(monkeypatch):
    """On the "kernel" path a causal query block shorter than the keys
    and without ``k_valid_len`` goes to K1 with the offset T − S (the
    call without one names none, as before); a non-causal one and a
    cached call stay on the plain path.  The result is the masked path's
    at the rows' positions.  An offset past T − S raises."""
    calls = []
    real = ops.flash_attention

    def record(q, k, v, *, causal, scale, **kw):
        calls.append((q.shape[1], k.shape[1], causal, kw))
        return real(q, k, v, causal=causal, scale=scale, **kw)

    monkeypatch.setattr(ops, "flash_attention", record)
    q, k, v = (_t(a) for a in _qkv("last_rows"))
    pos = 32 + torch.arange(16)
    got = ta.sdpa(q, k, v, causal=True, q_positions=pos, impl="kernel")
    want = ta.sdpa(q, k, v, causal=True, q_positions=pos, impl="plain")
    torch.testing.assert_close(got, want, **KTOL)
    ta.sdpa(q, k, v, causal=False, impl="kernel")
    ta.sdpa(q, k, v, causal=True, q_positions=pos, impl="kernel",
            k_valid_len=torch.tensor([48, 48]))
    ta.sdpa(k, k, v, causal=True, impl="kernel")
    assert calls == [(16, 48, True, {"q_offset": 32}), (48, 48, True, {})]
    for bad in (-1, 33):
        with pytest.raises(ValueError, match="q_offset"):
            real(q, k, v, causal=True, q_offset=bad)


# ----------------------------------------------------------------------
# the K/V gather and an attention block, on threads standing in for ranks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m", [2, 3, 4])
def test_kv_gather_is_the_concatenation(m):
    """Each rank's k [B, 3, K, 8] and v [B, 3, K, 6] rows: ``seq.keys``
    gives rank r every rank's rows up to its last, in order; the
    gradient of Σ_j Σ k·a_j + v·b_j (rank j's weights over its keys)
    reaching rank r's rows is the sum over the ranks that read them,
    j ≥ r.  One all-gather and one reduce-scatter, noted."""
    B, rows, K = 2, 3, 2
    rng = np.random.default_rng(m)
    ks = rng.standard_normal((m, B, rows, K, 8)).astype(np.float32)
    vs = rng.standard_normal((m, B, rows, K, 6)).astype(np.float32)
    a = rng.standard_normal((m, B, m * rows, K, 8)).astype(np.float32)
    b = rng.standard_normal((m, B, m * rows, K, 6)).astype(np.float32)

    def piece(comm):
        split = tseq.Seq(comm, m * rows)
        k = _t(ks[comm.rank]).clone().requires_grad_(True)
        v = _t(vs[comm.rank]).clone().requires_grad_(True)
        kk, vv = split.keys(k, v)
        end = split.start + split.rows
        loss = ((kk * _t(a[comm.rank])[:, :end]).sum()
                + (vv * _t(b[comm.rank])[:, :end]).sum())
        gk, gv = torch.autograd.grad(loss, (k, v))
        return kk.detach(), vv.detach(), gk, gv, comm.log

    got = _on_threads(m, piece)
    whole_k = np.concatenate(list(ks), axis=1)
    whole_v = np.concatenate(list(vs), axis=1)
    for r, (kk, vv, gk, gv, log) in enumerate(got):
        end = (r + 1) * rows
        assert np.array_equal(kk.numpy(), whole_k[:, :end])
        assert np.array_equal(vv.numpy(), whole_v[:, :end])
        mine = slice(r * rows, end)
        np.testing.assert_allclose(gk.numpy(), a[r:, :, mine].sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gv.numpy(), b[r:, :, mine].sum(0),
                                   rtol=1e-6, atol=1e-6)
        assert Counter(log) == {("all-gather", "seq.kv"): 1,
                                ("reduce-scatter", "seq.kv"): 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_pieces_of_an_attention_block_are_the_whole_block(arch):
    """``gqa_apply`` on 3 pieces of a sequence of 12 (RoPE at the rows'
    positions, chatglm3-6b's on half of each head; k and v gathered; K1's
    plain version at the rank's offset): the rows and, summed over the
    pieces, every projection's gradient are the whole block's, fp32."""
    cfg = tconfigs.get_smoke(arch)
    p = ta.gqa_init(torch.Generator().manual_seed(0), cfg,
                    dtype=torch.float32)
    L = 12
    x = torch.randn((2, L, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    w = torch.randn((2, L, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))

    def leaves():
        return {n: t.clone().requires_grad_(True) for n, t in p.items()}

    pw = leaves()
    y, _ = ta.gqa_apply(pw, x, cfg)
    whole = torch.autograd.grad((y * w).sum(), list(pw.values()))

    def piece(comm):
        split = tseq.Seq(comm, L)
        pk = leaves()
        yk, _ = ta.gqa_apply(pk, split.piece(x), cfg, seq=split)
        return yk.detach(), torch.autograd.grad(
            (yk * split.piece(w)).sum(), list(pk.values()))

    got = _on_threads(3, piece)
    _close(torch.cat([g[0] for g in got], dim=1).numpy(),
           y.detach().numpy(), "y")
    for i, name in enumerate(p):
        _close(sum(g[1][i] for g in got).numpy(), whole[i].numpy(), name)


# ----------------------------------------------------------------------
# gloo grids against one process and JAX's seq_shard step
# ----------------------------------------------------------------------
_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.launch.mesh import dp_axes
from repro.launch.sharding import batch_shardings
from repro.models import Model

a = json.loads(sys.argv[1])
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
losses = {}
for arch in a["archs"]:
    cfg = configs.get_smoke(arch)
    run = RunConfig(remat=False, attn_impl="xla", seq_shard=True)
    jm = Model(cfg, run, mesh=mesh, dp_axes=dp_axes(mesh),
               dtype=jnp.float32)
    params = ckpt.restore(f"{a['dir']}/{arch}/params", 0,
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    batch = {"tokens": jnp.asarray(np.load(f"{a['dir']}/tokens_2.npy"))}
    batch = jax.device_put(batch, batch_shardings(batch, mesh, run))
    with mesh:
        logits = jax.jit(jm.forward)(params, batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b), has_aux=True))(params, batch)
    np.save(f"{a['dir']}/{arch}/jax_logits.npy", np.asarray(logits))
    ckpt.save(f"{a['dir']}/{arch}/jax_grads", 0, grads)
    losses[arch] = float(loss)
print(json.dumps(losses))
"""

_WORKER = r"""
import datetime, json, sys
from collections import Counter
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh, train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig

a = json.loads(sys.argv[1])
rank, sizes = a["rank"], tuple(a["sizes"])
dist.init_process_group("gloo", init_method=a["init"], rank=rank,
                        world_size=int(np.prod(sizes)),
                        timeout=datetime.timedelta(seconds=120))
grid = mesh.make_grid(sizes)


class Keep:
    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {bridge._key(k): bridge.whole(params, k, g).clone()
                      for k, g in grads.items()}
        return self.opt.update(grads, state, params)


for tag, arch, _, kw, B in a["cells"]:
    cfg = configs.get_smoke(arch)
    flat = bridge.load_npz(f"{a['dir']}/{arch}/params/step_00000000")
    tokens = torch.from_numpy(np.load(f"{a['dir']}/tokens_{B}.npy")).long()
    run = RunConfig(seq_shard=True, **kw)
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    bridge.from_flat(flat, m)
    S = tokens.shape[1]
    split = m.seq_split(S)
    out = {".start": split.start}
    with torch.no_grad():
        out[".logits"] = m.forward({"tokens": tokens}).numpy()
        if sizes == (1, 2):
            # a cached call splits nothing: a one-call prefill at index 0,
            # then a decode step, on this rank's block of the cache
            caches = m.init_cache(B, S + 2)
            rows = caches.layout
            mine = tokens[rows.row0:rows.row0 + rows.rows]
            prefill, caches = m.decode_step(caches, mine, 0)
            decode, _ = m.decode_step(caches, mine[:, -1:], S)
            out[".prefill"], out[".decode"] = prefill.numpy(), decode.numpy()
            out[".row0"] = rows.row0
    opt = Keep(AdamW(AdamWConfig()))
    state = {"params": m, "opt": opt.init(m)}
    step = train.make_train_step(m, opt, run, grid=grid)
    state, metrics = step(state, {"tokens": tokens})
    out[".loss"] = metrics["loss"].numpy()
    out.update({k: g.numpy() for k, g in opt.grads.items()})
    out.update({"after/" + k: v for k, v in bridge.to_flat(m).items()})
    log = Counter(f"{k} {v}" for k, v in step.model_log
                  if str(v).startswith("seq."))
    np.savez(f"{a['out']}/{tag}_r{rank}.npz", **out)
    with open(f"{a['out']}/{tag}_r{rank}.json", "w") as f:
        json.dump(log, f)
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _start(tmp, sizes, cells, out):
    n = int(np.prod(sizes))
    store = tmp / ("store_" + "x".join(map(str, sizes)))
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps({
            "rank": rank, "sizes": list(sizes), "init": f"file://{store}",
            "cells": cells, "dir": str(tmp), "out": str(out)})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(n)]


def _wait(procs, timeout=400):
    """Every process's (stdout, stderr), each within its timeout; a failed
    or hung one fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * len(procs), [
        "\n".join(line for line in e.splitlines()
                  if "Warning" not in line and "return func" not in line
                  )[-3000:] for _, e in outs]
    return outs


def _one_process(cfg, flat, tokens):
    """The port's one-process fp32 forward, cached calls and step:
    logits, loss, gradients, the parameters after AdamW."""
    m = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    t = torch.from_numpy(tokens).long()
    B, Sq = t.shape
    with torch.no_grad():
        logits = m.forward({"tokens": t}).numpy()
        caches = m.init_cache(B, Sq + 2)
        prefill, caches = m.decode_step(caches, t, 0)
        decode, _ = m.decode_step(caches, t[:, -1:], Sq)
    opt = AdamW(AdamWConfig())
    kept = {}

    class Keep:
        def init(self, params):
            return opt.init(params)

        def update(self, grads, state, params):
            kept.update({bridge._key(k): g.numpy().copy()
                         for k, g in grads.items()})
            return opt.update(grads, state, params)

    state = {"params": m, "opt": opt.init(m)}
    _, metrics = ttrain.make_train_step(m, Keep(), TRunConfig())(
        state, {"tokens": t})
    return {"logits": logits, "prefill": prefill.numpy(),
            "decode": decode.numpy(), "loss": float(metrics["loss"]),
            "grads": kept, "flat": dict(flat)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's init of each arch, every grid's ranks (started together),
    JAX's ``seq_shard`` steps, and the one-process steps."""
    tmp = tmp_path_factory.mktemp("seq_attention")
    for i, B in enumerate((2, 4)):
        np.save(tmp / f"tokens_{B}.npy", np.random.default_rng(10 + i)
                .integers(0, 256, (B, S)).astype(np.int32))
    for i, arch in enumerate(ARCHS):
        jm = JModel(jconfigs.get_smoke(arch),
                    JRunConfig(remat=False, attn_impl="xla"),
                    dtype=jnp.float32)
        jckpt.save(str(tmp / arch / "params"), 0,
                   jm.init(jax.random.PRNGKey(20 + i)))
    out = tmp / "ranks"
    out.mkdir()
    cells = [[tag, arch, list(g), kw, B] for tag, arch, g, kw, B in CELLS]
    procs = []
    for sizes in sorted({tuple(c[2]) for c in cells}):
        procs += _start(tmp, sizes, [c for c in cells
                                     if tuple(c[2]) == sizes], out)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps({
            "dir": str(tmp), "archs": list(JAX_ARCHS)})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    one = {}
    for tag, arch, _, _, B in CELLS:
        if (arch, B) not in one:
            flat = bridge.load_npz(str(tmp / arch / "params"
                                       / "step_00000000"))
            one[arch, B] = _one_process(tconfigs.get_smoke(arch), flat,
                                        np.load(tmp / f"tokens_{B}.npy"))
    _wait(procs)
    (jout, _), = _wait([jax_proc], timeout=600)
    return {"tmp": tmp, "out": out, "one": one,
            "jax_loss": json.loads(jout.strip().splitlines()[-1])}


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _cell(tag):
    return next(c for c in CELLS if c[0] == tag)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_grid_step_equals_one_process(steps, tag):
    """Each rank's logits are one process's rows ``[k·S/m, (k+1)·S/m)``;
    the loss and every gradient are one process's on every rank, and
    every parameter after AdamW one process's AdamW step on them."""
    _, arch, (d, m), _, B = _cell(tag)
    one = steps["one"][arch, B]
    for rank in range(d * m):
        got = _npz(steps["out"] / f"{tag}_r{rank}.npz")
        rows, start = S // m, int(got.pop(".start"))
        assert start == (rank % m) * rows
        logits = got.pop(".logits")
        assert logits.shape == (B, rows, one["logits"].shape[-1])
        _close(logits, one["logits"][:, start:start + rows], "logits")
        assert float(got.pop(".loss")) == pytest.approx(one["loss"],
                                                        rel=1e-5)
        after = {k[len("after/"):]: got.pop(k) for k in list(got)
                 if k.startswith("after/")}
        for k in [k for k in got if k.startswith(".")]:
            got.pop(k)
        assert got.keys() == one["grads"].keys()
        for key, g in got.items():
            _close(g, one["grads"][key], key)
        want = stepped(tconfigs.get_smoke(arch), one["flat"], got)
        assert after.keys() == want.keys()
        for key, p in after.items():
            _close(p, want[key], "after " + key)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_grid_step_equals_jax_seq_shard_step(steps, arch):
    """On (1,2): the ranks' logits, joined along the sequence, the loss
    and every gradient equal JAX's ``seq_shard`` step on an Auto (1,2)
    mesh."""
    ranks = [_npz(steps["out"] / f"{arch}_1x2_r{r}.npz") for r in range(2)]
    jdir = steps["tmp"] / arch
    _close(np.concatenate([r[".logits"] for r in ranks], axis=1),
           np.load(jdir / "jax_logits.npy"), "logits")
    got = ranks[0]
    assert float(got[".loss"]) == pytest.approx(steps["jax_loss"][arch],
                                                rel=1e-5)
    jg = bridge.load_npz(str(jdir / "jax_grads" / "step_00000000"))
    grads = {k: g for k, g in got.items()
             if not k.startswith(".") and not k.startswith("after/")}
    assert grads.keys() == jg.keys()
    for key, g in grads.items():
        _close(g, jg[key], key)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_a_step_s_kv_collectives(steps, tag):
    """The model group's ``seq.*`` collectives of one remat step: a K/V
    all-gather a layer in the forward and again in remat's recompute, one
    reduce-scatter a layer in the backward, one loss all-reduce."""
    _, arch, (d, m), _, _ = _cell(tag)
    L = tconfigs.get_smoke(arch).n_layers
    want = {"all-gather seq.kv": 2 * L, "reduce-scatter seq.kv": L,
            "all-reduce seq.loss": 1}
    for rank in range(d * m):
        log = json.loads((steps["out"] / f"{tag}_r{rank}.json").read_text())
        assert log == want, (tag, rank)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_call_on_a_split_grid_is_one_process_s(steps, arch):
    """A cached call is not split (JAX's ``decode_step`` embeds no
    ``seq_shard`` constraint): on (1,2) the one-call prefill at index 0
    and the decode step after it give one process's logits on each
    rank, its rows of the batch, each rank holding its block of the
    cache."""
    one = steps["one"][arch, 2]
    for rank in range(2):
        got = _npz(steps["out"] / f"{arch}_1x2_r{rank}.npz")
        r0 = int(got[".row0"])
        rows = got[".prefill"].shape[0]
        _close(got[".prefill"], one["prefill"][r0:r0 + rows], "prefill")
        _close(got[".decode"], one["decode"][r0:r0 + rows], "decode")


# ----------------------------------------------------------------------
# what builds, what splits
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_the_split_runs_every_head_on_gathered_weights(arch):
    """Under ``seq_shard`` on a (1,2) stand-in grid no block runs tensor
    parallelism: every head and the whole FFN run on a rank's rows, the
    model-split weights gathered at use; any length the group divides
    splits (no chunk to respect), an odd one stays whole."""
    cfg = tconfigs.get_smoke(arch)
    for k in range(2):
        m = TModel(cfg, TRunConfig(seq_shard=True), device="meta",
                   grid=tmesh.stand_in((1, 2), k))
        assert all(not (b.tp_attn or b.tp_mlp) and b.local_cfg is cfg
                   for blocks in m.segments for b in blocks)
        assert any(b.at_use for blocks in m.segments for b in blocks)
        split = m.seq_split(6)
        assert (split.rows, split.start) == (3, 3 * k)
        assert m.seq_split(7) is None


def test_dry_run_traces_a_dense_seq_shard_cell():
    """deepseek-7b's prefill_32k at 16×16 with ``seq_shard`` named (smoke
    widths): a rank's 2 rows over the data axis and 2048 of the 32768
    positions, one K/V all-gather a layer on the model group."""
    cfg = tconfigs.get_smoke("deepseek-7b")
    rec = dryrun.trace_cell("deepseek-7b", "prefill_32k", cfg=cfg,
                            mesh=(16, 16), run_overrides={"seq_shard": True})
    assert rec["ok"] and rec["run"]["seq_shard"]
    assert (rec["batch_per_rank"], rec["seq_per_rank"]) == (2, 2048)
    assert rec["model_collectives"] == {"all-gather seq.kv": cfg.n_layers}
