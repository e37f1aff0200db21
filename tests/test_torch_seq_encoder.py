"""``RunConfig.seq_shard`` for internvl2-2b's vision prefix and
whisper-large-v3's encoder-decoder, on the CPU.

The split is JAX's constraint on the embedded input x
(``src/repro/models/model.py:332-353``): rank k of m model ranks keeps
rows ``[k·L/m, (k+1)·L/m)`` of x, L its length (``Model.seq_length``):
the vision prefix's rows and the tokens for internvl2-2b, the decoder's
tokens for whisper-large-v3, whose encoder runs whole on every rank
(JAX's ``_encode`` carries no constraint) and whose cross-attention takes
a rank's rows as queries over the whole encoder output.  Where m does not
divide L nothing is split.

- The pieces of ``Model._embed_inputs`` on (1,2), (1,4) and (1,3)
  stand-in grids, joined, are the whole x, bitwise: on (1,4) rank 0's 6
  rows of 8 + 16 are all prefix; on (1,3) S 16 alone does not divide but
  L 24 does, and S 15 divides where L 23 does not (nothing is split).
- A loss on threads standing in for ranks (``tests/test_torch_seq_shard.py``):
  a rank of prefix rows only adds an exact 0 that still carries its
  backward, and the parts' gradients sum to one process's.
- Gloo ranks (subprocesses on a ``file://`` store) take a forward and one
  fp32 train step of each arch's smoke config from JAX's seeded init on
  (1,2), (1,4), (1,3) and (2,2) with ``fsdp`` grids, bucketed and
  barrier: each rank's logits (its rows, prefix rows included), the loss
  and every gradient equal one process's to 1e-4 of max|·|
  (``tests/test_sync.py:55``).  The (1,3) cells run under
  ``batch_axes="all"``, where ``make_train_step`` lays the batch's rows
  out by the same prefix-inclusive length as the model splits it (a
  decision on the tokens alone would triple or garble the gradients).  On
  (1,2) both archs equal JAX's ``Model`` with ``seq_shard=True`` on an
  Auto (1,2) mesh (a subprocess with
  ``--xla_force_host_platform_device_count``), and a cached whisper call
  (the encoder on a rank's batch rows, a one-call prefill, a decode
  step) splits nothing and gives one process's logits.
- The dry run traces a named ``seq_shard`` cell of each arch at 16×16,
  the prefix counted in a rank's positions.
"""
import dataclasses
import json
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
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.models import model as tmodel
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sync import seq as tseq
from test_torch_seq_shard import _on_threads

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
VLM, AUDIO = "internvl2-2b", "whisper-large-v3"
ARCHS = (VLM, AUDIO)
# (tag, arch, grid, RunConfig fields, B, S)
CELLS = [
    (f"{VLM}_1x2", VLM, (1, 2), {}, 2, 16),
    (f"{VLM}_1x4", VLM, (1, 4), {}, 2, 16),
    (f"{VLM}_1x3_all", VLM, (1, 3), {"batch_axes": "all"}, 3, 16),
    (f"{VLM}_1x3_all_s15", VLM, (1, 3), {"batch_axes": "all"}, 3, 15),
    (f"{VLM}_2x2_fsdp", VLM, (2, 2), {"fsdp": True}, 4, 16),
    (f"{AUDIO}_1x2", AUDIO, (1, 2), {}, 2, 16),
    (f"{AUDIO}_1x2_barrier", AUDIO, (1, 2), {"sync_mode": "barrier"}, 2,
     16),
    (f"{AUDIO}_1x4", AUDIO, (1, 4), {}, 2, 16),
    (f"{AUDIO}_1x3_all_s15", AUDIO, (1, 3), {"batch_axes": "all"}, 3, 15),
    (f"{AUDIO}_2x2_fsdp", AUDIO, (2, 2), {"fsdp": True}, 4, 16),
]


def _close(got, want, key="x", tol: float = TOL):
    w = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=key)


def _batch(cfg, B, S, seed=0) -> dict:
    """numpy batch: tokens, and a vision prefix or audio frames where the
    config has them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.vision_embed_dim:
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_seq, cfg.vision_embed_dim)).astype(np.float32)
    if cfg.encoder_layers:
        batch["audio_embeds"] = rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _length(cfg, S: int) -> int:
    return S + (cfg.vision_seq if cfg.vision_embed_dim else 0)


@torch.no_grad()
def _copy(one: TModel, grid_model: TModel) -> None:
    """One process's parameters into a grid's whole ones; a head padded
    to the model group's multiple (V 256 over 3 ranks: 258, as JAX pads
    it) gets zero pad columns, which the head masks."""
    for p, q in zip(one.parameters(), grid_model.parameters()):
        q.zero_()
        q[tuple(slice(0, n) for n in p.shape)].copy_(p)


# ----------------------------------------------------------------------
# the pieces of the embedded input, on stand-in grids
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,S", [(2, 16), (4, 16), (3, 16), (3, 15)],
                         ids=["1x2", "1x4", "1x3", "1x3_s15"])
def test_pieces_of_the_embedded_input_are_the_whole(m, S):
    """Rank k's ``_embed_inputs`` on a (1,m) stand-in grid is rows
    ``[k·L/m, (k+1)·L/m)`` of one process's ``[prefix; tokens]`` (L = 8 +
    S), bitwise, and says how many of them are prefix rows; where m does
    not divide L (S 15 on (1,3)) no rank splits and each embeds it
    whole."""
    cfg = tconfigs.get_smoke(VLM)
    batch = _tbatch(_batch(cfg, 2, S))
    one = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    one.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        whole, n = one._embed_inputs(batch)
    L = _length(cfg, S)
    assert (n, whole.shape[1], one.seq_length(batch)) == (8, L, L)
    pieces, prefix = [], []
    for k in range(m):
        mk = TModel(cfg, TRunConfig(seq_shard=True, batch_axes="all"),
                    dtype=torch.float32, device="cpu",
                    grid=tmesh.stand_in((1, m), k))
        _copy(one, mk)
        split = mk.seq_split(mk.seq_length(batch))
        if L % m:
            assert split is None
            continue
        assert (split.start, split.rows) == (k * L // m, L // m)
        with torch.no_grad():
            x, nk = mk._embed_inputs(batch, seq=split)
        pieces.append(x)
        prefix.append(nk)
    if L % m:
        return
    assert torch.equal(torch.cat(pieces, dim=1), whole)
    rows = L // m
    assert prefix == [min(max(8 - k * rows, 0), rows) for k in range(m)]
    if m == 4:
        assert prefix[0] == rows == 6          # rank 0: prefix rows only


def test_the_split_length_counts_the_prefix():
    """``Model.seq_length``, ``make_train_step``'s decision and the dry
    run's ``split_length`` count the vision prefix; whisper's L is its
    tokens' (the frames are the encoder's, not split)."""
    for arch in ARCHS:
        cfg = tconfigs.get_smoke(arch)
        batch = _tbatch(_batch(cfg, 2, 16))
        L = tmodel.seq_length(cfg, batch)
        assert L == _length(cfg, 16)
        assert L == (24 if arch == VLM else 16)
        assert tmodel.seq_length(cfg, {"tokens": batch["tokens"]}) == 16
        shape = dryrun.SHAPES["prefill_32k"]
        assert dryrun.split_length(shape, cfg) == 32768 + (
            cfg.vision_seq if arch == VLM else 0)
    full = tconfigs.get(VLM)
    assert dryrun.seq_split(dryrun.SHAPES["prefill_32k"], (16, 16), full)
    assert dryrun.split_length(dryrun.SHAPES["train_4k"], full) == 5120


# ----------------------------------------------------------------------
# a loss on threads standing in for ranks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,m", [(VLM, 4), (VLM, 3), (AUDIO, 4)])
def test_a_split_loss_on_threads_is_one_process_s(arch, m):
    """``Model.loss`` on m threads standing in for a (1,m) model group
    under ``batch_axes="all"``: the parts (``Seq.total``'s inputs) sum to
    one process's loss; a rank of prefix rows only (internvl2-2b on
    (1,4): rank 0) adds an exact 0 that still needs a gradient; every
    parameter's gradient, summed over the ranks, is one process's."""
    cfg = tconfigs.get_smoke(arch)
    batch = _tbatch(_batch(cfg, 2, 16, seed=3))
    one = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    one.init(torch.Generator().manual_seed(1))
    loss, _ = one.loss(batch)
    names = [n for n, _ in one.named_parameters()]
    want = torch.autograd.grad(loss, list(one.parameters()),
                               materialize_grads=True)
    run = TRunConfig(seq_shard=True, batch_axes="all")
    parts = {}
    total = tseq.Seq.total

    def keep(self, part):
        parts[self.comm.rank] = part
        return total(self, part)

    def piece(comm):
        grid = tmesh.Grid((1, m), tmesh.AXES, comm.rank,
                          data=tmesh.StandIn(1), model=comm, world=comm)
        mk = TModel(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
        _copy(one, mk)
        lk, _ = mk.loss(batch)
        grads = torch.autograd.grad(lk, list(mk.parameters()),
                                    materialize_grads=True)
        return lk.detach(), grads

    tseq.Seq.total = keep
    try:
        got = _on_threads(m, piece)
    finally:
        tseq.Seq.total = total
    for lk, _ in got:
        assert float(lk) == pytest.approx(float(loss.detach()), rel=1e-5)
    assert all(torch.isfinite(p) and p.requires_grad for p in parts.values())
    assert float(sum(parts.values()).detach()) == pytest.approx(
        float(loss.detach()), rel=1e-5)
    if arch == VLM and m == 4:
        assert float(parts[0].detach()) == 0.0
    for i, name in enumerate(names):
        cut = tuple(slice(0, n) for n in want[i].shape)
        _close(sum(g[1][i] for g in got)[cut].numpy(), want[i].numpy(),
               name)


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
    with np.load(f"{a['dir']}/{arch}/batch_2_16.npz") as f:
        batch = {k: jnp.asarray(f[k]) for k in f.files}
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


for tag, arch, _, kw, B, S in a["cells"]:
    cfg = configs.get_smoke(arch)
    flat = bridge.load_npz(f"{a['dir']}/{arch}/params/step_00000000")
    with np.load(f"{a['dir']}/{arch}/batch_{B}_{S}.npz") as f:
        batch = {k: torch.from_numpy(f[k]).long() if k == "tokens"
                 else torch.from_numpy(f[k]) for k in f.files}
    run = RunConfig(seq_shard=True, **kw)
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    V = cfg.vocab_size
    # a head padded to the model group's multiple (JAX's): zero columns
    flat["lm_head"] = np.pad(flat["lm_head"], ((0, 0), (0, m.vocab - V)))
    bridge.from_flat(flat, m)
    split = m.seq_split(m.seq_length(batch))
    out = {".start": -1 if split is None else split.start}
    with torch.no_grad():
        out[".logits"] = m.forward(batch)[..., :V].numpy()
        if a["cached"] == tag:
            # a cached call splits nothing: the encoder over this rank's
            # rows of the batch, a one-call prefill at index 0, a decode
            # step, on this rank's block of the cache
            caches = m.init_cache(B, S + 2)
            rows = caches.layout
            mine = {k: v[rows.row0:rows.row0 + rows.rows]
                    for k, v in batch.items()}
            enc = m.encode(mine)
            prefill, caches = m.decode_step(caches, mine["tokens"], 0,
                                            enc_out=enc)
            decode, _ = m.decode_step(caches, mine["tokens"][:, -1:], S,
                                      enc_out=enc)
            out[".prefill"], out[".decode"] = prefill.numpy(), decode.numpy()
            out[".row0"] = rows.row0
    opt = Keep(AdamW(AdamWConfig()))
    state = {"params": m, "opt": opt.init(m)}
    step = train.make_train_step(m, opt, run, grid=grid)
    state, metrics = step(state, batch)
    out[".loss"] = metrics["loss"].numpy()
    out.update({k: g.numpy() for k, g in opt.grads.items()})
    out[".pad"] = np.abs(out["lm_head"][:, V:]).max(initial=0.0)
    out["lm_head"] = out["lm_head"][:, :V]
    log = Counter(f"{k} {v}" for k, v in step.model_log
                  if str(v).startswith("seq."))
    np.savez(f"{a['out']}/{tag}_r{rank}.npz", **out)
    with open(f"{a['out']}/{tag}_r{rank}.json", "w") as f:
        json.dump(log, f)
dist.destroy_process_group()
"""

CACHED = f"{AUDIO}_1x2"


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _start(tmp, sizes, cells, out):
    n = int(np.prod(sizes))
    store = tmp / ("store_" + "x".join(map(str, sizes)))
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps({
            "rank": rank, "sizes": list(sizes), "init": f"file://{store}",
            "cells": cells, "dir": str(tmp), "out": str(out),
            "cached": CACHED})],
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


def _one_process(cfg, flat, batch: dict) -> dict:
    """The port's one-process fp32 forward, cached calls and step:
    logits, loss, gradients."""
    m = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    t = _tbatch(batch)
    B, S = t["tokens"].shape
    out = {}
    with torch.no_grad():
        out["logits"] = m.forward(t).numpy()
        if cfg.encoder_layers:
            enc = m.encode(t)
            caches = m.init_cache(B, S + 2)
            prefill, caches = m.decode_step(caches, t["tokens"], 0,
                                            enc_out=enc)
            decode, _ = m.decode_step(caches, t["tokens"][:, -1:], S,
                                      enc_out=enc)
            out["prefill"], out["decode"] = prefill.numpy(), decode.numpy()
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
    _, metrics = ttrain.make_train_step(m, Keep(), TRunConfig())(state, t)
    out.update(loss=float(metrics["loss"]), grads=kept)
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's init of each arch, every grid's ranks (started together),
    JAX's ``seq_shard`` steps, and the one-process steps."""
    tmp = tmp_path_factory.mktemp("seq_encoder")
    for i, arch in enumerate(ARCHS):
        cfg = tconfigs.get_smoke(arch)
        (tmp / arch).mkdir()
        for B, S in {(c[4], c[5]) for c in CELLS if c[1] == arch}:
            np.savez(tmp / arch / f"batch_{B}_{S}.npz",
                     **_batch(cfg, B, S, seed=10 + B + S))
        jm = JModel(jconfigs.get_smoke(arch),
                    JRunConfig(remat=False, attn_impl="xla"),
                    dtype=jnp.float32)
        jckpt.save(str(tmp / arch / "params"), 0,
                   jm.init(jax.random.PRNGKey(30 + i)))
    out = tmp / "ranks"
    out.mkdir()
    cells = [[tag, arch, list(g), kw, B, S]
             for tag, arch, g, kw, B, S in CELLS]
    procs = []
    for sizes in sorted({tuple(c[2]) for c in cells}):
        procs += _start(tmp, sizes, [c for c in cells
                                     if tuple(c[2]) == sizes], out)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps({
            "dir": str(tmp), "archs": list(ARCHS)})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    one = {}
    for _, arch, _, _, B, S in CELLS:
        if (arch, B, S) not in one:
            flat = bridge.load_npz(str(tmp / arch / "params"
                                       / "step_00000000"))
            with np.load(tmp / arch / f"batch_{B}_{S}.npz") as f:
                batch = {k: f[k] for k in f.files}
            one[arch, B, S] = _one_process(tconfigs.get_smoke(arch), flat,
                                           batch)
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
    """Each rank's logits are one process's rows ``[k·L/m, (k+1)·L/m)``
    (every row where m does not divide L), a vision prefix's included;
    the loss and every gradient, the encoder's too, are one process's on
    every rank."""
    _, arch, (d, m), _, B, S = _cell(tag)
    one = steps["one"][arch, B, S]
    L = _length(tconfigs.get_smoke(arch), S)
    split = L % m == 0
    rows = L // m if split else L
    for rank in range(d * m):
        got = _npz(steps["out"] / f"{tag}_r{rank}.npz")
        start = int(got.pop(".start"))
        assert start == ((rank % m) * rows if split else -1)
        logits = got.pop(".logits")
        want = one["logits"]
        if split:
            want = want[:, start:start + rows]
        assert logits.shape == (B, rows, want.shape[-1])
        _close(logits, want, "logits")
        assert float(got.pop(".loss")) == pytest.approx(one["loss"],
                                                        rel=1e-5)
        assert float(got.pop(".pad")) == 0.0     # the pad columns' gradient
        for k in [k for k in got if k.startswith(".")]:
            got.pop(k)
        assert got.keys() == one["grads"].keys()
        for key, g in got.items():
            _close(g, one["grads"][key], key)


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_step_equals_jax_seq_shard_step(steps, arch):
    """On (1,2): the ranks' logits, joined along the sequence (the prefix
    rows first), the loss and every gradient equal JAX's ``seq_shard``
    step on an Auto (1,2) mesh."""
    ranks = [_npz(steps["out"] / f"{arch}_1x2_r{r}.npz") for r in range(2)]
    jdir = steps["tmp"] / arch
    _close(np.concatenate([r[".logits"] for r in ranks], axis=1),
           np.load(jdir / "jax_logits.npy"), "logits")
    got = ranks[0]
    assert float(got[".loss"]) == pytest.approx(steps["jax_loss"][arch],
                                                rel=1e-5)
    jg = bridge.load_npz(str(jdir / "jax_grads" / "step_00000000"))
    grads = {k: g for k, g in got.items() if not k.startswith(".")}
    assert grads.keys() == jg.keys()
    for key, g in grads.items():
        _close(g, jg[key], key)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_a_step_s_seq_collectives(steps, tag):
    """The model group's ``seq.*`` collectives of one remat step where L
    splits: a K/V all-gather a decoder layer in the forward and again in
    remat's recompute, one reduce-scatter a layer in the backward, one
    loss all-reduce; none for the encoder or cross-attention, and none
    where L does not split."""
    _, arch, (d, m), _, _, S = _cell(tag)
    cfg = tconfigs.get_smoke(arch)
    L = cfg.n_layers
    want = ({"all-gather seq.kv": 2 * L, "reduce-scatter seq.kv": L,
             "all-reduce seq.loss": 1}
            if _length(cfg, S) % m == 0 else {})
    for rank in range(d * m):
        log = json.loads((steps["out"] / f"{tag}_r{rank}.json").read_text())
        assert log == want, (tag, rank)


def test_cached_whisper_call_on_a_split_grid_is_one_process_s(steps):
    """A cached call is not split (JAX's ``decode_step`` embeds no
    ``seq_shard`` constraint): on (1,2) each rank encodes its rows of the
    batch whole, and its one-call prefill at index 0 and the decode step
    after it give one process's logits at those rows."""
    one = steps["one"][AUDIO, 2, 16]
    for rank in range(2):
        got = _npz(steps["out"] / f"{CACHED}_r{rank}.npz")
        r0 = int(got[".row0"])
        rows = got[".prefill"].shape[0]
        _close(got[".prefill"], one["prefill"][r0:r0 + rows], "prefill")
        _close(got[".decode"], one["decode"][r0:r0 + rows], "decode")


# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_traces_a_named_seq_shard_cell(arch):
    """prefill_32k at 16×16 with ``seq_shard`` named (smoke widths,
    internvl2-2b's prefix at its full 1024 rows): a rank's 2 rows over the
    data axis and its 1/16 of L (32768 + 1024 rows, or whisper's 32768
    tokens), one K/V all-gather a decoder layer on the model group."""
    cfg = tconfigs.get_smoke(arch)
    if cfg.vision_embed_dim:
        cfg = dataclasses.replace(cfg, vision_seq=tconfigs.get(arch)
                                  .vision_seq)
    rec = dryrun.trace_cell(arch, "prefill_32k", cfg=cfg, mesh=(16, 16),
                            run_overrides={"seq_shard": True})
    assert rec["ok"] and rec["run"]["seq_shard"]
    assert (rec["batch_per_rank"], rec["seq_per_rank"]) == (
        2, (32768 + (1024 if arch == VLM else 0)) // 16)
    assert rec["model_collectives"] == {"all-gather seq.kv": cfg.n_layers}
