"""``RunConfig.seq_shard`` for Mamba2 stacks (``sync.seq``): the sequence
split over a grid's model group, against one process and the JAX
package's ``seq_shard`` step, on the CPU.

- Gloo ranks (subprocesses on a ``file://`` store, as
  ``tests/test_torch_model_axis.py``) take a forward and one fp32 train
  step of the mamba2-130m smoke config (d 64, 2 layers, chunk 8, conv 4,
  vocab 256) from JAX's seeded init: on (1,2), (1,4) (the state crosses
  three ranks) and (2,2) with ``fsdp``, under ``batch_axes`` "all" (JAX's
  choice for the arch) and "dp", in bucketed and barrier mode.  Each
  rank's logits (its piece of the sequence), the loss and every gathered
  gradient equal the one-process step's to 1e-4 of max|·|
  (``tests/test_sync.py:55``); on (1,2) under "all" they equal JAX's
  ``Model`` with ``seq_shard=True`` on an Auto (1,2) mesh of two host
  devices (a subprocess with ``--xla_force_host_platform_device_count``).
- A length the model group does not divide runs unsplit, as JAX's; a
  piece the chunk does not divide, or shorter than the conv's halo,
  raises; any arch with MoE or MLA still raises on a grid (the GQA
  decoders build, a vision prefix counted in the length they split:
  their split steps are ``tests/test_torch_seq_attention.py``'s and
  ``tests/test_torch_seq_encoder.py``'s).
- The halo and the state prefix alone, on threads standing in for
  ranks: a sequence cut into m pieces gives the whole sequence's
  ``ssd_chunked`` and Mamba2 block, forward and backward.
- The dry run traces mamba2-130m's prefill_32k at 16×16 when
  ``seq_shard`` is asked for by name, and skips it otherwise.
- The data pipeline's blocks of rows equal JAX's per-device shards on an
  Auto (2,1) mesh, and its iterator JAX's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
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
from repro.models import ssm as jssm
from repro.models import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops as tops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.models import ssm as tssm
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sync import seq as tseq
from repro_torch.sync import shard

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-130m"
TOL = 1e-4
# (tag, grid, RunConfig fields, B, S): S 7 is no multiple of 2 (unsplit)
CELLS = [
    ("1x2_all_bucketed", (1, 2), {"batch_axes": "all"}, 2, 64),
    ("1x2_all_barrier", (1, 2), {"batch_axes": "all",
                                 "sync_mode": "barrier"}, 2, 64),
    ("1x2_dp_bucketed", (1, 2), {}, 2, 64),
    ("1x2_unsplit", (1, 2), {"batch_axes": "all"}, 2, 7),
    ("1x4_all_bucketed", (1, 4), {"batch_axes": "all"}, 2, 64),
    ("1x4_all_barrier", (1, 4), {"batch_axes": "all",
                                 "sync_mode": "barrier"}, 2, 64),
    ("1x4_dp_bucketed", (1, 4), {}, 2, 64),
    ("1x4_dp_barrier", (1, 4), {"sync_mode": "barrier"}, 2, 64),
    ("2x2_fsdp_all_bucketed", (2, 2), {"batch_axes": "all", "fsdp": True},
     4, 64),
    ("2x2_fsdp_all_barrier", (2, 2), {"batch_axes": "all", "fsdp": True,
                                      "sync_mode": "barrier"}, 4, 64),
    ("2x2_fsdp_dp_bucketed", (2, 2), {"fsdp": True}, 4, 64),
    ("2x2_fsdp_dp_barrier", (2, 2), {"fsdp": True, "sync_mode": "barrier"},
     4, 64),
]
JAX_TAG = "1x2_all_bucketed"
PIPE = DataConfig(vocab_size=256, seq_len=16, global_batch=4, seed=3)
PIPE_STEPS = (0, 7)

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch.sharding import batch_shardings
from repro.models import Model

a = json.loads(sys.argv[1])
cfg = configs.get_smoke("mamba2-130m")
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
run = RunConfig(remat=False, attn_impl="xla", seq_shard=True,
                batch_axes="all")
jm = Model(cfg, run, mesh=mesh, dp_axes=tuple(mesh.axis_names),
           dtype=jnp.float32)
params = ckpt.restore(f"{a['dir']}/params", 0,
                      jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
tokens = jnp.asarray(np.load(f"{a['dir']}/tokens_2x64.npy"))
batch = {"tokens": tokens}
batch = jax.device_put(batch, batch_shardings(batch, mesh, run))
with mesh:
    logits = jax.jit(jm.forward)(params, batch)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(params, batch)
np.save(f"{a['dir']}/jax_logits.npy", np.asarray(logits))
ckpt.save(f"{a['dir']}/jax_grads", 0, grads)

# the data pipeline: each device's shard of a batch on an Auto (2,1) mesh
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
p = a["pipe"]
data = SyntheticLM(DataConfig(**p), NamedSharding(mesh, P("data", None)))
shards = {}
for step in a["steps"]:
    arr = data.batch_at(step)["tokens"]
    for sh in arr.addressable_shards:
        shards[f"{step}_{sh.index[0].start or 0}"] = np.asarray(sh.data)
it = iter(SyntheticLM(DataConfig(**p)))
for i in range(2):
    shards[f"iter_{i}"] = np.asarray(next(it)["tokens"])
np.savez(f"{a['dir']}/jax_pipe.npz", **shards)
print(json.dumps({"loss": float(loss)}))
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
cfg = configs.get_smoke("mamba2-130m")
flat = bridge.load_npz(f"{a['dir']}/params/step_00000000")


class Keep:
    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {bridge._key(k): bridge.whole(params, k, g).clone()
                      for k, g in grads.items()}
        return self.opt.update(grads, state, params)


for tag, _, kw, B, S in a["cells"]:
    tokens = torch.from_numpy(np.load(f"{a['dir']}/tokens_{B}x{S}.npy"))
    run = RunConfig(seq_shard=True, **kw)
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    bridge.from_flat(flat, m)
    split = m.seq_split(S)
    with torch.no_grad():
        logits = m.forward({"tokens": tokens.long()})
    opt = Keep(AdamW(AdamWConfig()))
    state = {"params": m, "opt": opt.init(m)}
    step = train.make_train_step(m, opt, run, grid=grid)
    state, metrics = step(state, {"tokens": tokens.long()})
    log = Counter(f"{k} {v}" for k, v in step.model_log
                  if str(v).startswith("seq."))
    out = {".logits": logits.numpy(), ".loss": metrics["loss"].numpy(),
           ".start": split.start if split is not None else 0}
    out.update({k: g.numpy() for k, g in opt.grads.items()})
    np.savez(f"{a['out']}/{tag}_r{rank}.npz", **out)
    with open(f"{a['out']}/{tag}_r{rank}.json", "w") as f:
        json.dump(log, f)
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _start_ranks(tmp, sizes, cells, out):
    """``_WORKER`` on the ranks of a grid of ``sizes``: the processes."""
    n = int(np.prod(sizes))
    store = tmp / ("store_" + "x".join(map(str, sizes)))
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps({
            "rank": rank, "sizes": list(sizes), "init": f"file://{store}",
            "cells": cells, "dir": str(tmp), "out": str(out)})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(n)]


def _finish(procs):
    """Wait for every process, each within its timeout; a failed or hung
    one fails the test."""
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=400)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * len(procs), [
        "\n".join(line for line in e.splitlines()
                  if "Warning" not in line and "return func" not in line
                  )[-3000:] for e in errs]
    return errs


def _one_process(cfg, flat, tokens):
    """The port's one-process fp32 step: logits, loss, gradients."""
    m = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits = m.forward({"tokens": t}).numpy()
    opt = AdamW(AdamWConfig())
    kept = {}

    class Keep:
        def init(self, params):
            return opt.init(params)

        def update(self, grads, state, params):
            kept.update({bridge._key(k): g.numpy().copy()
                         for k, g in grads.items()})
            return state

    state = {"params": m, "opt": opt.init(m)}
    _, metrics = ttrain.make_train_step(m, Keep(), TRunConfig())(
        state, {"tokens": t})
    return {"logits": logits, "loss": float(metrics["loss"]),
            "grads": kept}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's init, the grids' ranks (all three at once), JAX's
    ``seq_shard`` step and the pipeline's shards, and the one-process
    steps they are held to."""
    tmp = tmp_path_factory.mktemp("seq_shard")
    cfg = jconfigs.get_smoke(ARCH)
    jm = JModel(cfg, JRunConfig(remat=False, attn_impl="xla"),
                dtype=jnp.float32)
    jckpt.save(str(tmp / "params"), 0, jm.init(jax.random.PRNGKey(5)))
    shapes = sorted({(B, S) for *_, B, S in CELLS})
    for i, (B, S) in enumerate(shapes):
        np.save(tmp / f"tokens_{B}x{S}.npy", np.random.default_rng(
            i).integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    out = tmp / "ranks"
    out.mkdir()
    cells = [[tag, list(g), kw, B, S] for tag, g, kw, B, S in CELLS]
    procs = []
    for sizes in sorted({tuple(c[1]) for c in cells}):
        procs += _start_ranks(tmp, sizes, [c for c in cells
                                           if tuple(c[1]) == sizes], out)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps({
            "dir": str(tmp), "pipe": dataclasses.asdict(PIPE),
            "steps": list(PIPE_STEPS)})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    flat = bridge.load_npz(str(tmp / "params" / "step_00000000"))
    tcfg = tconfigs.get_smoke(ARCH)
    one = {(B, S): _one_process(tcfg, flat, np.load(
        tmp / f"tokens_{B}x{S}.npy")) for B, S in shapes}
    _finish(procs)
    try:
        jout, jerr = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, jerr[-3000:]
    return {"tmp": tmp, "out": out, "one": one,
            "jax_loss": json.loads(jout.strip().splitlines()[-1])["loss"]}


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _close(got, want, key="x", tol: float = TOL):
    w = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=key)


def _rank(steps, tag, rank) -> dict:
    return _npz(steps["out"] / f"{tag}_r{rank}.npz")


def _cell(tag):
    return next(c for c in CELLS if c[0] == tag)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_grid_step_equals_one_process(steps, tag):
    """Each rank's logits are the one-process logits of its piece of the
    sequence (all of it where the length is no multiple of the model
    group: unsplit, as JAX's), and the loss and every whole gradient on
    every rank are the one-process step's."""
    _, (d, m), _, B, S = _cell(tag)
    one = steps["one"][B, S]
    for rank in range(d * m):
        got = _rank(steps, tag, rank)
        logits, start = got.pop(".logits"), int(got.pop(".start"))
        rows = S // m if S % m == 0 else S
        assert logits.shape == (B, rows, one["logits"].shape[-1])
        assert start == (rank % m) * rows if rows < S else start == 0
        _close(logits, one["logits"][:, start:start + rows])
        assert float(got.pop(".loss")) == pytest.approx(one["loss"],
                                                        rel=1e-5)
        assert got.keys() == one["grads"].keys()
        for key, g in got.items():
            _close(g, one["grads"][key], key)


def test_grid_step_equals_jax_seq_shard_step(steps):
    """On (1,2) under ``batch_axes="all"``: the ranks' logits, joined
    along the sequence, the loss and every gradient equal JAX's
    ``seq_shard`` step on an Auto (1,2) mesh."""
    ranks = [_rank(steps, JAX_TAG, r) for r in range(2)]
    jl = np.load(steps["tmp"] / "jax_logits.npy")
    _close(np.concatenate([r.pop(".logits") for r in ranks], axis=1), jl)
    got = ranks[0]
    assert float(got.pop(".loss")) == pytest.approx(steps["jax_loss"],
                                                    rel=1e-5)
    got.pop(".start")
    jg = bridge.load_npz(str(steps["tmp"] / "jax_grads" / "step_00000000"))
    assert got.keys() == jg.keys()
    for key, g in got.items():
        _close(g, jg[key], key)


def test_a_step_s_sequence_collectives(steps):
    """The model group's ``seq.*`` collectives of one remat step: a halo
    and a state all-gather a layer in the forward and again in remat's
    recompute, one reduce-scatter of each a layer in the backward, one
    loss all-reduce; none where the length is not split."""
    L = tconfigs.get_smoke(ARCH).n_layers
    want = {"all-gather seq.halo": 2 * L, "all-gather seq.state": 2 * L,
            "reduce-scatter seq.halo": L, "reduce-scatter seq.state": L,
            "all-reduce seq.loss": 1}
    for tag, (d, m), *_ in CELLS:
        for rank in range(d * m):
            log = json.loads((steps["out"] / f"{tag}_r{rank}.json")
                             .read_text())
            assert log == ({} if tag.endswith("unsplit") else want), tag


# ----------------------------------------------------------------------
# what is split, what raises
# ----------------------------------------------------------------------
def test_seq_split_follows_jax_s_condition_and_the_chunk():
    """m dividing the length splits it (rows k·S/m on); a length m does
    not divide stays whole; a piece the chunk does not divide, or shorter
    than the conv's W−1, raises naming both numbers."""
    cfg = tconfigs.get_smoke(ARCH)
    run = TRunConfig(seq_shard=True, batch_axes="all")
    for k in range(2):
        m = TModel(cfg, run, device="meta", grid=tmesh.stand_in((1, 2), k))
        split = m.seq_split(64)
        assert (split.rows, split.start) == (32, 32 * k)
        assert m.seq_split(7) is None
        with pytest.raises(ValueError, match="18 a rank.*chunk 8"):
            m.seq_split(36)
    m = TModel(cfg, dataclasses.replace(run, ssm_chunk=2), device="meta",
               grid=tmesh.stand_in((1, 2)))
    with pytest.raises(ValueError, match="2 a rank.*halo of 3"):
        m.seq_split(4)
    # a grid of one model rank, or no seq_shard: nothing is split
    m = TModel(cfg, run, device="meta", grid=tmesh.stand_in((2, 1)))
    assert m.seq_split(64) is None
    m = TModel(cfg, TRunConfig(batch_axes="all"), device="meta",
               grid=tmesh.stand_in((1, 2)))
    assert m.seq_split(64) is None


def test_seq_shard_without_a_grid_is_one_process():
    """Without a grid ``seq_shard`` splits nothing, as JAX's without a
    mesh: the model builds and its loss is the plain model's, bitwise."""
    cfg = tconfigs.get_smoke(ARCH)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    losses = []
    for run in (TRunConfig(), TRunConfig(seq_shard=True)):
        m = TModel(cfg, run, dtype=torch.float32, device="cpu")
        m.init(torch.Generator().manual_seed(1))
        assert m.seq_split(16) is None
        with torch.no_grad():
            losses.append(m.loss({"tokens": tokens})[0])
    assert torch.equal(*losses)


# the archs ported since (``models.model.seq_shardable``; their split
# steps: ``tests/test_torch_seq_attention.py``, for the vision prefix and
# the encoder ``tests/test_torch_seq_encoder.py``, for the MoE stacks
# ``tests/test_torch_seq_moe.py``)
PORTED = ("deepseek-7b", "chatglm3-6b", "nemotron-4-15b",
          "deepseek-coder-33b", "internvl2-2b", "whisper-large-v3",
          "olmoe-1b-7b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCHS
                                  if a != ARCH])
def test_other_archs_still_refuse_seq_shard(arch):
    """An arch with MLA and the MTP head (deepseek-v3-671b) raises on a
    grid and without one, naming ``seq_shard`` and the "model" axis.
    Every other arch builds with it (GQA decoders, with dense or MoE
    FFNs, and jamba's Mamba2, attention and MoE stack): on a (1,2) grid it
    splits a length the group divides, rows k·L/2 on, L the batch's
    ``seq_length`` (internvl2-2b's 8 prefix rows and 16 tokens, the
    others' 16 tokens; whisper-large-v3's frames are its encoder's;
    jamba's 8 rows a rank are its chunk), and without a grid it splits
    nothing, its loss the plain model's bit for bit."""
    cfg = tconfigs.get_smoke(arch)
    run = TRunConfig(seq_shard=True)
    if arch in PORTED:
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=g)}
        if cfg.vision_embed_dim:
            batch["vision_embeds"] = torch.randn(
                (2, cfg.vision_seq, cfg.vision_embed_dim), generator=g)
        if cfg.encoder_layers:
            batch["audio_embeds"] = torch.randn(
                (2, cfg.max_source_positions, cfg.d_model), generator=g)
        L = 16 + (cfg.vision_seq if cfg.vision_embed_dim else 0)
        for k in range(2):
            m = TModel(cfg, run, device="meta",
                       grid=tmesh.stand_in((1, 2), k))
            split = m.seq_split(m.seq_length(batch))
            assert (split.rows, split.start) == (L // 2, L // 2 * k)
        losses = []
        for r in (TRunConfig(), run):
            m = TModel(cfg, r, dtype=torch.float32, device="cpu")
            m.init(torch.Generator().manual_seed(1))
            assert m.seq_split(m.seq_length(batch)) is None
            with torch.no_grad():
                losses.append(m.loss(batch)[0])
        assert torch.equal(*losses)
        return
    for grid in (None, tmesh.stand_in((1, 2))):
        with pytest.raises(NotImplementedError, match="seq_shard") as err:
            TModel(cfg, run, device="meta", grid=grid)
        assert "model" in str(err.value) and "item 5" not in str(err.value)


# ----------------------------------------------------------------------
# the halo and the prefix alone, on threads standing in for ranks
# ----------------------------------------------------------------------
class _ThreadComm(shard.Comm):
    """Rank ``rank`` of ``world`` threads: an all-gather, a sum
    reduce-scatter and a sum all-reduce through shared slots and a
    barrier."""

    def __init__(self, shared, rank):
        self.world, self.rank, self.group = shared["world"], rank, None
        self.shared = shared
        self.log = []

    def _everyone(self, t):
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = t.detach().clone()
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_gather(self, out, inp):
        out.copy_(torch.cat([g.reshape(-1) for g in self._everyone(inp)]))

    def reduce_scatter(self, out, inp):
        total = torch.stack(self._everyone(inp)).sum(dim=0)
        out.copy_(total.view(self.world, -1)[self.rank])
        return _Done()

    def all_reduce(self, t, op=None, async_op=False):
        t.copy_(torch.stack(self._everyone(t)).sum(dim=0))


class _Done:
    def wait(self):
        pass


def _on_threads(world, fn):
    """``fn(comm)`` on ``world`` threads; their results in rank order."""
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


def _ssd_inputs(B, L, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, P)).astype(np.float32),
            (0.5 * rng.random((B, L, H)) + 0.01).astype(np.float32),
            -np.exp(rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((B, L, G, N)).astype(np.float32),
            rng.standard_normal((B, L, G, N)).astype(np.float32)]


@pytest.mark.parametrize("m", [2, 3, 4])
def test_pieces_of_ssd_chunked_are_the_whole_scan(m):
    """A sequence of 96 cut into m pieces (chunk 8): each rank's y is the
    whole scan's rows and the last rank's final state its final state,
    the whole scan's held to JAX's ``ssd_chunked``; the gradients of
    Σ y·w + Σ state·v over the pieces' inputs are the whole's."""
    B, L, H, P, G, N, Q = 2, 96, 4, 8, 2, 16, 8
    arrays = _ssd_inputs(B, L, H, P, G, N)
    rng = np.random.default_rng(1)
    wy = torch.from_numpy(rng.standard_normal((B, L, H, P)).astype(
        np.float32))
    ws = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32))

    def leaves():
        return [torch.from_numpy(a).requires_grad_(True) for a in arrays]

    xs, dt, A, Bm, Cm = leaves()
    y, s = tops.ssd_chunked(xs, dt, A, Bm, Cm, Q)
    jy, js = jssm.ssd_chunked(*[jnp.asarray(a) for a in arrays], Q)
    _close(y.detach().numpy(), np.asarray(jy), "y vs JAX")
    _close(s.detach().numpy(), np.asarray(js), "state vs JAX")
    whole = torch.autograd.grad((y * wy).sum() + (s * ws).sum(),
                                (xs, dt, A, Bm, Cm))

    def piece(comm):
        split = tseq.Seq(comm, L)
        xs, dt, A, Bm, Cm = leaves()
        cut = [split.piece(t) for t in (xs, dt)] + [A] + [
            split.piece(t) for t in (Bm, Cm)]
        yk, sk = tops.ssd_chunked(*cut, Q, seq=split)
        loss = (yk * split.piece(wy)).sum() + (
            (sk * ws).sum() if split.last else 0.0)
        return (yk.detach(), sk.detach(),
                torch.autograd.grad(loss, (xs, dt, A, Bm, Cm)))

    got = _on_threads(m, piece)
    _close(torch.cat([g[0] for g in got], dim=1).numpy(), y.detach()
           .numpy(), "y")
    _close(got[-1][1].numpy(), s.detach().numpy(), "final state")
    for i, name in enumerate(("x", "dt", "A", "B", "C")):
        _close(sum(g[2][i] for g in got).numpy(), whole[i].numpy(),
               f"d{name}")


def test_pieces_of_a_mamba2_block_are_the_whole_block():
    """The Mamba2 block (conv halo and state prefix) on 3 pieces of a
    sequence of 48 (conv 4, chunk 8): the rows and, summed over the
    pieces, every parameter's gradient are the whole block's."""
    cfg = tconfigs.get_smoke(ARCH)
    p = tssm.ssm_init(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32)
    p["conv_b"] = 0.1 * torch.randn(p["conv_b"].shape,
                                    generator=torch.Generator()
                                    .manual_seed(2))
    L = 48
    x = torch.randn((2, L, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    w = torch.randn((2, L, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))

    def leaves():
        return {k: v.clone().requires_grad_(True) for k, v in p.items()}

    pw = leaves()
    y, _ = tssm.ssm_apply(pw, x, cfg)
    whole = torch.autograd.grad((y * w).sum(), list(pw.values()))

    def piece(comm):
        split = tseq.Seq(comm, L)
        pk = leaves()
        yk, _ = tssm.ssm_apply(pk, split.piece(x), cfg, seq=split)
        return yk.detach(), torch.autograd.grad(
            (yk * split.piece(w)).sum(), list(pk.values())), comm.log

    got = _on_threads(3, piece)
    _close(torch.cat([g[0] for g in got], dim=1).numpy(), y.detach()
           .numpy(), "y")
    for i, name in enumerate(p):
        _close(sum(g[1][i] for g in got).numpy(), whole[i].numpy(), name)
    assert Counter(got[1][2]) == {("all-gather", "seq.halo"): 1,
                                  ("all-gather", "seq.state"): 1,
                                  ("reduce-scatter", "seq.halo"): 1,
                                  ("reduce-scatter", "seq.state"): 1}


# ----------------------------------------------------------------------
# the dry run
# ----------------------------------------------------------------------
def test_dry_run_traces_the_seq_shard_cell_when_asked_by_name():
    """mamba2-130m's prefill_32k at 16×16 (JAX's choice: ``seq_shard``)
    is traced with ``--set seq_shard=True``: a rank's 2 rows over the
    data axis and 2048 of the 32768 positions, its halo and state
    gathered over the model group; without it a skip naming
    ``seq_shard``, as before."""
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH),
                              ssm_chunk=tconfigs.get(ARCH).ssm_chunk)
    rec = dryrun.trace_cell(ARCH, "prefill_32k", cfg=cfg, mesh=(16, 16),
                            run_overrides={"seq_shard": True})
    assert rec["ok"] and rec["run"]["seq_shard"]
    assert (rec["batch_per_rank"], rec["seq_per_rank"]) == (2, 2048)
    assert rec["jax_run"]["seq_shard"] is True
    assert rec["model_collectives"] == {
        "all-gather seq.halo": cfg.n_layers,
        "all-gather seq.state": cfg.n_layers}
    skip = dryrun.trace_cell(ARCH, "prefill_32k", cfg=cfg, mesh=(16, 16))
    assert skip["ok"] is False and "seq_shard" in skip["skipped"]


# ----------------------------------------------------------------------
# the data pipeline
# ----------------------------------------------------------------------
def test_pipeline_blocks_are_jax_s_per_device_shards(steps):
    """``SyntheticLM(cfg, device, block=(k, 2))`` hands out the rows that
    JAX's ``make_array_from_callback`` puts on device k of an Auto (2,1)
    mesh, bit for bit, and iterating the stream gives JAX's batches."""
    jx = _npz(steps["tmp"] / "jax_pipe.npz")
    whole = SyntheticLM(PIPE, "cpu")
    b = PIPE.global_batch // 2
    for step in PIPE_STEPS:
        for k in range(2):
            got = SyntheticLM(PIPE, "cpu", block=(k, 2)).batch_at(step)
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          jx[f"{step}_{k * b}"])
            assert torch.equal(got["tokens"], whole.batch_at(step)[
                "tokens"][k * b:(k + 1) * b])
    it = iter(whole)
    for i in range(2):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      jx[f"iter_{i}"])
    with pytest.raises(ValueError, match="block"):
        SyntheticLM(PIPE, "cpu", block=(0, 3))
