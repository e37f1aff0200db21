"""``fsdp=True`` with ``batch_axes="all"`` on a grid whose world divides a
stack's repeat count R, on the CPU.

JAX's rule puts the whole mesh on the first dimension the world divides
(``src/repro/launch/sharding.py:62-70``): for a stacked per-layer vector
(``ln1`` [R, d], the Mamba2 vectors [R, H]) that is the repeat axis.  A
rank of the port keeps every repeat (``launch.sharding.placement``'s
``lead``), so those vectors stay whole on it; every other tensor keeps its
rows of the second-to-last axis.

- Gloo ranks (subprocesses on a ``file://`` store) on (1,2) and (2,1)
  grids, the smoke configs (R 2) of mamba2-130m, deepseek-7b and
  olmoe-1b-7b, fp32, and mamba2-130m with ``seq_shard`` too: ``Model.init``
  gives one process's parameters bit for bit (gathered through
  ``bridge.to_flat``); from JAX's init (``bridge.from_flat``) the logits,
  the loss, every gradient and the parameters after one AdamW step equal
  one process's (olmoe-1b-7b's as two microbatches, each data rank
  routing its own rows) and JAX's step on an Auto mesh of the same shape
  (a subprocess with ``--xla_force_host_platform_device_count``), to
  1e-4 of max|·| (``tests/test_sync.py:55``).  The parameters after the
  step are one process's AdamW step on the same gradients: AdamW's first
  step moves a parameter by lr·g/(|g| + eps), which turns a last-bit
  difference of a gradient near eps into a visible one, so the update is
  held on the grid's own gradients, and they to the references.  JAX's
  MoE step under
  "all" on a "model" axis of 2 sums other tokens' expert outputs
  (ROADMAP, "In the reference"): olmoe-1b-7b is held to JAX on (2,1)
  only.
- The rule: a stacked vector whose repeat axis the world divides stays
  whole, the same vector unstacked, and every tensor whose
  second-to-last axis is not a repeat axis, keep the split they had.
"""
import json
import os
import subprocess
import sys
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
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.optim import AdamW, AdamWConfig

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
B, S = 4, 16
ARCHS = ("mamba2-130m", "deepseek-7b", "olmoe-1b-7b")
FSDP_ALL = {"fsdp": True, "batch_axes": "all"}
# (tag, arch, grid, RunConfig fields)
CELLS = ([(f"{a}_{d}x{m}", a, (d, m), FSDP_ALL)
          for a in ARCHS for d, m in ((1, 2), (2, 1))]
         + [("mamba2-130m_1x2_seq", "mamba2-130m", (1, 2),
             {**FSDP_ALL, "seq_shard": True})])
# JAX's MoE step under "all" on a model axis of 2 is not the function
JAX_CELLS = [c for c in CELLS
             if not (c[1] == "olmoe-1b-7b" and c[2] == (1, 2))]

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.launch.sharding import batch_shardings
from repro.launch.train import make_train_step, state_shardings
from repro.models import Model
from repro.optim import AdamW, AdamWConfig

a = json.loads(sys.argv[1])
losses = {}
for tag, arch, (d, m), kw in a["cells"]:
    cfg = configs.get_smoke(arch)
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    run = RunConfig(remat=False, attn_impl="xla", **kw)
    jm = Model(cfg, run, mesh=mesh, dp_axes=tuple(mesh.axis_names),
               dtype=jnp.float32)
    params = ckpt.restore(f"{a['dir']}/{arch}/params", 0,
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    batch = {"tokens": jnp.asarray(np.load(f"{a['dir']}/tokens.npy"))}
    batch = jax.device_put(batch, batch_shardings(batch, mesh, run))
    opt = AdamW(AdamWConfig())
    state = {"params": params, "opt": opt.init(params)}
    state = jax.device_put(state, state_shardings(
        jax.eval_shape(lambda: state), cfg, run, mesh))
    with mesh:
        logits = jax.jit(jm.forward)(state["params"], batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b), has_aux=True))(state["params"],
                                                       batch)
        state, _ = jax.jit(make_train_step(jm, opt, run))(state, batch)
    np.save(f"{a['dir']}/jax_{tag}_logits.npy", np.asarray(logits))
    ckpt.save(f"{a['dir']}/jax_{tag}_grads", 0, grads)
    ckpt.save(f"{a['dir']}/jax_{tag}_after", 0, state["params"])
    losses[tag] = float(loss)
print(json.dumps(losses))
"""

_WORKER = r"""
import datetime, json, sys
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


for tag, arch, _, kw in a["cells"]:
    cfg = configs.get_smoke(arch)
    run = RunConfig(**kw)
    tokens = torch.from_numpy(np.load(f"{a['dir']}/tokens.npy")).long()
    # Model.init: each rank draws one process's init and keeps its slices
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    m.init(torch.Generator().manual_seed(3))
    out = {"init/" + k: v for k, v in bridge.to_flat(m).items()}
    out[".local"] = json.dumps({n: list(p.shape)
                                for n, p in m.named_parameters()})
    # from JAX's init: a forward, one step
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    bridge.from_flat(bridge.load_npz(f"{a['dir']}/{arch}/params/"
                                     "step_00000000"), m)
    with torch.no_grad():
        out[".logits"] = m.forward({"tokens": tokens}).numpy()
    split = m.seq_split(tokens.shape[1])
    out[".start"] = split.start if split is not None else 0
    opt = Keep(AdamW(AdamWConfig()))
    state = {"params": m, "opt": opt.init(m)}
    state, metrics = train.make_train_step(m, opt, run, grid=grid)(
        state, {"tokens": tokens})
    out[".loss"] = metrics["loss"].numpy()
    out.update({"grad/" + k: g.numpy() for k, g in opt.grads.items()})
    out.update({"after/" + k: v for k, v in bridge.to_flat(m).items()})
    np.savez(f"{a['out']}/{tag}_r{rank}.npz", **out)
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _popen(script, arg):
    return subprocess.Popen([sys.executable, "-c", script, json.dumps(arg)],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=400):
    """Every process's stdout, each within its timeout; a failed or hung
    one fails the test."""
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
    return [o for o, _ in outs]


def stepped(cfg, flat: dict, grads: dict) -> dict:
    """The parameters ``flat`` after one process's first AdamW step on
    ``grads`` (both flat, by checkpoint key)."""
    m = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    opt = AdamW(AdamWConfig())
    opt.update({n: torch.from_numpy(grads[bridge._key(n)])
                for n, _ in m.named_parameters()}, opt.init(m), m)
    return bridge.to_flat(m)


def _one_process(cfg, flat, tokens, microbatches):
    """One process's fp32 init, forward and step from ``flat``."""
    run = TRunConfig(microbatches=microbatches)
    m = TModel(cfg, run, dtype=torch.float32, device="cpu")
    init = bridge.to_flat(m.init(torch.Generator().manual_seed(3)))
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
            return opt.update(grads, state, params)

    state = {"params": m, "opt": opt.init(m)}
    _, metrics = ttrain.make_train_step(m, Keep(), run)(state, {"tokens": t})
    return {"init": init, "logits": logits, "loss": float(metrics["loss"]),
            "grad": kept, "flat": dict(flat)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_repeat_axis")
    tokens = np.random.default_rng(4).integers(0, 256, (B, S)).astype(
        np.int32)
    np.save(tmp / "tokens.npy", tokens)
    for i, arch in enumerate(ARCHS):
        jm = JModel(jconfigs.get_smoke(arch),
                    JRunConfig(remat=False, attn_impl="xla"),
                    dtype=jnp.float32)
        jckpt.save(str(tmp / arch / "params"), 0,
                   jm.init(jax.random.PRNGKey(30 + i)))
    out = tmp / "ranks"
    out.mkdir()
    procs = []
    for sizes in ((1, 2), (2, 1)):
        cells = [[t, a, list(g), kw] for t, a, g, kw in CELLS if g == sizes]
        store = tmp / ("store_" + "x".join(map(str, sizes)))
        procs += [_popen(_WORKER, {
            "rank": r, "sizes": list(sizes), "init": f"file://{store}",
            "cells": cells, "dir": str(tmp), "out": str(out)})
            for r in range(2)]
    jax_proc = _popen(_JAX, {"dir": str(tmp), "cells": [
        [t, a, list(g), kw] for t, a, g, kw in JAX_CELLS]})
    one = {arch: _one_process(
        tconfigs.get_smoke(arch),
        bridge.load_npz(str(tmp / arch / "params" / "step_00000000")),
        tokens, 2 if tconfigs.get_smoke(arch).n_experts else 1)
        for arch in ARCHS}
    _wait(procs)
    jout, = _wait([jax_proc], timeout=600)
    return {"tmp": tmp, "out": out, "one": one,
            "jax_loss": json.loads(jout.strip().splitlines()[-1])}


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _close(got, want, key="x", tol: float = TOL):
    w = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=key)


def _part(got: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix)}


def _cell(tag):
    return next(c for c in CELLS if c[0] == tag)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_init_is_one_process_s_and_vectors_stay_whole(steps, tag):
    """``Model.init`` on the grid gives one process's parameters bit for
    bit, and a rank keeps every repeat: each stacked vector whole, each
    stacked matrix's rows of its second-to-last axis."""
    _, arch, (d, m), _ = _cell(tag)
    one = steps["one"][arch]
    for rank in range(d * m):
        got = _npz(steps["out"] / f"{tag}_r{rank}.npz")
        init = _part(got, "init/")
        assert init.keys() == one["init"].keys()
        for key, p in init.items():
            assert np.array_equal(p, one["init"][key]), key
        local = json.loads(str(got[".local"]))
        for name, shape in local.items():
            whole = one["init"][bridge._key(name)].shape
            assert len(shape) == len(whole), name
            if name.startswith("segments.") and len(whole) == 2:
                assert tuple(shape) == whole, name
            assert tuple(shape[:-2]) == whole[:-2], name


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_step_from_jax_s_init_equals_one_process(steps, tag):
    """From JAX's init: each rank's logits (its rows of the sequence
    where ``seq_shard`` splits it), the loss and every gradient are one
    process's, and every parameter after AdamW is one process's AdamW
    step on those gradients."""
    _, arch, (d, m), kw = _cell(tag)
    one = steps["one"][arch]
    for rank in range(d * m):
        got = _npz(steps["out"] / f"{tag}_r{rank}.npz")
        logits, start = got[".logits"], int(got[".start"])
        _close(logits, one["logits"][:, start:start + logits.shape[1]],
               "logits")
        assert float(got[".loss"]) == pytest.approx(one["loss"], rel=1e-5)
        grads = _part(got, "grad/")
        assert grads.keys() == one["grad"].keys()
        for key, v in grads.items():
            _close(v, one["grad"][key], f"grad {key}")
        want = stepped(tconfigs.get_smoke(arch), one["flat"], grads)
        after = _part(got, "after/")
        assert after.keys() == want.keys()
        for key, v in after.items():
            _close(v, want[key], f"after {key}")


@pytest.mark.parametrize("tag", [c[0] for c in JAX_CELLS])
def test_step_equals_jax_s_on_an_auto_mesh(steps, tag):
    """Rank 0's logits (joined with rank 1's where the sequence is
    split), loss and gradients equal JAX's ``fsdp`` step under
    ``batch_axes="all"`` on an Auto mesh of the grid's shape, and JAX's
    parameters after its AdamW step are one process's step on JAX's
    gradients (the grid's are held so by
    ``test_step_from_jax_s_init_equals_one_process``)."""
    _, arch, (d, m), kw = _cell(tag)
    ranks = [_npz(steps["out"] / f"{tag}_r{r}.npz") for r in range(d * m)]
    logits = (np.concatenate([r[".logits"] for r in ranks], axis=1)
              if kw.get("seq_shard") else ranks[0][".logits"])
    tmp = steps["tmp"]
    _close(logits, np.load(tmp / f"jax_{tag}_logits.npy"), "logits")
    got = ranks[0]
    assert float(got[".loss"]) == pytest.approx(steps["jax_loss"][tag],
                                                rel=1e-5)
    jg = bridge.load_npz(str(tmp / f"jax_{tag}_grads" / "step_00000000"))
    grads = _part(got, "grad/")
    assert grads.keys() == jg.keys()
    for key, v in grads.items():
        _close(v, jg[key], f"grad {key}")
    jafter = bridge.load_npz(str(tmp / f"jax_{tag}_after"
                                 / "step_00000000"))
    want = stepped(tconfigs.get_smoke(arch), steps["one"][arch]["flat"], jg)
    assert jafter.keys() == want.keys()
    for key, v in jafter.items():
        _close(v, want[key], f"JAX's after {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_placement_keeps_a_rank_s_repeats(arch):
    """At full width under fsdp and "all", on (1,2), (2,1) and (2,2)
    stand-in grids: where JAX's spec puts the world on a stacked
    vector's repeat axis, the rank's placement splits nothing; an
    unstacked vector of the same shape is not split either (one axis);
    a stacked matrix keeps the split of its second-to-last axis."""
    cfg = tconfigs.get(arch)
    run = TRunConfig(**FSDP_ALL)
    d = cfg.d_model
    for sizes in ((1, 2), (2, 1), (2, 2)):
        grid = tmesh.stand_in(sizes)
        model = TModel(cfg, run, device="meta", grid=grid)
        R = model.segments_spec[0].repeats
        W = int(np.prod(sizes))
        spec = sharding.param_spec_for(("ln1",), (R, d), cfg, run, grid)
        if R % W == 0:
            assert sharding.axes_of(spec[0]), (arch, sizes)
        assert not sharding.placement(("ln1",), (R, d), cfg, run, grid, 1)
        assert not sharding.placement(("ln1",), (d,), cfg, run, grid)
        place = sharding.placement(("mlp", "w_in"), (R, d, 4 * d), cfg,
                                   run, grid, 1)
        assert place.data == (d % W == 0) and place.model is None
        for name, p in model.named_parameters():
            if name.startswith("segments."):
                assert p.shape[0] == R, name
