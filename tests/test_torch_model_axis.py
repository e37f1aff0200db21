"""The port's "model" axis (``launch.mesh``, ``launch.sharding``, tensor
and expert parallelism in ``Model``) against its one-process step and the
JAX package's step on the same data × model mesh, on the CPU.  This file
runs the (1,2) grid; ``tests/test_torch_model_axis_2x2.py`` runs the
(2,2) grid with the checkers below.

- Gloo ranks (subprocesses on a ``file://`` store, as
  ``tests/test_torch_fsdp.py``) laid on (1,2) and (2,2) grids take one
  fp32 step of the deepseek-7b, olmoe-1b-7b, deepseek-v3-671b and
  mamba2-130m smoke configs from JAX's seeded init: the MoE archs with
  both ``moe_combine``s, the (2,2) grid with ``fsdp`` too.  Their logits,
  loss, gathered gradients and parameters after AdamW equal the
  one-process port step's (the batch as one microbatch a data row, as
  each data shard routes its own tokens) and JAX's step on an Auto-typed
  (d, m) mesh of host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``), to 1e-4 of max|·|; the
  two combines equal each other.
- Serving on the grid (a one-call prefill and a decode step, each rank
  its rows of the batch in its block of JAX's decode-cache layout: a
  T of 18, 9 rows a model rank, every KV head, the step's row in the
  second rank's block) gives the one-process logits (one call a data
  row) on every rank, so that the ranks together cover the batch.
- A vocabulary made odd (257) pads the head to 258 at tp 2, as JAX's.
- Checkpoints: the grid's state has JAX's keys, shapes and values and
  restores into JAX; JAX's restores into the grid's ranks, saved again
  byte for byte.
- ``batch_axes="all"``: a dense model equals JAX's step; a MoE model the
  one-process step (JAX's ``shard_map`` sums different tokens' expert
  outputs over "model" there: recorded, not copied).
- The train CLI's ``--mesh 1x2`` under ``torchrun``.
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
from repro.launch import train as jtrain
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge, ckpt
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.optim import AdamW, AdamWConfig, compression
from repro_torch.sync import model_axis

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
B, S = 4, 16
MOE = ("olmoe-1b-7b", "deepseek-v3-671b")
ARCHS = ("deepseek-7b", "mamba2-130m") + MOE
ODD = "deepseek-7b-odd"            # deepseek-7b's smoke config at V 257


def _cfg(name, pkg):
    if name == ODD:
        import dataclasses
        return dataclasses.replace(pkg.get_smoke("deepseek-7b"),
                                   vocab_size=257)
    return pkg.get_smoke(name)


def _cells():
    """(tag, arch, (d, m), RunConfig overrides) of every grid step."""
    out = []
    for arch in ARCHS:
        for grid in ((1, 2), (2, 2)):
            combines = ("psum", "psum_scatter") if arch in MOE else ("psum",)
            for comb in combines:
                kw = {"moe_combine": comb} if comb != "psum" else {}
                if grid == (2, 2):
                    kw["fsdp"] = True
                tag = f"{arch}_{grid[0]}x{grid[1]}_{comb}"
                out.append((tag, arch, grid, kw))
    out.append((f"{ODD}_1x2_psum", ODD, (1, 2), {}))
    # int8 moments and fp8 compression: scales of rows the model group
    # splits are the whole row's
    x = {"opt_8bit": True, "grad_compression": True}
    out.append(("deepseek-7b_1x2_extras", "deepseek-7b", (1, 2), x))
    out.append(("olmoe-1b-7b_2x2_extras", "olmoe-1b-7b", (2, 2),
                {**x, "fsdp": True}))
    for arch in ("deepseek-7b", "olmoe-1b-7b"):
        out.append((f"{arch}_1x2_all", arch, (1, 2), {"batch_axes": "all"}))
    return out


CELLS = _cells()
CELLS_1x2 = [c for c in CELLS if c[2] == (1, 2)]
CELLS_2x2 = [c for c in CELLS if c[2] == (2, 2)]

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.launch.mesh import dp_axes
from repro.launch.train import make_train_step, state_shardings
from repro.models import Model
from repro.optim import AdamW, AdamWConfig, compression

a = json.loads(sys.argv[1])
losses = {}
for tag, arch, (d, m), kw in a["cells"]:
    cfg = configs.get_smoke(arch.replace("-odd", ""))
    if arch.endswith("-odd"):
        cfg = dataclasses.replace(cfg, vocab_size=257)
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:d * m])
    run = RunConfig(remat=False, attn_impl="xla", **kw)
    dp = tuple(mesh.axis_names) if run.batch_axes == "all" else dp_axes(mesh)
    jm = Model(cfg, run, mesh=mesh, dp_axes=dp, dtype=jnp.float32)
    src = f"{a['dir']}/{arch}"
    params = ckpt.restore(f"{src}/params_tp{m}", 0,
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tokens = jnp.asarray(np.load(f"{src}/tokens.npy"))
    opt = AdamW(AdamWConfig(state_8bit=run.opt_8bit))
    state = {"params": params, "opt": opt.init(params)}
    if run.grad_compression:
        state["err"] = compression.init_error_state(params)
    state = jax.device_put(state, state_shardings(
        jax.eval_shape(lambda: state), cfg, run, mesh))
    with mesh:
        logits = jax.jit(jm.forward)(state["params"], {"tokens": tokens})
        state, metrics = jax.jit(make_train_step(jm, opt, run))(
            state, {"tokens": tokens})
    np.save(f"{a['dir']}/jax_{tag}_logits.npy", np.asarray(logits))
    ckpt.save(f"{a['dir']}/jax_{tag}", 1, state)
    losses[tag] = float(metrics["loss"])
print(json.dumps(losses))
"""

_WORKER = r"""
import dataclasses, datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import bridge, ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh, train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig, compression

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


logs = {}
for tag, arch, _, kw in a["cells"]:
    cfg = configs.get_smoke(arch.replace("-odd", ""))
    if arch.endswith("-odd"):
        cfg = dataclasses.replace(cfg, vocab_size=257)
    src = f"{a['dir']}/{arch}"
    tokens = torch.from_numpy(np.load(f"{src}/tokens.npy")).long()
    flat = bridge.load_npz(f"{src}/params_tp{sizes[-1]}/step_00000000")
    run = RunConfig(**kw)
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    bridge.from_flat(flat, m)
    with torch.no_grad():
        logits = m.forward({"tokens": tokens})
        # serving: a one-call prefill, then a decode step, on this rank's
        # rows of the batch (its cache's)
        B, S = tokens.shape
        caches = m.init_cache(B, S + 2)
        rows = caches.layout
        mine = tokens[rows.row0:rows.row0 + rows.rows]
        prefill, caches = m.decode_step(caches, mine, 0)
        decode, _ = m.decode_step(caches, mine[:, -1:], S)
    opt = Keep(AdamW(AdamWConfig(state_8bit=run.opt_8bit)))
    state = {"params": m, "opt": opt.init(m)}
    if run.grad_compression:
        state["err"] = compression.init_error_state(m)
    step = train.make_train_step(m, opt, run, grid=grid)
    state, metrics = step(state, {"tokens": tokens})
    shapes = {n: list(p.shape) for n, p in m.named_parameters()}
    if ckpt.is_sharded(state) or rank == 0:   # sharded: every rank gathers
        ckpt.save(f"{a['out']}/{tag}", 1, state)
    np.savez(f"{a['out']}/{tag}_serve_r{rank}.npz", row0=rows.row0,
             prefill=prefill.numpy(), decode=decode.numpy())
    if rank == 0:
        out = {k: g.numpy() for k, g in opt.grads.items()}
        out[".loss"] = metrics["loss"].numpy()
        out[".logits"] = logits.numpy()
        np.savez(f"{a['out']}/{tag}_grads.npz", **out)
    logs[tag] = {"model": [list(map(str, e)) for e in step.model_log],
                 "shapes": shapes}
    # JAX's state after its step, restored into the ranks, saved again
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    state = {"params": m, "opt": AdamW(AdamWConfig(
        state_8bit=run.opt_8bit)).init(m)}
    if run.grad_compression:
        state["err"] = compression.init_error_state(m)
    ckpt.restore(f"{a['dir']}/jax_{tag.replace('psum_scatter', 'psum')}", 1,
                 state)
    if ckpt.is_sharded(state) or rank == 0:
        ckpt.save(f"{a['out']}/from_jax/{tag}", 1, state)
with open(f"{a['out']}/logs_{'x'.join(map(str, sizes))}_r{rank}.json",
          "w") as f:
    json.dump(logs, f)
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _ranks(tmp, sizes, cells, out):
    """``_WORKER`` on the ranks of a grid of ``sizes``; each process has
    its own timeout, and a failed or hung rank fails the test."""
    n = int(np.prod(sizes))
    procs = []
    for rank in range(n):
        arg = json.dumps({"rank": rank, "sizes": list(sizes),
                          "init": f"file://{tmp / ('store_' + str(n))}",
                          "cells": cells, "dir": str(tmp), "out": str(out)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, arg], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=400)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, [
        "\n".join(line for line in e.splitlines()
                  if "Warning" not in line and "return func" not in line
                  )[-3000:] for e in errs]


def _one_process(cfg, flat, tokens, d, out, x=False):
    """The port's one-process step over the whole batch as ``d``
    microbatches (one a data row of the grid), with int8 moments and fp8
    compression where ``x``: logits, loss, gradients, parameters after
    AdamW; its state saved under ``out``."""
    run = TRunConfig(microbatches=d, opt_8bit=x, grad_compression=x)
    m = TModel(cfg, run, dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits = m.forward({"tokens": t}).numpy()
        serve = {"prefill": [], "decode": []}
        for part in t.chunk(d):                 # one call a data row
            caches = m.init_cache(part.shape[0], part.shape[1] + 2)
            prefill, caches = m.decode_step(caches, part, 0)
            serve["prefill"].append(prefill.numpy())
            serve["decode"].append(m.decode_step(
                caches, part[:, -1:], part.shape[1])[0].numpy())
        serve = {k: np.concatenate(v) for k, v in serve.items()}
    opt = AdamW(AdamWConfig(state_8bit=x))
    kept = {}

    class Keep:
        def init(self, params):
            return opt.init(params)

        def update(self, grads, state, params):
            kept.update({bridge._key(k): g.numpy().copy()
                         for k, g in grads.items()})
            return opt.update(grads, state, params)

    state = {"params": m, "opt": opt.init(m)}
    if x:
        state["err"] = compression.init_error_state(m)
    state, metrics = ttrain.make_train_step(m, Keep(), run)(
        state, {"tokens": t})
    ckpt.save(str(out), 1, state)
    return {"logits": logits, "serve": serve, "loss": float(metrics["loss"]),
            "grads": kept, "params": bridge.to_flat(m)}


def build_steps(tmp, cells):
    """JAX's init of each arch of ``cells`` (its head padded as its (·, m)
    mesh pads it), JAX's step of each cell, the grids' ranks, and the
    one-process steps they are held to."""
    archs = sorted({arch for _, arch, _, _ in cells})
    for arch in archs:
        cfg = _cfg(arch, jconfigs)
        for m in (1, 2):
            mesh = type("Mesh", (), {"shape": {"data": 1, "model": m},
                                     "axis_names": ("data", "model")})()
            jm = JModel(cfg, JRunConfig(remat=False, attn_impl="xla"),
                        dtype=jnp.float32)
            jm.mesh = mesh if m > 1 else None
            jckpt.save(str(tmp / arch / f"params_tp{m}"), 0,
                       jm.init(jax.random.PRNGKey(3)))
        seed = (ARCHS + (ODD,)).index(arch)
        np.save(tmp / arch / "tokens.npy", np.random.default_rng(
            seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    cells = [[tag, arch, list(grid), kw] for tag, arch, grid, kw in cells]
    # JAX's psum_scatter combine does not trace under jax 0.9.0 (its
    # shard_map cannot infer the all-gather's result replicated over
    # "model"): the port's is held to JAX's psum step, the same function
    res = subprocess.run(
        [sys.executable, "-c", _JAX, json.dumps({
            "cells": [c for c in cells if "psum_scatter" not in c[0]],
            "dir": str(tmp)})],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_loss = json.loads(res.stdout.strip().splitlines()[-1])
    out = tmp / "ranks"
    out.mkdir()
    for sizes in sorted({tuple(c[2]) for c in cells}):
        _ranks(tmp, sizes, [c for c in cells if tuple(c[2]) == sizes], out)
    one = {}
    for tag, arch, (d, m), kw in cells:
        if arch == ODD:
            continue
        d = d * m if kw.get("batch_axes") == "all" else d
        x = kw.get("opt_8bit", False)
        if (arch, d, x) not in one:
            flat = bridge.load_npz(str(tmp / arch / "params_tp1"
                                       / "step_00000000"))
            tokens = np.load(tmp / arch / "tokens.npy")
            one[arch, d, x] = _one_process(
                _cfg(arch, tconfigs), flat, tokens, d,
                tmp / "one" / f"{arch}_{d}_{x}", x)
    return {"tmp": tmp, "out": out, "jax_loss": jax_loss, "one": one}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return build_steps(tmp_path_factory.mktemp("model_axis"), CELLS_1x2)


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _state(path) -> dict:
    return _npz(Path(path) / "step_00000001" / "arrays.npz")


def _close(got: dict, want: dict, keys=None, tol: float = TOL):
    """Every tensor within ``tol`` of its max|want| (and relative)."""
    for key in keys if keys is not None else want:
        w = np.asarray(want[key], dtype=np.float64)
        np.testing.assert_allclose(got[key], w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=key)


def _cell(tag):
    return next(c for c in CELLS if c[0] == tag)


def step_tags(cells):
    return [c[0] for c in cells if c[1] != ODD
            and c[3].get("batch_axes") != "all" and not _extras(c[0])]


def jax_tags(cells):
    return [c[0] for c in cells if not _extras(c[0])
            and not (c[1] in MOE and c[3].get("batch_axes") == "all")]


def extras_tags(cells):
    return [c[0] for c in cells if _extras(c[0])]


def _extras(tag):
    return tag.endswith("_extras")


def check_one_process(steps, tag):
    """The grid's logits, loss, gathered gradients and parameters after
    AdamW equal the one-process step's (one microbatch a data row)."""
    _, arch, (d, _), _ = _cell(tag)
    one = steps["one"][arch, d, False]
    got = _npz(steps["out"] / f"{tag}_grads.npz")
    _close({"x": got.pop(".logits")}, {"x": one["logits"]})
    assert float(got.pop(".loss")) == pytest.approx(one["loss"], rel=1e-5)
    _close(got, one["grads"])
    state = _state(steps["out"] / tag)
    _close({k[len("params/"):]: v for k, v in state.items()
            if k.startswith("params/")}, one["params"])


def check_serving(steps, tag):
    """A one-call prefill and a decode step on the grid give, on every
    rank, the one-process logits of that rank's rows of the batch (its
    cache's: over "data" where d divides B; T over "model", 9 of the 18
    rows a rank, every KV head), to 1e-4 of max|·|; the ranks' rows
    cover the batch."""
    _, arch, (d, m), _ = _cell(tag)
    want = steps["one"][arch, d, False]["serve"]
    covered = set()
    for rank in range(d * m):
        got = _npz(steps["out"] / f"{tag}_serve_r{rank}.npz")
        r0, n = int(got.pop("row0")), got["prefill"].shape[0]
        covered.update(range(r0, r0 + n))
        _close(got, {k: v[r0:r0 + n] for k, v in want.items()})
    assert covered == set(range(B)), covered


def check_jax(steps, tag):
    """Loss, logits, parameters and moments after one step equal JAX's
    step on an Auto (d, m) mesh of host devices, to 1e-4 of max|·| (a
    ``psum_scatter`` step: JAX's ``psum`` step)."""
    jtag = tag.replace("psum_scatter", "psum")
    got = _state(steps["out"] / tag)
    jx = _state(steps["tmp"] / f"jax_{jtag}")
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in jx.items()}
    _close(got, jx, [k for k in got if k != "opt/step"])
    g = _npz(steps["out"] / f"{tag}_grads.npz")
    assert float(g[".loss"]) == pytest.approx(steps["jax_loss"][jtag],
                                              rel=1e-5)
    jl = np.load(steps["tmp"] / f"jax_{jtag}_logits.npy")
    V = _cfg(_cell(tag)[1], tconfigs).vocab_size
    _close({"x": g[".logits"][..., :V]}, {"x": jl[..., :V]})


def check_combines(steps, arch, grid):
    """``moe_combine="psum"`` and ``"psum_scatter"`` give the same step."""
    a = _npz(steps["out"] / f"{arch}_{grid}_psum_grads.npz")
    b = _npz(steps["out"] / f"{arch}_{grid}_psum_scatter_grads.npz")
    assert a.keys() == b.keys()
    _close(b, a, tol=1e-6)


def check_checkpoints(steps, tag):
    """The grid's saved state restores into JAX's target (the same
    arrays); JAX's state, restored into the grid's ranks and saved again,
    is JAX's byte for byte."""
    _, arch, (d, m), kw = _cell(tag)
    got = _state(steps["out"] / tag)
    cfg = _cfg(arch, jconfigs)
    mesh = type("Mesh", (), {"shape": {"data": d, "model": m},
                             "axis_names": ("data", "model")})()
    jm = JModel(cfg, JRunConfig(**kw), dtype=jnp.float32)
    jm.mesh = mesh
    opt = JAdamW(JAdamWConfig())
    target = jax.eval_shape(lambda: jtrain.init_train_state(
        jm, opt, JRunConfig(**kw), jax.random.PRNGKey(0)))
    restored = jckpt._flatten(jckpt.restore(str(steps["out"] / tag), 1,
                                            target))
    assert restored.keys() == got.keys()
    for k in got:
        np.testing.assert_array_equal(restored[k], got[k], err_msg=k)
    jx = _state(steps["tmp"] / f"jax_{tag}")
    back = _state(steps["out"] / "from_jax" / tag)
    assert back.keys() == jx.keys()
    for k in jx:
        np.testing.assert_array_equal(back[k], jx[k], err_msg=k)


def check_extras(steps, tag):
    """With int8 moments and fp8 compression: parameters after AdamW
    equal the one-process step's and JAX's on its mesh to 1e-4 of
    max|·|, and each int8 scale (one a last-axis row: the whole row's,
    where the model group splits the row) too; codes and the fp8 error
    as ``tests/test_torch_fsdp.py`` holds them (within one step, a
    counted few)."""
    from test_torch_fsdp import _extras_close
    _, arch, (d, _), _ = _cell(tag)
    got = _state(steps["out"] / tag)
    g = _npz(steps["out"] / f"{tag}_grads.npz")
    for want in (_state(steps["tmp"] / "one" / f"{arch}_{d}_True"),
                 _state(steps["tmp"] / f"jax_{tag}")):
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        _close(got, want, [k for k in got if k.startswith("params/")
                           or k.endswith("/s")])
        _extras_close(got, want, g)


def ckpt_tags(cells):
    return [c[0] for c in cells if c[0].endswith("_psum")]


@pytest.mark.parametrize("tag", step_tags(CELLS_1x2))
def test_grid_step_equals_one_process(steps, tag):
    """``check_one_process``."""
    check_one_process(steps, tag)


@pytest.mark.parametrize("tag", step_tags(CELLS_1x2))
def test_grid_serving_equals_one_process(steps, tag):
    """``check_serving``."""
    check_serving(steps, tag)


@pytest.mark.parametrize("tag", jax_tags(CELLS_1x2))
def test_grid_step_equals_jax_on_its_mesh(steps, tag):
    """``check_jax``."""
    check_jax(steps, tag)


@pytest.mark.parametrize("arch", MOE)
def test_the_two_combines_agree(steps, arch):
    """``check_combines``."""
    check_combines(steps, arch, "1x2")


@pytest.mark.parametrize("tag", extras_tags(CELLS_1x2))
def test_int8_moments_and_fp8_compression_on_a_grid(steps, tag):
    """``check_extras``."""
    check_extras(steps, tag)


@pytest.mark.parametrize("tag", ckpt_tags(CELLS_1x2))
def test_checkpoints_carry_jax_s_layout_both_ways(steps, tag):
    """``check_checkpoints``."""
    check_checkpoints(steps, tag)


def test_an_odd_vocabulary_pads_the_head(steps):
    """At V 257 and tp 2 the head is [d, 258], as JAX pads it: the pad
    column's logit is -1e30 and its gradient 0; the checkpoint carries
    the padded shape both ways."""
    tag = f"{ODD}_1x2_psum"
    g = _npz(steps["out"] / f"{tag}_grads.npz")
    assert g["lm_head"].shape == (64, 258)
    assert (g[".logits"][..., 257] <= -1e29).all()
    assert not g["lm_head"][:, 257].any()
    logs = json.loads((steps["out"] / "logs_1x2_r0.json").read_text())
    assert logs[tag]["shapes"]["lm_head"] == [64, 129]
    assert _state(steps["out"] / tag)["params/lm_head"].shape == (64, 258)


def test_batch_axes_all_splits_the_batch_over_every_rank(steps):
    """Under ``batch_axes="all"`` every rank is a data rank and no model
    collective runs; olmoe-1b-7b equals the one-process step at two
    microbatches (each rank routes its own tokens), where JAX's mesh step
    does not: its ``shard_map`` keeps expert parallelism over "model"
    while the tokens differ across it."""
    logs = json.loads((steps["out"] / "logs_1x2_r0.json").read_text())
    for arch in ("deepseek-7b", "olmoe-1b-7b"):
        assert logs[f"{arch}_1x2_all"]["model"] == []
    got = _npz(steps["out"] / "olmoe-1b-7b_1x2_all_grads.npz")
    one = steps["one"]["olmoe-1b-7b", 2, False]
    assert float(got.pop(".loss")) == pytest.approx(one["loss"], rel=1e-5)
    got.pop(".logits")
    _close(got, one["grads"])
    assert steps["jax_loss"]["olmoe-1b-7b_1x2_all"] != pytest.approx(
        one["loss"], rel=1e-4)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS
                                 if c[0].endswith("1x2_psum")
                                 and c[1] in ARCHS])
def test_the_model_group_logs_its_collectives(steps, tag):
    """Both ranks log the same collectives of the model group, a step's
    as ``sync.model_axis.step_log`` counts them per layer: for
    deepseek-7b's two layers, six all-reduces of attention (the combine,
    again in remat's recompute, the input's gradient) and four of the
    MLP (remat stops before its combine), and one gather and one
    reduce-scatter each of the embedding and the head."""
    from collections import Counter
    _, arch, _, _ = _cell(tag)
    logs = [json.loads((steps["out"] / f"logs_1x2_r{r}.json").read_text())
            for r in range(2)]
    assert logs[0][tag]["model"] == logs[1][tag]["model"]
    got = Counter(tuple(e) for e in logs[0][tag]["model"])
    model = TModel(tconfigs.get_smoke(arch), device="meta",
                   grid=tmesh.stand_in((1, 2)))
    want = {(kind, str(key)): n
            for (kind, key), n in model_axis.step_log(model).items()}
    assert dict(got) == want
    if arch == "deepseek-7b":
        assert want == {("all-reduce", "attn"): 6, ("all-reduce", "mlp"): 4,
                        ("all-gather", "('embed',)"): 1,
                        ("reduce-scatter", "('embed',)"): 1,
                        ("all-gather", "('head',)"): 1,
                        ("reduce-scatter", "('head',)"): 1}


def test_the_cli_trains_on_a_grid(tmp_path):
    """``torchrun --nproc_per_node=2 -m repro_torch.launch.train --device
    cpu --smoke --mesh 1x2`` takes two steps; a mesh that is not the
    world's size raises."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "repro_torch.launch.train",
           "--device", "cpu", "--smoke", "--steps", "2", "--batch", "4",
           "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")]
    res = subprocess.run(cmd + ["--mesh", "1x2"], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "as a 1x2 grid" in res.stdout and "done: 2 steps" in res.stdout
    bad = subprocess.run(cmd + ["--mesh", "2x2"], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "WORLD_SIZE" in bad.stderr


def test_seq_shard_stays_unported_on_a_grid():
    """A grid reads ``batch_axes`` and ``moe_combine``; ``seq_shard``
    still raises for an arch it is not ported for (deepseek-v3-671b: MLA
    and the MTP head), naming itself and the "model" axis."""
    import dataclasses
    cfg = tconfigs.get_smoke("deepseek-v3-671b")
    grid = tmesh.stand_in((1, 2))
    for kw in ({"batch_axes": "all"}, {"moe_combine": "psum_scatter"}):
        TModel(cfg, TRunConfig(**kw), device="meta", grid=grid)
    with pytest.raises(NotImplementedError, match="seq_shard") as err:
        TModel(cfg, dataclasses.replace(TRunConfig(), seq_shard=True),
               device="meta", grid=grid)
    assert "model" in str(err.value)
