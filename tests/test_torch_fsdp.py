"""The port's sharded training state (``RunConfig.fsdp``, ``sync.shard``)
against its replicated step and the JAX package's ``fsdp=True`` step, on
the CPU.

- The sharded names: at worlds 2 and 3 the port shards exactly the
  tensors that ``repro.launch.sharding.param_spec_for`` gives a data-axis
  entry, each rank holding whole last-axis rows.
- Two gloo ranks (subprocesses, as ``tests/test_torch_sync.py``) take one
  fp32 step of deepseek-7b, mamba2-130m and olmoe-1b-7b at smoke size,
  sharded and replicated, in both sync modes, with fp32 moments and
  again with int8 moments and fp8 compression.  Sharded equals
  replicated; both equal the one-process step, and JAX's ``fsdp=True``
  step on an Auto (2,1) mesh of two host devices, to 1e-4 of max|·| per
  tensor (loss, gathered gradients, parameters after AdamW).  The
  one-process step takes the batch as two microbatches of the ranks'
  halves: each rank routes its own tokens (its MoE capacity and aux
  loss), as each data shard of JAX's mesh does, and so does each
  microbatch.  Under int8 moments an element's code may part by one step
  from its counterpart's; such elements are counted.
- Checkpoints: written under fsdp, a train state has the keys, shapes
  and values of the replicated one (JAX's layout); it restores into a
  replicated port state and into JAX, and JAX's checkpoint restores into
  sharded ranks.
- The sync log: gathers in the forward and in remat's recompute, one
  reduce-scatter a repeat and dtype inside the bucketed backward.
"""
import dataclasses
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
import torch.distributed as dist
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import sharding as jsharding
from repro.launch import train as jtrain
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge, ckpt
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.optim import AdamW, AdamWConfig, compression
from repro_torch.sync import shard
from repro_torch.sync.overlap import GradSync

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
ARCHS = ["deepseek-7b", "mamba2-130m", "olmoe-1b-7b"]
B, S = 4, 16
# sharded leaves at world 2 (the JAX step's, read on its (2,1) mesh)
LEAVES_AT_2 = {"deepseek-7b": 8, "mamba2-130m": 5, "olmoe-1b-7b": 9}
EXTRAS = ("plain", "extras")         # fp32 moments; int8 + fp8


class _Ranks(shard.Comm):
    """``world`` ranks' sizes without a process group (no collective is
    called: the model is built on the meta device)."""

    def __init__(self, world: int, rank: int = 0):
        self.group, self.world, self.rank = None, world, rank


def _jax_sharded(cfg, world):
    """{dotted name: full shape} of the tensors JAX's rule gives a
    data-axis entry, on a stand-in mesh of ``world`` data ranks."""
    mesh = type("Mesh", (), {"shape": {"data": world, "model": 1},
                             "axis_names": ("data", "model")})()
    run = JRunConfig(fsdp=True)
    shapes = jax.eval_shape(JModel(cfg, run).init, jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = jsharding.param_spec_for(path, leaf.shape, cfg, run, mesh)
        if any(e == "data" or (isinstance(e, tuple) and "data" in e)
               for e in spec):
            out[".".join(jsharding._path_names(path))] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_sharded_names_are_jax_s(arch, world):
    """The names ``Model.shards`` holds at ``world`` ranks are those JAX
    shards over its data axis; each rank's slice is whole last-axis rows
    (the second-to-last axis divided by the world)."""
    want = _jax_sharded(jconfigs.get_smoke(arch), world)
    cfg = tconfigs.get_smoke(arch)
    model = TModel(cfg, TRunConfig(fsdp=True), dtype=torch.float32,
                   device="meta", group=_Ranks(world))
    assert set(model.shards.names) == set(want)
    whole = dict(TModel(cfg, dtype=torch.float32,
                        device="meta").named_parameters())
    for name, p in model.named_parameters():
        full = tuple(whole[name].shape)
        if name in want:
            assert full == want[name]
            assert tuple(p.shape) == full[:-2] + (full[-2] // world,
                                                  full[-1]), name
        else:
            assert tuple(p.shape) == full, name
    # what the rule names but the world does not divide stays whole
    assert set(shard.replicated(model)) == set(
        _jax_sharded(jconfigs.get_smoke(arch), 1)) - set(want)
    if world == 2 and arch in LEAVES_AT_2:
        assert len(want) == LEAVES_AT_2[arch]


def test_the_guard_leaves_an_undivided_tensor_whole():
    """chatglm3-6b's ``w_out`` [28, 13696, 4096] at 256 ranks: JAX shards
    its last axis; the port's axis, 13696, is not divided by 256, so it
    stays replicated and ``replicated`` lists it."""
    names = ("segments", "0", "0", "mlp", "w_out")
    assert shard.shard_axis(names, (28, 13696, 4096), 256) is None
    assert shard.shard_axis(names, (28, 13696, 4096), 2) == -2
    assert shard.shard_axis(("embed",), (65024, 4096), 2) is None
    assert shard.shard_axis(("segments", "0", "0", "ssm", "conv_w"),
                            (28, 4, 3072), 2) is None
    assert shard.shard_axis(("router",), (28, 64, 8), 2) is None
    assert shard.shard_axis(("segments", "0", "0", "moe", "router"),
                            (28, 64, 8), 2) == -2


# ----------------------------------------------------------------------
# one step: two gloo ranks, one process, JAX's (2,1) mesh
# ----------------------------------------------------------------------
def _run(extras: str, **kw) -> TRunConfig:
    x = extras == "extras"
    return TRunConfig(opt_8bit=x, grad_compression=x, **kw)


def _opt(extras: str) -> AdamW:
    return AdamW(AdamWConfig(state_8bit=extras == "extras"))


_WORKER = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import bridge, ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig, compression
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.runtime import LoopConfig, run_training

a = json.loads(sys.argv[1])
rank = a["rank"]
dist.init_process_group("gloo", init_method=a["init"], rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=120))
group = dist.group.WORLD


class Keep:
    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {bridge._key(k): bridge.whole(params, k, g).clone()
                      for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def state_of(m, x):
    opt = Keep(AdamW(AdamWConfig(state_8bit=x)))
    state = {"params": m, "opt": opt.init(m)}
    if x:
        state["err"] = compression.init_error_state(m)
    return opt, state


logs = {}
for arch in a["archs"]:
    cfg = configs.get_smoke(arch)
    tokens = torch.from_numpy(np.load(f"{a['dir']}/{arch}/tokens.npy")).long()
    flat = bridge.load_npz(f"{a['dir']}/{arch}/params/step_00000000")
    for extras in ("plain", "extras"):
        x = extras == "extras"
        for fsdp in (False, True):
            for mode in ("barrier", "bucketed"):
                tag = f"{arch}/{extras}/{'fsdp' if fsdp else 'rep'}/{mode}"
                run = RunConfig(fsdp=fsdp, sync_mode=mode, opt_8bit=x,
                                grad_compression=x)
                m = Model(cfg, run, dtype=torch.float32, device="cpu",
                          group=group)
                bridge.from_flat(flat, m)
                opt, state = state_of(m, x)
                step = train.make_train_step(m, opt, run, group)
                state, metrics = step(state, {"tokens": tokens})
                out = {k: g.numpy() for k, g in opt.grads.items()}
                out[".loss"] = metrics["loss"].numpy()
                np.savez(f"{a['out']}/{tag.replace('/', '_')}_r{rank}.npz",
                         **out)
                if fsdp or rank == 0:   # sharded: every rank gathers
                    ckpt.save(f"{a['out']}/{tag}", 1, state)
                logs[tag] = [s.log for s in step.syncs]
        # JAX's state after its fsdp step, restored into sharded ranks
        # and saved again
        m = Model(cfg, RunConfig(fsdp=True, opt_8bit=x, grad_compression=x),
                  dtype=torch.float32, device="cpu", group=group)
        _, state = state_of(m, x)
        ckpt.restore(f"{a['dir']}/{arch}/jax_{extras}", 1, state)
        ckpt.save(f"{a['out']}/{arch}/{extras}/from_jax", 1, state)
    # a plain backward, no GradSync: each sharded gradient is the sum of
    # the ranks' (the gather's adjoint), reduce-scattered into the rows
    m = Model(cfg, RunConfig(fsdp=True), dtype=torch.float32, device="cpu",
              group=group)
    bridge.from_flat(flat, m)
    half = tokens.shape[0] // 2
    m.loss({"tokens": tokens[rank * half:(rank + 1) * half]})[0].backward()
    np.savez(f"{a['out']}/{arch}_plain_backward_r{rank}.npz",
             **{bridge._key(n): bridge.whole(m, n, p.grad).numpy()
                for n, p in m.named_parameters() if n in m.shards})
    # serving, sharded: a forward, a one-call prefill and a decode step
    m = Model(cfg, RunConfig(fsdp=True), dtype=torch.float32, device="cpu",
              group=group)
    bridge.from_flat(flat, m)
    with torch.no_grad():
        caches = m.init_cache(tokens.shape[0], tokens.shape[1] + 1)
        _, caches = m.decode_step(caches, tokens, 0)
        np.savez(f"{a['out']}/{arch}_serve_r{rank}.npz",
                 forward=m.forward({"tokens": tokens}).numpy(),
                 decode=m.decode_step(caches, tokens[:, -1:],
                                      tokens.shape[1])[0].numpy())
    if arch == "deepseek-7b":
        # run_training, sharded: every rank takes part in each save, each
        # restores its own rows after the injected failure
        run = RunConfig(fsdp=True)
        m = Model(cfg, run, dtype=torch.float32, device="cpu", group=group)
        opt = AdamW(AdamWConfig())

        def init():
            bridge.from_flat(flat, m)
            return {"params": m, "opt": opt.init(m)}
        seen = []
        summary = run_training(
            LoopConfig(total_steps=5, ckpt_dir=f"{a['out']}/drill",
                       ckpt_every=2, fail_at_step=3),
            train_step=train.make_train_step(m, opt, run, group),
            init_state=init,
            batch_at=SyntheticLM(DataConfig(cfg.vocab_size, 16, 4),
                                 "cpu").batch_at,
            on_step=lambda s, mt: seen.append((s, float(mt["loss"]))),
            group=group)
        logs["drill"] = {"seen": seen, "restarts": summary["restarts"]}
with open(f"{a['out']}/logs_r{rank}.json", "w") as f:
    json.dump(logs, f)
dist.destroy_process_group()
"""

_JAX_FSDP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.launch.train import make_train_step, state_shardings
from repro.models import Model
from repro.optim import AdamW, AdamWConfig, compression

a = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
losses = {}
for arch in a["archs"]:
    cfg = configs.get_smoke(arch)
    d = f"{a['dir']}/{arch}"
    tokens = jnp.asarray(np.load(f"{d}/tokens.npy"))
    for extras in ("plain", "extras"):
        x = extras == "extras"
        run = RunConfig(fsdp=True, remat=False, attn_impl="xla",
                        opt_8bit=x, grad_compression=x)
        jm = Model(cfg, run, mesh=mesh, dtype=jnp.float32)
        opt = AdamW(AdamWConfig(state_8bit=x))
        params = ckpt.restore(f"{d}/params", 0,
                              jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        state = {"params": params, "opt": opt.init(params)}
        if x:
            state["err"] = compression.init_error_state(params)
        state = jax.device_put(state, state_shardings(
            jax.eval_shape(lambda: state), cfg, run, mesh))
        with mesh:
            state, metrics = jax.jit(make_train_step(jm, opt, run))(
                state, {"tokens": tokens})
        ckpt.save(f"{d}/jax_{extras}", 1, state)
        losses[f"{arch}/{extras}"] = float(metrics["loss"])
print(json.dumps(losses))
"""


def _subprocess_env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _two_ranks(tmp, archs):
    """``_WORKER`` on two gloo ranks (a file store); each process has its
    own timeout, and a failed or hung rank fails the test."""
    out = tmp / "ranks"
    out.mkdir()
    procs = []
    for rank in range(2):
        arg = json.dumps({"rank": rank, "init": f"file://{tmp / 'store'}",
                          "archs": archs, "dir": str(tmp),
                          "out": str(out)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, arg], env=_subprocess_env(),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=400)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e[-3000:] for e in errs]
    return out


def _one_process(cfg, flat, tokens, extras, out):
    """The replicated step in this process over the whole batch, as two
    microbatches of the ranks' halves: its loss and gradients; its state
    saved under ``out``."""
    run = _run(extras, microbatches=2)
    m = TModel(cfg, run, dtype=torch.float32, device="cpu")
    bridge.from_flat(flat, m)
    opt = _opt(extras)
    kept = {}

    class Keep:
        def init(self, params):
            return opt.init(params)

        def update(self, grads, state, params):
            kept.update({bridge._key(k): g.numpy().copy()
                         for k, g in grads.items()})
            return opt.update(grads, state, params)

    state = {"params": m, "opt": opt.init(m)}
    if extras == "extras":
        state["err"] = compression.init_error_state(m)
    step = ttrain.make_train_step(m, Keep(), run)
    state, metrics = step(state,
                          {"tokens": torch.from_numpy(tokens).long()})
    ckpt.save(str(out), 1, state)
    return float(metrics["loss"]), kept


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every side's one step from JAX's seeded init of each arch: JAX's
    fsdp step (a subprocess on two host devices), the two ranks' eight
    configurations (sharded or not, each sync mode, plain or extras) and
    the one-process step."""
    tmp = tmp_path_factory.mktemp("fsdp")
    for i, arch in enumerate(ARCHS):
        cfg = jconfigs.get_smoke(arch)
        jm = JModel(cfg, JRunConfig(remat=False, attn_impl="xla"),
                    dtype=jnp.float32)
        jckpt.save(str(tmp / arch / "params"), 0,
                   jm.init(jax.random.PRNGKey(3)))
        np.save(tmp / arch / "tokens.npy", np.random.default_rng(i).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
    res = subprocess.run(
        [sys.executable, "-c", _JAX_FSDP, json.dumps({
            "archs": ARCHS, "dir": str(tmp)})],
        env=_subprocess_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_loss = json.loads(res.stdout.strip().splitlines()[-1])
    ranks = _two_ranks(tmp, ARCHS)
    one = {}
    for arch in ARCHS:
        flat = bridge.load_npz(str(tmp / arch / "params" / "step_00000000"))
        tokens = np.load(tmp / arch / "tokens.npy")
        for extras in EXTRAS:
            one[arch, extras] = _one_process(
                tconfigs.get_smoke(arch), flat, tokens, extras,
                tmp / "one" / arch / extras)
    return {"tmp": tmp, "ranks": ranks, "jax_loss": jax_loss, "one": one}


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _state(steps, *parts) -> dict:
    """A saved train state's arrays: ``parts`` under the ranks' output
    (``arch, extras, fsdp|rep, mode``), or ("one", arch, extras), or
    ("jax", arch, extras)."""
    tmp = steps["tmp"]
    if parts[0] == "one":
        d = tmp / "one" / parts[1] / parts[2]
    elif parts[0] == "jax":
        d = tmp / parts[1] / f"jax_{parts[2]}"
    else:
        d = steps["ranks"].joinpath(*parts)
    return _npz(d / "step_00000001" / "arrays.npz")


def _grads(steps, arch, extras, kind, mode, rank=0) -> dict:
    return _npz(steps["ranks"] / f"{arch}_{extras}_{kind}_{mode}_r{rank}.npz")


def _close(got: dict, want: dict, keys=None, tol: float = TOL):
    """Every tensor within ``tol`` of its max|want| (and relative)."""
    for key in keys if keys is not None else want:
        w = np.asarray(want[key], dtype=np.float64)
        np.testing.assert_allclose(got[key], w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=key)


def _extras_close(got: dict, want: dict, grads: dict):
    """Two states after one step with int8 moments and fp8 compression
    (as ``chip_smoke.py`` phase 13 holds them): the error accumulator's
    elements outside 1e-4 are each within one fp8 step of the
    compressed gradient (|g|/8 + 2^-9 of its scale: ``g`` is ``grads``,
    the decompressed gradient, plus ``got``'s error) and at most 1e-2 of
    all; int8 moment codes part by at most 127 // 8, and at most 1e-2 of
    them part at all."""
    over, size = 0, 0
    for key in (k for k in want if k.startswith("err/")):
        g32 = grads[key[len("err/"):]] + got[key]
        step = np.abs(g32) / 8 + np.abs(g32).max() / 448 * 2.0 ** -9
        d, w = np.abs(got[key] - want[key]), np.abs(want[key])
        out = d > TOL * w.max() + TOL * w
        assert (d[out] <= step[out]).all(), key
        over, size = over + int(out.sum()), size + w.size
    assert over <= 1e-2 * size
    codes = [k for k in want if k.endswith("/q")]
    diff = [np.abs(got[k].astype(int) - want[k].astype(int)) for k in codes]
    assert max(int(d.max()) for d in diff) <= 127 // 8
    assert sum(int((d > 0).sum()) for d in diff) <= 1e-2 * sum(
        d.size for d in diff)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_sharded_ranks_equal_replicated_one_process_and_jax(steps, arch):
    """One step on two gloo ranks, in both sync modes, with fp32 moments
    and with int8 moments and fp8 compression: the ranks' gathered
    gradients equal each other's and the replicated ranks' bit for bit;
    loss, gradients and parameters after AdamW equal the one-process
    step's and JAX's ``fsdp=True`` step's to 1e-4 of max|·| (its moments
    too, in fp32; int8 codes and the fp8 error counted)."""
    for extras in EXTRAS:
        loss, one_grads = steps["one"][arch, extras]
        one = _state(steps, "one", arch, extras)
        jx = _state(steps, "jax", arch, extras)
        assert loss == pytest.approx(steps["jax_loss"][f"{arch}/{extras}"],
                                     rel=1e-5)
        for mode in ("barrier", "bucketed"):
            g = _grads(steps, arch, extras, "fsdp", mode)
            for other in (_grads(steps, arch, extras, "fsdp", mode, 1),
                          _grads(steps, arch, extras, "rep", mode)):
                assert g.keys() == other.keys()
                for k in g:
                    np.testing.assert_array_equal(g[k], other[k], err_msg=k)
            assert float(g.pop(".loss")) == pytest.approx(loss, rel=1e-5)
            _close(g, one_grads)
            got = _state(steps, arch, extras, "fsdp", mode)
            params = [k for k in got if k.startswith("params/")]
            _close(got, one, params)
            _close(got, jx, params)
            if extras == "plain":
                _close(got, jx, [k for k in got if k.startswith("opt/")
                                 and k != "opt/step"])
            else:
                _extras_close(got, one, g)
                _extras_close(got, jx, g)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_equals_one_process(steps, arch):
    """``forward``, a one-call prefill and a decode step of the sharded
    model (each repeat's rows gathered, no gradient) give the replicated
    model's logits, bit for bit."""
    cfg = tconfigs.get_smoke(arch)
    tmp = steps["tmp"]
    m = TModel(cfg, TRunConfig(), dtype=torch.float32, device="cpu")
    bridge.from_flat(bridge.load_npz(str(tmp / arch / "params"
                                         / "step_00000000")), m)
    tokens = torch.from_numpy(np.load(tmp / arch / "tokens.npy")).long()
    with torch.no_grad():
        caches = m.init_cache(B, S + 1)
        _, caches = m.decode_step(caches, tokens, 0)
        want = {"forward": m.forward({"tokens": tokens}).numpy(),
                "decode": m.decode_step(caches, tokens[:, -1:], S)[0].numpy()}
    for rank in range(2):
        got = _npz(steps["ranks"] / f"{arch}_serve_r{rank}.npz")
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _jax_target(arch, extras):
    """The shapes of JAX's train state for ``arch`` (smoke, fp32)."""
    x = extras == "extras"
    run = JRunConfig(opt_8bit=x, grad_compression=x)
    jm = JModel(jconfigs.get_smoke(arch), run, dtype=jnp.float32)
    opt = JAdamW(JAdamWConfig(state_8bit=x))
    return jax.eval_shape(lambda: jtrain.init_train_state(
        jm, opt, run, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_checkpoint_is_the_replicated_layout(steps, arch, tmp_path):
    """A train state saved by two sharded ranks has the keys and shapes of
    the replicated ranks', the one process's and JAX's, and their values
    to 1e-4 (int8 codes within one step); it restores into a replicated
    port state (saved again: the same bytes) and into JAX (the same
    values); JAX's state restores into sharded ranks (saved again by
    them: JAX's bytes)."""
    for extras in EXTRAS:
        got = _state(steps, arch, extras, "fsdp", "bucketed")
        rep = _state(steps, arch, extras, "rep", "bucketed")
        for other in (rep, _state(steps, "one", arch, extras),
                      _state(steps, "jax", arch, extras)):
            assert {k: v.shape for k, v in got.items()} == {
                k: v.shape for k, v in other.items()}
        floats = [k for k, v in rep.items() if v.dtype == np.float32]
        _close(got, rep, floats)
        for k in (k for k, v in rep.items() if v.dtype == np.int8):
            assert np.abs(got[k].astype(int) - rep[k]).max() <= 1, k
        # into a replicated port state, and out again
        run = _run(extras)
        m = TModel(tconfigs.get_smoke(arch), run, dtype=torch.float32,
                   device="cpu")
        opt = _opt(extras)
        state = ttrain.init_train_state(m, opt, run,
                                        torch.Generator().manual_seed(5))
        src = steps["ranks"] / arch / extras / "fsdp" / "bucketed"
        ckpt.restore(str(src), 1, state)
        ckpt.save(str(tmp_path / extras), 1, state)
        again = _npz(tmp_path / extras / "step_00000001" / "arrays.npz")
        assert again.keys() == got.keys()
        for k in got:
            np.testing.assert_array_equal(again[k], got[k], err_msg=k)
        # into JAX
        restored = jckpt._flatten(jckpt.restore(str(src), 1,
                                                _jax_target(arch, extras)))
        assert restored.keys() == got.keys()
        for k in got:
            np.testing.assert_array_equal(restored[k], got[k], err_msg=k)
        # JAX's, into sharded ranks and out again
        jx = _state(steps, "jax", arch, extras)
        back = _npz(steps["ranks"] / arch / extras / "from_jax"
                    / "step_00000001" / "arrays.npz")
        assert back.keys() == jx.keys()
        for k in jx:
            np.testing.assert_array_equal(back[k], jx[k], err_msg=k)


def _fsdp_log(repeats: int, head: bool, mode: str) -> list:
    """One fp32 backward's ``GradSync.log`` under fsdp with remat: the
    forward gathers each repeat's rows (and the untied head); bucketed,
    the head's reduce-scatter, then each repeat's backward start, its
    recompute's gather, its replicated rows' all-reduce and its sharded
    rows' reduce-scatter; after the backward one all-reduce of what no
    repeat covers.  Barrier: the recompute's gathers inside the backward,
    every collective after it (a reduce-scatter a gather, in the
    backward's order, then an all-reduce)."""
    log = [["gather", [0, r]] for r in range(repeats)]
    log += [["gather", ["head"]]] if head else []
    if mode == "barrier":
        log += [["gather", [0, r]] for r in reversed(range(repeats))]
        return log + [["end"]] + [["after"]] * (repeats + head + 1)
    log += [["scatter", ["head"]]] if head else []
    for r in reversed(range(repeats)):
        log += [["backward", [0, r]], ["gather", [0, r]], ["issue", [0, r]],
                ["scatter", [0, r]]]
    return log + [["end"], ["after"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_sync_log(steps, arch):
    """The two ranks' logs of each sharded step (one ``GradSync``): the
    gathers in the forward and in remat's recompute, one reduce-scatter a
    repeat and dtype inside the bucketed backward, between the start of
    that repeat's backward and the next lower one's."""
    cfg = tconfigs.get_smoke(arch)
    logs = [json.loads((steps["ranks"] / f"logs_r{r}.json").read_text())
            for r in range(2)]
    assert logs[0] == logs[1]
    for extras in EXTRAS:
        for mode in ("barrier", "bucketed"):
            got = logs[0][f"{arch}/{extras}/fsdp/{mode}"]
            assert got == [_fsdp_log(cfg.n_layers, not cfg.tie_embeddings,
                                     mode)]


@pytest.mark.parametrize("field,value", [
    ("batch_axes", "all"), ("moe_combine", "psum_scatter"),
    ("seq_shard", True)])
def test_fields_that_need_a_model_axis_still_raise(field, value):
    """``fsdp`` builds (one process: the whole model, nothing sharded);
    the three fields that place work on JAX's "model" axis raise, naming
    themselves (``seq_shard`` for an arch it is not ported for,
    deepseek-v3-671b)."""
    cfg = tconfigs.get_smoke("deepseek-v3-671b" if field == "seq_shard"
                             else "deepseek-7b")
    model = TModel(cfg, TRunConfig(fsdp=True), device="cpu")
    assert model.run.fsdp and not model.shards
    run = dataclasses.replace(TRunConfig(fsdp=True), **{field: value})
    with pytest.raises(NotImplementedError, match=field) as err:
        TModel(cfg, run, device="cpu")
    assert "model" in str(err.value)


def test_make_train_step_takes_the_model_s_group():
    """A sharded model's step over another group, or a model built
    without ``fsdp`` stepped with it, raises: there is no silent
    replicated path."""
    cfg = tconfigs.get_smoke("deepseek-7b")
    model = TModel(cfg, TRunConfig(fsdp=True), dtype=torch.float32,
                   device="meta", group=_Ranks(2))
    with pytest.raises(ValueError, match="fsdp"):
        ttrain.make_train_step(model, AdamW(), TRunConfig(fsdp=True), None)
    with pytest.raises(ValueError, match="fsdp"):
        ttrain.make_train_step(TModel(cfg, device="meta"), AdamW(),
                               TRunConfig(fsdp=True), None)


def test_sharded_run_training_restarts_from_rank_0_s_checkpoint(steps):
    """deepseek-7b's two sharded ranks through ``run_training`` with a
    failure injected at step 3: every rank takes part in each save (rank
    0 writes), both restore their rows from step 1's checkpoint and
    replay step 2 with the first pass's loss."""
    logs = [json.loads((steps["ranks"] / f"logs_r{r}.json").read_text())
            for r in range(2)]
    drill = logs[0]["drill"]
    assert drill == logs[1]["drill"] and drill["restarts"] == 1
    seen = drill["seen"]
    assert [s for s, _ in seen] == [0, 1, 2, 2, 3, 4]
    assert seen[2][1] == seen[3][1]
    assert sorted(os.listdir(steps["ranks"] / "drill")) == [
        "step_00000001", "step_00000003", "step_00000004"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_plain_backward_sums_over_the_ranks(steps, arch):
    """Without a ``GradSync`` the gather's backward is its adjoint: each
    sharded tensor's gradient is reduce-scattered, the sum of the two
    ranks' (half the batch each), so it is twice the synced step's mean
    (fp32 moments, bucketed), to 1e-4 of max|g|."""
    want = _grads(steps, arch, "plain", "fsdp", "bucketed")
    for rank in range(2):
        got = _npz(steps["ranks"] / f"{arch}_plain_backward_r{rank}.npz")
        assert len(got) == LEAVES_AT_2[arch]
        _close({k: v / 2 for k, v in got.items()}, want, list(got))


@pytest.mark.parametrize("fsdp", [False, True])
def test_the_step_does_not_hold_its_model(fsdp):
    """``make_train_step``'s closures (``train_step.syncs`` ties them into
    a cycle) must not reach the model: dropped, the model is freed at
    once, not at the collector's next pass, so that a program stepping
    one model after another does not hold the last one's parameters."""
    import gc
    import weakref
    cfg = tconfigs.get_smoke("deepseek-7b")
    run = TRunConfig(fsdp=fsdp, grad_compression=True)
    model = TModel(cfg, run, dtype=torch.float32, device="cpu")
    opt = AdamW(AdamWConfig())
    state = ttrain.init_train_state(model, opt, run,
                                    torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(model, opt, run)
    state, _ = step(state, {"tokens": torch.zeros((2, 8), dtype=torch.long)})
    alive = weakref.ref(model)
    gc.disable()
    try:
        del model, state
        assert alive() is None
    finally:
        gc.enable()
    assert step.syncs
