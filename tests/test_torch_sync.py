"""The port's MXDAG-planned gradient sync against the JAX package's, on
the CPU.

- ``sync.plan``: with JAX's constants the port's ``plan_sync`` is JAX's,
  field for field; on the H100 constants it keeps the reference's
  properties (``tests/test_sync.py`` ``TestPlan``).
- ``sync.overlap``: bucketed gradients equal barrier gradients (1e-4, as
  ``tests/test_sync.py:55``) and JAX's, in one process and across two gloo
  ranks in subprocesses; bucketed mode issues one collective per repeat
  inside the backward, barrier mode one after it.
- ``runtime.fault``: ``StepMonitor``'s attribution and ``recovery_drill``
  give JAX's results; ``run_training`` on two ranks restarts both from
  rank 0's checkpoint.
- MoE under data parallelism: each rank routes its own tokens (its
  capacity and load-balancing loss), as JAX's step on a (2,1) data × model
  mesh routes each data shard, and the two steps agree; the mesh-less
  one-process step, which routes the whole batch, differs by the aux loss
  (measured below).

JAX's bucketed path needs a mesh whose axes are Auto (jax 0.9.0 types
``jax.make_mesh``'s axes Explicit, which the JAX model's sharding
constraints refuse), so the tests build their 1×1 and 2×1 meshes so.
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
from repro.configs.base import SHAPES as JSHAPES
from repro.core import builders as jbuilders
from repro.core.nemesis import Fault as JFault
from repro.core.schedule import MXDAGScheduler as JScheduler
from repro.launch import hlo_analysis
from repro.models import Model as JModel
from repro.runtime import fault as jfault
from repro.sync import plan as jplan
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core import builders as tbuilders
from repro_torch.core.nemesis import Fault as TFault
from repro_torch.core.schedule import MXDAGScheduler as TScheduler
from repro_torch.launch import train as ttrain
from repro_torch.launch.roofline import H100, Hardware
from repro_torch.models import Model as TModel
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import fault as tfault
from repro_torch.sync import plan as tplan
from repro_torch.sync.overlap import GradSync

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4                                  # tests/test_sync.py:55
ARCHS = ["deepseek-7b", "olmoe-1b-7b", "mamba2-130m"]
# the JAX package's roofline constants (TPU v5e), as a Hardware
JAX_HW = Hardware("TPU v5e (the JAX package)", hlo_analysis.PEAK_FLOPS,
                  hlo_analysis.HBM_BW, hlo_analysis.HBM_PER_CHIP,
                  hlo_analysis.ICI_BW, hlo_analysis.ICI_BW)


# ----------------------------------------------------------------------
# plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-coder-33b",
                                  "olmoe-1b-7b"])
def test_plan_with_jax_constants_is_jax_plan(arch):
    """JAX's scale (256 chips, tp 16) and constants: the same plan,
    exactly, and the same per-layer times."""
    want = jplan.plan_sync(jconfigs.get(arch), JSHAPES["train_4k"])
    got = tplan.plan_sync(tconfigs.get(arch), TSHAPES["train_4k"], tp=16,
                          hw=JAX_HW)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.predicted_speedup == want.predicted_speedup
    assert tplan._per_layer_times(tconfigs.get(arch), TSHAPES["train_4k"],
                                  256, 16, JAX_HW) == \
        jplan._per_layer_times(jconfigs.get(arch), JSHAPES["train_4k"],
                               256, 16)


def test_h100_constants_are_the_data_sheet_s():
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes, H100.nvlink_bw,
            H100.dp_link_bw) == (989e12, 3.35e12, 80e9, 450e9, 50e9)


class TestPlanOnH100:
    """Twins of ``tests/test_sync.py`` ``TestPlan`` at the port's
    production scale: 256 H100s, tp 8, the dp sync between nodes."""

    @pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-coder-33b"])
    def test_order_is_lower_layer_first(self, arch):
        plan = tplan.plan_sync(tconfigs.get(arch), TSHAPES["train_4k"])
        idx = [int(name[4:]) for name in plan.order]
        assert idx == sorted(idx) == list(range(tconfigs.get(arch).n_layers))

    def test_bucketed_predicted_when_comm_bound(self):
        plan = tplan.plan_sync(tconfigs.get("deepseek-coder-33b"),
                               TSHAPES["train_4k"])
        assert plan.mode == "bucketed"
        assert plan.predicted_speedup > 1.0

    def test_plan_reports_both_predictions(self):
        for arch in ("deepseek-7b", "olmoe-1b-7b"):
            plan = tplan.plan_sync(tconfigs.get(arch), TSHAPES["train_4k"])
            assert plan.predicted_bucketed > 0
            assert plan.predicted_barrier > 0
            assert plan.predicted_bucketed <= plan.predicted_barrier + 1e-9

    def test_a_faster_link_shrinks_the_sync_not_the_compute(self):
        cfg, shape = tconfigs.get("deepseek-7b"), TSHAPES["train_4k"]
        fast = dataclasses.replace(H100, dp_link_bw=H100.nvlink_bw)
        a = tplan._per_layer_times(cfg, shape, 256, 8, H100)
        b = tplan._per_layer_times(cfg, shape, 256, 8, fast)
        assert a[:2] == b[:2] and b[2] == pytest.approx(a[2] * 50 / 450)


# ----------------------------------------------------------------------
# overlap, one process
# ----------------------------------------------------------------------
def _jax_model_and_params(cfg_j, run_j, tmp_path, mesh=None):
    jm = JModel(cfg_j, run_j, mesh=mesh, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3))
    return jm, params, jckpt.save(str(tmp_path), 0, params)


def _port_model(cfg_t, run_t, step_dir):
    tm = TModel(cfg_t, run_t, dtype=torch.float32, device="cpu")
    bridge.from_flat(bridge.load_npz(step_dir), tm)
    return tm


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_sync_grads(tm, tokens, group=None):
    """(loss, {key: grad}, the GradSync's log) of one backward."""
    sync = GradSync(group)
    loss, _ = tm.loss({"tokens": torch.from_numpy(tokens).long()}, sync)
    plist = list(tm.parameters())
    grads = sync.finish(plist, torch.autograd.grad(
        loss, plist, materialize_grads=True))
    keys = [bridge._key(n) for n, _ in tm.named_parameters()]
    return (float(loss.detach()), {k: g.numpy() for k, g in zip(keys, grads)},
            sync.log)


def _close(got: dict, want: dict, tol: float = TOL):
    """Every tensor within ``tol`` of its max|want| (and relative)."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_grads_match_barrier_and_jax(arch, tmp_path):
    """Twin of ``tests/test_sync.py::test_bucketed_grads_match_barrier``
    (fp32, remat off, B 2 × S 16): the port's bucketed gradients equal its
    barrier ones to 1e-4, over a gloo group of one (a real collective,
    the identity) and with none; and JAX's bucketed gradients (its synced
    scan on a 1×1 mesh) to 1e-4 of max|g|."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jm, params, step_dir = _jax_model_and_params(
        jconfigs.get_smoke(arch),
        JRunConfig(sync_mode="bucketed", remat=False, attn_impl="xla"),
        tmp_path, mesh)
    assert jm._grad_sync_fn() is not None
    tokens = _tokens(jm.cfg, 2, 16, seed=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens)})[0]))(params)
    one = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    out = {}
    for mode in ("barrier", "bucketed"):
        for group in (None, one):
            tm = _port_model(tconfigs.get_smoke(arch),
                             TRunConfig(sync_mode=mode, remat=False),
                             step_dir)
            out[mode, group is None] = _port_sync_grads(tm, tokens, group)
    loss, want, _ = out["barrier", True]
    for (mode, _), (got_loss, got, log) in out.items():
        assert got_loss == pytest.approx(loss, rel=1e-5)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{mode} {key}")
        assert any(e[0] == "issue" for e in log) == (mode == "bucketed")
    assert out["bucketed", False][0] == pytest.approx(float(jloss), rel=1e-5)
    _close(out["bucketed", False][1], jckpt._flatten(jgrads))


def _expected_log(repeats: int) -> list:
    """Bucketed: repeat r's collective between the start of its backward
    and the start of the backward of the repeat below it; one more after
    the backward for what no repeat covers."""
    return [e for r in reversed(range(repeats))
            for e in (("backward", (0, r)), ("issue", (0, r)))] \
        + [("end",), ("after",)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-130m"])
def test_bucketed_issues_one_collective_per_repeat_inside_the_backward(
        arch, remat):
    """At 6 layers (fp32: one bucket a repeat), over a gloo group of one:
    each repeat's collective is issued exactly once a backward, after its
    own backward starts and before the next lower repeat's does, with
    remat (whose recompute runs the bucket's forward again) as without;
    barrier mode issues one collective, after the backward.  Through
    ``make_train_step`` the same, one ``GradSync`` a step."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), n_layers=6)
    tokens = _tokens(cfg, 2, 16, seed=1)
    one = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    for mode, want in (("bucketed", _expected_log(6)),
                       ("barrier", [("end",), ("after",)])):
        run = TRunConfig(sync_mode=mode, remat=remat)
        tm = TModel(cfg, run, dtype=torch.float32, device="cpu").init(
            torch.Generator().manual_seed(0))
        assert _port_sync_grads(tm, tokens, one)[2] == want
        opt = AdamW(AdamWConfig())
        step = ttrain.make_train_step(tm, opt, run, one)
        state = {"params": tm, "opt": opt.init(tm)}
        for i in range(2):
            state, _ = step(state, {"tokens": torch.from_numpy(
                _tokens(cfg, 2, 16, seed=i)).long()})
            assert [s.log for s in step.syncs] == [want]


def test_world_must_divide_the_batch():
    cfg = tconfigs.get_smoke("deepseek-7b")
    tm = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    opt = AdamW(AdamWConfig())

    class _Two:                      # the shape of a two-rank group
        def rank(self):
            return 0

        def size(self):
            return 2
    step = ttrain.make_train_step(tm, opt, TRunConfig(), _Two())
    with pytest.raises(ValueError, match="2 data-parallel ranks"):
        step({"params": tm, "opt": opt.init(tm)},
             {"tokens": torch.zeros((3, 8), dtype=torch.long)})


# ----------------------------------------------------------------------
# overlap and run_training, two gloo ranks in subprocesses
# ----------------------------------------------------------------------
_WORKER = r"""
import dataclasses, datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import LoopConfig, run_training

a = json.loads(sys.argv[1])
rank = a["rank"]
dist.init_process_group("gloo", init_method=a["init"], rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=60))
group = dist.group.WORLD
cfg = dataclasses.replace(configs.get_smoke(a["arch"]), **a["replace"])
tokens = torch.from_numpy(np.load(a["tokens"])).long()


class Keep:
    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {bridge._key(k): g.detach().clone()
                      for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def model(run):
    m = Model(cfg, run, dtype=torch.float32, device="cpu")
    bridge.from_flat(bridge.load_npz(a["params"]), m)
    return m


out, logs = {}, {}
for mode in ("barrier", "bucketed"):
    run = RunConfig(sync_mode=mode)
    m, opt = model(run), Keep(AdamW(AdamWConfig()))
    step = train.make_train_step(m, opt, run, group)
    _, metrics = step({"params": m, "opt": opt.init(m)}, {"tokens": tokens})
    out.update({f"{mode}/{k}": g.numpy() for k, g in opt.grads.items()})
    out[f"{mode}/.loss"] = metrics["loss"].numpy()
    logs[mode] = [s.log for s in step.syncs]
np.savez(f"{a['out']}/rank{rank}.npz", **out)
drill = None
if a["drill"]:
    run = RunConfig()
    m, opt = model(run), AdamW(AdamWConfig())
    seen = []
    summary = run_training(
        LoopConfig(total_steps=5, ckpt_dir=a["ckpt"], ckpt_every=2,
                   fail_at_step=3),
        train_step=train.make_train_step(m, opt, run, group),
        init_state=lambda: {"params": model(run), "opt": opt.init(m)},
        batch_at=SyntheticLM(DataConfig(cfg.vocab_size, 16, 4), "cpu"
                             ).batch_at,
        on_step=lambda s, mt: seen.append((s, float(mt["loss"]))),
        group=group)
    drill = {"seen": seen, "restarts": summary["restarts"]}
with open(f"{a['out']}/rank{rank}.json", "w") as f:
    json.dump({"logs": logs, "drill": drill}, f)
dist.destroy_process_group()
"""


def _two_ranks(tmp_path, arch, tokens, step_dir, *, replace=None,
               drill=False):
    """Run ``_WORKER`` on two gloo ranks (a file store, no port); each
    process has its own timeout, and a failed or hung rank fails the
    test.  Returns each rank's (gradients, json)."""
    out = tmp_path / "out"
    out.mkdir()
    np.save(tmp_path / "tokens.npy", tokens)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(2):
        arg = json.dumps({
            "rank": rank, "init": f"file://{tmp_path / 'store'}",
            "arch": arch, "replace": replace or {},
            "tokens": str(tmp_path / "tokens.npy"), "params": step_dir,
            "out": str(out), "drill": drill,
            "ckpt": str(tmp_path / "ckpt")})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, arg], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    return [(dict(np.load(out / f"rank{r}.npz")),
             json.loads((out / f"rank{r}.json").read_text()))
            for r in range(2)]


def _modes(grads: dict) -> dict:
    """{mode: {key: grad}} of a worker's npz."""
    out = {}
    for k, v in grads.items():
        mode, key = k.split("/", 1)
        out.setdefault(mode, {})[key] = v
    return out


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-130m"])
def test_two_gloo_ranks_equal_each_other_and_jax_full_batch(arch, tmp_path):
    """Two ranks, B 4 × S 16 split 2 and 2, fp32, remat on: after the sync
    both ranks hold bitwise-equal gradients and loss; bucketed equals
    barrier to 1e-4; both equal JAX's one-device gradients of the whole
    batch to 1e-4 of max|g|.  Bucketed issues its collectives inside the
    backward (one a repeat), barrier one after.  deepseek-7b's ranks also
    take an injected failure: both restart from rank 0's checkpoint and
    replay step 2 with the first pass's loss."""
    jm, params, step_dir = _jax_model_and_params(
        jconfigs.get_smoke(arch), JRunConfig(remat=False, attn_impl="xla"),
        tmp_path / "jax")
    tokens = _tokens(jm.cfg, 4, 16, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens)})[0]))(params)
    drill = arch == "deepseek-7b"
    (g0, j0), (g1, j1) = _two_ranks(tmp_path, arch, tokens, step_dir,
                                    drill=drill)
    assert g0.keys() == g1.keys()
    for key in g0:
        np.testing.assert_array_equal(g0[key], g1[key], err_msg=key)
    grads = _modes(g0)
    for mode in ("barrier", "bucketed"):
        assert float(grads[mode].pop(".loss")) == pytest.approx(
            float(jloss), rel=1e-5)
    for key, want in grads["barrier"].items():
        np.testing.assert_allclose(grads["bucketed"][key], want, rtol=TOL,
                                   atol=TOL, err_msg=key)
    for mode in ("barrier", "bucketed"):
        _close(grads[mode], jckpt._flatten(jgrads))
    R = jm.cfg.n_layers
    assert j0["logs"] == j1["logs"]
    assert j0["logs"]["barrier"] == [[["end"], ["after"]]]
    assert j0["logs"]["bucketed"] == [json.loads(json.dumps(
        _expected_log(R)))]
    if drill:
        for j in (j0, j1):
            assert j["drill"]["restarts"] == 1
            seen = j["drill"]["seen"]
            assert [s for s, _ in seen] == [0, 1, 2, 2, 3, 4]
            assert seen[2][1] == seen[3][1]
        assert j0["drill"] == j1["drill"]
        assert sorted(os.listdir(tmp_path / "ckpt")) == [
            "step_00000001", "step_00000003", "step_00000004"]


_MESH_GRADS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.models import Model

a = json.loads(sys.argv[1])
cfg = dataclasses.replace(configs.get_smoke(a["arch"]), **a["replace"])
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
jm = Model(cfg, RunConfig(remat=False, attn_impl="xla"), mesh=mesh,
           dtype=jnp.float32)
params = ckpt.restore(os.path.dirname(a["params"]), 0,
                      jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
tokens = jnp.asarray(np.load(a["tokens"]))
with mesh:
    grads = jax.jit(jax.grad(
        lambda p: jm.loss(p, {"tokens": tokens})[0]))(params)
np.savez(a["out"], **ckpt._flatten(grads))
"""


def _jax_mesh_grads(tmp_path, arch, tokens, step_dir, replace=None):
    """JAX's data-parallel gradients: its step on a (2,1) data × model mesh
    of two host devices with Auto axes, in a subprocess (the device count
    is fixed when jax starts).  Each data shard takes half the batch."""
    np.save(tmp_path / "mesh_tokens.npy", tokens)
    out = tmp_path / "mesh_grads.npz"
    arg = json.dumps({"arch": arch, "replace": replace or {},
                      "params": step_dir,
                      "tokens": str(tmp_path / "mesh_tokens.npy"),
                      "out": str(out)})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _MESH_GRADS, arg], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


def test_moe_two_ranks_part_from_the_global_batch_by_the_aux_loss(
        tmp_path):
    """olmoe's smoke config (capacity factor 16: nothing dropped on either
    side) on two ranks: the ranks agree and bucketed equals barrier; each
    rank routes its own tokens, so its capacity and its Switch
    load-balancing loss (the product of two per-expert means) are over
    its half of the batch, and the ranks' aux losses are averaged.  That
    is JAX's data-parallel step: on a mesh JAX's ``moe_apply`` routes each
    data shard inside ``shard_map`` and averages the shards' aux losses
    (``src/repro/models/moe.py:133-175``), and the port's step equals
    JAX's on a (2,1) data × model mesh to 1e-4 of max|g|.  Only JAX's
    mesh-less step routes the whole batch at once: the two-rank step parts
    from that one by the aux loss, and with the aux weight at 0 equals it
    to 1e-4 of max|g|."""
    gaps = {}
    for weight in (None, 0.0):
        replace = {} if weight is None else {"router_aux_weight": weight}
        cfg_j = dataclasses.replace(jconfigs.get_smoke("olmoe-1b-7b"),
                                    **replace)
        sub = tmp_path / f"w{weight}"
        jm, params, step_dir = _jax_model_and_params(
            cfg_j, JRunConfig(remat=False, attn_impl="xla"), sub / "jax")
        tokens = _tokens(cfg_j, 4, 16, seed=2)
        jgrads = jckpt._flatten(jax.jit(jax.grad(
            lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens)})[0]))(
                params))
        (g0, _), (g1, _) = _two_ranks(sub, "olmoe-1b-7b", tokens, step_dir,
                                      replace=replace)
        for key in g0:
            np.testing.assert_array_equal(g0[key], g1[key], err_msg=key)
        grads = _modes(g0)
        for key, want in grads["barrier"].items():
            np.testing.assert_allclose(grads["bucketed"][key], want,
                                       rtol=TOL, atol=TOL, err_msg=key)
        grads["bucketed"].pop(".loss")
        gaps[weight] = {
            k: float(np.abs(grads["bucketed"][k] - w).max()
                     / np.abs(w).max())
            for k, w in jgrads.items() if np.abs(w).max() > 0}
        if weight == 0.0:
            _close(grads["bucketed"], jgrads)
        else:
            # JAX's data-parallel step: each data shard routes its own
            mesh = _jax_mesh_grads(sub, "olmoe-1b-7b", tokens, step_dir,
                                   replace)
            for mode in ("barrier", "bucketed"):
                _close({k: v for k, v in grads[mode].items()
                        if k != ".loss"}, mesh)
    # measured (this config and batch, fp32, the CPU): at the config's aux
    # weight 0.01 the router's gradient parts from the mesh-less step's by
    # 1.185e-02 of its max|g|, ln2's by 1.062e-02, attention's wo by
    # 7.33e-03 (the aux loss's gradient reaches every parameter at or below
    # the router), where it is within 1.19e-06 of the (2,1)-mesh step's; at
    # weight 0, by at most 1.8e-06
    router = "segments/0/0/moe/router"
    assert gaps[None][router] == pytest.approx(1.185e-2, rel=0.1), gaps
    assert max(gaps[None].values()) == gaps[None][router]
    assert max(gaps[0.0].values()) <= TOL, gaps


# ----------------------------------------------------------------------
# runtime.fault: attribution and the recovery drill, against JAX
# ----------------------------------------------------------------------
def _step_graph(pkg):
    builders, scheduler = {"jax": (jbuilders, JScheduler),
                           "port": (tbuilders, TScheduler)}[pkg]
    g = builders.fig1_jobs()
    return g, scheduler().schedule(g).simulate()


@pytest.mark.parametrize("records,kind,detail", [
    # twins of tests/test_runtime_fault.py:28-69
    ([(0, 1.0, None)], None, None),
    ([(0, 1.0, None), (1, 1.01, None), (2, 5.0, None)], "step-time", ""),
    ([(0, 3.0, None), (1, 9.0, {"b": 0.2})], "compute", "b"),
    ([(0, 1.9, None), (1, 6.0, {"f1": 0.1})], "network", "f1"),
    ([(0, 2.9, None), (1, 9.0, {"b": 0.01, "f1": 0.9})], "compute", "b"),
], ids=["seed", "step-time", "compute", "network", "worst-wins"])
def test_step_monitor_attributes_as_jax(records, kind, detail):
    """The same records through both packages' monitors, with the step
    MXDAG where progress is given: the same reports."""
    reports = {}
    for pkg, mod in (("jax", jfault), ("port", tfault)):
        g, expected = _step_graph(pkg)
        graph = any(p for _, _, p in records)
        mon = mod.StepMonitor(step_graph=g if graph else None,
                              expected=expected if graph else None)
        last = [mon.record(s, t, task_progress=p) for s, t, p in records][-1]
        reports[pkg] = ([dataclasses.asdict(r) for r in mon.reports],
                        mon.ewma, last and (last.kind, last.detail))
    assert reports["port"] == reports["jax"]
    assert reports["port"][2] == (None if kind is None else (kind, detail))


def _drill(pkg, **kw):
    builders, scheduler, mod = {
        "jax": (jbuilders, JScheduler, jfault),
        "port": (tbuilders, TScheduler, tfault)}[pkg]
    g, cl = builders.oversubscribed_fanin(8, oversubscription=8.0)
    sched = scheduler(try_pipelining=False).schedule(g, cl)
    if "faults" in kw:
        fault = {"jax": JFault, "port": TFault}[pkg]
        kw["faults"] = [fault(*f) for f in kw["faults"]]
    return mod.recovery_drill(sched, cl, **kw)


@pytest.mark.parametrize("kw", [
    # twins of tests/test_runtime_fault.py:125-150
    {"faults": [(2.5, "host_loss", "d0")]},
    {"n_faults": 2, "seed": 11},
    {"n_faults": 3, "seed": 5, "campaign": "storm", "cost_aware": True},
], ids=["host-loss", "seeded", "storm-cost-aware"])
def test_recovery_drill_reports_as_jax(kw):
    got, want = _drill("port", **kw), _drill("jax", **kw)
    assert got == want
    if "faults" in kw:
        assert got["no_replan"] == float("inf")
        assert got["replan"] < float("inf")
        assert got["detection_rate"] == 1.0 and got["recovered"]
        assert "host_loss" in got["report"]
