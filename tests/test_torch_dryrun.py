"""The port's dry run (``repro_torch.launch.dryrun``, ``specs``,
``roofline.Roofline``) against the JAX package's, on the CPU.

- Train flops: the port's step traced under ``FakeTensorMode`` counts
  JAX's ``hlo_analysis.analyze(...).flops`` of the same step lowered on an
  Auto-typed (1,1) mesh (smoke configs at vocab 512, B 8 × S 64, remat,
  one microbatch): exactly for deepseek-7b and olmoe-1b-7b; for
  mamba2-130m exactly that plus the C·Bᵀ products of K2's plain version,
  which takes C·Bᵀ once a head where JAX's ``ssd_chunked`` takes it once
  a head group (``_cb_excess``).
- ``Roofline`` on JAX's TPU constants is JAX's ``Roofline``, key for key.
- ``input_specs``/``decode_specs`` give JAX's shapes and dtypes (tokens
  int64 where JAX's are int32) for every arch.
- ``trace_cell`` records every key for a train, a prefill and a decode cell
  of each family; ``default_run`` keeps JAX's choice beside the port's.

The reference runs in a subprocess with its own device count, as
``tests/test_dryrun_small.py`` runs it, but on a mesh whose axes are Auto
(jax 0.9.0 types ``jax.make_mesh``'s axes Explicit, which the JAX model's
sharding constraints refuse).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlo_analysis
from repro.launch.specs import decode_specs as jdecode_specs
from repro.launch.specs import input_specs as jinput_specs
from repro.models import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.configs.base import RunConfig, SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import Hardware, Roofline
from repro_torch.launch.specs import decode_specs, input_specs
from repro_torch.models import Model
from repro_torch.models.ssm import ssm_dims

ROOT = Path(__file__).resolve().parents[1]
FLOP_ARCHS = ["deepseek-7b", "olmoe-1b-7b", "mamba2-130m"]
B, S = 8, 64
# one arch of each family
FAMILIES = ["deepseek-7b", "olmoe-1b-7b", "mamba2-130m", "jamba-v0.1-52b",
            "deepseek-v3-671b", "whisper-large-v3", "internvl2-2b"]
JAX_HW = Hardware("TPU v5e (the JAX package)", hlo_analysis.PEAK_FLOPS,
                  hlo_analysis.HBM_BW, hlo_analysis.HBM_PER_CHIP,
                  hlo_analysis.ICI_BW, hlo_analysis.ICI_BW)

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import dataclasses, json, sys
import jax
from jax.sharding import AxisType
from repro import configs
from repro.configs.base import RunConfig, ShapeConfig
from repro.launch import hlo_analysis, sharding as shard_lib
from repro.launch.mesh import dp_axes
from repro.launch.specs import input_specs
from repro.launch.train import (init_train_state, make_train_step,
                                model_flops, state_shardings)
from repro.models import Model
from repro.optim import AdamW, AdamWConfig

B, S, archs = json.loads(sys.argv[1])
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
shape = ShapeConfig("tiny_train", S, B, "train")
out = {"flops": {}, "default_run": {}}
for arch in archs:
    cfg = dataclasses.replace(configs.get_smoke(arch), vocab_size=512)
    run = RunConfig(remat=True, microbatches=1)
    model = Model(cfg, run, mesh=mesh, dp_axes=dp_axes(mesh))
    with mesh:
        opt = AdamW(AdamWConfig())
        ss = jax.eval_shape(lambda: init_train_state(
            model, opt, run, jax.random.PRNGKey(0)))
        batch = input_specs(cfg, shape)
        comp = jax.jit(make_train_step(model, opt, run),
                       in_shardings=(state_shardings(ss, cfg, run, mesh),
                                     shard_lib.batch_shardings(batch, mesh,
                                                               run)),
                       donate_argnums=0).lower(ss, batch).compile()
    out["flops"][arch] = hlo_analysis.analyze(
        comp, 1, model_flops=model_flops(cfg, shape)).flops
# imported after jax has its devices (the module sets XLA_FLAGS itself)
from repro.launch.dryrun import default_run
for arch in configs.ARCHS:
    r = default_run(configs.get(arch))
    out["default_run"][arch] = {k: getattr(r, k) for k in (
        "fsdp", "opt_8bit", "remat", "batch_axes", "microbatches")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps([B, S, FLOP_ARCHS])],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _smoke(arch):
    return dataclasses.replace(tconfigs.get_smoke(arch), vocab_size=512)


def _cb_excess(cfg, batch, seq):
    """The flops K2's plain version adds to JAX's in a remat train step:
    it takes C·Bᵀ (2·B·L·G·Q·N flops a call over a layer's chunks, JAX's
    count) once a head, hpg = H/G times, where JAX takes it once a group
    and repeats it; four such products a layer a step (the forward, remat's
    recompute, and the gradients of C and of B)."""
    d = ssm_dims(cfg)
    hpg = d["n_heads"] // d["n_groups"]
    per_call = 2 * batch * seq * d["n_groups"] * cfg.ssm_chunk * d["d_state"]
    return (hpg - 1) * 4 * cfg.n_layers * per_call


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_train_flops_are_jax_s(reference, arch):
    cfg = _smoke(arch)
    got = dryrun.trace_step(cfg, RunConfig(remat=True, microbatches=1),
                            ShapeConfig("tiny_train", S, B, "train"), B)
    want = reference["flops"][arch]
    excess = _cb_excess(cfg, B, S) if cfg.ssm_state else 0
    assert got["flops"] == want + excess
    if arch == "mamba2-130m":
        # 548,929,536 + 7 · 4 · 2 layers · 131,072 (C·Bᵀ at B 8, L 64,
        # G 1, Q 8, N 16; 8 heads a group): 1.34% over JAX's count
        assert (want, excess) == (548_929_536, 7_340_032)
    else:
        assert want in (451_411_968, 1_881_669_632)


def test_default_run_keeps_jax_s_choice(reference):
    for arch, want in reference["default_run"].items():
        run, jax_run = dryrun.default_run(tconfigs.get(arch))
        assert jax_run == want, arch
        # the port takes JAX's fsdp; batch_axes "all" needs a model axis
        assert (run.fsdp, run.batch_axes) == (want["fsdp"], "dp")
        assert (run.opt_8bit, run.remat, run.microbatches) == (
            want["opt_8bit"], want["remat"], want["microbatches"])
        # a rank's one row takes one microbatch
        assert dryrun.default_run(tconfigs.get(arch),
                                  batch=1)[0].microbatches == 1


@pytest.mark.parametrize("terms", [
    (1.5e15, 2.0e11, 0.0, {}, 1, 6.0e14),
    (3.0e13, 9.0e11, 4.0e10, {"all-reduce": 4.0e10}, 256, 2.0e18),
    (1.0e9, 1.0e6, 8.0e12, {"all-gather": 6.0e12, "all-reduce": 2.0e12},
     16, 1.0e12),
    (0.0, 0.0, 0.0, {}, 4, 0.0),
])
def test_roofline_on_jax_constants_is_jax_s(terms):
    flops, hbm, coll, breakdown, chips, mf = terms
    want = hlo_analysis.Roofline(flops, hbm, coll, dict(breakdown), chips,
                                 mf)
    got = Roofline(flops, hbm, coll, dict(breakdown), chips, mf, hw=JAX_HW)
    assert got.to_dict() == want.to_dict()
    assert (got.bound_s, got.dominant) == (want.bound_s, want.dominant)


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(map(str, prefix)): (
            tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}
    return {k: v for key, sub in items
            for k, v in _port_leaves(sub, prefix + (key,)).items()}


def _as_port_dtype(leaves):
    """JAX's int32 tokens are the port's int64; every other dtype is
    the same."""
    return {k: (shape, "int64" if dt == "int32" else dt)
            for k, (shape, dt) in leaves.items()}


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_specs_are_jax_s(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for kind in ("train", "prefill"):
        shape = ShapeConfig("tiny", S, 3, kind)
        assert _port_leaves(input_specs(cfg, shape)) == _as_port_dtype(
            _jax_leaves(jinput_specs(jcfg, JShape("tiny", S, 3, kind))))
    dshape = ShapeConfig("tiny_decode", S, 3, "decode")
    jm = JModel(jcfg, dtype=jnp.bfloat16)
    jtok, jcache, jindex = jdecode_specs(jm, jcfg,
                                         JShape("tiny_decode", S, 3, "decode"))
    with FakeTensorMode():
        model = Model(cfg, dtype=torch.bfloat16, device="cpu")
        tokens, cache, index = decode_specs(model, cfg, dshape)
    assert _port_leaves(cache) == _jax_leaves(jcache)
    assert _port_leaves([tokens]) == _as_port_dtype(_jax_leaves([jtok]))
    assert jindex.shape == () and index == S - 1
    # a rank's rows
    assert input_specs(cfg, SHAPES["train_4k"], 1)["tokens"].shape == (
        1, 4096)


RECORD_KEYS = {"arch", "shape", "kind", "world", "global_batch",
               "batch_per_rank", "seq_len", "dtype", "hardware", "run",
               "jax_run", "params", "flops", "hbm_bytes", "coll_bytes",
               "peak_bytes", "peak_split", "param_bytes", "state_bytes",
               "fits_80GB", "roofline", "trace_s", "notes", "ok"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_trace_cell_records_every_key(arch, shape):
    # the full configs' chunk: the SSD scan loops over chunks in Python, as
    # many times as at full width (the smoke chunk, 8, would loop 4096
    # times over a 32k prompt)
    cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                              ssm_chunk=tconfigs.get(arch).ssm_chunk)
    rec = dryrun.trace_cell(arch, shape, cfg=cfg)
    assert set(rec) == RECORD_KEYS and rec["ok"]
    assert (rec["world"], rec["batch_per_rank"]) == (
        256, max(1, SHAPES[shape].global_batch // 256))
    roof = rec["roofline"]
    assert set(roof) == set(hlo_analysis.Roofline(
        0, 0, 0, {}, 1).to_dict())
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["peak_bytes"] >= rec["param_bytes"] + rec["state_bytes"]
    assert rec["param_bytes"] == sum(
        p.numel() * p.element_size()
        for p in Model(cfg, dtype=torch.bfloat16, device="meta").parameters())
    assert rec["fits_80GB"] == (rec["peak_bytes"] <= 80e9)
    if SHAPES[shape].kind == "train":
        assert rec["state_bytes"] > 0
        assert rec["coll_bytes"] == pytest.approx(
            2 * 255 / 256 * rec["param_bytes"])
        assert roof["coll_breakdown"] == {"all-reduce": rec["coll_bytes"]}
    else:
        assert rec["state_bytes"] == 0 and rec["coll_bytes"] == 0


def test_main_writes_a_skip_for_long_500k_on_a_quadratic_arch(tmp_path):
    assert dryrun.main(["--arch", "deepseek-7b", "--shape", "long_500k",
                        "--out", str(tmp_path), "--tag", "t"]) == 0
    recs = json.loads((tmp_path / "dryrun_torch_t.json").read_text())
    assert recs == {"deepseek-7b|long_500k|skip": {
        "arch": "deepseek-7b", "shape": "long_500k", "ok": False,
        "skipped": "long_500k needs sub-quadratic attention"}}


def test_text_only_traces_the_tokens_alone():
    """``chip_smoke.py`` trains internvl2-2b's language model on tokens
    alone, as ``data.SyntheticLM`` gives them: traced so, the step does the
    work of the config without a vision prefix."""
    cfg = _smoke("internvl2-2b")
    shape, run = ShapeConfig("tiny_train", S, B, "train"), RunConfig()
    text = dryrun.trace_step(cfg, run, shape, B, text_only=True)
    bare = dryrun.trace_step(
        dataclasses.replace(cfg, vision_embed_dim=0, vision_seq=0), run,
        shape, B)
    full = dryrun.trace_step(cfg, run, shape, B)
    assert text["flops"] == bare["flops"] < full["flops"]


def test_peak_split_counts_the_gradients_made_by_the_peak():
    """``torch.autograd.grad``'s outputs are filed as gradients, not as
    temporaries: ``MemTracker``'s hook on each parameter labels its
    gradient when the backward makes it.  A train step peaks early in its
    backward, so the split's gradients are those of the head and final
    norm alone (olmoe-1b-7b's head is untied)."""
    cfg = _smoke("olmoe-1b-7b")
    got = dryrun.trace_step(cfg, RunConfig(remat=True),
                            ShapeConfig("tiny_train", S, B, "train"), B)
    params = dict(Model(cfg, dtype=torch.bfloat16,
                        device="meta").named_parameters())
    head = sum(params[n].numel() * params[n].element_size()
               for n in ("lm_head", "final_norm"))
    assert got["peak_split"]["gradients"] == head == 65_664
    assert sum(got["peak_split"].values()) == got["peak_bytes"]


def test_sharded_trace_counts_gathers_and_reduce_scatters():
    """A sharded rank's train step (deepseek-7b smoke, world 2, remat,
    bucketed): the rank holds half of each sharded tensor; its collective
    bytes are a ring's share of the gathers (each repeat's rows twice,
    in the forward and the recompute; the untied head once), one
    reduce-scatter of every sharded gradient, and the all-reduce of the
    replicated ones and the clipping norm's square: no all-reduce of
    the sharded gradients."""
    cfg = _smoke("deepseek-7b")
    W = 2
    run = RunConfig(fsdp=True, sync_mode="bucketed")
    got = dryrun.trace_step(cfg, run, ShapeConfig("tiny_train", S, B,
                                                  "train"), B, world=W)
    whole = dict(Model(cfg, dtype=torch.bfloat16,
                       device="meta").named_parameters())
    rank = dict(Model(cfg, run, dtype=torch.bfloat16, device="meta",
                      group=dryrun._TracedRanks(W)).named_parameters())

    def nbytes(names):
        return sum(whole[n].numel() * whole[n].element_size()
                   for n in names)
    sharded = [n for n in whole if rank[n].shape != whole[n].shape]
    assert len(sharded) == 8 and "lm_head" in sharded
    share = (W - 1) / W
    gathered = 2 * nbytes(n for n in sharded if n != "lm_head") + nbytes(
        ["lm_head"])
    assert got["param_bytes"] == sum(p.numel() * p.element_size()
                                     for p in rank.values())
    assert got["roofline"]["coll_breakdown"] == pytest.approx({
        "all-gather": share * gathered,
        "reduce-scatter": share * nbytes(sharded),
        "all-reduce": 2 * share * (nbytes(n for n in whole
                                          if n not in sharded) + 4)})
    assert got["coll_bytes"] == pytest.approx(
        sum(got["roofline"]["coll_breakdown"].values()))


# ----------------------------------------------------------------------
# a rank of a data x model grid
# ----------------------------------------------------------------------
_JAX_DEFAULT_RUN = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import json
from repro import configs
from repro.configs.base import SHAPES
from repro.launch.dryrun import default_run

out = {}
for arch in configs.ARCHS:
    r = default_run(configs.get(arch))
    out[arch] = {k: getattr(r, k) for k in (
        "fsdp", "opt_8bit", "remat", "batch_axes", "microbatches")}
    # lower_cell's choice on its 256-chip mesh (launch/dryrun.py:71-78)
    out[arch]["seq_shard"] = {
        name: r.batch_axes == "all" and shape.global_batch % 256 != 0
        for name, shape in SHAPES.items()}
print(json.dumps(out))
"""


def test_default_run_on_a_mesh_is_jax_s():
    """On a 16×16 grid ``default_run`` takes JAX's whole choice,
    ``batch_axes`` included, and reports the ``seq_shard`` choice JAX's
    ``lower_cell`` makes for each shape; a cell that needs it is a skip
    record naming it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _JAX_DEFAULT_RUN],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for arch in tconfigs.ARCHS:
        seq = want[arch].pop("seq_shard")
        for name, shape in SHAPES.items():
            run, jax_run = dryrun.default_run(tconfigs.get(arch),
                                              shape=shape, mesh=(16, 16))
            assert jax_run == {**want[arch], "seq_shard": seq[name]}, arch
            assert (run.fsdp, run.batch_axes, run.opt_8bit, run.remat,
                    run.microbatches) == tuple(want[arch][k] for k in (
                        "fsdp", "batch_axes", "opt_8bit", "remat",
                        "microbatches")), arch
        assert any(seq.values()) == (want[arch]["batch_axes"] == "all")
    rec = dryrun.trace_cell("mamba2-130m", "prefill_32k", mesh=(16, 16))
    assert rec["ok"] is False and "seq_shard" in rec["skipped"]
    assert rec["jax_run"]["seq_shard"] is True


_GRID_STEP = r"""
import collections, datetime, json, sys
import torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh, train
from repro_torch.models import Model
from repro_torch.optim import AdamW

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=store, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
grid = mesh.make_grid((1, 2))
cfg = configs.get_smoke("olmoe-1b-7b")
run = RunConfig(remat=True)
m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
opt = AdamW()
state = train.init_train_state(m, opt, run, torch.Generator().manual_seed(0))
step = train.make_train_step(m, opt, run, grid=grid)
step(state, {"tokens": torch.zeros((4, 16), dtype=torch.long)})
if rank == 0:
    print(json.dumps(collections.Counter(
        f"{kind} {key}" for kind, key in step.model_log)))
dist.destroy_process_group()
"""


def test_a_grid_trace_counts_the_model_group_s_collectives(tmp_path):
    """A (1,2) trace of olmoe-1b-7b's smoke step counts the model group's
    collectives, by what each serves, as two gloo ranks on that grid log
    them in one training step; their bytes are filed apart from the data
    group's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GRID_STEP, str(r),
         f"file://{tmp_path / 'store'}"], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:]
                                                     for _, e in outs]
    logged = json.loads(outs[0][0].strip().splitlines()[-1])
    got = dryrun.trace_step(tconfigs.get_smoke("olmoe-1b-7b"),
                            RunConfig(remat=True),
                            ShapeConfig("tiny_train", 16, 4, "train"), 4,
                            mesh=(1, 2))
    assert got["model_collectives"] == logged
    # per layer: attention's combine (again in remat's recompute) and its
    # input's gradient; the experts' combine and input gradient, the gates'
    assert logged["all-reduce attn"] == 3 * 2
    assert logged["all-reduce moe"] == 2 * 2
    assert logged["all-reduce moe.gate"] == 2
    kinds = set(got["roofline"]["coll_breakdown"])
    assert {"model all-reduce", "model all-gather",
            "model reduce-scatter"} <= kinds
