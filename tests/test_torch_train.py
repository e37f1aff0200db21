"""The port's training step against the JAX package's, on the CPU.

Both sides run the same parameters (JAX's ``Model.init`` draws them, the
JAX checkpoint writer saves them, the port loads them through its bridge)
and the same numpy-made batches.  Gradients are held to JAX's
``jax.value_and_grad(model.loss)``: in fp32 within 1e-4 of each tensor's
max|g| (sums in another order); in bf16 against JAX's fp32 model on the
same weights, as ``test_loss_and_grads_match_jax`` says.
"""
import dataclasses
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
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain
from repro.models import Model as JModel
from repro.models import layers as jl
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import compression as jcompression
from repro.optim import cosine_schedule as jcosine
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge, ckpt
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tl
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.runtime import LoopConfig, run_training

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ARCHS = ["deepseek-7b", "mamba2-130m", "olmoe-1b-7b", "internvl2-2b",
         "deepseek-v3-671b", "whisper-large-v3"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(cfg_j, cfg_t, dtype, tmp_path):
    """(JAX model, its params, port model with the same params)."""
    jd, td = DTYPES[dtype]
    jm = JModel(cfg_j, JRunConfig(remat=False, attn_impl="xla"), dtype=jd)
    params = jm.init(jax.random.PRNGKey(3))
    step_dir = jckpt.save(str(tmp_path), 0, params)
    tm = TModel(cfg_t, dtype=td, device="cpu")
    bridge.from_flat(bridge.load_npz(step_dir), tm)
    return jm, params, tm


def _batch(cfg, B, S, seed=0):
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


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(tm, batch):
    loss, metrics = tm.loss(_tbatch(batch))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                materialize_grads=True)
    return loss, metrics, {bridge._key(n): g for n, g in zip(names, grads)}


def _assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for key in want:
        g, w = _np(got[key]), want[key]
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=key)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax_custom_vjp(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    g = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jw, jx, jg = (jnp.asarray(a, jd) for a in (w, x, g))
    want, vjp = jax.vjp(lambda w_, x_: jl.rmsnorm(w_, x_, 1e-5), jw, jx)
    want_dw, want_dx = vjp(jg)
    tw, tx = (torch.from_numpy(a).to(td).requires_grad_() for a in (w, x))
    got = tl.rmsnorm(tw, tx, 1e-5)
    dw, dx = torch.autograd.grad(got, (tw, tx), torch.from_numpy(g).to(td))
    assert got.dtype == dx.dtype == dw.dtype == td
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    for a, b in ((got, want), (dw, want_dw), (dx, want_dx)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = tl.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ----------------------------------------------------------------------
# the kernel wrappers' autograd.Functions, their kernels stood in for by
# the plain versions (the card's own check: tests/test_torch_gpu.py)
# ----------------------------------------------------------------------
@pytest.fixture
def plain_kernels(monkeypatch):
    monkeypatch.setattr(tfa, "flash_attention_fwd", lambda q, k, v, causal,
                        scale: ops._plain_attention(causal, scale)(q, k, v)[0])
    monkeypatch.setattr(tssd, "ssd_intra_chunk_fwd", lambda *a: tuple(
        t.detach() for t in ops._plain_intra_chunk(a[-1])(*a[:-1])))
    monkeypatch.setattr(tgmm, "gmm_fwd", lambda x, w: ref.gmm_ref(x, w))


def _leaves(rng, *shapes):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .requires_grad_() for s in shapes]


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_kernel_functions_recompute_the_plain_gradients(kernel,
                                                        plain_kernels):
    """Each Function's forward counts a launch; its backward gives autograd
    through the plain version, for every input."""
    rng = np.random.default_rng(2)
    if kernel == "K1":
        ins = _leaves(rng, (2, 12, 4, 8), (2, 12, 2, 8), (2, 12, 2, 8))
        fn = ops._FlashAttention.apply
        args, plain, wrapper = (True, None), (lambda *t: ops._plain_attention(
            True, None)(*t)), ops.flash_attention
    elif kernel == "K2":
        x, Bm, Cm = _leaves(rng, (2, 16, 4, 8), (2, 16, 2, 6), (2, 16, 2, 6))
        dt = torch.nn.functional.softplus(torch.from_numpy(
            rng.standard_normal((2, 16, 4)).astype(np.float32))
        ).requires_grad_()
        A = torch.tensor([-1.0, -2.0, -0.5, -3.0], requires_grad=True)
        ins = [x, dt, A, Bm, Cm]
        fn, args, plain, wrapper = (ops._SsdIntraChunk.apply, (8,),
                                    ops._plain_intra_chunk(8),
                                    ops.ssd_chunked)
    else:
        ins = _leaves(rng, (3, 8, 16), (3, 16, 24))
        fn, args, plain, wrapper = (ops._GroupedMatmul.apply, (),
                                    lambda x, w: (ref.gmm_ref(x, w),),
                                    ops.grouped_matmul)
    before = wrapper.launches
    got = fn(*ins, *args)
    got = got if isinstance(got, tuple) else (got,)
    assert wrapper.launches == before + 1
    want = plain(*ins)
    cots = [torch.from_numpy(rng.standard_normal(tuple(t.shape))
                             .astype(np.float32)) for t in want]
    g_got = torch.autograd.grad(got, ins, cots)
    g_want = torch.autograd.grad(want, ins, cots)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ssd_function_takes_grad_of_x_alone(plain_kernels):
    """Where only x needs a gradient, the recompute leaves out cum (which
    depends on dt and A alone)."""
    rng = np.random.default_rng(3)
    x = _leaves(rng, (1, 16, 2, 8))[0]
    dt = torch.full((1, 16, 2), 0.5)
    A = torch.tensor([-1.0, -2.0])
    Bm, Cm = (torch.from_numpy(rng.standard_normal((1, 16, 1, 4))
                               .astype(np.float32)) for _ in range(2))
    (g,) = torch.autograd.grad(ops._SsdIntraChunk.apply(
        x, dt, A, Bm, Cm, 8)[0].sum(), x)
    (want,) = torch.autograd.grad(ops._plain_intra_chunk(8)(
        x, dt, A, Bm, Cm)[0].sum(), x)
    torch.testing.assert_close(g, want)


# ----------------------------------------------------------------------
# Model.loss and its gradients
# ----------------------------------------------------------------------
def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, dtype, tmp_path):
    """Loss, metrics and every gradient against ``jax.value_and_grad`` of
    JAX's ``Model.loss`` (mesh None, attn_impl "xla"); the port with its
    defaults (remat on, the kernel path's plain version).  olmoe's smoke
    capacity factor 16 drops nothing; internvl2 has a vision prefix;
    deepseek-v3 runs MLA, MoE after a dense layer and the MTP head (its
    ``mtp_ce`` a metric too); whisper an encoder over audio frames and
    cross-attention.

    fp32: each gradient within 1e-4 of max|g|.  bf16: the two packages
    round to bf16 at other places, and their gradients differ by more than
    2e-2 of max|g| where each is 1-16% of max|g| from the fp32 gradient
    (mamba2: JAX 4-16%, the port 1-8%; olmoe: both 1-4%).  So, as for
    jamba's bf16 forward in tests/test_torch_moe.py, each is held to JAX's
    fp32 model on the same bf16-valued weights: over all gradients (one
    vector) the port's relative error may be at most 1.25x JAX's, and per
    tensor at most 2x JAX's plus one bf16 rounding (2^-8); the loss and
    metrics stay within 2e-2 of JAX's bf16 ones."""
    jm, params, tm = _pair(jconfigs.get_smoke(arch), tconfigs.get_smoke(arch),
                           dtype, tmp_path)
    batch = _batch(jm.cfg, 2, 16)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, _jbatch(batch))
    loss, metrics, grads = _port_grads(tm, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    names = {"ce", "aux", "loss"} | ({"mtp_ce"} if jm.cfg.mtp else set())
    assert set(metrics) == set(jmetrics) | {"loss"} == names
    tol = GRAD_TOL[dtype]
    for name in names:
        np.testing.assert_allclose(float(metrics[name].detach()),
                                   float(jmetrics[name]), rtol=tol,
                                   atol=1e-6)
    assert all(g.dtype == p.dtype for g, p in
               zip(grads.values(), tm.parameters()))
    want = jckpt._flatten(jgrads)
    if dtype == "float32":
        _assert_grads_close(grads, want, tol)
        return
    jm32 = JModel(jm.cfg, JRunConfig(remat=False, attn_impl="xla"),
                  dtype=jnp.float32)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ref32 = jckpt._flatten(jax.jit(jax.grad(lambda p, b: jm32.loss(p, b)[0]))(
        params32, _jbatch(batch)))
    assert grads.keys() == ref32.keys()
    got = {k: _np(g) for k, g in grads.items()}
    for key in ref32:
        port_err, jax_err = _rel(got[key], ref32[key]), \
            _rel(want[key], ref32[key])
        assert port_err <= 2 * jax_err + 2 ** -8, (key, port_err, jax_err)
    flat = [np.concatenate([d[k].ravel() for k in ref32])
            for d in (got, want, ref32)]
    port_err, jax_err = _rel(flat[0], flat[2]), _rel(flat[1], flat[2])
    assert port_err <= 1.25 * jax_err, (port_err, jax_err)


def _cfg_20m(configs_mod):
    """The 20M config of examples/train_lm.py:39-42."""
    return dataclasses.replace(
        configs_mod.get("deepseek-7b"), name="deepseek-20m",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
        d_ff=1024, vocab_size=4096)


def test_loss_and_grads_of_the_20m_example_match_jax(tmp_path):
    jm, params, tm = _pair(_cfg_20m(jconfigs), _cfg_20m(tconfigs),
                           "float32", tmp_path)
    batch = _batch(jm.cfg, 2, 32, seed=4)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, _jbatch(batch))
    loss, _, grads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_close(grads, jckpt._flatten(jgrads), GRAD_TOL["float32"])


@pytest.mark.parametrize("logits_fp32", [True, False])
def test_mtp_head_is_fp32_and_weighted_as_jax(logits_fp32, tmp_path):
    """In bf16 the MTP head's logits are fp32 whatever ``logits_fp32``
    says (so its CE is the same both ways), and the loss is ce + router
    weight × aux + 0.3 × mtp_ce; both metrics within bf16's 2e-2 of JAX's
    under the same setting."""
    cfg_j = jconfigs.get_smoke("deepseek-v3-671b")
    jm = JModel(cfg_j, JRunConfig(remat=False, attn_impl="xla",
                                  logits_fp32=logits_fp32),
                dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(3))
    step_dir = jckpt.save(str(tmp_path), 0, params)
    batch = _batch(cfg_j, 2, 16, seed=6)
    _, jmetrics = jax.jit(jm.loss)(params, _jbatch(batch))
    out = {}
    for fp32 in (True, False):
        tm = TModel(tconfigs.get_smoke("deepseek-v3-671b"),
                    TRunConfig(logits_fp32=fp32), dtype=torch.bfloat16,
                    device="cpu")
        bridge.from_flat(bridge.load_npz(step_dir), tm)
        with torch.no_grad():
            out[fp32] = tm.loss(_tbatch(batch))
    loss, metrics = out[logits_fp32]
    assert float(out[True][1]["mtp_ce"]) == float(out[False][1]["mtp_ce"])
    want = metrics["ce"] + tm.cfg.router_aux_weight * metrics["aux"] \
        + 0.3 * metrics["mtp_ce"]
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    for name in ("ce", "mtp_ce", "loss"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=2e-2)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
def _smoke_state(run, seed=0, arch="deepseek-7b"):
    cfg = tconfigs.get_smoke(arch)
    model = TModel(cfg, run, dtype=torch.float32, device="cpu")
    opt = AdamW(AdamWConfig(lr=cosine_schedule(1e-2, warmup=2, total=8)))
    state = ttrain.init_train_state(
        model, opt, run, torch.Generator().manual_seed(seed))
    return model, opt, state


class _Recorder:
    """An optimizer stand-in that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.grads = grads
        return state


def test_microbatches_two_match_one():
    """k = 2 sums the two halves' gradients in fp32 and halves them: the
    step's metrics and the gradients handed to the optimizer equal k = 1's
    (fp32 tolerance 1e-4 of max|g|, as against JAX)."""
    batch = _tbatch(_batch(tconfigs.get_smoke("deepseek-7b"), 4, 16, seed=5))
    out = []
    for k in (1, 2):
        run = TRunConfig(microbatches=k)
        model, _, state = _smoke_state(run)
        rec = _Recorder()
        _, metrics = ttrain.make_train_step(model, rec, run)(state, batch)
        assert all(g.dtype == torch.float32 for g in rec.grads.values())
        out.append((metrics, rec.grads))
    (m1, g1), (m2, g2) = out
    for name in m1:
        np.testing.assert_allclose(float(m2[name]), float(m1[name]),
                                   rtol=1e-5, atol=1e-7)
    _assert_grads_close(g2, {k: _np(g) for k, g in g1.items()},
                        GRAD_TOL["float32"])


def _run(tmp_path, name, fail_at_step, ckpt_final=True, steps=6):
    run = TRunConfig()
    model, opt, _ = _smoke_state(run)
    cfg = model.cfg
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2), "cpu")
    seen = []
    summary = run_training(
        LoopConfig(total_steps=steps, ckpt_dir=str(tmp_path / name),
                   ckpt_every=2, fail_at_step=fail_at_step,
                   ckpt_final=ckpt_final),
        train_step=ttrain.make_train_step(model, opt, run),
        init_state=lambda: ttrain.init_train_state(
            model, opt, run, torch.Generator().manual_seed(0)),
        batch_at=data.batch_at,
        on_step=lambda step, m: seen.append((step, float(m["loss"]))))
    return summary, seen


def test_run_training_restart_replays_the_same_losses(tmp_path):
    """A failure injected at step 3 restarts from step 1's checkpoint; the
    replayed step 2 and every later step give the uninterrupted run's
    losses."""
    plain, plain_seen = _run(tmp_path, "plain", None)
    failed, failed_seen = _run(tmp_path, "failed", 3)
    assert plain["restarts"] == 0 and failed["restarts"] == 1
    assert [s for s, _ in failed_seen] == [0, 1, 2, 2, 3, 4, 5]
    want = dict(plain_seen)
    for step, loss in failed_seen:
        np.testing.assert_allclose(loss, want[step], rtol=1e-6)
    assert failed["loss_history"][-1] == plain["loss_history"][-1]


def test_run_training_can_skip_the_final_checkpoint(tmp_path):
    """With ``ckpt_final=False`` and 5 steps every 2, the loop saves after
    steps 1 and 3 and not after the last (4); the restart at 3 still
    restores step 1's checkpoint and replays step 2 with its first-pass
    loss."""
    run, seen = _run(tmp_path, "skip", 3, ckpt_final=False, steps=5)
    plain, _ = _run(tmp_path, "all", 3, steps=5)
    assert len(run["save_seconds"]) == len(plain["save_seconds"]) - 1 == 2
    assert ckpt.all_steps(str(tmp_path / "skip")) == [1, 3]
    assert ckpt.all_steps(str(tmp_path / "all")) == [1, 3, 4]
    assert run["restarts"] == 1 and run["restore_seconds"]
    assert [s for s, _ in seen] == [0, 1, 2, 2, 3, 4]
    assert seen[2][1] == seen[3][1]


# 12 bf16 steps of the two packages from the same weights: the largest
# relative loss difference read is 4.7e-4 (they round to bf16 at other
# places), an order below the batch-to-batch spread of the losses (~2.5e-2)
TRAJ_TOL = 2e-3


def test_bf16_steps_at_the_cli_lr_follow_jax_and_lower_the_held_out_loss(
        tmp_path):
    """internvl2-2b's smoke model, text only as at full width, takes the 12
    steps of chip_smoke.py's full-width run with the CLI's AdamW (peak
    3e-3, warmup 20, decay 0.1) in bf16, the port beside JAX's jitted
    ``make_train_step``: every step's loss, and the held-out loss
    (``train.held_out_loss``) before and after, within TRAJ_TOL of JAX's.
    The last loss is above the first in both (another batch), while the
    held-out loss falls in both by more than chip_smoke.py's REPLAY_TOL of
    itself (1e-3): the check that shows learning."""
    steps, lr, B, S = 12, ttrain.CLI_LR, 4, 32
    arch = "internvl2-2b"
    jm, params, tm = _pair(jconfigs.get_smoke(arch),
                           tconfigs.get_smoke(arch), "bfloat16", tmp_path)
    jopt = JAdamW(JAdamWConfig(lr=jcosine(lr, warmup=ttrain.CLI_WARMUP,
                                          total=steps)))
    jstep = jax.jit(jtrain.make_train_step(
        jm, jopt, JRunConfig(remat=False, attn_impl="xla")))
    jdata = JSyntheticLM(JDataConfig(jm.cfg.vocab_size, S, B))
    jheld = jdata.batch_at(ttrain.HELD_OUT_STEP)
    jstate = {"params": params, "opt": jopt.init(params)}
    want = [float(jm.loss(params, jheld)[0])]
    for step in range(steps):
        jstate, m = jstep(jstate, jdata.batch_at(step))
        want.append(float(m["loss"]))
    want.append(float(jm.loss(jstate["params"], jheld)[0]))

    run = TRunConfig()
    opt = ttrain.cli_optimizer(steps)
    data = SyntheticLM(DataConfig(jm.cfg.vocab_size, S, B), "cpu")
    state = {"params": tm, "opt": opt.init(tm)}
    step_fn = ttrain.make_train_step(tm, opt, run)
    got = [ttrain.held_out_loss(tm, data)]
    for step in range(steps):
        state, m = step_fn(state, data.batch_at(step))
        got.append(float(m["loss"]))
    got.append(ttrain.held_out_loss(tm, data))

    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL)
    for losses in (got, want):
        assert losses[steps] > losses[1]
        assert losses[0] - losses[-1] > 1e-3 * losses[0]


@pytest.mark.parametrize("field,value,item", [
    ("sync_mode", "bucketed", "item 5"), ("opt_8bit", True, "item 4"),
    ("grad_compression", True, "item 4"),
])
def test_check_run_still_refuses(field, value, item):
    """Item 5's ``sync_mode`` is ported: ``bucketed`` builds, an unknown
    mode raises, and the fields that need a "model" mesh axis
    (``seq_shard`` here, for an arch it is not ported for:
    deepseek-v3-671b;
    ``fsdp`` is ported) still raise, naming themselves and not item 5;
    item 4's (the optimizer extras) are ported: the model builds and the
    train state carries them (int8 moments, the error accumulator)."""
    run = dataclasses.replace(TRunConfig(), **{field: value})
    if item == "item 5":
        assert TModel(tconfigs.get_smoke("deepseek-7b"), run,
                      device="cpu").run.sync_mode == value
        with pytest.raises(ValueError, match="sync_mode"):
            TModel(tconfigs.get_smoke("deepseek-7b"),
                   TRunConfig(sync_mode="ring"), device="cpu")
        with pytest.raises(NotImplementedError, match="seq_shard") as err:
            TModel(tconfigs.get_smoke("deepseek-v3-671b"),
                   dataclasses.replace(run, seq_shard=True), device="cpu")
        assert "item 5" not in str(err.value)
        return
    model = TModel(tconfigs.get_smoke("deepseek-7b"), run,
                   dtype=torch.float32, device="cpu")
    opt = AdamW(AdamWConfig(state_8bit=run.opt_8bit))
    state = ttrain.init_train_state(model, opt, run,
                                    torch.Generator().manual_seed(0))
    assert ("err" in state) == run.grad_compression
    moment = state["opt"]["m"]["embed"]
    assert isinstance(moment, dict) == run.opt_8bit


# the optimizer extras in a train step against JAX's, each step taken from
# JAX's state: quantisers turn the last-bit differences of the two
# gradients (sums in another order, within 1e-4 of max|g|) into whole code
# steps.  fp8: a per-tensor scale that moves with the tensor's absmax
# moves many codes by one (measured at the smoke configs: up to 652 of
# 157k error elements, 4.2e-3); int8: a row whose absmax element's fp8
# code moved has its scale moved by up to an fp8 step (1/8), so its codes
# by up to 127/8 (measured: at most 3, on at most 2.1e-3 of the codes)
EXTRAS_STEPS = 3
EXTRAS_SHARE = 1e-2
PARAM_SHARE = 1e-4


def _extras_pair(arch, dtype, tmp_path, peak_lr):
    """JAX's jitted train step with ``opt_8bit`` and ``grad_compression``
    and its state, the port's with the same weights, and each step's
    batch: (jm, jstep, jstate, step_fn, state)."""
    jm, params, tm = _pair(jconfigs.get_smoke(arch),
                           tconfigs.get_smoke(arch), dtype, tmp_path)
    jrun = JRunConfig(remat=False, attn_impl="xla", opt_8bit=True,
                      grad_compression=True)
    jopt = JAdamW(JAdamWConfig(lr=jcosine(peak_lr, warmup=2, total=8),
                               state_8bit=True))
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, jrun))
    jstate = {"params": params, "opt": jopt.init(params),
              "err": jcompression.init_error_state(params)}
    run = TRunConfig(opt_8bit=True, grad_compression=True)
    opt = AdamW(AdamWConfig(lr=cosine_schedule(peak_lr, warmup=2, total=8),
                            state_8bit=True))
    state = ttrain.init_train_state(tm, opt, run,
                                    torch.Generator().manual_seed(0))
    return jm, jstep, jstate, ttrain.make_train_step(tm, opt, run), state


def _extras_steps(arch, dtype, tmp_path, peak_lr):
    """EXTRAS_STEPS steps of both, the port restoring JAX's train state
    (parameters, int8 moments, error accumulator) through the checkpoint
    layout before each: yields each step's (loss, JAX's loss, the port's
    new state and JAX's, flattened under JAX's key paths)."""
    jm, jstep, jstate, step_fn, state = _extras_pair(arch, dtype, tmp_path,
                                                     peak_lr)
    for step in range(EXTRAS_STEPS):
        d = str(tmp_path / f"step{step}")
        jckpt.save(d, step, jstate)
        ckpt.restore(d, step, state)
        batch = _batch(jm.cfg, 2, 16, seed=step)
        jstate, jmetrics = jstep(jstate, _jbatch(batch))
        state, metrics = step_fn(state, _tbatch(batch))
        got, want = ckpt._flatten(state), jckpt._flatten(jstate)
        assert got.keys() == want.keys()
        assert "opt/m/embed/q" in got and "err/embed" in got
        yield float(metrics["loss"]), float(jmetrics["loss"]), got, want


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-130m",
                                  "olmoe-1b-7b"])
def test_train_step_with_8bit_moments_and_compression_matches_jax(
        arch, tmp_path):
    """``make_train_step`` with ``opt_8bit`` and ``grad_compression``
    beside JAX's jitted ``make_train_step`` with the same fields, fp32,
    each step from JAX's state: the loss within 1e-5; every array of the
    new state within 1e-4 of its tensor's max, except where a quantiser's
    code differs (the int8 codes by at most 127 / 8, on at most
    EXTRAS_SHARE of them; the error on at most EXTRAS_SHARE of its
    elements; the parameters on at most PARAM_SHARE: an Adam step is
    about lr whatever the gradient's size)."""
    for loss, want_loss, got, want in _extras_steps(arch, "float32",
                                                    tmp_path, 1e-2):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        over = {"params": 0, "err": 0, "q": 0}
        size = {"params": 0, "err": 0, "q": 0}
        for key, w in want.items():
            g = got[key]
            assert g.dtype == w.dtype, key
            kind = "q" if key.endswith("/q") else key.split("/")[0]
            if kind == "q":
                dq = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert dq.max() <= 127 // 8, key
                n = int((dq > 0).sum())
            else:
                n = int((np.abs(g - w) > 1e-4 * np.abs(w).max()
                         + 1e-4 * np.abs(w)).sum())
                if kind not in over:            # opt/step, the scales
                    assert n == 0 or key.endswith("/s"), key
                    continue
            over[kind] += n
            size[kind] += w.size
        assert over["params"] <= PARAM_SHARE * size["params"], over
        assert over["err"] <= EXTRAS_SHARE * size["err"], over
        assert over["q"] <= EXTRAS_SHARE * size["q"], over


def test_bf16_step_with_the_optimizer_extras_follows_jax(tmp_path):
    """olmoe-1b-7b's smoke model in bf16 with both extras at peak lr 1e-3
    (the full-width runs'), each step from JAX's state: the loss within
    2e-2 of JAX's (the bf16 loss tolerance of
    ``test_loss_and_grads_match_jax``) and the new state finite, int8
    where JAX's is.  The new parameters are not compared: the
    bf16 gradients differ by more than 2e-2 of max|g| (ROADMAP Queue 3
    note 7), and where a v code is 0 the int8 update divides by a √v made
    of the fresh gradient alone.  Two bf16 runs that each carry their own
    state part there (``examples/int8_moments_vs_jax.py``: in 6 steps at
    peak lr 1e-3 with both extras JAX's loss goes 6.1606 → 6.3761 (step
    2) → 6.4453, the port's 6.1641 → 5.9437 → 5.9935; ROADMAP Queue 3)."""
    for loss, want_loss, got, want in _extras_steps("olmoe-1b-7b",
                                                    "bfloat16", tmp_path,
                                                    1e-3):
        np.testing.assert_allclose(loss, want_loss,
                                   rtol=GRAD_TOL["bfloat16"])
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            assert np.isfinite(got[key]).all(), key


def test_train_cli_runs_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --smoke --steps 3``
    in a fresh interpreter (which imports no JAX), in bucketed mode by
    default."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--steps", "3", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "done: 3 steps" in proc.stdout and "restarts=0" in proc.stdout
    assert "sync bucketed" in proc.stdout          # the default, as JAX's
