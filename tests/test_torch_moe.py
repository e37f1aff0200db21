"""The port's MoE path (K3's plain version, the routed MoE layer, the
olmoe-1b-7b and jamba-v0.1-52b models) against the JAX package's.

On the CPU the port's grouped matmul runs K3's plain version; JAX runs its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` does.  The
CUDA kernel itself is tested on the card by ``tests/test_torch_gpu.py``.
Tolerances: fp32 2e-5 and bf16 2e-2 for the kernel
(``tests/test_kernels.py:15``); whole layers and models in fp32 1e-4 (sums
in another order) and bf16 2e-2 with atol scaled by the outputs' largest
magnitude, as ``tests/test_torch_model.py`` and ``tests/test_torch_ssm.py``.

Routing is held to be identical.  ``jax.lax.top_k`` and ``torch.topk``
could order two near-equal router probabilities differently; every test
here asserts the least top-k margin it met, so a flip would show as a
margin below ``MARGIN`` and not as a silent mismatch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import make_serve_step as jmake_serve_step
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import Model as TModel
from repro_torch.models import moe as tmoe

ARCH = "olmoe-1b-7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the least gap between the k-th and (k+1)-th router probability below
# which fp32 sums in another order (~1e-7) could flip a top-k choice
MARGIN = 1e-6
# the same in bf16, where the two sides' hidden states differ by bf16
# roundings (8 significant bits) before they reach the fp32 router
BF16_MARGIN = 5e-3
# nothing drops (the smoke configs' own factor) / experts overflow
NO_DROP, DROPS = 16.0, 0.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scaled(dtype, want):
    """bf16 atol scaled by max|want| (see the module docstring)."""
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(_np(want)).max()))
    return tol


def _cfgs(capacity_factor=NO_DROP, arch=ARCH, **kw):
    return tuple(dataclasses.replace(c.get_smoke(arch),
                                     capacity_factor=capacity_factor, **kw)
                 for c in (jconfigs, tconfigs))


# ----------------------------------------------------------------------
# K3's plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (2, 16, 32, 32),               # tests/test_kernels.py:137-141
    (4, 64, 128, 64),
    (3, 32, 96, 48),
])
def test_grouped_matmul_plain_matches_pallas(E, C, d, f, dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((E, C, d), dtype=np.float32)
    w = rng.standard_normal((E, d, f), dtype=np.float32)
    jx, jw = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    want = jops.grouped_matmul(jx, jw, block_c=16, block_f=16, block_d=32)
    before = tops.grouped_matmul.launches
    got = tops.grouped_matmul(torch.from_numpy(x).to(td),
                              torch.from_numpy(w).to(td))
    assert tops.grouped_matmul.launches == before     # the CPU never counts
    assert got.dtype == td and tuple(got.shape) == (E, C, f)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jref.gmm_ref(jx, jw)),
                               **KERNEL_TOL[dtype])


def test_grouped_matmul_refuses_other_devices_and_the_launcher_cuda_only():
    x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.grouped_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tgmm.gmm_fwd(x, w)       # the kernel's own entry never runs plain


# ----------------------------------------------------------------------
# the MoE layer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 4, 32, 4096, 4097])
@pytest.mark.parametrize("capacity_factor", [NO_DROP, 1.25, DROPS])
def test_capacity_matches_jax(T, capacity_factor):
    jcfg, tcfg = _cfgs(capacity_factor)
    assert tmoe._capacity(T, tcfg) == jmoe._capacity(T, jcfg)
    full_j, full_t = (dataclasses.replace(c.get(ARCH),
                                          capacity_factor=capacity_factor)
                      for c in (jconfigs, tconfigs))
    assert tmoe._capacity(T, full_t) == jmoe._capacity(T, full_j)


def _layer(dtype, capacity_factor, shared=0, B=2, S=16, seed=11):
    """JAX moe params, the same as torch tensors, and one input."""
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _cfgs(capacity_factor, n_shared_experts=shared)
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jcfg, dtype=jd)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else td)
        for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model), dtype=np.float32)
    return jcfg, tcfg, jp, tp, jnp.asarray(x).astype(jd), \
        torch.from_numpy(x).to(td)


def _jax_routing(x2, router, cfg):
    """The JAX package's dispatch as ``_local_moe`` computes it
    (src/repro/models/moe.py:75-103, one expert shard)."""
    T, E, k = x2.shape[0], cfg.n_experts, cfg.n_experts_per_tok
    C = jmoe._capacity(T, cfg)
    probs = jax.nn.softmax(x2.astype(jnp.float32) @ router, axis=-1)
    gates, ids = jax.lax.top_k(probs, k)
    flat_ids = ids.reshape(-1)
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    edges = jnp.searchsorted(sorted_ids, jnp.arange(E + 1))
    starts, counts = edges[:-1], edges[1:] - edges[:-1]
    slot = starts[:, None] + jnp.arange(C)[None, :]
    valid = jnp.arange(C)[None, :] < jnp.minimum(counts, C)[:, None]
    tok = (order // k)[jnp.where(valid, slot, 0)]
    return {"ids": np.asarray(ids), "tok": np.asarray(tok),
            "valid": np.asarray(valid), "counts": np.asarray(counts)}


@pytest.mark.parametrize("capacity_factor", [NO_DROP, DROPS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(dtype, capacity_factor):
    """Routing (ids, slots, used slots) identical, y and aux within
    tolerance; at factor 0.5 experts overflow, and the stable sort decides
    which assignments are dropped."""
    jcfg, tcfg, jp, tp, jx, tx = _layer(dtype, capacity_factor)
    want_y, want_aux = jmoe.moe_apply(jp, jx, jcfg, mesh=None)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    assert y.dtype == DTYPES[dtype][1] and aux.dtype == torch.float32

    d = jcfg.d_model
    r = tmoe.route(tx.reshape(-1, d), tp["router"], tcfg)
    want_r = _jax_routing(jx.reshape(-1, d), jp["router"], jcfg)
    assert float(r.margins.min()) > MARGIN
    np.testing.assert_array_equal(r.ids.numpy(), want_r["ids"])
    np.testing.assert_array_equal(r.valid.numpy(), want_r["valid"])
    np.testing.assert_array_equal(r.tok.numpy(), want_r["tok"])
    np.testing.assert_array_equal(r.counts.numpy(), want_r["counts"])
    dropped = int(r.dropped)
    assert (dropped > 0) == (capacity_factor == DROPS), dropped

    np.testing.assert_allclose(_np(y), _np(want_y),
                               **_scaled(dtype, want_y))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_expert_branch_matches_jax(dtype):
    jcfg, tcfg, jp, tp, jx, tx = _layer(dtype, NO_DROP, shared=1)
    assert {"shared_in", "shared_gate", "shared_out"} <= set(tp)
    shapes = tmoe.moe_shapes(tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == shapes
    want_y, want_aux = jmoe.moe_apply(jp, jx, jcfg, mesh=None)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    np.testing.assert_allclose(_np(y), _np(want_y),
                               **_scaled(dtype, want_y))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_init_matches_reference_shapes_dtypes_and_scales(shared):
    jcfg, tcfg = _cfgs(n_shared_experts=shared)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
    assert sorted(tp) == sorted(jp)
    for name, want in jp.items():
        got = tp[name]
        assert tuple(got.shape) == want.shape, name
        assert (got.dtype == torch.float32) == (want.dtype == jnp.float32)
        np.testing.assert_allclose(_np(got).std(), _np(want).std(),
                                   rtol=0.15, err_msg=name)
    assert tp["router"].dtype == torch.float32


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
def _pair(dtype, tmp_path, capacity_factor=NO_DROP, arch=ARCH):
    """(JAX model, its params, port model with the same params)."""
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _cfgs(capacity_factor, arch)
    jm = JModel(jcfg, JRunConfig(remat=False), dtype=jd)
    params = jm.init(jax.random.PRNGKey(3))
    step_dir = ckpt.save(str(tmp_path), 0, params)
    tm = TModel(tcfg, dtype=td, device="cpu")
    bridge.from_flat(bridge.load_npz(step_dir), tm)
    return jm, params, tm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _forward(jm, params, tm, tokens):
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tm({"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == tm.dtype
    assert tuple(got.shape) == tuple(want.shape)
    return got, want


@pytest.mark.parametrize("arch,dtype", [
    (ARCH, "float32"), (ARCH, "bfloat16"), ("jamba-v0.1-52b", "float32"),
])
def test_forward_matches_jax(arch, dtype, tmp_path):
    """olmoe (MoE in every layer) and jamba (Mamba2 and attention mixers,
    MoE in every other layer) at smoke size."""
    jm, params, tm = _pair(dtype, tmp_path, arch=arch)
    got, want = _forward(jm, params, tm, _tokens(jm.cfg, 2, 16))
    np.testing.assert_allclose(_np(got), _np(want), **_scaled(dtype, want))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_jamba_bf16_forward_is_as_accurate_as_jax(tmp_path):
    """jamba's 8 smoke layers (7 of them Mamba2) carry bf16 rounding that
    grows layer by layer: on these inputs JAX's own bf16 logits are 0.110
    (relative norm) from its fp32 model on the same bf16-valued weights,
    and the port's 0.038; the two bf16 outputs differ by up to 0.83 at
    max|logit| 4.0 (0.05 relative with the MoE layers made dense).  Two
    bf16 implementations that round at other places then cannot agree
    elementwise, so each is held to that fp32 model: the port's bf16
    logits may be no farther from it than JAX's (x1.25 for noise, the rule
    chip_smoke.py applies to K1), and the two argmaxes mostly agree."""
    jm, params, tm = _pair("bfloat16", tmp_path, arch="jamba-v0.1-52b")
    tokens = _tokens(jm.cfg, 2, 16)
    got, want = _forward(jm, params, tm, tokens)
    jm32 = JModel(jm.cfg, JRunConfig(remat=False), dtype=jnp.float32)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    ref = jax.jit(jm32.forward)(params32, {"tokens": jnp.asarray(tokens)})
    port_err, jax_err = _rel(got, ref), _rel(want, ref)
    assert port_err <= 1.25 * jax_err, (port_err, jax_err)
    agree = (_np(got).argmax(-1) == _np(want).argmax(-1)).mean()
    assert agree >= 0.75, agree


def _token_margins(seen):
    """Per token of one call, its least top-k margin over the MoE layers."""
    return np.stack([_np(r.margins) for r in seen]).min(axis=0)


@pytest.mark.parametrize("capacity_factor", [NO_DROP, DROPS])
def test_one_call_prefill_matches_jax_forward(capacity_factor, tmp_path):
    """decode_step(prompt, 0) computes capacity from the B·S tokens of the
    call, as JAX's forward does, so the two agree also where experts
    overflow and assignments drop."""
    jm, params, tm = _pair("float32", tmp_path, capacity_factor)
    B, S = 2, 16
    tokens = _tokens(jm.cfg, B, S, seed=1)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad(), tmoe.recorded_routes() as seen:
        got, _ = tm.decode_step(tm.init_cache(B, S),
                                torch.from_numpy(tokens).long(), 0)
    assert _token_margins(seen).min() > MARGIN
    dropped = sum(int(r.dropped) for r in seen)
    assert (dropped > 0) == (capacity_factor == DROPS), dropped
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_call_prefill_then_decode_matches_jax_token_by_token(dtype,
                                                                  tmp_path):
    """Where nothing drops (the smoke configs' factor 16), the one-call
    prefill and two decode steps equal JAX's decode_step token by token:
    logits and the attention caches.

    In bf16 the two sides' hidden states differ by bf16 roundings, which
    can flip a router's top-k choice where the k-th and (k+1)-th
    probabilities are close (seen here: a flip at a margin of 1.8e-3).
    Tokens whose least margin in the port's routing is below
    ``BF16_MARGIN`` are left out of the comparison and counted (7 of the
    28 here); at least half must remain."""
    jm, params, tm = _pair(dtype, tmp_path)
    B, S, extra = 2, 12, 2
    tokens = _tokens(jm.cfg, B, S + extra, seed=1)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, S + extra)
    outs = []
    for t in range(S + extra):
        logits, cache = step(params, cache,
                             jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        outs.append(logits[:, 0])
    want = _np(jnp.stack(outs, axis=1))

    with torch.no_grad(), tmoe.recorded_routes() as seen:
        tcache = tm.init_cache(B, S + extra)
        got, tcache = tm.decode_step(
            tcache, torch.from_numpy(tokens[:, :S]).long(), 0)
        got, margins = [got], [_token_margins(seen).reshape(B, S)]
        dropped = sum(int(r.dropped) for r in seen)
        for t in range(S, S + extra):
            seen.clear()
            logits, tcache = tm.decode_step(
                tcache, torch.from_numpy(tokens[:, t:t + 1]).long(), t)
            got.append(logits)
            margins.append(_token_margins(seen).reshape(B, 1))
            dropped += sum(int(r.dropped) for r in seen)
    assert dropped == 0
    got = _np(torch.cat(got, dim=1))
    keep = np.concatenate(margins, axis=1) > (
        MARGIN if dtype == "float32" else BF16_MARGIN)
    if dtype == "float32":
        assert keep.all()
    assert keep.mean() >= 0.5, f"{(~keep).sum()} near-tie tokens"
    np.testing.assert_allclose(got[keep], want[keep], **_scaled(dtype, want))
    for si, seg in enumerate(tcache):
        for j, c in enumerate(seg):
            for name in ("k", "v"):
                want_c = _np(cache[si][j]["attn"][name])[:, keep]
                np.testing.assert_allclose(
                    _np(c["attn"][name])[:, keep], want_c,
                    **_scaled(dtype, want_c), err_msg=name)


def test_greedy_serve_tokens_match_jax(tmp_path):
    """The port's serve loop (one-call prefill, then token by token) picks
    the same greedy tokens as JAX's serve step driven as its serve.main
    drives it (prefill token by token); nothing drops at factor 16."""
    jm, params, tm = _pair("float32", tmp_path)
    B, P, gen = 2, 8, 8
    prompts = _tokens(jm.cfg, B, P, seed=2)
    step = jax.jit(jmake_serve_step(jm))
    cache = jm.init_cache(B, P + gen)
    for t in range(P):
        tok, cache = step(params, cache, jnp.asarray(prompts[:, t:t + 1]),
                          jnp.int32(t))
    want = [tok]
    for t in range(P, P + gen - 1):
        tok, cache = step(params, cache, tok, jnp.int32(t))
        want.append(tok)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    with torch.inference_mode():
        got = tserve.generate(tm, torch.from_numpy(prompts).long(), gen)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_summed_aux_matches_jax_loss_metric(arch, tmp_path):
    """The blocks' summed router aux loss, which the port's model carries
    for the training slice, equals the ``aux`` of JAX's ``Model.loss``."""
    jm, params, tm = _pair("float32", tmp_path, arch=arch)
    tokens = _tokens(jm.cfg, 2, 16, seed=3)
    _, metrics = jax.jit(jm.loss)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        x, _ = tm._embed_inputs({"tokens": torch.from_numpy(tokens).long()})
        _, aux = tm._run_segments(x, positions=torch.arange(16))
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(metrics["aux"]), rtol=1e-5)


def test_checkpoint_bridge_round_trip_keeps_the_fp32_router(tmp_path):
    """A bf16 olmoe checkpoint saved by JAX restores exactly, MoE leaves
    ``segments/<s>/<j>/moe/*`` stacked [R, ...] included; the router stays
    fp32 in the bf16 model, as in JAX."""
    jm, params, tm = _pair("bfloat16", tmp_path)
    flat = bridge.load_npz(str(tmp_path / "step_00000000"))
    cfg = jm.cfg
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    R = cfg.n_layers
    assert flat["segments/0/0/moe/router"].shape == (R, d, E)
    assert flat["segments/0/0/moe/w_in"].shape == (R, E, d, f)
    assert flat["segments/0/0/moe/w_out"].shape == (R, E, f, d)
    dtypes = {name: p.dtype for name, p in tm.named_parameters()}
    assert dtypes["segments.0.0.moe.router"] == torch.float32
    assert params["segments"][0][0]["moe"]["router"].dtype == jnp.float32
    for name in ("w_in", "w_gate", "w_out"):
        assert dtypes[f"segments.0.0.moe.{name}"] == torch.bfloat16
    back = bridge.to_flat(tm)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_model_builds_with_the_jax_parameter_names(arch, dtype):
    """MoE blocks are ported: olmoe and jamba build with JAX's parameter
    names, shapes and dtypes (the router fp32 in a bf16 model), and serve
    a prompt on the CPU."""
    jd, td = DTYPES[dtype]
    jm = JModel(jconfigs.get_smoke(arch), JRunConfig(remat=False), dtype=jd)
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jm.init(jax.random.PRNGKey(0)))[0]}
    tm = TModel(tconfigs.get_smoke(arch), dtype=td,
                device="cpu").init(torch.Generator().manual_seed(0))
    tparams = {n.replace(".", "/"): p for n, p in tm.named_parameters()}
    assert sorted(tparams) == sorted(jflat)
    assert any("/moe/router" in key for key in tparams)
    for key, arr in jflat.items():
        assert tuple(tparams[key].shape) == arr.shape, key
        assert (tparams[key].dtype == torch.float32) == (
            arr.dtype == jnp.float32), key
    with torch.inference_mode():
        out = tserve.generate(tm, torch.zeros((2, 8), dtype=torch.long), 3)
    assert tuple(out.shape) == (2, 3)


def test_full_width_config_has_the_published_shape():
    cfg = tconfigs.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size) == (16, 2048, 16, 16, 50304)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.expert_d_ff,
            cfg.capacity_factor) == (64, 8, 1024, 1.25)
    tm = TModel(cfg, device="meta")
    n = sum(p.numel() for p in tm.parameters())
    assert 6.9e9 < n < 6.95e9
    assert tm.segments[0][0].moe["router"].dtype == torch.float32
    assert (tserve.MOE_ARCH, tserve.MOE_BATCH, tserve.MOE_PROMPT,
            tserve.MOE_GEN) == (ARCH, 4, 1024, 32)
    # the prefill's capacity and the decode step's (4 tokens)
    assert tmoe._capacity(4 * 1024, cfg) == 640
    assert tmoe._capacity(4, cfg) == 8
