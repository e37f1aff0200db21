"""The port's MLA attention (deepseek-v3) and the deepseek-v3 smoke model
against the JAX package's, on the CPU.

``mla_apply`` is held to JAX's on the same parameters (JAX's ``mla_init``
draws them) and the same numpy-made inputs, on all three of its paths: the
naive train path (latents expanded to per-head k and v), the cached call at
index 0 (the port's one-call prefill runs the naive path over the cached
latents, JAX its absorbed path over the S tokens: the same function), and
the absorbed latent decode at index > 0.  Tolerances: fp32 1e-4 (sums in
another order); bf16 2e-2 with atol scaled by max|out|, as
``tests/test_torch_model.py``.
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
from repro.launch.serve import make_serve_step as jmake_serve_step
from repro.models import Model as JModel
from repro.models import attention as ja
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import Model as TModel
from repro_torch.models import attention as ta

ARCH = "deepseek-v3-671b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype, want):
    """fp32 as is; bf16's atol scaled by max|want| (a bf16 rounding error
    comes from sums over the model width, so it scales with the output's
    magnitude)."""
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= float(np.abs(_np(want)).max())
    return tol


def _cfg(q_lora: bool, configs_mod):
    cfg = configs_mod.get_smoke(ARCH)
    return cfg if q_lora else dataclasses.replace(cfg, q_lora_rank=0)


def _mla_pair(q_lora, dtype):
    """(JAX config, JAX params, port config, port params) of one MLA
    block, JAX's ``mla_init`` drawing both."""
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _cfg(q_lora, jconfigs), _cfg(q_lora, tconfigs)
    jp = ja.mla_init(jax.random.PRNGKey(7), jcfg, dtype=jd)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(td)
          for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def _x(cfg, B, S, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_apply_without_cache_matches_jax(q_lora, dtype, impl):
    """The naive train path; on the "kernel" path the port's sdpa hands it
    to K1 (its plain version on the CPU) at qk head dim 24 / v head dim
    16, JAX to its Pallas kernel in interpret mode."""
    jcfg, jp, tcfg, tp = _mla_pair(q_lora, dtype)
    jx, tx = _x(jcfg, 2, 8, dtype)
    want, _ = ja.mla_apply(jp, jx, jcfg,
                           impl="pallas" if impl == "kernel" else "xla")
    with torch.no_grad():
        got, cache = ta.mla_apply(tp, tx, tcfg, impl=impl)
    assert cache is None and got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, want))


def _jax_cached(jcfg, jp, jx, steps, Tmax):
    """JAX's cached mla_apply over x's tokens in the given (start, stop)
    calls; returns (outputs along S, final cache)."""
    B = jx.shape[0]
    cache = ja.mla_cache_init(jcfg, B, Tmax, dtype=jx.dtype)
    outs = []
    for lo, hi in steps:
        out, cache = jax.jit(lambda p, x, c, i: ja.mla_apply(
            p, x, jcfg, cache=c, cache_index=i))(jp, jx[:, lo:hi], cache,
                                                  jnp.int32(lo))
        outs.append(out)
    return jnp.concatenate(outs, axis=1), cache


def _port_cached(tcfg, tp, tx, steps, Tmax, impl="kernel"):
    cache = ta.mla_cache_init(tcfg, tx.shape[0], Tmax, dtype=tx.dtype)
    outs = []
    with torch.no_grad():
        for lo, hi in steps:
            out, cache = ta.mla_apply(tp, tx[:, lo:hi], tcfg, cache=cache,
                                      cache_index=lo, impl=impl)
            outs.append(out)
    return torch.cat(outs, dim=1), cache


def _assert_caches_close(got, want, dtype):
    assert set(got) == set(want) == {"ckv", "kr"}
    for name in want:
        assert got[name].dtype == DTYPES[dtype][1]
        assert tuple(got[name].shape) == tuple(want[name].shape)
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   **_tol(dtype, want[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_one_call_prefill_matches_jax(q_lora, dtype):
    """A cached call at index 0 over a whole prompt: the port runs the
    naive path over the cached latents, JAX the absorbed path; outputs and
    the written ckv/kr caches agree, and so does JAX's token-by-token
    decode of the same prompt."""
    jcfg, jp, tcfg, tp = _mla_pair(q_lora, dtype)
    jx, tx = _x(jcfg, 2, 8, dtype, seed=1)
    want, jcache = _jax_cached(jcfg, jp, jx, [(0, 8)], 12)
    by_token, _ = _jax_cached(jcfg, jp, jx, [(t, t + 1) for t in range(8)],
                              12)
    got, cache = _port_cached(tcfg, tp, tx, [(0, 8)], 12)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, want))
    np.testing.assert_allclose(_np(got), _np(by_token),
                               **_tol(dtype, by_token))
    _assert_caches_close(cache, jcache, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_absorbed_decode_matches_jax(q_lora, dtype):
    """After a 6-token prefill, decode steps at index > 0 run attention in
    the latent space: one token at 6, then two at once at 7 (causal within
    the call), then one at 9, against JAX's same calls."""
    jcfg, jp, tcfg, tp = _mla_pair(q_lora, dtype)
    jx, tx = _x(jcfg, 2, 10, dtype, seed=2)
    steps = [(0, 6), (6, 7), (7, 9), (9, 10)]
    want, jcache = _jax_cached(jcfg, jp, jx, steps, 12)
    got, cache = _port_cached(tcfg, tp, tx, steps, 12)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, want))
    _assert_caches_close(cache, jcache, dtype)


def test_absorbed_decode_equals_the_naive_path():
    """The same function two ways in the port alone: the uncached naive
    path over 10 tokens, and a 4-token prefill followed by six absorbed
    decode steps, in fp32."""
    _, _, tcfg, tp = _mla_pair(True, "float32")
    _, tx = _x(tcfg, 2, 10, "float32", seed=3)
    with torch.no_grad():
        want, _ = ta.mla_apply(tp, tx, tcfg, impl="plain")
    got, _ = _port_cached(tcfg, tp, tx,
                          [(0, 4)] + [(t, t + 1) for t in range(4, 10)], 10)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_mla_cache_refuses_rows_past_its_end():
    _, _, tcfg, tp = _mla_pair(True, "float32")
    _, tx = _x(tcfg, 1, 3, "float32")
    cache = ta.mla_cache_init(tcfg, 1, 4, dtype=torch.float32)
    with pytest.raises(IndexError, match="exceed"):
        ta.mla_apply(tp, tx, tcfg, cache=cache, cache_index=2)


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_init_matches_reference_shapes_and_scales(q_lora):
    """Names, shapes and dtypes equal ``mla_init``'s; each weight's spread
    is its scale (JAX's random numbers cannot be drawn here), and the two
    norms are ones."""
    jcfg, jp, tcfg, _ = _mla_pair(q_lora, "float32")
    tp = ta.mla_init(torch.Generator().manual_seed(0), tcfg,
                     dtype=torch.float32)
    assert sorted(tp) == sorted(jp)
    for name, w in jp.items():
        assert tuple(tp[name].shape) == w.shape, name
        np.testing.assert_allclose(_np(tp[name]).std(), _np(w).std(),
                                   rtol=0.15, atol=1e-6, err_msg=name)
    for name in ("kv_norm",) + (("q_norm",) if q_lora else ()):
        assert torch.equal(tp[name], torch.ones_like(tp[name]))


# ----------------------------------------------------------------------
# the deepseek-v3 smoke model: a dense first layer, then MoE, all MLA
# ----------------------------------------------------------------------
def _pair(dtype, tmp_path, impl="kernel"):
    """(JAX model, its params, port model with the same params)."""
    jd, td = DTYPES[dtype]
    jm = JModel(jconfigs.get_smoke(ARCH),
                JRunConfig(remat=False,
                           attn_impl="pallas" if impl == "kernel" else "xla"),
                dtype=jd)
    params = jm.init(jax.random.PRNGKey(3))
    step_dir = ckpt.save(str(tmp_path), 0, params)
    tm = TModel(tconfigs.get_smoke(ARCH), TRunConfig(attn_impl=impl),
                dtype=td, device="cpu")
    bridge.from_flat(bridge.load_npz(step_dir), tm)
    return jm, params, tm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, tmp_path):
    jm, params, tm = _pair(dtype, tmp_path)
    assert [len(s.pattern) * s.repeats for s in tm.segments_spec] == [1, 1]
    assert [s.pattern[0].ffn for s in tm.segments_spec] == ["dense", "moe"]
    tokens = _tokens(jm.cfg, 2, 16)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tm({"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, want))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_one_call_prefill_matches_jax_token_by_token_decode(impl, tmp_path):
    """decode_step(prompt, 0) in one call equals JAX's token-by-token
    decode_step: the logits and every layer's ckv/kr caches."""
    jm, params, tm = _pair("float32", tmp_path, impl)
    B, S, Tmax = 2, 8, 12
    tokens = _tokens(jm.cfg, B, S, seed=1)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, Tmax)
    outs = []
    for t in range(S):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
        outs.append(logits[:, 0])
    by_token = jnp.stack(outs, axis=1)
    with torch.no_grad():
        got, tcache = tm.decode_step(tm.init_cache(B, Tmax),
                                     torch.from_numpy(tokens).long(), 0)
    np.testing.assert_allclose(_np(got), _np(by_token), **TOL["float32"])
    for si, seg in enumerate(tcache):
        for j, c in enumerate(seg):
            assert set(c["attn"]) == {"ckv", "kr"}
            for name in ("ckv", "kr"):
                np.testing.assert_allclose(
                    _np(c["attn"][name]), _np(cache[si][j]["attn"][name]),
                    **TOL["float32"])


def test_greedy_serve_tokens_match_jax(tmp_path):
    """The port's serve loop (one-call prefill, then absorbed decode) picks
    the same 8 greedy tokens as JAX's serve step token by token."""
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
        got = tserve.generate(
            tm, {"tokens": torch.from_numpy(prompts).long()}, gen)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_width_config_has_the_published_shape():
    """deepseek-v3-671b at full width: MLA 128 heads of 128 + 64 (192) by
    v 128 over latents of 512 + 64, 256 experts top-8 of d_ff 2048 and one
    shared, the first 3 layers dense; the served cut keeps every width."""
    cfg = tconfigs.get(ARCH)
    assert (cfg.d_model, cfg.n_heads, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank,
            cfg.q_lora_rank) == (7168, 128, 128, 64, 128, 512, 1536)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.expert_d_ff,
            cfg.n_shared_experts, cfg.first_dense_layers) == (256, 8, 2048,
                                                              1, 3)
    cut = tserve.full_config(ARCH)
    assert dataclasses.replace(cut, name=cfg.name, n_layers=cfg.n_layers,
                               first_dense_layers=3) == cfg
    assert cut.name == f"{ARCH}-{tserve.MLA_LAYERS}l"
    assert (cut.n_layers, cut.first_dense_layers) == (tserve.MLA_LAYERS, 1)
    # the two layers and embeddings (13.94 B) and the MTP head (0.69 B)
    assert cut.param_counts()["total"] == pytest.approx(13.944e9, rel=1e-4)
    n = sum(p.numel() for p in TModel(cut, device="meta").parameters())
    assert n == pytest.approx(14.630e9, rel=1e-4)
