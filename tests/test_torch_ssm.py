"""The port's Mamba2 path (K2's plain version, the chunked SSD scan, the
block and the mamba2-130m model) against the JAX package's.

On the CPU the port's SSD wrapper runs K2's plain version; JAX runs its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` does.  The
CUDA kernel itself is tested on the card by ``tests/test_torch_gpu.py``.
Tolerances: fp32 1e-4 and bf16 2e-2 (``tests/test_kernels.py:95``);
chunked against sequential 1e-3 (``tests/test_kernels.py:113``).
"""
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
from repro.kernels.ssd import ssd_intra_chunk as jssd_intra_chunk
from repro.launch.serve import make_serve_step as jmake_serve_step
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import serve as tserve
from repro_torch.models import Model as TModel
from repro_torch.models import ssm as tssm

ARCH = "mamba2-130m"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SEQ_TOL = dict(rtol=1e-3, atol=1e-3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _both(arrays, dtype):
    """numpy arrays → (JAX arrays, torch tensors); float arrays named in
    ``dtype`` go to that type, the rest stay fp32."""
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd if cast else jnp.float32)
             for a, cast in arrays],
            [torch.from_numpy(a).to(td if cast else torch.float32)
             for a, cast in arrays])


def _scaled(tol, dtype, want):
    """In bf16 an output's rounding error comes from sums over the block's
    width, so it scales with the outputs' magnitude, not with the element's
    own (as in tests/test_torch_model.py): atol is scaled by max|want|."""
    tol = dict(tol[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(_np(want)).max()))
    return tol


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _a_values(n, mamba_like, rng):
    """A per head: mamba2's -linspace(1, 16) (cum reaches ~-1e2 within a
    short chunk), or the JAX tests' -|normal| - 0.1."""
    if mamba_like:
        return -np.linspace(1.0, 16.0, n, dtype=np.float32)
    return (-np.abs(rng.standard_normal(n)) - 0.1).astype(np.float32)


# ----------------------------------------------------------------------
# K2's plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,P,N,G,H,mamba_like", [
    (16, 16, 8, 1, 2, False),       # tests/test_kernels.py:79-82
    (32, 32, 16, 2, 4, False),
    (8, 16, 16, 1, 8, False),       # the smoke config's chunk
    (32, 16, 16, 2, 4, True),       # mamba2's A range
])
def test_intra_chunk_plain_matches_pallas(Q, P, N, G, H, mamba_like, dtype):
    rng = np.random.default_rng(3)
    BH, BG, nc = 2 * H, 2 * G, 3
    arrays = [
        (rng.standard_normal((BH, nc, Q, P), dtype=np.float32), True),
        (_softplus(rng.standard_normal((BH, nc, Q), dtype=np.float32)),
         False),
        (np.tile(_a_values(H, mamba_like, rng), 2), False),
        (rng.standard_normal((BG, nc, Q, N), dtype=np.float32), True),
        (rng.standard_normal((BG, nc, Q, N), dtype=np.float32), True),
    ]
    jin, tin = _both(arrays, dtype)
    want = jssd_intra_chunk(*jin, interpret=True)
    oracle = jref.ssd_intra_chunk_ref(*jin)
    got = tref.ssd_intra_chunk_ref(*tin)
    for name, g, w, o in zip(("y", "state", "cum"), got, want, oracle):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype],
                                   err_msg=name)
        np.testing.assert_allclose(_np(g), _np(o), **TOL[dtype],
                                   err_msg=name)


# ----------------------------------------------------------------------
# the chunked scan
# ----------------------------------------------------------------------
def _ssd_arrays(B, L, H, P, G, N, seed, mamba_like=False, init=False):
    rng = np.random.default_rng(seed)
    arrays = [
        (rng.standard_normal((B, L, H, P), dtype=np.float32), True),
        (_softplus(rng.standard_normal((B, L, H), dtype=np.float32)), False),
        (_a_values(H, mamba_like, rng), False),
        (rng.standard_normal((B, L, G, N), dtype=np.float32), True),
        (rng.standard_normal((B, L, G, N), dtype=np.float32), True),
    ]
    state = (rng.standard_normal((B, H, P, N), dtype=np.float32)
             if init else None)
    return arrays, state


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype, init):
    arrays, s0 = _ssd_arrays(2, 64, 4, 16, 2, 8, seed=4, init=init)
    jin, tin = _both(arrays, dtype)
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    before = tops.ssd_chunked.launches
    y, final = tops.ssd_chunked(*tin, 16, init_state=ts0)
    assert tops.ssd_chunked.launches == before     # the CPU never counts
    assert y.dtype == tin[0].dtype and final.dtype == torch.float32
    for want in (jops.ssd_chunked_pallas(*jin, 16, init_state=js0),
                 jssm.ssd_chunked(*jin, 16, init_state=js0)):
        np.testing.assert_allclose(_np(y), _np(want[0]), **TOL[dtype])
        np.testing.assert_allclose(_np(final), _np(want[1]), **TOL[dtype])


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("mamba_like", [False, True])
def test_ssd_chunked_matches_sequential(mamba_like, init):
    """State-space duality: the chunked scan equals the recurrence, and the
    port's recurrence equals the JAX oracle."""
    arrays, s0 = _ssd_arrays(2, 64, 4, 16, 2, 8, seed=5,
                             mamba_like=mamba_like, init=init)
    jin, tin = _both(arrays, "float32")
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, final = tops.ssd_chunked(*tin, 16, init_state=ts0)
    ys, fs = tref.ssd_sequential_ref(*tin, init_state=ts0)
    np.testing.assert_allclose(_np(y), _np(ys), **SEQ_TOL)
    np.testing.assert_allclose(_np(final), _np(fs), **SEQ_TOL)
    jy, jf = jref.ssd_sequential_ref(
        *jin, init_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(_np(ys), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(fs), _np(jf), **TOL["float32"])


def test_ssd_chunked_refuses_a_ragged_length_and_other_devices():
    arrays, _ = _ssd_arrays(1, 24, 2, 8, 1, 8, seed=6)
    _, tin = _both(arrays, "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tops.ssd_chunked(*tin, 16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.ssd_chunked(*(t.to("meta") for t in tin), 8)


def test_launcher_takes_only_cuda_tensors():
    """The kernel's own entry point never runs the plain version."""
    arrays, _ = _ssd_arrays(1, 16, 2, 8, 1, 8, seed=6)
    _, tin = _both(arrays, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_intra_chunk_fwd(*tin, 8)


# ----------------------------------------------------------------------
# the block
# ----------------------------------------------------------------------
def _block(dtype):
    """JAX block params and the same params as torch tensors."""
    jd, td = DTYPES[dtype]
    cfg = jconfigs.get_smoke(ARCH)
    jp = jssm.ssm_init(jax.random.PRNGKey(7), cfg, dtype=jd)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else td)
        for k, v in jp.items()}
    return cfg, tconfigs.get_smoke(ARCH), jp, tp


def _x(cfg, B, L, dtype, seed=8):
    a = np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model), dtype=np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    st = rng.standard_normal((2, 3, 24), dtype=np.float32) \
        if with_state else None
    jy, jst = jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                                None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(tst), _np(jst), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_without_cache_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _block(dtype)
    jx, tx = _x(jcfg, 2, 16, dtype)
    want, _ = jssm.ssm_apply(jp, jx, jcfg)
    got, cache = tssm.ssm_apply(tp, tx, tcfg)
    assert cache is None and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_scaled(TOL, dtype,
                                                              want))


def _jax_token_by_token(jp, jx, jcfg, cache):
    outs = []
    for t in range(jx.shape[1]):
        y, cache = jssm.ssm_apply(jp, jx[:, t:t + 1], jcfg, cache=cache)
        outs.append(y)
    return jnp.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("L", [16, 5, 12, 20])
def test_ssm_apply_one_call_prefill_matches_jax_token_by_token(L):
    """The cached path with L > 1 (a chunked scan from the cache's state)
    gives the outputs and leaves the cache of JAX's L == 1 path run over
    the same inputs; L 5 is shorter than the chunk and than the conv; L 12
    and 20 are one and two chunks of 8 and a remainder of 4, scanned as a
    shorter chunk from the state the whole chunks end in."""
    jcfg, tcfg, jp, tp = _block("float32")
    jx, tx = _x(jcfg, 2, L, "float32")
    want, jcache = _jax_token_by_token(
        jp, jx, jcfg, jssm.ssm_cache_init(jcfg, 2, dtype=jnp.float32))
    cache = tssm.ssm_cache_init(tcfg, 2, dtype=torch.float32)
    got, out = tssm.ssm_apply(tp, tx, tcfg, cache=cache)
    assert out is cache
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    for name in ("conv", "state"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL["float32"], err_msg=name)


def test_ssm_apply_prefill_from_a_carried_cache_matches_jax():
    """The cached path with L > 1 from a cache that earlier tokens left
    (a nonzero state and conv tail): the chunked scan starts from that
    state, as JAX's L == 1 path continues token by token."""
    jcfg, tcfg, jp, tp = _block("float32")
    jx, tx = _x(jcfg, 2, 24, "float32")
    _, jcache = _jax_token_by_token(
        jp, jx[:, :8], jcfg, jssm.ssm_cache_init(jcfg, 2, dtype=jnp.float32))
    cache = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in jcache.items()}
    assert float(cache["state"].abs().max()) > 0
    want, jcache = _jax_token_by_token(jp, jx[:, 8:], jcfg, jcache)
    got, _ = tssm.ssm_apply(tp, tx[:, 8:], tcfg, cache=cache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    for name in ("conv", "state"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL["float32"], err_msg=name)


def test_ssm_apply_ragged_prefill_from_a_carried_cache_matches_jax():
    """The one-call prefill of 13 tokens (a chunk of 8 and a remainder of
    5) from the cache that 8 earlier tokens left, against JAX's L == 1
    path continuing token by token."""
    jcfg, tcfg, jp, tp = _block("float32")
    jx, tx = _x(jcfg, 2, 21, "float32", seed=10)
    _, jcache = _jax_token_by_token(
        jp, jx[:, :8], jcfg, jssm.ssm_cache_init(jcfg, 2, dtype=jnp.float32))
    cache = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in jcache.items()}
    want, jcache = _jax_token_by_token(jp, jx[:, 8:], jcfg, jcache)
    got, _ = tssm.ssm_apply(tp, tx[:, 8:], tcfg, cache=cache)
    assert tuple(got.shape) == (2, 13, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    for name in ("conv", "state"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL["float32"], err_msg=name)


def test_ssm_apply_without_cache_refuses_a_ragged_length():
    """The uncached scan keeps JAX's rule (``ssd_chunked`` asserts L %
    chunk == 0): 12 tokens at chunk 8 raise; only the cached one-call
    prefill takes a remainder chunk."""
    _, tcfg, _, tp = _block("float32")
    _, tx = _x(tcfg, 2, 12, "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssm_apply(tp, tx, tcfg)


def test_ssm_apply_decode_step_matches_jax():
    """The L == 1 path from a cache that a prompt left, in place."""
    jcfg, tcfg, jp, tp = _block("float32")
    jx, tx = _x(jcfg, 2, 9, "float32")
    _, jcache = _jax_token_by_token(
        jp, jx[:, :8], jcfg, jssm.ssm_cache_init(jcfg, 2, dtype=jnp.float32))
    cache = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in jcache.items()}
    want, jcache = jssm.ssm_apply(jp, jx[:, 8:], jcfg, cache=jcache)
    before = tops.ssd_chunked.launches
    got, _ = tssm.ssm_apply(tp, tx[:, 8:], tcfg, cache=cache)
    assert tops.ssd_chunked.launches == before
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    for name in ("conv", "state"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL["float32"], err_msg=name)


def test_ssm_init_matches_reference_shapes_dtypes_and_scales():
    jcfg, tcfg, jp, _ = _block("bfloat16")
    tp = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg)
    assert sorted(tp) == sorted(jp)
    for name, want in jp.items():
        got = tp[name]
        assert tuple(got.shape) == want.shape, name
        assert (got.dtype == torch.float32) == (want.dtype == jnp.float32)
        np.testing.assert_allclose(_np(got).std(), _np(want).std(),
                                   rtol=0.15, atol=1e-6, err_msg=name)
    for name in ("D", "dt_bias", "conv_b", "norm_w"):
        np.testing.assert_array_equal(_np(tp[name]), _np(jp[name]))
    # log(linspace(1, 16)): the two linspaces differ in the last bit
    np.testing.assert_allclose(_np(tp["A_log"]), _np(jp["A_log"]),
                               rtol=2e-7)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _pair(dtype, tmp_path, ssm_chunk=0):
    """(JAX model, its params, port model with the same params)."""
    jd, td = DTYPES[dtype]
    jm = JModel(jconfigs.get_smoke(ARCH),
                JRunConfig(remat=False, ssm_chunk=ssm_chunk), dtype=jd)
    params = jm.init(jax.random.PRNGKey(3))
    step_dir = ckpt.save(str(tmp_path), 0, params)
    tm = TModel(tconfigs.get_smoke(ARCH), TRunConfig(ssm_chunk=ssm_chunk),
                dtype=td, device="cpu")
    bridge.from_flat(bridge.load_npz(step_dir), tm)
    return jm, params, tm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("ssm_chunk", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, ssm_chunk, tmp_path):
    """ssm_chunk 4 (the RunConfig override) cuts 16 tokens into 4 chunks
    where the smoke config's own chunk of 8 cuts them into 2."""
    jm, params, tm = _pair(dtype, tmp_path, ssm_chunk)
    tokens = _tokens(jm.cfg, 2, 16)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tm({"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want),
                               **_scaled(TOL, dtype, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_call_prefill_then_decode_matches_jax_token_by_token(dtype,
                                                                  tmp_path):
    """decode_step(prompt, 0) in one call, then two decode steps, against
    JAX's decode_step token by token: logits and caches."""
    jm, params, tm = _pair(dtype, tmp_path)
    B, S, extra = 2, 16, 2
    tokens = _tokens(jm.cfg, B, S + extra, seed=1)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, S + extra)
    outs = []
    for t in range(S + extra):
        logits, cache = step(params, cache,
                             jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        outs.append(logits[:, 0])
    want = jnp.stack(outs, axis=1)

    with torch.no_grad():
        tcache = tm.init_cache(B, S + extra)
        got, tcache = tm.decode_step(
            tcache, torch.from_numpy(tokens[:, :S]).long(), 0)
        got = [got]
        for t in range(S, S + extra):
            logits, tcache = tm.decode_step(
                tcache, torch.from_numpy(tokens[:, t:t + 1]).long(), t)
            got.append(logits)
        got = torch.cat(got, dim=1)
    np.testing.assert_allclose(_np(got), _np(want),
                               **_scaled(TOL, dtype, want))
    for si, seg in enumerate(tcache):
        for j, c in enumerate(seg):
            for name in ("conv", "state"):
                want_c = cache[si][j]["ssm"][name]
                np.testing.assert_allclose(
                    _np(c["ssm"][name]), _np(want_c),
                    **_scaled(TOL, dtype, want_c), err_msg=name)


def _greedy_serve_tokens_match_jax(tmp_path, P):
    jm, params, tm = _pair("float32", tmp_path)
    B, gen = 2, 8
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


def test_greedy_serve_tokens_match_jax(tmp_path):
    """The port's serve loop (one-call prefill, then token by token) picks
    the same greedy tokens as JAX's serve step driven as its serve.main
    drives it (prefill token by token)."""
    _greedy_serve_tokens_match_jax(tmp_path, 16)


def test_greedy_serve_tokens_match_jax_at_a_ragged_prompt(tmp_path):
    """A 12-token prompt (a chunk of 8 and a remainder of 4) prefilled in
    one call gives JAX's greedy tokens."""
    _greedy_serve_tokens_match_jax(tmp_path, 12)


def test_serve_main_takes_a_ragged_prompt():
    """``python -m repro_torch.launch.serve --prompt-len 12`` serves on the
    CPU (the smoke config's chunk is 8)."""
    out = tserve.main(["--device", "cpu", "--prompt-len", "12", "--batch",
                       "2", "--gen", "4"])
    assert tuple(out.shape) == (2, 4)


def test_checkpoint_bridge_round_trip_keeps_fp32_params(tmp_path):
    """A bf16 mamba2 checkpoint saved by JAX restores exactly; A_log, D and
    dt_bias stay fp32 in the bf16 model, as in JAX."""
    jm, params, tm = _pair("bfloat16", tmp_path)
    flat = bridge.load_npz(str(tmp_path / "step_00000000"))
    R = jm.cfg.n_layers
    assert flat["segments/0/0/ssm/in_proj"].shape[0] == R
    dtypes = {name: p.dtype for name, p in tm.named_parameters()}
    for name in tssm.FP32_PARAMS:
        assert dtypes[f"segments.0.0.ssm.{name}"] == torch.float32
        assert params["segments"][0][0]["ssm"][name].dtype == jnp.float32
    assert dtypes["segments.0.0.ssm.in_proj"] == torch.bfloat16
    back = bridge.to_flat(tm)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)


def test_model_init_and_cache_layout():
    tm = TModel(tconfigs.get_smoke(ARCH), dtype=torch.bfloat16,
                device="cpu").init(torch.Generator().manual_seed(0))
    cfg, dims = tm.cfg, tssm.ssm_dims(tm.cfg)
    p = dict(tm.named_parameters())
    np.testing.assert_allclose(
        _np(p["segments.0.0.ssm.A_log"][0]),
        np.log(np.linspace(1.0, 16.0, dims["n_heads"])), rtol=1e-6)
    # the smoke config keeps a dense FFN (d_ff 128), as the JAX one does
    assert "segments.0.0.ln2" in p and "lm_head" not in p
    cache = tm.init_cache(3, 100)[0][0]["ssm"]
    assert tuple(cache["conv"].shape) == (
        cfg.n_layers, 3, cfg.ssm_conv - 1, dims["conv_dim"])
    assert cache["conv"].dtype == torch.bfloat16
    assert tuple(cache["state"].shape) == (
        cfg.n_layers, 3, dims["n_heads"], dims["head_dim"], dims["d_state"])
    assert cache["state"].dtype == torch.float32


def test_full_width_config_has_the_published_shape():
    cfg = tconfigs.get(ARCH)
    dims = tssm.ssm_dims(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 768, 50280)
    assert (dims["d_inner"], dims["n_heads"], dims["head_dim"],
            dims["n_groups"], dims["d_state"]) == (1536, 24, 64, 1, 128)
    assert (cfg.ssm_conv, cfg.ssm_chunk, cfg.tie_embeddings) == (4, 256, True)
    tm = TModel(cfg, device="meta")
    names = {name for name, _ in tm.named_parameters()}
    assert "segments.0.0.ssm.in_proj" in names
    assert not any(".ln2" in n or ".mlp." in n for n in names)  # d_ff 0
    n = sum(p.numel() for p in tm.parameters())
    assert 125e6 < n < 135e6
    assert tserve.SSM_ARCH == ARCH

