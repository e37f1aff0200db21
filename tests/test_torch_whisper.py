"""The port's whisper path (encoder, decoder cross-attention, decode with
the encoder's states) against the JAX package's, on the CPU.

Both sides run the same parameters (JAX's ``Model.init`` draws them, the
JAX checkpoint writer saves them, the port loads them through its bridge)
and the same numpy-made tokens and audio frame embeddings.  Tolerances:
fp32 1e-4 (sums in another order); bf16 2e-2 with atol scaled by
max|out|, as ``tests/test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.models import Model as JModel
from repro.models import attention as ja
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import Model as TModel
from repro_torch.models import attention as ta

ARCH = "whisper-large-v3"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype, want):
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= float(np.abs(_np(want)).max())
    return tol


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


def _batch(cfg, B, S, seed=0):
    """numpy tokens [B,S] and audio frame embeddings [B, frames, d]."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32),
            "audio_embeds": rng.standard_normal(
                (B, cfg.max_source_positions, cfg.d_model)
            ).astype(np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long(),
            "audio_embeds": torch.from_numpy(batch["audio_embeds"])}


def test_model_stacks_the_encoder_and_gives_every_decoder_block_xattn():
    """The encoder stacked under ``encoder`` [R, ...] with ``enc_norm``
    beside it and non-causal; every decoder block cross-attends, with
    ``ln_x`` and ``xattn`` (the keys and shapes against JAX's:
    ``tests/test_torch_model.py``)."""
    cfg = tconfigs.get_smoke(ARCH)
    tm = TModel(cfg, dtype=torch.float32, device="cpu")
    tflat = bridge.to_flat(tm)
    assert tflat["encoder/attn/wq"].shape[0] == cfg.encoder_layers
    assert "enc_norm" in tflat and "segments/0/0/ln_x" in tflat
    assert "encoder/xattn/wq" not in tflat
    assert all(spec.cross for seg in tm.segments_spec for spec in seg.pattern)
    assert not tm.ENC_SPEC.causal and not tm.ENC_SPEC.cross


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    """``gqa_apply`` with ``kv_src``: K/V from the encoder states, no
    RoPE, no mask, no cache; S (6) differs from the states' length (10),
    so the port runs the plain path on either impl."""
    jd, td = DTYPES[dtype]
    cfg_j, cfg_t = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = ja.gqa_init(jax.random.PRNGKey(4), cfg_j, cross=True, dtype=jd)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(td)
          for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, cfg_j.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 10, cfg_j.d_model)).astype(np.float32)
    want, _ = ja.gqa_apply(jp, jnp.asarray(x, jd), cfg_j,
                           kv_src=jnp.asarray(src, jd), causal=False,
                           use_rope=False)
    for impl in ("kernel", "plain"):
        got, cache = ta.gqa_apply(tp, torch.from_numpy(x).to(td), cfg_t,
                                  kv_src=torch.from_numpy(src).to(td),
                                  impl=impl)
        assert cache is None
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, want))
    with pytest.raises(ValueError, match="no cache"):
        ta.gqa_apply(tp, torch.from_numpy(x), cfg_t, kv_src=torch.zeros(
            2, 10, cfg_t.d_model), cache={}, cache_index=0)


def test_sdpa_routes_whole_sequence_self_attention_to_the_kernel(
        monkeypatch):
    """On the "kernel" path sdpa hands self-attention over a whole
    sequence to K1, causal or not; cross-attention (S != T) and a cached
    decode call (k_valid_len) stay on the plain path.  The JAX package
    sends only the causal case to its kernel: the same function, held
    here to the plain path."""
    calls = []
    real = ops.flash_attention

    def record(q, k, v, *, causal, scale):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(ops, "flash_attention", record)
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 12, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    for causal in (True, False):
        got = ta.sdpa(q, k, v, causal=causal, impl="kernel")
        want = ta.sdpa(q, k, v, causal=causal, impl="plain")
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    ta.sdpa(q[:, :5], k, v, causal=False, impl="kernel")
    ta.sdpa(q[:, :1], k, v, causal=True, impl="kernel",
            q_positions=torch.tensor([11]),
            k_valid_len=torch.tensor([12, 12]))
    assert calls == [(12, 12, True), (12, 12, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, tmp_path):
    jm, params, tm = _pair(dtype, tmp_path)
    batch = _batch(jm.cfg, 2, 8)
    want = jax.jit(jm.forward)(params, _jbatch(batch))
    with torch.no_grad():
        got = tm(_tbatch(batch))
    assert got.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype, want))


def test_encoder_runs_k1_non_causal_and_cross_attention_plain(
        monkeypatch, tmp_path):
    """The forward hands each encoder layer's self-attention to K1 with
    causal=False over the frames (16 at smoke size) and each decoder
    layer's to K1 causal; cross-attention never reaches it."""
    calls = []
    real = ops.flash_attention

    def record(q, k, v, *, causal, scale):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(ops, "flash_attention", record)
    _, _, tm = _pair("float32", tmp_path)
    cfg = tm.cfg
    with torch.no_grad():
        tm(_tbatch(_batch(cfg, 2, 8)))
    F = cfg.max_source_positions
    assert calls == [(F, F, False)] * cfg.encoder_layers \
        + [(8, 8, True)] * cfg.n_layers


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_decode_with_enc_out_matches_jax(impl, tmp_path):
    """The port's one-call prefill and its token-by-token decode, both
    with ``enc_out`` from ``encode``, against JAX's token-by-token
    ``decode_step(..., enc_out=_encode(...))``: logits and the
    self-attention caches."""
    jm, params, tm = _pair("float32", tmp_path, impl)
    B, S, Tmax = 2, 8, 12
    batch = _batch(jm.cfg, B, S, seed=1)
    jenc = jax.jit(jm._encode)(params, _jbatch(batch))
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, Tmax)
    outs = []
    for t in range(S):
        logits, cache = step(params, cache,
                             jnp.asarray(batch["tokens"][:, t:t + 1]),
                             jnp.int32(t), enc_out=jenc)
        outs.append(logits[:, 0])
    by_token = jnp.stack(outs, axis=1)
    tb = _tbatch(batch)
    with torch.no_grad():
        enc = tm.encode(tb)
        np.testing.assert_allclose(_np(enc), _np(jenc), **TOL["float32"])
        got, tcache = tm.decode_step(tm.init_cache(B, Tmax), tb["tokens"], 0,
                                     enc_out=enc)
        seq = tm.init_cache(B, Tmax)
        got_seq = torch.cat([tm.decode_step(seq, tb["tokens"][:, t:t + 1],
                                            t, enc_out=enc)[0]
                             for t in range(S)], dim=1)
    np.testing.assert_allclose(_np(got), _np(by_token), **TOL["float32"])
    np.testing.assert_allclose(_np(got_seq), _np(by_token), **TOL["float32"])
    for si, seg in enumerate(tcache):
        for j, c in enumerate(seg):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _np(c["attn"][name]), _np(cache[si][j]["attn"][name]),
                    **TOL["float32"])


def test_greedy_serve_tokens_match_jax(tmp_path):
    """``serve.generate`` (encode once, one-call prefill, then decode with
    the states) picks the same 8 greedy tokens as JAX's decode step driven
    token by token with ``enc_out`` (JAX's serve step passes none)."""
    jm, params, tm = _pair("float32", tmp_path)
    B, P, gen = 2, 8, 8
    batch = _batch(jm.cfg, B, P, seed=2)
    jenc = jax.jit(jm._encode)(params, _jbatch(batch))
    step = jax.jit(lambda p, c, t, i: jm.decode_step(p, c, t, i,
                                                     enc_out=jenc))
    cache = jm.init_cache(B, P + gen)

    def greedy(logits):
        return jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)

    prompts = batch["tokens"]
    for t in range(P):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, t:t + 1]),
                             jnp.int32(t))
    want = [greedy(logits)]
    for t in range(P, P + gen - 1):
        logits, cache = step(params, cache, want[-1], jnp.int32(t))
        want.append(greedy(logits))
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    with torch.inference_mode():
        got = tserve.generate(tm, _tbatch(batch), gen)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_setup_draws_audio_frames_from_the_seed():
    cfg = tconfigs.get_smoke(ARCH)
    _, a = tserve.setup(cfg, 2, 5, "cpu", dtype=torch.float32, seed=4)
    _, b = tserve.setup(cfg, 2, 5, "cpu", dtype=torch.float32, seed=4)
    assert set(a) == {"tokens", "audio_embeds"}
    assert tuple(a["audio_embeds"].shape) == (2, cfg.max_source_positions,
                                              cfg.d_model)
    assert torch.equal(a["audio_embeds"], b["audio_embeds"])
    assert torch.equal(a["tokens"], b["tokens"])


def test_full_width_config_has_the_published_shape():
    """whisper-large-v3: 32 encoder and 32 decoder layers of d_model 1280,
    20 heads of 64, GELU d_ff 5120, 1500 frames; the served prompt and
    generation stay inside its 448-token decoder context."""
    cfg = tconfigs.get(ARCH)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.mlp_type,
            cfg.max_source_positions) == (32, 32, 1280, 20, 64, 5120, "gelu",
                                          1500)
    assert tserve.ENC_PROMPT + tserve.ENC_GEN <= 448
    n = sum(p.numel() for p in TModel(cfg, device="meta").parameters())
    assert n == pytest.approx(1.601e9, rel=1e-3)


def test_decode_step_needs_enc_out():
    """An encoder-decoder model's decode step without the encoder's
    states raises, where it would otherwise skip every cross-attention
    block and return another model's logits."""
    cfg = tconfigs.get_smoke(ARCH)
    tm = TModel(cfg, TRunConfig(attn_impl="plain"), dtype=torch.float32,
                device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.long)
    with torch.inference_mode(), pytest.raises(ValueError, match="enc_out"):
        tm.decode_step(tm.init_cache(2, 4), tokens, 0)
