"""The port's model, serve loop and weight bridge against the JAX package.

Both sides run the same parameters: JAX's ``Model.init`` draws them, the
JAX checkpoint writer saves them, and the port loads them through its
bridge (``jax.random`` numbers cannot be drawn in PyTorch).
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
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import Model as TModel

ARCHS = ["deepseek-7b", "chatglm3-6b"]      # dense GQA; chatglm3: 2d RoPE
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),   # sums in another order
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}  # tests/test_models.py:113


def _pair(arch, dtype, tmp_path, impl="kernel"):
    """(JAX model, its params, port model with the same params)."""
    jd, td = DTYPES[dtype]
    jm = JModel(jconfigs.get_smoke(arch),
                JRunConfig(remat=False,
                           attn_impl="pallas" if impl == "kernel" else "xla"),
                dtype=jd)
    params = jm.init(jax.random.PRNGKey(3))
    step_dir = ckpt.save(str(tmp_path), 0, params)
    tm = TModel(tconfigs.get_smoke(arch), TRunConfig(attn_impl=impl),
                dtype=td, device="cpu")
    bridge.from_flat(bridge.load_npz(step_dir), tm)
    return jm, params, tm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dtype, tmp_path):
    jm, params, tm = _pair(arch, dtype, tmp_path)
    tokens = _tokens(jm.cfg, 2, 16)
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tm({"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == tuple(want.shape)
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        # a bf16 logit's rounding error comes from sums over d_model, so it
        # scales with the logits' magnitude, not with the element's own: at
        # max|logit| ~4.3 JAX's own "pallas" and "xla" paths differ by 0.05
        tol["atol"] *= float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-coder-33b",
                                  "internvl2-2b"])
def test_forward_other_dense_archs_match_jax(arch, tmp_path):
    """The other attention + dense-FFN families: relu2 (nemotron), GQA 7:1
    (deepseek-coder) and a vision prefix through vis_proj (internvl2)."""
    jm, params, tm = _pair(arch, "float32", tmp_path)
    tokens = _tokens(jm.cfg, 2, 16)
    batch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens).long()}
    if jm.cfg.vision_embed_dim:
        vis = np.random.default_rng(5).standard_normal(
            (2, jm.cfg.vision_seq, jm.cfg.vision_embed_dim)).astype(np.float32)
        batch["vision_embeds"] = jnp.asarray(vis)
        tbatch["vision_embeds"] = torch.from_numpy(vis)
    want = jax.jit(jm.forward)(params, batch)
    with torch.no_grad():
        got = tm(tbatch)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_call_prefill_matches_jax_decode(arch, impl, tmp_path):
    """decode_step(prompt, 0) in one call equals JAX's one-call and
    token-by-token decode_step, and leaves the same cache."""
    jm, params, tm = _pair(arch, "float32", tmp_path, impl)
    B, S, Tmax = 2, 8, 12
    tokens = _tokens(jm.cfg, B, S, seed=1)
    step = jax.jit(jm.decode_step)
    one_call, jcache = step(params, jm.init_cache(B, Tmax),
                            jnp.asarray(tokens), jnp.int32(0))
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
    np.testing.assert_allclose(_np(got), _np(one_call), **TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(by_token), **TOL["float32"])
    for si, seg in enumerate(tcache):
        for j, c in enumerate(seg):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _np(c["attn"][name]), _np(jcache[si][j]["attn"][name]),
                    **TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_tokens_match_jax(arch, tmp_path):
    """The port's serve loop (one-call prefill, then token by token) picks
    the same 8 greedy tokens as JAX's serve step driven as its serve.main
    drives it (prefill token by token)."""
    jm, params, tm = _pair(arch, "float32", tmp_path)
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
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_checkpoint_bridge_round_trip_is_exact(tmp_path):
    """JAX ckpt.save (bf16 params as fp32 upcasts) → load_npz → from_flat →
    to_flat gives back the saved arrays bit for bit."""
    jm, params, tm = _pair("chatglm3-6b", "bfloat16", tmp_path)
    flat = bridge.load_npz(str(tmp_path / "step_00000000"))
    assert "segments/0/0/attn/wq" in flat
    assert flat["segments/0/0/attn/wq"].shape == (
        jm.cfg.n_layers, jm.cfg.d_model, jm.cfg.n_heads * jm.cfg.head_dim)
    back = bridge.to_flat(tm)
    assert sorted(back) == sorted(flat)
    for key in flat:
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], flat[key])


def test_bridge_rejects_mismatched_keys_and_shapes(tmp_path):
    tm = TModel(tconfigs.get_smoke("deepseek-7b"), dtype=torch.float32,
                device="cpu")
    flat = bridge.to_flat(tm)
    with pytest.raises(KeyError):
        bridge.from_flat({k: v for k, v in flat.items() if k != "embed"}, tm)
    flat["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        bridge.from_flat(flat, tm)


def test_init_matches_reference_shapes_and_scales():
    jm = JModel(jconfigs.get_smoke("deepseek-7b"), JRunConfig(remat=False),
                dtype=jnp.float32)
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jm.init(jax.random.PRNGKey(0)))[0]}
    tm = TModel(tconfigs.get_smoke("deepseek-7b"), dtype=torch.float32,
                device="cpu").init(torch.Generator().manual_seed(0))
    tflat = bridge.to_flat(tm)
    assert sorted(tflat) == sorted(jflat)
    for key, arr in jflat.items():
        assert tflat[key].shape == arr.shape, key
        np.testing.assert_allclose(tflat[key].std(), arr.std(), rtol=0.15,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("argv", [
    ["--device", "cpu"],
    ["--device", "cpu", "--arch", "chatglm3-6b", "--batch", "2",
     "--prompt-len", "20", "--gen", "3"],
    ["--device", "cpu", "--arch", "deepseek-v3-671b", "--batch", "2",
     "--gen", "4"],
    ["--device", "cpu", "--arch", "whisper-large-v3", "--batch", "2",
     "--gen", "4"],
])
def test_serve_main_on_cpu(argv, capsys):
    out = tserve.main(argv)
    args = dict(zip(argv[::2], argv[1::2]))
    B, gen = int(args.get("--batch", 4)), int(args.get("--gen", 32))
    assert tuple(out.shape) == (B, gen)
    # the default arch is mamba2-130m, as in the JAX package's serve.main
    cfg = tconfigs.get_smoke(args.get("--arch", "mamba2-130m"))
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    assert f"served {B} requests of {cfg.name}" in capsys.readouterr().out


def test_model_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Model() builds on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TModel(tconfigs.get_smoke("deepseek-7b"))


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_every_arch_builds_with_the_jax_parameter_tree(arch):
    """All ten architectures build on the CPU at smoke size, with JAX's
    ``Model.init`` keys and shapes (MLA, ``mtp/...`` unstacked, whisper's
    ``encoder/...`` and cross-attention included), and fill them."""
    jm = JModel(jconfigs.get_smoke(arch), JRunConfig(remat=False),
                dtype=jnp.float32)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]}
    tm = TModel(tconfigs.get_smoke(arch), dtype=torch.float32,
                device="cpu").init(torch.Generator().manual_seed(0))
    tflat = bridge.to_flat(tm)
    assert {k: v.shape for k, v in tflat.items()} == want
    assert all(np.isfinite(v).all() for v in tflat.values())


@pytest.mark.parametrize("arch,keys", [
    ("deepseek-v3-671b", ("mtp/proj", "mtp/ln", "mtp/block/attn/wq_a",
                          "mtp/block/mlp/w_gate", "segments/1/0/moe/w_in")),
    ("whisper-large-v3", ("encoder/attn/wq", "encoder/mlp/w_in", "enc_norm",
                          "segments/0/0/xattn/wv", "segments/0/0/ln_x")),
])
def test_checkpoint_bridge_round_trip_keeps_mtp_and_encoder_keys(
        arch, keys, tmp_path):
    """A JAX bf16 save of deepseek-v3 (MLA, a dense then an MoE segment,
    the unstacked MTP head) and of whisper (the stacked encoder, the
    cross-attention) loads through the bridge and comes back bit for bit;
    the MTP block has no repeat axis."""
    jm = JModel(jconfigs.get_smoke(arch), JRunConfig(remat=False),
                dtype=jnp.bfloat16)
    step_dir = ckpt.save(str(tmp_path), 0, jm.init(jax.random.PRNGKey(1)))
    flat = bridge.load_npz(step_dir)
    tm = TModel(tconfigs.get_smoke(arch), dtype=torch.bfloat16,
                device="cpu")
    bridge.from_flat(flat, tm)
    back = bridge.to_flat(tm)
    assert set(keys) <= set(flat) and sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    if jm.cfg.mtp:
        d = jm.cfg.d_model
        assert flat["mtp/proj"].shape == (2 * d, d)
        assert flat["mtp/block/attn/wkv_a"].shape == (
            d, jm.cfg.kv_lora_rank + jm.cfg.qk_rope_head_dim)


@pytest.mark.parametrize("field,value", [
    ("remat", False), ("microbatches", 4), ("logits_fp32", False),
    ("fsdp", True), ("sync_mode", "bucketed"), ("opt_8bit", True),
    ("grad_compression", True),
])
def test_unimplemented_run_options_raise(field, value):
    """The fields the training step reads (``remat``, ``microbatches``,
    ``logits_fp32``, ``opt_8bit``, ``grad_compression``, ``sync_mode``,
    ``fsdp``) build; every other one (the JAX package's "model" mesh
    axis) set away from its default raises, naming itself."""
    run = dataclasses.replace(TRunConfig(), **{field: value})
    if field in ("remat", "microbatches", "logits_fp32", "opt_8bit",
                 "grad_compression", "sync_mode", "fsdp"):
        tm = TModel(tconfigs.get_smoke("deepseek-7b"), run, device="cpu")
        assert getattr(tm.run, field) == value
        return
    with pytest.raises(NotImplementedError, match=field):
        TModel(tconfigs.get_smoke("deepseek-7b"), run, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_model_builds(dtype):
    """SSM blocks are ported: mamba2-130m builds, with the JAX parameter
    names, and serves a prompt on the CPU."""
    cfg = tconfigs.get_smoke("mamba2-130m")
    tm = TModel(cfg, dtype=dtype, device="cpu").init(
        torch.Generator().manual_seed(0))
    names = {name for name, _ in tm.named_parameters()}
    assert {f"segments.0.0.ssm.{k}" for k in (
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
        "out_proj")} <= names
    with torch.inference_mode():
        out = tserve.generate(
            tm, {"tokens": torch.zeros((2, 8), dtype=torch.long)}, 3)
    assert tuple(out.shape) == (2, 3)


@pytest.mark.parametrize("ssm_chunk,ok", [(0, True), (4, True), (3, False)])
def test_ssm_chunk_is_honoured(ssm_chunk, ok):
    """RunConfig.ssm_chunk is read, not refused: it replaces the config's
    chunk (8 at smoke size), and a chunk that does not divide the prompt
    raises as the JAX scan asserts."""
    tm = TModel(tconfigs.get_smoke("mamba2-130m"),
                TRunConfig(ssm_chunk=ssm_chunk), dtype=torch.float32,
                device="cpu").init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.long)}
    if ok:
        assert tuple(tm(batch).shape) == (1, 16, tm.cfg.vocab_size)
    else:
        with pytest.raises(ValueError, match="multiple of the chunk 3"):
            tm(batch)
