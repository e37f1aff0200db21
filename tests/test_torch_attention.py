"""Port attention against the JAX package's, in fp32 on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as ja
from repro_torch import configs as tconfigs
from repro_torch.models import attention as ta

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["plain", "positions_1d", "positions_2d",
                                  "valid_len"])
def test_sdpa_plain_matches_jax(case, causal):
    rng = np.random.default_rng(0)
    B, S, T, H, K, hd = 2, 4, 10, 4, 2, 16
    if case == "plain":
        T = S
    q, k, v = _rand(rng, B, S, H, hd), _rand(rng, B, T, K, hd), \
        _rand(rng, B, T, K, hd)
    kw = {}
    if case == "positions_1d":
        kw["q_positions"] = np.arange(S, dtype=np.int32) + 5
    elif case == "positions_2d":
        kw["q_positions"] = np.stack([np.arange(S) + 2,
                                      np.arange(S) + 6]).astype(np.int32)
    elif case == "valid_len":
        kw["q_positions"] = np.arange(S, dtype=np.int32) + 3
        kw["k_valid_len"] = np.array([7, 5], np.int32)
    want = ja.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, impl="xla",
                   **{n: jnp.asarray(a) for n, a in kw.items()})
    got = ta.sdpa(_t(q), _t(k), _t(v), causal=causal, impl="plain",
                  **{n: _t(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdpa_rejects_unknown_impl():
    q = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError):
        ta.sdpa(q, q, q, causal=True, impl="xla")


def _cfg(arch):
    return jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)


def _params(cfg, rng):
    return {name: _rand(rng, *shape) * scale
            for name, (shape, scale) in ta.gqa_shapes(cfg).items()}


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "chatglm3-6b"])
def test_gqa_apply_train_matches_jax(arch, impl):
    jcfg, tcfg = _cfg(arch)
    rng = np.random.default_rng(1)
    p = _params(tcfg, rng)
    x = _rand(rng, 2, 8, tcfg.d_model)
    pos = np.arange(8, dtype=np.int32)
    want, _ = ja.gqa_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                           impl="xla")
    got, cache = ta.gqa_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                              positions=_t(pos), impl=impl)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("index,S", [(0, 5), (0, 1), (3, 1), (4, 2)])
def test_gqa_apply_cached_matches_jax(index, S, impl):
    """A cached call writes rows index..index+S and attends over them and
    the rows before; at index 0 the kernel path takes the whole prompt."""
    jcfg, tcfg = _cfg("chatglm3-6b")
    rng = np.random.default_rng(2)
    p = _params(tcfg, rng)
    Tmax, B = 8, 2
    ck = _rand(rng, B, Tmax, tcfg.n_kv_heads, tcfg.head_dim)
    cv = _rand(rng, B, Tmax, tcfg.n_kv_heads, tcfg.head_dim)
    x = _rand(rng, B, S, tcfg.d_model)
    want, jc = ja.gqa_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg,
                            cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                            cache_index=jnp.int32(index), impl="xla")
    tc = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    got, tc2 = ta.gqa_apply({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                            cache=tc, cache_index=index, impl=impl)
    assert tc2 is tc                                     # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_gqa_apply_rejects_writes_past_the_cache():
    _, tcfg = _cfg("deepseek-7b")
    p = {k: torch.zeros(s) for k, (s, _) in ta.gqa_shapes(tcfg).items()}
    cache = ta.gqa_cache_init(tcfg, 1, 4, dtype=torch.float32)
    with pytest.raises(IndexError):
        ta.gqa_apply(p, torch.zeros(1, 2, tcfg.d_model), tcfg, cache=cache,
                     cache_index=3)


def test_gqa_cache_init_shapes():
    _, tcfg = _cfg("chatglm3-6b")
    c = ta.gqa_cache_init(tcfg, 3, 9, dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in c.items()} == {
        n: ((3, 9, tcfg.n_kv_heads, tcfg.head_dim), torch.bfloat16)
        for n in ("k", "v")}
