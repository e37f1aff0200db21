"""Port layers against the JAX package's, in fp32 on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    w, x = _rand(rng, 64), _rand(rng, 2, 8, 64)
    want = jl.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-5)
    got = tl.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rmsnorm_keeps_input_dtype():
    x = torch.randn(2, 3, 16).to(torch.bfloat16)
    assert tl.rmsnorm(torch.ones(16), x).dtype == torch.bfloat16


@pytest.mark.parametrize("batched_positions", [False, True])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_interleaved_with_offset_positions(fraction,
                                                      batched_positions):
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 6, 3, 16
    x = _rand(rng, B, S, H, hd)
    pos = 7 + np.arange(S, dtype=np.int32)          # decode-style offsets
    if batched_positions:
        pos = np.stack([pos, pos + 11])
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                        fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if fraction < 1.0:      # the unrotated half passes through unchanged
        np.testing.assert_array_equal(got.numpy()[..., hd // 2:],
                                      x[..., hd // 2:])


def test_rope_freqs():
    np.testing.assert_allclose(tl.rope_freqs(128, 1e4, 0.5).numpy(),
                               np.asarray(jl.rope_freqs(128, 1e4, 0.5)),
                               **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp(kind):
    rng = np.random.default_rng(2)
    d, ff = 32, 64
    shapes = tl.mlp_shapes(d, ff, kind)
    p = {name: _rand(rng, *shape) * scale
         for name, (shape, scale) in shapes.items()}
    x = _rand(rng, 2, 5, d)
    want = jl.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  kind)
    got = tl.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_init_matches_reference_shapes_and_scales(kind):
    """Same names, shapes and init scales as the JAX package's mlp_init."""
    import jax
    jp = jl.mlp_init(jax.random.PRNGKey(0), 256, 512, kind, jnp.float32)
    tp = tl.mlp_init(torch.Generator().manual_seed(0), 256, 512, kind,
                     torch.float32)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape
        np.testing.assert_allclose(float(tp[name].std()),
                                   float(jnp.std(jp[name])), rtol=0.05)
