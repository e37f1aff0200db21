"""The port's fp8 error-feedback gradient compression against the JAX
package's ``repro.optim.compression``, on the CPU, from the same numpy-made
gradients and error accumulators."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.optim import compression

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _inputs(shape, seed, zero=False):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * np.exp(
        2 * rng.standard_normal(shape))).astype(np.float32)
    if zero:
        g[...] = 0.0
    err = (1e-2 * rng.standard_normal(shape)).astype(np.float32)
    return g, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,zero", [((3, 40, 24), False), ((200,), False),
                                        ((8, 8), True)])
def test_compress_leaf_matches_jax(shape, zero, dtype):
    """fp8 codes, scale and the new error equal to JAX's bit for bit (both
    cast rounding to nearest even), for an fp32 or bf16 gradient whose
    entries span ~10 binades, and for a zero gradient (scale 1e-12 / 448,
    every code the error's).  JAX runs as written, op by op: under
    ``jax.jit`` XLA folds the division by 448 into a multiply by its fp32
    reciprocal, one ulp off the quotient for some absmax values."""
    jd, td = DTYPES[dtype]
    g, err = _inputs(shape, 0, zero)
    jg8, js, jerr = jcomp.compress_leaf(jnp.asarray(g, jd), jnp.asarray(err))
    g8, s, new_err = compression.compress_leaf(
        torch.from_numpy(g).to(td), torch.from_numpy(err))
    assert g8.dtype == compression.F8 and tuple(g8.shape) == shape
    assert s.dtype == new_err.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(_np(g8), _np(jg8))
    np.testing.assert_array_equal(_np(s), _np(js))
    np.testing.assert_array_equal(_np(new_err), _np(jerr))
    np.testing.assert_array_equal(
        _np(compression.decompress_leaf(g8, s)),
        _np(jcomp.decompress_leaf(jg8, js)))
    assert np.abs(_np(g8)).max() <= compression.F8_MAX


def test_compress_tree_matches_jax_and_keeps_the_residual():
    """Over a tree keyed by parameter name: every code, scale and error as
    JAX's, and ``decompress(g8, scale) + new_err == g + err`` to fp32
    rounding (the residual is what the cast left out)."""
    shapes = {"embed": (64, 16), "segments.0.0.attn.wq": (2, 16, 32),
              "final_norm": (16,)}
    g = {k: _inputs(s, i)[0] for i, (k, s) in enumerate(shapes.items())}
    err = {k: _inputs(s, i + 10)[1] for i, (k, s) in enumerate(shapes.items())}
    tg8, ts, terr = compression.compress_tree(
        {k: torch.from_numpy(a) for k, a in g.items()},
        {k: torch.from_numpy(a) for k, a in err.items()})
    jg8, js, jerr = jcomp.compress_tree(
        {k: jnp.asarray(a) for k, a in g.items()},
        {k: jnp.asarray(a) for k, a in err.items()})
    back = compression.decompress_tree(tg8, ts)
    assert tg8.keys() == ts.keys() == terr.keys() == back.keys() == g.keys()
    for k in shapes:
        np.testing.assert_array_equal(_np(tg8[k]), _np(jg8[k]))
        np.testing.assert_array_equal(_np(ts[k]), _np(js[k]))
        np.testing.assert_array_equal(_np(terr[k]), _np(jerr[k]))
        total = g[k] + err[k]
        np.testing.assert_allclose(_np(back[k]) + _np(terr[k]), total,
                                   rtol=1e-6,
                                   atol=1e-6 * np.abs(total).max())


def test_error_state_and_tree_keys():
    """``init_error_state`` is a zero fp32 tensor per parameter, on its
    device; gradients and error state with other keys are refused."""
    model = torch.nn.Linear(3, 2).to(torch.bfloat16)
    err = compression.init_error_state(model)
    assert err.keys() == {"weight", "bias"}
    assert all(e.dtype == torch.float32 and not e.any() for e in err.values())
    assert tuple(err["weight"].shape) == (2, 3)
    with pytest.raises(KeyError, match="bias"):
        compression.compress_tree({"weight": torch.ones(2, 3)}, err)
