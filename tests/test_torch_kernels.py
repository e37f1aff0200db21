"""K1 (flash attention): the port's wrapper against the JAX package's; and
the C interfaces of K1, K2 and K3 against their ctypes bindings.

On the CPU the port's wrapper runs K1's plain version; JAX runs the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` does.  The CUDA
kernel itself is tested on the card by ``tests/test_torch_gpu.py``.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),       # tests/test_kernels.py:15
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(B, S, H, K, hd, hdv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, K, hd), dtype=np.float32),
            rng.standard_normal((B, S, K, hdv), dtype=np.float32))


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd,H,K", [
    (128, 32, 2, 2),    # MHA
    (128, 64, 4, 2),    # GQA 2:1
    (256, 32, 4, 1),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(S, hd, H, K, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, S, H, K, hd, hd), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    before = tops.flash_attention.launches
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert tops.flash_attention.launches == before   # the CPU never counts
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_unequal_head_dims(causal):
    """hd != hd_v, as MLA needs (24/16 is deepseek-v3's smoke shape)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 128, 4, 2, 24, 16),
                                       "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, 128, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_plain_takes_ragged_length():
    """S need not be a multiple of a block (the Pallas wrapper asserts it):
    held against the JAX oracle at S=100 with an explicit scale."""
    q, k, v = _inputs(2, 100, 4, 2, 32, 32)
    want = jref.flash_attention_ref(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        causal=True, scale=0.3)
    got = tref.flash_attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=True, scale=0.3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_wrapper_rejects_other_devices():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        tops.flash_attention(q, q, q)


def test_launcher_takes_only_cuda_tensors():
    """The kernel's own entry point never runs the plain version."""
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, q, q)


# ---------------------------------------------------------------------------
# The C interfaces, read from the sources: a mismatch between a library's
# extern "C" functions and the ctypes types its module binds them with
# would only show as a crash on the card.  Nothing here builds.
_C_KINDS = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float, "const char*": ctypes.c_char_p}
_MODULES = (tfa, tssd, tgmm)


def _c_type(text):
    ctype = re.sub(r"\s+", " ", text).strip().replace(" *", "*")
    assert ctype in _C_KINDS, f"unknown C type {ctype!r}"
    return _C_KINDS[ctype]


def _c_functions(source):
    """Each ``extern "C"`` function of a source: name -> (the ctypes kinds
    of its parameters, that of its result)."""
    found = {}
    for ret, name, params in re.findall(
            r'extern "C" ([\w ]+?\*?) ?(\w+)\(([^)]*)\)',
            source.read_text()):
        kinds = [_c_type(p.strip().rsplit(" ", 1)[0])
                 for p in params.split(",") if p.strip()]
        found[name] = (kinds, _c_type(ret))
    return found


def test_every_c_function_is_bound():
    for module in _MODULES:
        assert set(_c_functions(module.SOURCE)) == set(module.C_FUNCTIONS)


@pytest.mark.parametrize("module,function", [
    (module, name) for module in _MODULES for name in module.C_FUNCTIONS])
def test_c_interface_matches_argtypes(module, function):
    argtypes, restype = module.C_FUNCTIONS[function]
    assert _c_functions(module.SOURCE)[function] == (list(argtypes), restype)
