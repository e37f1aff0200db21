"""The port's AdamW, cosine schedule and synthetic data against the JAX
package's, on the CPU, from the same numpy-made parameters, gradients and
seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

# name -> shape: a stacked norm [R, d] (decayed: ndim 2, as in JAX), a
# final norm [d] (not decayed), a dense weight and a stacked one
SHAPES = {"norm_stack": (2, 8), "final_norm": (8,), "w": (8, 12),
          "stack.wq": (2, 8, 4)}
STEPS = 5


class _Params(nn.Module):
    def __init__(self, arrays: dict, dtype):
        super().__init__()
        self.p = nn.ParameterDict({
            k.replace(".", "_"): nn.Parameter(torch.from_numpy(a).to(dtype))
            for k, a in arrays.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("step", [0, 1, 3, 4, 10, 55, 100, 120])
def test_cosine_schedule_matches_jax(step):
    got = cosine_schedule(3e-3, warmup=4, total=100, floor=0.1)(step)
    want = float(jcosine(3e-3, warmup=4, total=100, floor=0.1)(step))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_trajectory_matches_jax(dtype):
    """Five steps from the same parameters and gradients: the cosine
    schedule's warm-up, global-norm clipping (the gradients' global norm
    is ~40, against a clip of 5), bias correction and decay by ndim.  fp32
    moments on both sides; parameters in the given dtype.  fp32: 1e-5
    relative (operations in another order; the moments' absolute part
    scaled by max|m|, where a sum cancels); bf16 parameters: 2e-2
    (tests/test_models.py:113), a last-bit difference before the rounding
    moving one bf16 step."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=5.0)

    jopt = JAdamW(JAdamWConfig(lr=jcosine(0.05, warmup=2, total=STEPS),
                               **kw))
    jparams = {k: jnp.asarray(a, jd) for k, a in arrays.items()}
    jstate = jopt.init(jparams)
    topt = AdamW(AdamWConfig(lr=cosine_schedule(0.05, warmup=2,
                                                total=STEPS), **kw))
    module = _Params(arrays, td)
    tstate = topt.init(module)

    def name(k):
        return "p." + k.replace(".", "_")

    ptol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    for g in grads:
        jparams, jstate = jax.jit(jopt.update)(
            {k: jnp.asarray(a, jd) for k, a in g.items()}, jstate, jparams)
        tstate = topt.update({name(k): torch.from_numpy(a).to(td)
                              for k, a in g.items()}, tstate, module)
        assert int(tstate["step"]) == int(jstate["step"])
        for k in SHAPES:
            got = dict(module.named_parameters())[name(k)]
            assert got.dtype == td
            np.testing.assert_allclose(_np(got), _np(jparams[k]), **ptol,
                                       err_msg=k)
            for mom in ("m", "v"):
                assert tstate[mom][name(k)].dtype == torch.float32
                want = _np(jstate[mom][k])
                np.testing.assert_allclose(
                    _np(tstate[mom][name(k)]), want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max(), err_msg=f"{mom} {k}")


def test_weight_decay_follows_the_stored_ndim():
    """With zero gradients only decay moves a parameter: [R, d] norms and
    dense weights shrink by lr·wd, a [d] vector stays."""
    arrays = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    module = _Params(arrays, torch.float32)
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.5))
    state = opt.init(module)
    opt.update({n: torch.zeros_like(p) for n, p in module.named_parameters()},
               state, module)
    for n, p in module.named_parameters():
        want = 1.0 if p.ndim < 2 else 1.0 - 0.1 * 0.5
        torch.testing.assert_close(p, torch.full_like(p, want))


def test_8bit_moments_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 4"):
        AdamW(AdamWConfig(state_8bit=True))


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 0), (3, 1234),
                                       (17, 42)])
def test_synthetic_batches_equal_jax(seed, step):
    cfg = dict(vocab_size=300, seq_len=40, global_batch=3, seed=seed)
    want = np.asarray(JSyntheticLM(JDataConfig(**cfg)).batch_at(step)
                      ["tokens"])
    got = SyntheticLM(DataConfig(**cfg), "cpu").batch_at(step)["tokens"]
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
