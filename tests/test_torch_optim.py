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
from repro.optim import adamw as jadamw
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import AdamW, AdamWConfig, adamw, cosine_schedule

# name -> shape: a stacked norm [R, d] (decayed: ndim 2, as in JAX), a
# final norm [d] (not decayed), a dense weight and a stacked one
SHAPES = {"norm_stack": (2, 8), "final_norm": (8,), "w": (8, 12),
          "stack.wq": (2, 8, 4)}
STEPS = 5


class _Params(nn.Module):
    """The arrays as parameters, copied: an fp32 parameter made by
    ``from_numpy`` would share its buffer with the array, which JAX on the
    CPU may read, asynchronously, while the update writes it."""

    def __init__(self, arrays: dict, dtype):
        super().__init__()
        self.p = nn.ParameterDict({
            k.replace(".", "_"): nn.Parameter(torch.tensor(a, dtype=dtype))
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
    """ROADMAP Queue 1 item 4 is ported: 8-bit moments build, each an int8
    ``q`` of the parameter's shape and an fp32 ``s`` of its shape with the
    last axis 1 (``(1,)`` for a 1-D parameter), as JAX's ``init`` makes
    them."""
    arrays = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    state = AdamW(AdamWConfig(state_8bit=True)).init(
        _Params(arrays, torch.float32))
    jstate = JAdamW(JAdamWConfig(state_8bit=True)).init(
        {k: jnp.asarray(a) for k, a in arrays.items()})
    for k in SHAPES:
        for mom in ("m", "v"):
            got, want = state[mom][_name(k)], jstate[mom][k]
            assert got.keys() == want.keys() == {"q", "s"}
            assert got["q"].dtype == torch.int8
            assert got["s"].dtype == torch.float32
            for part in ("q", "s"):
                assert tuple(got[part].shape) == want[part].shape
                assert not got[part].any()


def _name(k):
    return "p." + k.replace(".", "_")


# the 8-bit tests: a stacked weight, a stacked norm, a final norm and a
# dense weight, 99,072 elements in all, so that a share of 1e-4 of the
# codes is a count of ~20
SHAPES_8BIT = {"stack.w": (2, 64, 256), "norm_stack": (2, 256),
               "final_norm": (256,), "w": (128, 512)}


@pytest.mark.parametrize("shape,zero_row", [
    ((5, 7, 33), (1, 2)), ((40,), None), ((3, 1, 8), None),
    ((6, 128), (0,)),
])
def test_quant8_matches_jax(shape, zero_row):
    """Codes and scales equal to JAX's ``_quant8`` as written (op by op),
    rows of very different sizes, a zero row (scale 1e-12 / 127, codes
    0) and a 1-D tensor (one scale); ``_dequant8`` equal too.  (Under
    ``jax.jit`` XLA folds the division by 127 into a multiply by its fp32
    reciprocal, which moves ~4% of the scales by one ulp.)"""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * np.exp(
        3 * rng.standard_normal(shape[:-1] + (1,)))).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    q, s = adamw._quant8(torch.from_numpy(x))
    jq, js = jadamw._quant8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(adamw._dequant8(q, s).numpy(),
                                  np.asarray(jadamw._dequant8(jq, js)))


def _8bit_state(jstate):
    """The port's AdamW state from JAX's (8-bit moments)."""
    def moment(mom):
        return {_name(k): {part: torch.from_numpy(np.array(v[part]))
                           for part in ("q", "s")}
                for k, v in jstate[mom].items()}
    return {"step": torch.tensor(int(jstate["step"]), dtype=torch.int32),
            "m": moment("m"), "v": moment("v")}


@pytest.mark.parametrize("clip_norm", [5.0, None])
def test_adamw_8bit_steps_match_jax(clip_norm):
    """20 steps of ``AdamW(state_8bit=True)`` beside JAX's jitted update,
    the port starting each step from JAX's parameters and state: the int8
    codes differ from JAX's by at most 1, on at most 1e-4 of them (a
    last-bit difference of the fp32 m or v before the rounding: XLA fuses
    b1·m + (1−b1)·g into one FMA, and the global norm is summed in
    another order), the scales and the parameters within 1e-6 of each
    tensor's max.  Two runs that each carry their own state drift apart
    where a code once differed: in 20 steps of these shapes 11-15
    elements, one by 2 codes by the end (the reference's int8 moments
    amplify a one-code difference of a small v; ROADMAP Queue 3)."""
    rng = np.random.default_rng(5)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES_8BIT.items()}
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              clip_norm=clip_norm, state_8bit=True)
    jopt = JAdamW(JAdamWConfig(lr=jcosine(0.05, warmup=2, total=20), **kw))
    topt = AdamW(AdamWConfig(lr=cosine_schedule(0.05, warmup=2, total=20),
                             **kw))
    jparams = {k: jnp.asarray(a) for k, a in arrays.items()}
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    module = _Params(arrays, torch.float32)
    n_codes = 2 * sum(a.size for a in arrays.values())
    for _ in range(20):
        g = {k: (3 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES_8BIT.items()}
        with torch.no_grad():
            for k, p in jparams.items():
                module.p[_name(k)[2:]].copy_(torch.from_numpy(np.array(p)))
        tstate = _8bit_state(jstate)
        jparams, jstate = jupdate({k: jnp.asarray(a) for k, a in g.items()},
                                  jstate, jparams)
        tstate = topt.update({_name(k): torch.from_numpy(a)
                              for k, a in g.items()}, tstate, module)
        differ = 0
        for k in SHAPES_8BIT:
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(
                _np(dict(module.named_parameters())[_name(k)]), want,
                rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=k)
            for mom in ("m", "v"):
                got, want = tstate[mom][_name(k)], jstate[mom][k]
                d = got["q"].numpy().astype(int) - np.asarray(want["q"])
                assert np.abs(d).max() <= 1, (k, mom)
                differ += int((d != 0).sum())
                ws = np.asarray(want["s"])
                np.testing.assert_allclose(got["s"].numpy(), ws, rtol=0,
                                           atol=1e-6 * ws.max())
        assert differ <= 1e-4 * n_codes


@pytest.mark.parametrize("state_8bit", [False, True])
def test_slice_walked_update_equals_the_whole_tensor(state_8bit,
                                                     monkeypatch):
    """With ``SLICE_NUMEL`` below a tensor's size the update walks its
    leading axes (a [2, 64, 256] stack in four [32, 256] slices, each
    entry of its first axis walked; a [128, 512] weight in eight runs of
    16 rows): parameters and moments bit-equal to the whole-tensor
    update's, three steps running."""
    rng = np.random.default_rng(6)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES_8BIT.items()}
    grads = [{_name(k): torch.from_numpy(
        (3 * rng.standard_normal(s)).astype(np.float32))
        for k, s in SHAPES_8BIT.items()} for _ in range(3)]
    out = []
    for slice_numel in (adamw.SLICE_NUMEL, 32 * 256):
        monkeypatch.setattr(adamw, "SLICE_NUMEL", slice_numel)
        module = _Params(arrays, torch.float32)
        opt = AdamW(AdamWConfig(lr=0.01, clip_norm=5.0,
                                state_8bit=state_8bit))
        state = opt.init(module)
        for g in grads:
            state = opt.update(g, state, module)
        out.append((module.state_dict(), state))
    (p_whole, s_whole), (p_walked, s_walked) = out
    assert list(adamw._slices(torch.zeros(2, 64, 256))) == [
        (i, slice(j, j + 32)) for i in range(2) for j in (0, 32)]
    assert list(adamw._slices(torch.zeros(128, 512))) == [
        (slice(i, i + 16),) for i in range(0, 128, 16)]
    for k in p_whole:
        torch.testing.assert_close(p_walked[k], p_whole[k], rtol=0, atol=0)
    for mom in ("m", "v"):
        for k, want in s_whole[mom].items():
            got = s_walked[mom][k]
            for part in (("q", "s") if state_8bit else (None,)):
                a, b = (got, want) if part is None else (got[part],
                                                         want[part])
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 0), (3, 1234),
                                       (17, 42)])
def test_synthetic_batches_equal_jax(seed, step):
    cfg = dict(vocab_size=300, seq_len=40, global_batch=3, seed=seed)
    want = np.asarray(JSyntheticLM(JDataConfig(**cfg)).batch_at(step)
                      ["tokens"])
    got = SyntheticLM(DataConfig(**cfg), "cpu").batch_at(step)["tokens"]
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
