"""The port's checkpoint writer against the JAX package's, on the CPU: a
train state saved by either package restores into the other, and the next
step taken from it agrees; atomic writes, pruning and async writes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import train as jtrain
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as jcosine
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule

ARCH = "deepseek-7b"
B, S = 2, 16
# one AdamW step from states that agree to fp32 rounding: the update is
# m̂/(√v̂+eps), so a gradient that is ~0 on both sides may round either
# way; held, as the gradients are, to 1e-4 of each tensor's max
TOL = 1e-4


def _batch(step):
    rng = np.random.default_rng(step)
    return rng.integers(0, 256, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's deepseek-7b smoke model (fp32, mesh None), AdamW, its jitted
    train step, and its state after one step (m, v and step not zero)."""
    jm = JModel(jconfigs.get_smoke(ARCH),
                JRunConfig(remat=False, attn_impl="xla"), dtype=jnp.float32)
    jopt = JAdamW(JAdamWConfig(lr=jcosine(1e-2, warmup=2, total=10)))
    run = JRunConfig(remat=False, attn_impl="xla")
    step = jax.jit(jtrain.make_train_step(jm, jopt, run))
    state = jtrain.init_train_state(jm, jopt, run, jax.random.PRNGKey(0))
    state, _ = step(state, {"tokens": jnp.asarray(_batch(0))})
    return jm, jopt, step, state


def _port():
    run = TRunConfig()
    model = TModel(tconfigs.get_smoke(ARCH), run, dtype=torch.float32,
                   device="cpu")
    opt = AdamW(AdamWConfig(lr=cosine_schedule(1e-2, warmup=2, total=10)))
    state = ttrain.init_train_state(model, opt, run,
                                    torch.Generator().manual_seed(1))
    return state, ttrain.make_train_step(model, opt, run)


def _assert_states_close(port_state, jax_state):
    """Every array of the two train states under JAX's key paths."""
    got, want = ckpt._flatten(port_state), jckpt._flatten(jax_state)
    assert got.keys() == want.keys()
    assert "params/segments/0/0/attn/wq" in got and "opt/m/embed" in got
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-30)
        np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                   atol=TOL * scale, err_msg=key)


def test_jax_saved_state_restores_into_the_port(jax_side, tmp_path):
    _, _, jstep, jstate = jax_side
    jckpt.save(str(tmp_path), 1, jstate)
    state, step = _port()
    ckpt.restore(str(tmp_path), 1, state)
    assert int(state["opt"]["step"]) == 1
    _assert_states_close(state, jstate)
    batch = _batch(1)
    jnext, jmetrics = jstep(jstate, {"tokens": jnp.asarray(batch)})
    state, metrics = step(state, {"tokens": torch.from_numpy(batch).long()})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    _assert_states_close(state, jnext)


def test_port_saved_state_restores_into_jax(jax_side, tmp_path):
    jm, jopt, jstep, _ = jax_side
    state, step = _port()
    state, _ = step(state, {"tokens": torch.from_numpy(_batch(0)).long()})
    ckpt.save(str(tmp_path), 1, state, meta={"arch": ARCH})
    assert ckpt.read_meta(str(tmp_path), 1) == {"step": 1, "arch": ARCH}
    target = jtrain.init_train_state(jm, jopt, JRunConfig(),
                                     jax.random.PRNGKey(5))
    jstate = jckpt.restore(str(tmp_path), 1, target)
    _assert_states_close(state, jstate)
    batch = _batch(1)
    jnext, _ = jstep(jstate, {"tokens": jnp.asarray(batch)})
    state, _ = step(state, {"tokens": torch.from_numpy(batch).long()})
    _assert_states_close(state, jnext)


def _tiny_state(value):
    model = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(model.weight, value)
    return {"params": model, "opt": {"step": torch.tensor(
        int(value), dtype=torch.int32)}}


def test_save_is_atomic_and_prunes_to_keep(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000004.tmp"))     # a crashed writer
    assert ckpt.all_steps(d) == [] and ckpt.latest_step(d) is None
    for s in range(5):
        ckpt.save(d, s, _tiny_state(s), keep=2)
    assert ckpt.all_steps(d) == [3, 4] and ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    target = _tiny_state(0)
    ckpt.restore(d, 3, target)
    assert int(target["opt"]["step"]) == 3
    torch.testing.assert_close(target["params"].weight,
                               torch.full((2, 3), 3.0))


def test_save_async_writes_the_snapshot(tmp_path):
    """The arrays are taken when ``save_async`` is called: a change made
    while the thread writes does not reach the checkpoint."""
    d = str(tmp_path)
    state = _tiny_state(7)
    thread = ckpt.save_async(d, 7, state)
    with torch.no_grad():
        state["params"].weight.fill_(-1.0)
    thread.join()
    target = _tiny_state(0)
    ckpt.restore(d, ckpt.latest_step(d), target)
    torch.testing.assert_close(target["params"].weight,
                               torch.full((2, 3), 7.0))
