"""The JAX package's int8 AdamW moments beside the port's, on the CPU, at
olmoe-1b-7b's smoke config: both packages start from the same weights (JAX
draws them, the port loads them through the checkpoint bridge) and take
the same batches.

    python examples/int8_moments_vs_jax.py        # ~4 min on the CPU

1. The held-out loss (``train.held_out_loss``'s batch) before and after
   10 steps of B 4 × S 2048 in bf16 with the CLI's AdamW (warm-up 20,
   decay 0.1) at peak lr 1e-3 and 3e-3, int8 and fp32 moments: does the
   reference learn where the port does not, or the other way round?
2. 6 bf16 steps of B 4 × S 32 at peak lr 1e-3 after a 2-step warm-up with
   each combination of int8 moments and fp8 gradient compression: every
   step's loss, each package carrying its own state.
3. A least-squares toy: W [256, 1024] from zero fits targets X @ W*, W* ~
   N(0, 1/16²), 2048 rows of X ~ N(0, 1) with column j scaled by
   exp(σ z_j), batches of 64 in order, AdamW at a constant lr 1e-3
   without decay, 200 steps; the full-data mean squared error every 40
   steps and max|W| at the end, for σ 0, 0.5 and 1.5, each optimizer
   with fp32 and int8 moments.

Needs jax and the JAX package beside the port (``src/``).
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402

ARCH = "olmoe-1b-7b"


def pair(opt_8bit: bool, grad_compression: bool, peak_lr: float,
         warmup: int, steps: int):
    """JAX's jitted train step and state, and the port's, from the same
    bf16 weights: (jm, jstep, jstate, port model, step_fn, state)."""
    jrun = JRunConfig(remat=False, attn_impl="xla", opt_8bit=opt_8bit,
                      grad_compression=grad_compression)
    jm = JModel(jconfigs.get_smoke(ARCH), jrun, dtype=jax.numpy.bfloat16)
    params = jm.init(jax.random.PRNGKey(3))
    with tempfile.TemporaryDirectory() as d:
        model = Model(tconfigs.get_smoke(ARCH), device="cpu")
        bridge.from_flat(bridge.load_npz(jckpt.save(d, 0, params)), model)
    jopt = JAdamW(JAdamWConfig(lr=jcosine(peak_lr, warmup=warmup,
                                          total=steps),
                               weight_decay=train.CLI_DECAY,
                               state_8bit=opt_8bit))
    jstate = {"params": params, "opt": jopt.init(params)}
    run = RunConfig(opt_8bit=opt_8bit, grad_compression=grad_compression)
    opt = train.cli_optimizer(steps, peak_lr, state_8bit=opt_8bit,
                              warmup=warmup)
    state = {"params": model, "opt": opt.init(model)}
    if grad_compression:
        jstate["err"] = jcompression.init_error_state(params)
        state["err"] = {n: torch.zeros(p.shape)
                        for n, p in model.named_parameters()}
    return (jm, jax.jit(jtrain.make_train_step(jm, jopt, jrun)), jstate,
            model, train.make_train_step(model, opt, run), state)


def data(jm, seq: int, batch: int):
    return (JSyntheticLM(JDataConfig(jm.cfg.vocab_size, seq, batch)),
            SyntheticLM(DataConfig(jm.cfg.vocab_size, seq, batch), "cpu"))


def held_out(steps: int = 10, B: int = 4, S: int = 2048) -> None:
    for peak_lr in (1e-3, 3e-3):
        for opt_8bit in (True, False):
            jm, jstep, jstate, model, step_fn, state = pair(
                opt_8bit, False, peak_lr, train.CLI_WARMUP, steps)
            jdata, tdata = data(jm, S, B)
            jheld = jdata.batch_at(train.HELD_OUT_STEP)
            jb = float(jm.loss(jstate["params"], jheld)[0])
            tb = train.held_out_loss(model, tdata)
            for step in range(steps):
                jstate, _ = jstep(jstate, jdata.batch_at(step))
                state, _ = step_fn(state, tdata.batch_at(step))
            ja = float(jm.loss(jstate["params"], jheld)[0])
            ta = train.held_out_loss(model, tdata)
            print(f"held-out, peak {peak_lr:g}, "
                  f"{'int8' if opt_8bit else 'fp32'} moments: JAX {jb:.4f} "
                  f"-> {ja:.4f} ({(jb - ja) / jb:+.3e}); port {tb:.4f} -> "
                  f"{ta:.4f} ({(tb - ta) / tb:+.3e})", flush=True)


def trajectories(steps: int = 6, B: int = 4, S: int = 32) -> None:
    for opt_8bit in (False, True):
        for grad_compression in (False, True):
            jm, jstep, jstate, _, step_fn, state = pair(
                opt_8bit, grad_compression, 1e-3, 2, steps)
            jdata, tdata = data(jm, S, B)
            want, got = [], []
            for step in range(steps):
                jstate, jmetrics = jstep(jstate, jdata.batch_at(step))
                state, metrics = step_fn(state, tdata.batch_at(step))
                want.append(round(float(jmetrics["loss"]), 4))
                got.append(round(float(metrics["loss"]), 4))
            print(f"losses, int8 moments {opt_8bit}, fp8 compression "
                  f"{grad_compression}: JAX {want}; port {got}", flush=True)


def toy(sigma: float, opt_8bit: bool, steps: int = 200) -> None:
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2048, 256))
         * np.exp(sigma * rng.standard_normal(256))).astype(np.float32)
    y = x @ (rng.standard_normal((256, 1024)) / 16).astype(np.float32)
    kw = dict(lr=1e-3, weight_decay=0.0, state_8bit=opt_8bit)

    def jloss(w, xb, yb):
        return jax.numpy.mean((xb @ w["w"] - yb) ** 2)

    jopt = JAdamW(JAdamWConfig(**kw))
    jw = {"w": jax.numpy.zeros((256, 1024), jax.numpy.float32)}
    jstate = jopt.init(jw)

    @jax.jit
    def jstep(w, state, xb, yb):
        g = jax.grad(jloss)(w, xb, yb)
        return jopt.update(g, state, w)

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(256, 1024))
    opt = AdamW(AdamWConfig(**kw))
    state = opt.init(model)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    out = {"JAX": [], "port": []}
    for step in range(steps):
        rows = slice(64 * step % 2048, 64 * step % 2048 + 64)
        jw, jstate = jstep(jw, jstate, x[rows], y[rows])
        loss = torch.mean((tx[rows] @ model.w - ty[rows]) ** 2)
        (g,) = torch.autograd.grad(loss, [model.w])
        state = opt.update({"w": g}, state, model)
        if (step + 1) % 40 == 0:
            out["JAX"].append(float(jloss(jw, x, y)))
            with torch.no_grad():
                out["port"].append(float(torch.mean((tx @ model.w - ty)
                                                    ** 2)))
    print(f"toy, sigma {sigma}, {'int8' if opt_8bit else 'fp32'} moments, "
          f"loss at steps 40..200: "
          + "; ".join(f"{k} {[float(f'{v:.4g}') for v in vals]}"
                      for k, vals in out.items())
          + f"; max|W| JAX {float(np.abs(np.asarray(jw['w'])).max()):.3g}, "
          f"port {float(model.w.detach().abs().max()):.3g}", flush=True)


if __name__ == "__main__":
    held_out()
    trajectories()
    for sigma in (0.0, 0.5, 1.5):
        for opt_8bit in (False, True):
            toy(sigma, opt_8bit)
