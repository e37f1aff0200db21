"""``RunConfig.seq_shard`` for the MoE stacks (olmoe-1b-7b, then
jamba-v0.1-52b's Mamba2, attention and MoE blocks): a MoE block gathers
the rows of a sequence split over a grid's model group, routes the whole
sequence as one call (the capacity, the order and the aux loss of one
process), runs a rank's experts on it and reduce-scatters the sum back to
each rank's rows (``sync.seq``, ``models.moe``), on the CPU.

- ``gather_rows`` and ``scatter_rows`` on threads standing in for ranks
  (``tests/test_torch_seq_shard.py``): the concatenation and the
  sum-then-slice, each one's backward the other's.  A MoE block on
  pieces of a sequence, its banks whole or a rank's slice: the rows, the
  aux loss, every routing's drops and kept slots and, summed over the
  pieces, every gradient (the router's included) are the whole block's;
  with the aux loss's gradient not shared out (a planted fault) the
  router's gradient is not.
- Gloo ranks (subprocesses on a ``file://`` store) take a forward, one
  fp32 train step and AdamW of each arch's smoke config from JAX's seeded
  init, at a capacity factor of 1.0, where experts overflow (the smoke
  configs' 16.0 drops nothing): olmoe-1b-7b on (1,2) and (1,4) grids
  under ``batch_axes="dp"`` and ``"all"``, on (2,2) with ``fsdp`` at the
  smoke capacity, jamba-v0.1-52b on (1,2) and (1,4).  Logits (each rank
  its rows), loss and every gradient equal one process's to 1e-4 of
  max|·| (``tests/test_sync.py:55``), the parameters after the step one
  process's AdamW step on those gradients, and every routing's drops and
  kept slots one process's exactly.  Rank-local routing (each rank's rows
  routed alone, the capacity from them) fails that comparison.  On (1,2)
  under ``"dp"`` both archs equal JAX's ``Model`` with ``seq_shard=True``
  on an Auto (1,2) mesh (a subprocess with
  ``--xla_force_host_platform_device_count``).  Under ``"all"`` with a
  model axis > 1 JAX's ``moe_apply`` adds other tokens' outputs over
  "model" (ROADMAP, "In the reference"): the port is held to one process
  there.
"""
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.models import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model as TModel
from repro_torch.models import moe as tmoe
from repro_torch.models.model import derive_segments
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sync import seq as tseq
from test_torch_fsdp_repeat_axis import stepped
from test_torch_seq_shard import _on_threads

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
OLMOE, JAMBA = "olmoe-1b-7b", "jamba-v0.1-52b"
ARCHS = (OLMOE, JAMBA)
# a capacity factor at which the smoke configs' experts overflow: at B 2 x
# S 32 one call's C is 16 slots; a rank of (1,2) routing its own rows
# alone would take C 8
DROPS = 1.0
S = 32
# (tag, arch, grid, RunConfig fields, B, capacity factor: None keeps the
# smoke config's)
CELLS = [("olmoe_1x2", OLMOE, (1, 2), {}, 2, DROPS),
         ("olmoe_1x4", OLMOE, (1, 4), {}, 2, DROPS),
         ("olmoe_1x2_all", OLMOE, (1, 2), {"batch_axes": "all"}, 2, DROPS),
         ("olmoe_1x4_all", OLMOE, (1, 4), {"batch_axes": "all"}, 2, DROPS),
         ("olmoe_2x2_fsdp", OLMOE, (2, 2), {"fsdp": True}, 4, None),
         ("jamba_1x2", JAMBA, (1, 2), {}, 2, DROPS),
         ("jamba_1x4", JAMBA, (1, 4), {}, 2, DROPS)]
# the planted fault: the ranks of (1,2) route their own rows alone
FAULT = ("olmoe_1x2_local", OLMOE, (1, 2), {}, 2, DROPS)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, key="x", tol: float = TOL):
    w = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, w, rtol=tol,
                               atol=tol * float(np.abs(w).max()),
                               err_msg=key)


def _cfg(arch: str, capacity=DROPS):
    cfg = tconfigs.get_smoke(arch)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    return cfg


def _slots(r: tmoe.Routing) -> np.ndarray:
    """Each slot's token, -1 where the slot is unused: [E, C]."""
    return torch.where(r.valid, r.tok, -1).numpy()


# ----------------------------------------------------------------------
# the two collectives and a MoE block, on threads standing in for ranks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m", [2, 3, 4])
def test_rows_gather_and_scatter_are_concatenation_and_sum(m):
    """Each rank's x [B, 3, 5] rows and its partial y [B, 3m, 5]:
    ``gather_rows`` gives every rank every row in order, and the gradient
    of Σ_j gathered·a_j reaching rank r's rows is Σ_j a_j at them;
    ``scatter_rows`` gives rank r its rows of Σ_j y_j, and the gradient of
    Σ_j out_j·b_j reaching y_r is every rank's b_j at its rows.  One
    all-gather and one reduce-scatter each, noted."""
    B, rows, d = 2, 3, 5
    rng = np.random.default_rng(m)
    xs = rng.standard_normal((m, B, rows, d)).astype(np.float32)
    ys = rng.standard_normal((m, B, m * rows, d)).astype(np.float32)
    a = rng.standard_normal((m, B, m * rows, d)).astype(np.float32)
    b = rng.standard_normal((m, B, rows, d)).astype(np.float32)

    def piece(comm):
        split = tseq.Seq(comm, m * rows)
        x = _t(xs[comm.rank]).clone().requires_grad_(True)
        y = _t(ys[comm.rank]).clone().requires_grad_(True)
        whole = split.gather_rows(x, "x")
        mine = split.scatter_rows(y, "y")
        gx, gy = torch.autograd.grad(
            (whole * _t(a[comm.rank])).sum()
            + (mine * _t(b[comm.rank])).sum(), (x, y))
        return whole.detach(), mine.detach(), gx, gy, comm.log

    got = _on_threads(m, piece)
    sums = ys.sum(0)
    for r, (whole, mine, gx, gy, log) in enumerate(got):
        rs = slice(r * rows, (r + 1) * rows)
        assert np.array_equal(whole.numpy(), np.concatenate(list(xs), 1))
        np.testing.assert_allclose(mine.numpy(), sums[:, rs], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gx.numpy(), a[:, :, rs].sum(0),
                                   rtol=1e-6, atol=1e-6)
        assert np.array_equal(gy.numpy(), np.concatenate(list(b), 1))
        assert Counter(log) == {("all-gather", "x"): 1,
                                ("reduce-scatter", "x"): 1,
                                ("reduce-scatter", "y"): 1,
                                ("all-gather", "y"): 1}


def _block(m: int, banks: str, main: float = 1.0, seed: int = 0):
    """olmoe's smoke MoE block at the dropping capacity, whole and on m
    pieces of a sequence of 32 (B 2; the banks whole on every rank, each
    rank's slice of E/m experts, or whole beside a shared expert): (y,
    aux, the gradients of main ·
    Σ y·w + aux_weight · aux) of the whole block, then of each piece, and the
    routings (drops, slots) of the whole block's call, then of the
    pieces' (the threads share the recorder: one a rank)."""
    cfg = _cfg(OLMOE)
    if banks == "shared":
        cfg = dataclasses.replace(cfg, n_shared_experts=1)
    p = tmoe.moe_init(torch.Generator().manual_seed(seed), cfg,
                      dtype=torch.float32)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((2, S, cfg.d_model), generator=g)
    w = torch.randn((2, S, cfg.d_model), generator=g)

    def run(params, xs, ws, seq=None):
        leaves = {n: t.clone().requires_grad_(True)
                  for n, t in params.items()}
        y, aux = tmoe.moe_apply(leaves, xs, cfg, seq=seq,
                                ep=seq is not None and banks == "slice")
        grads = torch.autograd.grad(
            main * (y * ws).sum() + cfg.router_aux_weight * aux,
            list(leaves.values()))
        return y.detach(), aux.detach(), dict(zip(leaves, grads))

    def piece(comm):
        split = tseq.Seq(comm, S)
        n = cfg.n_experts // m
        mine = dict(p)
        if banks == "slice":
            mine.update({k: p[k][comm.rank * n:(comm.rank + 1) * n]
                         for k in ("w_in", "w_gate", "w_out")})
        return run(mine, split.piece(x), split.piece(w), split)

    routes = []
    for fn in (lambda: [run(p, x, w)], lambda: _on_threads(m, piece)):
        with tmoe.recorded_routes() as seen:
            got = fn()
        routes.append([(int(r.dropped), _slots(r)) for r in seen])
    return cfg, run(p, x, w), got, routes


def _summed(got, banks: str) -> dict:
    """Each parameter's gradient summed over the pieces (a rank's slice
    of the banks put in its place)."""
    out = {}
    for name in got[0][2]:
        parts = [g[2][name] for g in got]
        if banks == "slice" and name in ("w_in", "w_gate", "w_out"):
            out[name] = torch.cat(parts)
        else:
            out[name] = sum(parts)
    return out


@pytest.mark.parametrize("banks", ["whole", "slice", "shared"])
@pytest.mark.parametrize("m", [2, 4])
def test_pieces_of_a_moe_block_are_the_whole_block(m, banks):
    """On m pieces: each rank's y is the whole block's rows, its aux loss
    the whole block's, every rank's routing the whole block's (its drops,
    some, and every slot's token), and each gradient, summed over the
    pieces (the router's with the aux loss's; a shared expert's, run
    whole on each rank's rows), the whole block's, fp32."""
    _, (y, aux, grads), got, (want, routes) = _block(m, banks)
    assert want[0][0] > 0                         # experts overflow
    _close(torch.cat([g[0] for g in got], dim=1).numpy(), y.numpy(), "y")
    for g in got:
        assert float(g[1]) == pytest.approx(float(aux), rel=1e-6)
    assert len(routes) == m
    for n, slots in routes:
        assert n == want[0][0] and np.array_equal(slots, want[0][1])
    summed = _summed(got, banks)
    for name, g in grads.items():
        _close(summed[name].numpy(), g.numpy(), name)


@pytest.mark.parametrize("once", ["shared", "whole on every rank"])
def test_the_aux_loss_counts_once_over_the_group(monkeypatch, once):
    """Every rank's aux loss is the whole sequence's.  The gradient of
    ``router_aux_weight`` · aux alone, summed over 2 ranks: the whole
    block's for the router (``Seq.once`` hands each rank half of it);
    with each rank taking all of it (the planted fault) twice the whole
    block's, beyond the tolerance.  In the model's loss the aux term is
    0.2-6% of the smoke routers' max|gradient|, so the grid steps' 1e-4
    comparison below sees it counted twice too."""
    if once != "shared":
        monkeypatch.setattr(tseq.Seq, "once", lambda self, t: t)
    _, (_, _, grads), got, _ = _block(2, "whole", main=0.0)
    summed = _summed(got, "whole")["router"].numpy()
    want = grads["router"].numpy()
    assert np.abs(want).max() > 0
    if once == "shared":
        _close(summed, want, "router")
    else:
        _close(summed, 2 * want, "router")
        with pytest.raises(AssertionError):
            _close(summed, want, "router")


def test_the_experts_must_split_over_the_group():
    """E = 8 experts over 3 model ranks raises, naming both numbers."""
    cfg = _cfg(OLMOE)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.float32)

    def piece(comm):
        split = tseq.Seq(comm, 6)
        x = torch.zeros((1, 2, cfg.d_model))
        with pytest.raises(ValueError, match="8 experts .* 3 model"):
            tmoe.moe_apply(p, x, cfg, seq=split)

    _on_threads(3, piece)


# ----------------------------------------------------------------------
# gloo grids against one process and JAX's seq_shard step
# ----------------------------------------------------------------------
_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt
from repro.configs.base import RunConfig
from repro.launch.mesh import dp_axes
from repro.launch.sharding import batch_shardings
from repro.models import Model

a = json.loads(sys.argv[1])
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
losses = {}
for arch in a["archs"]:
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              capacity_factor=a["capacity"])
    run = RunConfig(remat=False, attn_impl="xla", seq_shard=True)
    jm = Model(cfg, run, mesh=mesh, dp_axes=dp_axes(mesh),
               dtype=jnp.float32)
    params = ckpt.restore(f"{a['dir']}/{arch}/params", 0,
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    batch = {"tokens": jnp.asarray(np.load(f"{a['dir']}/tokens_2.npy"))}
    batch = jax.device_put(batch, batch_shardings(batch, mesh, run))
    with mesh:
        logits = jax.jit(jm.forward)(params, batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b), has_aux=True))(params, batch)
    np.save(f"{a['dir']}/{arch}/jax_logits.npy", np.asarray(logits))
    ckpt.save(f"{a['dir']}/{arch}/jax_grads", 0, grads)
    losses[arch] = float(loss)
print(json.dumps(losses))
"""

_WORKER = r"""
import dataclasses, datetime, json, sys
from collections import Counter
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import bridge
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh, train
from repro_torch.models import Model, moe
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sync import shard

a = json.loads(sys.argv[1])
rank, sizes = a["rank"], tuple(a["sizes"])
dist.init_process_group("gloo", init_method=a["init"], rank=rank,
                        world_size=int(np.prod(sizes)),
                        timeout=datetime.timedelta(seconds=120))
grid = mesh.make_grid(sizes)
real = moe.moe_apply


def rank_local(p, x, cfg, *, seq=None, **kw):
    # the planted fault: the rank's rows routed alone (their capacity),
    # every expert run here on the banks gathered whole
    if seq is None:
        return real(p, x, cfg, **kw)
    p = {k: shard.gather(seq.comm, v.contiguous(), 0)
         if k in ("w_in", "w_gate", "w_out")
         and v.shape[0] != cfg.n_experts else v for k, v in p.items()}
    return real(p, x, cfg)


class Keep:
    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = {bridge._key(k): bridge.whole(params, k, g).clone()
                      for k, g in grads.items()}
        return self.opt.update(grads, state, params)


for tag, arch, _, kw, B, capacity in a["cells"]:
    cfg = configs.get_smoke(arch)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    flat = bridge.load_npz(f"{a['dir']}/{arch}/params/step_00000000")
    tokens = torch.from_numpy(np.load(f"{a['dir']}/tokens_{B}.npy")).long()
    run = RunConfig(seq_shard=True, **kw)
    m = Model(cfg, run, dtype=torch.float32, device="cpu", grid=grid)
    bridge.from_flat(flat, m)
    split = m.seq_split(tokens.shape[1])
    out = {".start": split.start}
    fault = tag == a["fault"]
    moe.moe_apply = rank_local if fault else real
    with torch.no_grad(), moe.recorded_routes() as seen:
        out[".logits"] = m.forward({"tokens": tokens}).numpy()
    out[".drops"] = np.array([int(r.dropped) for r in seen])
    for i, r in enumerate(seen):
        out[f".slots{i}"] = torch.where(r.valid, r.tok, -1).numpy()
    if not fault:
        opt = Keep(AdamW(AdamWConfig()))
        state = {"params": m, "opt": opt.init(m)}
        step = train.make_train_step(m, opt, run, grid=grid)
        state, metrics = step(state, {"tokens": tokens})
        out[".loss"] = metrics["loss"].numpy()
        out.update({k: g.numpy() for k, g in opt.grads.items()})
        out.update({"after/" + k: v for k, v in bridge.to_flat(m).items()})
        log = Counter(f"{k} {v}" for k, v in step.model_log
                      if str(v).startswith("seq."))
        with open(f"{a['out']}/{tag}_r{rank}.json", "w") as f:
            json.dump(log, f)
    np.savez(f"{a['out']}/{tag}_r{rank}.npz", **out)
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _start(tmp, sizes, cells, out):
    n = int(np.prod(sizes))
    store = tmp / ("store_" + "x".join(map(str, sizes)))
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps({
            "rank": rank, "sizes": list(sizes), "init": f"file://{store}",
            "cells": cells, "fault": FAULT[0], "dir": str(tmp),
            "out": str(out)})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(n)]


def _wait(procs, timeout=400):
    """Every process's (stdout, stderr), each within its timeout; a failed
    or hung one fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * len(procs), [
        "\n".join(line for line in e.splitlines()
                  if "Warning" not in line and "return func" not in line
                  )[-3000:] for _, e in outs]
    return outs


def _one_process(cfg, flat, tokens, d: int):
    """The port's one-process fp32 forward and step, the step's batch as
    ``d`` microbatches (a grid's data rows route theirs apart): logits,
    the forward's routings, loss, gradients, the parameters as given."""
    m = TModel(cfg, TRunConfig(microbatches=d), dtype=torch.float32,
               device="cpu")
    bridge.from_flat(flat, m)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad(), tmoe.recorded_routes() as seen:
        logits = m.forward({"tokens": t}).numpy()
    routes = [(int(r.dropped), _slots(r)) for r in seen]
    opt = AdamW(AdamWConfig())
    kept = {}

    class Keep:
        def init(self, params):
            return opt.init(params)

        def update(self, grads, state, params):
            kept.update({bridge._key(k): g.numpy().copy()
                         for k, g in grads.items()})
            return opt.update(grads, state, params)

    state = {"params": m, "opt": opt.init(m)}
    _, metrics = ttrain.make_train_step(m, Keep(), m.run)(
        state, {"tokens": t})
    return {"logits": logits, "routes": routes,
            "loss": float(metrics["loss"]), "grads": kept,
            "flat": dict(flat)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's init of each arch, every grid's ranks (started together),
    JAX's ``seq_shard`` steps, and the one-process steps."""
    tmp = tmp_path_factory.mktemp("seq_moe")
    for i, B in enumerate((2, 4)):
        np.save(tmp / f"tokens_{B}.npy", np.random.default_rng(30 + i)
                .integers(0, 256, (B, S)).astype(np.int32))
    for i, arch in enumerate(ARCHS):
        jm = JModel(jconfigs.get_smoke(arch),
                    JRunConfig(remat=False, attn_impl="xla"),
                    dtype=jnp.float32)
        jckpt.save(str(tmp / arch / "params"), 0,
                   jm.init(jax.random.PRNGKey(40 + i)))
    out = tmp / "ranks"
    out.mkdir()
    cells = [[tag, arch, list(g), kw, B, cap]
             for tag, arch, g, kw, B, cap in CELLS + [FAULT]]
    procs = []
    for sizes in sorted({tuple(c[2]) for c in cells}):
        procs += _start(tmp, sizes, [c for c in cells
                                     if tuple(c[2]) == sizes], out)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps({
            "dir": str(tmp), "archs": list(ARCHS), "capacity": DROPS})],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    one = {}
    for _, arch, (d, _), _, B, cap in CELLS:
        if (arch, B, cap) not in one:
            flat = bridge.load_npz(str(tmp / arch / "params"
                                       / "step_00000000"))
            one[arch, B, cap] = _one_process(
                _cfg(arch, cap), flat, np.load(tmp / f"tokens_{B}.npy"), d)
    _wait(procs)
    (jout, _), = _wait([jax_proc], timeout=600)
    return {"tmp": tmp, "out": out, "one": one,
            "jax_loss": json.loads(jout.strip().splitlines()[-1])}


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _cell(tag):
    return next(c for c in CELLS + [FAULT] if c[0] == tag)


def _routes(got: dict) -> list:
    """A rank's routings as (drops, slots), layer by layer."""
    drops = got.pop(".drops")
    return [(int(n), got.pop(f".slots{i}")) for i, n in enumerate(drops)]


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_grid_step_equals_one_process(steps, tag):
    """Each rank's logits are one process's rows ``[k·S/m, (k+1)·S/m)``;
    the loss and every gradient, the router's included, are one
    process's on every rank, and every parameter after AdamW one
    process's AdamW step on them."""
    _, arch, (d, m), _, B, cap = _cell(tag)
    one = steps["one"][arch, B, cap]
    for rank in range(d * m):
        got = _npz(steps["out"] / f"{tag}_r{rank}.npz")
        _routes(got)
        rows, start = S // m, int(got.pop(".start"))
        assert start == (rank % m) * rows
        logits = got.pop(".logits")
        assert logits.shape == (B, rows, one["logits"].shape[-1])
        _close(logits, one["logits"][:, start:start + rows], "logits")
        assert float(got.pop(".loss")) == pytest.approx(one["loss"],
                                                        rel=1e-5)
        after = {k[len("after/"):]: got.pop(k) for k in list(got)
                 if k.startswith("after/")}
        assert got.keys() == one["grads"].keys()
        assert any("router" in k for k in got)
        for key, g in got.items():
            _close(g, one["grads"][key], key)
        want = stepped(_cfg(arch, cap), one["flat"], got)
        assert after.keys() == want.keys()
        for key, p in after.items():
            _close(p, want[key], "after " + key)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_grid_routes_equal_one_process_s(steps, tag):
    """Every rank's forward routes the batch's whole sequence as one
    call: each MoE layer's drop count and the token in every expert slot
    equal one process's, at the dropping capacity some assignments
    dropped."""
    _, arch, (d, m), _, B, cap = _cell(tag)
    one = steps["one"][arch, B, cap]
    n_moe = sum(tconfigs.get_smoke(arch).is_moe_layer(i)
                for i in range(tconfigs.get_smoke(arch).n_layers))
    for rank in range(d * m):
        got = _routes(_npz(steps["out"] / f"{tag}_r{rank}.npz"))
        want = one["routes"]
        assert len(got) == len(want) == n_moe
        for (n, slots), (wn, wslots) in zip(got, want):
            assert n == wn and np.array_equal(slots, wslots), (tag, rank)
        if cap is not None:
            assert sum(n for n, _ in got) > 0


def test_rank_local_routing_fails_the_comparison(steps):
    """The planted fault: on (1,2) each rank routes its own 32 tokens
    (capacity 8, against one call's 16) through every expert.  Its drops
    and its logits part from one process's beyond the tolerance."""
    tag, arch, _, _, B, cap = FAULT
    one = steps["one"][arch, B, cap]
    parted = []
    for rank in range(2):
        got = _npz(steps["out"] / f"{tag}_r{rank}.npz")
        routes = _routes(got)
        start = int(got[".start"])
        assert routes[0][1].shape[1] == 8 != one["routes"][0][1].shape[1]
        try:
            _close(got[".logits"], one["logits"][:, start:start + S // 2])
        except AssertionError:
            parted.append(rank)
    assert parted == [0, 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_step_equals_jax_seq_shard_step(steps, arch):
    """On (1,2) under ``"dp"``: the ranks' logits, joined along the
    sequence, the loss and every gradient equal JAX's ``seq_shard`` step
    on an Auto (1,2) mesh at the dropping capacity."""
    tag = "olmoe_1x2" if arch == OLMOE else "jamba_1x2"
    ranks = [_npz(steps["out"] / f"{tag}_r{r}.npz") for r in range(2)]
    jdir = steps["tmp"] / arch
    _close(np.concatenate([r[".logits"] for r in ranks], axis=1),
           np.load(jdir / "jax_logits.npy"), "logits")
    got = ranks[0]
    assert float(got[".loss"]) == pytest.approx(steps["jax_loss"][arch],
                                                rel=1e-5)
    jg = bridge.load_npz(str(jdir / "jax_grads" / "step_00000000"))
    grads = {k: g for k, g in got.items()
             if not k.startswith(".") and not k.startswith("after/")}
    assert grads.keys() == jg.keys()
    for key, g in grads.items():
        _close(g, jg[key], key)


def _want_log(cfg) -> dict:
    """The model group's ``seq.*`` collectives of one remat step: per MoE
    block the row all-gather in the forward and again in remat's
    recompute and its reduce-scatter in the backward; the partials'
    reduce-scatter in the forward, again in the recompute unless the
    block ends its repeat (the recompute stops after the last saved
    tensor, and only the residual add reads it), and its all-gather in
    the backward; per attention block the K/V gather's 2 + 1, per Mamba2
    block the halo's and the state's; one loss all-reduce."""
    log = Counter({"all-reduce seq.loss": 1})
    for seg in derive_segments(cfg):
        for j, spec in enumerate(seg.pattern * seg.repeats):
            keys = (["seq.kv"] if spec.mixer == "attn"
                    else ["seq.halo", "seq.state"])
            for key in keys:
                log[f"all-gather {key}"] += 2
                log[f"reduce-scatter {key}"] += 1
            if spec.ffn == "moe":
                last = j % len(seg.pattern) == len(seg.pattern) - 1
                log["all-gather seq.moe"] += 3
                log["reduce-scatter seq.moe"] += 2 + (not last)
    return dict(log)


@pytest.mark.parametrize("tag", [c[0] for c in CELLS])
def test_a_step_s_seq_collectives(steps, tag):
    """The model group's ``seq.*`` collectives of one remat step on every
    rank, as ``_want_log`` counts them."""
    _, arch, (d, m), _, _, _ = _cell(tag)
    want = _want_log(tconfigs.get_smoke(arch))
    for rank in range(d * m):
        log = json.loads((steps["out"] / f"{tag}_r{rank}.json").read_text())
        assert log == want, (tag, rank)


# ----------------------------------------------------------------------
# what builds, what splits, the dry run
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_the_split_runs_a_rank_s_experts(arch):
    """Under ``seq_shard`` on a (1,2) stand-in grid under ``"dp"`` each
    MoE block holds its rank's 4 of the 8 experts (``ep``), attention and
    the dense FFN run whole on gathered weights; a length whose rows a
    rank the chunk divides splits (jamba: 16 a rank, chunk 8), an odd one
    stays whole."""
    cfg = tconfigs.get_smoke(arch)
    for k in range(2):
        m = TModel(cfg, TRunConfig(seq_shard=True), device="meta",
                   grid=tmesh.stand_in((1, 2), k))
        blocks = [b for bs in m.segments for b in bs]
        assert all(not (b.tp_attn or b.tp_mlp or b.tp_shared)
                   for b in blocks)
        for b in blocks:
            if hasattr(b, "moe"):
                assert b.ep and b.moe["w_in"].shape[1] == 4
        split = m.seq_split(32)
        assert (split.rows, split.start) == (16, 16 * k)
        assert m.seq_split(33) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_traces_a_named_moe_seq_shard_cell(arch):
    """prefill_32k at 16×16 with ``seq_shard`` named (smoke widths with 16
    experts, so that the 16 model ranks split them; jamba at its full
    config's chunk): a rank's 2 rows over the data axis and 2048 of the
    32768 positions; per MoE block one row all-gather and one
    reduce-scatter of the partials on the model group, beside the K/V
    gather of each attention block and the halo and state of each Mamba2
    block."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), n_experts=16,
                              ssm_chunk=tconfigs.get(arch).ssm_chunk)
    rec = dryrun.trace_cell(arch, "prefill_32k", cfg=cfg, mesh=(16, 16),
                            run_overrides={"seq_shard": True})
    assert rec["ok"] and rec["run"]["seq_shard"]
    assert (rec["batch_per_rank"], rec["seq_per_rank"]) == (2, 2048)
    specs = [s for seg in derive_segments(cfg)
             for _ in range(seg.repeats) for s in seg.pattern]
    want = Counter()
    for spec in specs:
        for key in (["seq.kv"] if spec.mixer == "attn"
                    else ["seq.halo", "seq.state"]):
            want[f"all-gather {key}"] += 1
        if spec.ffn == "moe":
            want["all-gather seq.moe"] += 1
            want["reduce-scatter seq.moe"] += 1
    assert rec["model_collectives"] == dict(want)
