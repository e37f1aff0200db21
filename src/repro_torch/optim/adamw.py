"""AdamW with a cosine schedule, global-norm clipping and optional 8-bit
moments: the port of the JAX package's ``repro.optim.adamw``.

Parameters stay in the model's dtype, updated in fp32 and rounded back (no
fp32 master copy, as in JAX).  Weight decay applies where the stored
tensor has ``ndim >= 2``: a stacked norm weight ``[R, d]`` is decayed,
``final_norm [d]`` is not, as there.  The state is ``{"step": int32 0-d
tensor (on the CPU), "m": {name: moment}, "v": {name: moment}}``, keyed by
parameter name, which the checkpoint writer stores under JAX's key paths
(``opt/m/segments/0/0/attn/wq``).  A moment is fp32 of the parameter's
shape, or with ``state_8bit`` ``{"q": int8 codes, "s": fp32 scales}``,
one scale per trailing-axis row (``opt/m/.../wq/q`` and ``.../s``), as
JAX's ``_quant8`` stores it: m and v are re-quantised each step from the
fp32 values the update used.

The update walks a tensor of more than ``SLICE_NUMEL`` elements along its
leading axes, one slice at a time, so that its fp32 temporaries stay of
that size (a stacked olmoe-1b-7b expert weight holds 2.1 G elements).
Every operation of the update is elementwise or reduces along the last
axis, so a walked tensor gets the whole tensor's result, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Mapping, Optional, Union

import torch
from torch import nn

Grads = Mapping[str, torch.Tensor]

# the largest slice, in elements, that the update takes of a tensor at once
SLICE_NUMEL = 1 << 26


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` ×
    ``peak_lr`` at ``total``; computed in fp32, as JAX computes it."""
    def lr(step: int) -> float:
        f32 = torch.float32
        step = torch.tensor(step, dtype=f32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(torch.tensor(math.pi, dtype=f32)
                                          * t)))
        return float(torch.where(step < warmup, warm, cos))
    return lr


# ----------------------------------------------------------------------
# int8 block quantisation of the moments
# ----------------------------------------------------------------------
def _quant8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and fp32 scales (absmax over the last axis / 127) of an
    fp32 tensor; ``torch.round`` rounds half to even, as ``jnp.round``."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # a divisor on the tensor's device: CUDA multiplies by the reciprocal
    # of a Python scalar divisor, one ulp off the quotient at times
    scale = torch.clamp(absmax, min=1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _slices(t: torch.Tensor) -> Iterator[tuple]:
    """Index tuples into ``t``'s leading axes (never its last) whose
    slices hold at most ``SLICE_NUMEL`` elements, or one row: runs of the
    first axis where one of its entries fits, else each entry walked."""
    if t.numel() <= SLICE_NUMEL or t.ndim <= 1:
        yield ()
        return
    inner = t[0].numel()
    if inner <= SLICE_NUMEL:
        n = SLICE_NUMEL // inner
        for i in range(0, t.shape[0], n):
            yield (slice(i, i + n),)
        return
    for i in range(t.shape[0]):
        for rest in _slices(t[0]):
            yield (i,) + rest


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_8bit: bool = False


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    def init(self, params: nn.Module) -> dict:
        """Zero moments for every parameter of ``params``."""
        def zeros(p):
            if self.cfg.state_8bit:
                return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                         device=p.device),
                        "s": torch.zeros(p.shape[:-1] + (1,),
                                         dtype=torch.float32,
                                         device=p.device)}
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        def moments():
            return {name: zeros(p) for name, p in params.named_parameters()}
        return {"step": torch.zeros((), dtype=torch.int32), "m": moments(),
                "v": moments()}

    def _read(self, moment, idx: tuple) -> torch.Tensor:
        """A slice of a moment in fp32: a view of fp32 state (updated in
        place), or a dequantised copy of 8-bit state."""
        if self.cfg.state_8bit:
            return _dequant8(moment["q"][idx], moment["s"][idx])
        return moment[idx]

    def _write(self, moment, idx: tuple, value: torch.Tensor) -> None:
        if self.cfg.state_8bit:
            q, s = _quant8(value)
            moment["q"][idx].copy_(q)
            moment["s"][idx].copy_(s)

    @torch.no_grad()
    def update(self, grads: Grads, state: dict, params: nn.Module) -> dict:
        """One AdamW step: updates ``params`` and the moments of ``state``
        in place (the JAX function returns new ones), and returns the state
        with its step advanced.  ``grads`` maps each parameter's name to
        its gradient, in any float dtype."""
        cfg = self.cfg
        step = int(state["step"]) + 1
        lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
        named = dict(params.named_parameters())
        if named.keys() != grads.keys():
            raise KeyError(f"gradients do not match the parameters: "
                           f"{sorted(named.keys() ^ grads.keys())}")

        scale = None
        if cfg.clip_norm is not None:
            # on the card a bf16 tensor's norm accumulates in fp32 without
            # an fp32 copy of it
            sq = sum(torch.square(torch.linalg.vector_norm(
                g, dtype=torch.float32)) for g in grads.values())
            scale = torch.clamp(cfg.clip_norm / (torch.sqrt(sq) + 1e-12),
                                max=1.0)

        # bias corrections in fp32, as JAX computes them
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(cfg.b1, dtype=f32) ** step)
        bc2 = float(1 - torch.tensor(cfg.b2, dtype=f32) ** step)
        for name, p in named.items():
            decay = cfg.weight_decay if p.ndim >= 2 else 0.0
            m_st, v_st = state["m"][name], state["v"][name]
            for idx in _slices(p):
                g = grads[name][idx].float()      # may be the caller's
                if scale is not None:
                    g = g * scale
                m = self._read(m_st, idx).mul_(cfg.b1).add_(g * (1 - cfg.b1))
                v = self._read(v_st, idx).mul_(cfg.b2).add_(
                    torch.square(g).mul_(1 - cfg.b2))
                del g
                delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
                # m and v are stored after the update has read them
                self._write(m_st, idx, m)
                self._write(v_st, idx, v)
                del m, v
                pf = p[idx].float()
                delta.add_(pf * decay)
                p[idx].copy_(pf.sub_(delta.mul_(lr)))
        return {"step": torch.tensor(step, dtype=torch.int32),
                "m": state["m"], "v": state["v"]}
