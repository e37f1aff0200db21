"""AdamW with a cosine schedule and global-norm clipping: the port of the
JAX package's ``repro.optim.adamw``.

Moments are fp32; parameters stay in the model's dtype, updated in fp32
and rounded back (no fp32 master copy, as in JAX).  Weight decay applies
where the stored tensor has ``ndim >= 2``: a stacked norm weight
``[R, d]`` is decayed, ``final_norm [d]`` is not, as there.  The state is
``{"step": int32 0-d tensor (on the CPU), "m": {name: fp32}, "v": {name:
fp32}}``, keyed by parameter name, which the checkpoint writer stores
under JAX's key paths (``opt/m/segments/0/0/attn/wq``).  8-bit moments
wait for ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Union

import torch
from torch import nn

Grads = Mapping[str, torch.Tensor]


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
        if cfg.state_8bit:
            raise NotImplementedError(
                "8-bit AdamW moments are not ported yet (ROADMAP Queue 1 "
                "item 4, optimizer and compression extras)")
        self.cfg = cfg

    def init(self, params: nn.Module) -> dict:
        """Zero moments (fp32) for every parameter of ``params``."""
        def zeros():
            return {name: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                    for name, p in params.named_parameters()}
        return {"step": torch.zeros((), dtype=torch.int32), "m": zeros(),
                "v": zeros()}

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

        scale = 1.0
        if cfg.clip_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)

        bc1 = 1 - cfg.b1 ** step
        bc2 = 1 - cfg.b2 ** step
        for name, p in named.items():
            g = grads[name].float() * scale
            m, v = state["m"][name], state["v"][name]
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            pf = p.float()
            if p.ndim >= 2:
                delta.add_(pf, alpha=cfg.weight_decay)
            p.copy_(torch.sub(pf, delta, alpha=lr))
        return {"step": torch.tensor(step, dtype=torch.int32),
                "m": state["m"], "v": state["v"]}
