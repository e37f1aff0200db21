"""Serving: one-call prefill + batched greedy decode.

The prompt is prefilled with ONE ``decode_step`` over ``[B, prompt_len]``
at cache index 0 (where the JAX demo prefills token by token): attention
blocks run it through the flash-attention kernel K1 on the "kernel" path,
Mamba2 blocks through the chunked SSD scan on K2, MoE blocks their experts
through the grouped matmul K3.  Then tokens are decoded one at a time:
attention on the plain masked path, Mamba2 on the single-step recurrence,
MoE experts on K3 again.  An MoE block's capacity follows the tokens of the
call (B·prompt_len in the prefill, B in a decode step), as in JAX.

    python -m repro_torch.launch.serve --device cpu          # smoke config
    python -m repro_torch.launch.serve --full --prompt-len 4096   # on the card
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import Model

# the full-width serving runs that chip_smoke.py and profile_serve.py drive
FULL_ARCH, FULL_BATCH, FULL_PROMPT, FULL_GEN = "deepseek-7b", 4, 1024, 32
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN = "mamba2-130m", 8, 4096, 32
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN = "olmoe-1b-7b", 4, 1024, 32


def setup(cfg: ArchConfig, batch: int, prompt_len: int, device=None,
          dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """A model with random weights and random prompts [batch, prompt_len],
    both drawn from one generator seeded with ``seed``."""
    model = Model(cfg, dtype=dtype, device=device)
    g = torch.Generator(device=model.device).manual_seed(seed)
    model.init(g)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=model.device)
    return model, prompts


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def make_serve_step(model: Model):
    """One decode step: (cache, tokens [B,S], index) → (next token [B,1], cache)."""
    def serve_step(cache, tokens, index):
        logits, cache = model.decode_step(cache, tokens, index)
        return _greedy(logits), cache
    return serve_step


def prefill(model: Model, cache, prompts: torch.Tensor):
    """Write the whole prompt into the cache in one call at index 0.

    Returns (first generated token [B,1], logits [B,P,V], cache).
    """
    logits, cache = model.decode_step(cache, prompts, 0)
    return _greedy(logits), logits, cache


def decode(model: Model, cache, tok: torch.Tensor, start: int, steps: int):
    """Greedy-decode ``steps`` tokens after ``tok``, which sits at ``start``.

    Returns (tokens [B, steps], cache)."""
    step = make_serve_step(model)
    out = []
    for t in range(start, start + steps):
        tok, cache = step(cache, tok, t)
        out.append(tok)
    return torch.cat([tok[:, :0], *out], dim=1), cache


def generate(model: Model, prompts: torch.Tensor, gen: int) -> torch.Tensor:
    """Serve a batch of prompts [B,P]: ``gen`` greedy tokens each, [B,gen]."""
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen)
    tok, _, cache = prefill(model, cache, prompts)
    rest, _ = decode(model, cache, tok, P, gen - 1)
    return torch.cat([tok, rest], dim=1)


def main(argv: Optional[list[str]] = None) -> torch.Tensor:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mamba2-130m")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--full", action="store_true",
                   help="full-width config instead of the smoke config")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    model, prompts = setup(cfg, args.batch, args.prompt_len, dev)
    with torch.inference_mode():
        out = generate(model, prompts, args.gen)
    print(f"served {args.batch} requests of {cfg.name}, generated "
          f"{out.shape[1]} tokens each on {dev}")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
