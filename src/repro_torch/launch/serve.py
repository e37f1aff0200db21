"""Serving: one-call prefill + batched greedy decode.

The prompt is prefilled with ONE ``decode_step`` over ``[B, prompt_len]``
at cache index 0 (where the JAX demo prefills token by token): attention
blocks run it through the flash-attention kernel K1 on the "kernel" path,
Mamba2 blocks through the chunked SSD scan on K2, MoE blocks their experts
through the grouped matmul K3.  Then tokens are decoded one at a time:
attention on the plain masked path, Mamba2 on the single-step recurrence,
MoE experts on K3 again.  An MoE block's capacity follows the tokens of the
call (B·prompt_len in the prefill, B in a decode step), as in JAX.  MLA
blocks (deepseek-v3) prefill through K1 on the expanded latents and decode
in the latent space.  An encoder-decoder (whisper) encodes its audio
frames once a request batch (non-causal K1 on the "kernel" path) and
hands the states to every prefill and decode step's cross-attention.

    python -m repro_torch.launch.serve --device cpu          # smoke config
    python -m repro_torch.launch.serve --full --prompt-len 4096   # on the card
    python -m repro_torch.launch.serve --arch whisper-large-v3 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
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
# deepseek-v3-671b at full width, cut to 2 layers: one dense (MLA + d_ff
# 18432) and one MoE (MLA + 256 experts of 2048 and a shared one), 13.94 B
# parameters with the embeddings, 14.63 B (29.3 GB in bf16) with the MTP
# head.  The 61-layer model (671 B) cannot be held by one card; every
# width is the published one (``full_config``)
MLA_ARCH, MLA_LAYERS, MLA_BATCH, MLA_PROMPT, MLA_GEN = \
    "deepseek-v3-671b", 2, 4, 1024, 32
# whisper-large-v3 whole: 32 encoder and 32 decoder layers, 1500 frames;
# 128 + 32 tokens stay inside its 448-token decoder context
ENC_ARCH, ENC_BATCH, ENC_PROMPT, ENC_GEN = "whisper-large-v3", 4, 128, 32


def full_config(arch: str) -> ArchConfig:
    """The full-width config served for ``arch``: deepseek-v3-671b cut to
    ``MLA_LAYERS`` layers, the first of them dense, and named for the cut
    (``deepseek-v3-671b-2l``); any other whole."""
    cfg = configs.get(arch)
    if arch == MLA_ARCH:
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-{MLA_LAYERS}l",
                                  n_layers=MLA_LAYERS, first_dense_layers=1)
    return cfg


def setup(cfg: ArchConfig, batch: int, prompt_len: int, device=None,
          dtype: torch.dtype = torch.bfloat16, seed: int = 0):
    """A model with random weights and a request batch: {"tokens": random
    prompts [batch, prompt_len]}, and for an encoder-decoder
    "audio_embeds" [batch, max_source_positions, d_model] (standard
    normal, in the model dtype), all drawn from one generator seeded with
    ``seed``."""
    model = Model(cfg, dtype=dtype, device=device)
    g = torch.Generator(device=model.device).manual_seed(seed)
    model.init(g)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=model.device)
    requests = {"tokens": prompts}
    if cfg.encoder_layers:
        requests["audio_embeds"] = torch.randn(
            (batch, cfg.max_source_positions, cfg.d_model), generator=g,
            device=model.device).to(dtype)
    return model, requests


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def make_serve_step(model: Model, enc_out: Optional[torch.Tensor] = None):
    """One decode step: (cache, tokens [B,S], index) → (next token [B,1], cache)."""
    def serve_step(cache, tokens, index):
        logits, cache = model.decode_step(cache, tokens, index,
                                          enc_out=enc_out)
        return _greedy(logits), cache
    return serve_step


def encode(model: Model, requests: dict) -> Optional[torch.Tensor]:
    """The encoder's states for a request batch (None without an
    encoder): computed once, read by every prefill and decode step."""
    return model.encode(requests) if model.cfg.encoder_layers else None


def prefill(model: Model, cache, prompts: torch.Tensor,
            enc_out: Optional[torch.Tensor] = None):
    """Write the whole prompt into the cache in one call at index 0.

    Returns (first generated token [B,1], logits [B,P,V], cache).
    """
    logits, cache = model.decode_step(cache, prompts, 0, enc_out=enc_out)
    return _greedy(logits), logits, cache


def decode(model: Model, cache, tok: torch.Tensor, start: int, steps: int,
           enc_out: Optional[torch.Tensor] = None):
    """Greedy-decode ``steps`` tokens after ``tok``, which sits at ``start``.

    Returns (tokens [B, steps], cache)."""
    step = make_serve_step(model, enc_out)
    out = []
    for t in range(start, start + steps):
        tok, cache = step(cache, tok, t)
        out.append(tok)
    return torch.cat([tok[:, :0], *out], dim=1), cache


def generate(model: Model, requests: dict, gen: int) -> torch.Tensor:
    """Serve a request batch (``setup``'s dict: prompts [B,P] under
    ``tokens``, and any audio frames): ``gen`` greedy tokens each,
    [B,gen]."""
    prompts = requests["tokens"]
    B, P = prompts.shape
    enc_out = encode(model, requests)
    cache = model.init_cache(B, P + gen)
    tok, _, cache = prefill(model, cache, prompts, enc_out)
    rest, _ = decode(model, cache, tok, P, gen - 1, enc_out)
    return torch.cat([tok, rest], dim=1)


def main(argv: Optional[list[str]] = None) -> torch.Tensor:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mamba2-130m")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--full", action="store_true",
                   help="full-width config instead of the smoke config "
                        f"({MLA_ARCH}: cut to {MLA_LAYERS} layers)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = (full_config(args.arch) if args.full
           else configs.get_smoke(args.arch))
    model, requests = setup(cfg, args.batch, args.prompt_len, dev)
    with torch.inference_mode():
        out = generate(model, requests, args.gen)
    print(f"served {args.batch} requests of {cfg.name}, generated "
          f"{out.shape[1]} tokens each on {dev}")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
