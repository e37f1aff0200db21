"""Stand-ins for every model input of a dry-run cell: the port of the JAX
package's ``launch/specs.py``.

Where the JAX package returns ``jax.ShapeDtypeStruct``s, these return
tensors, made inside whatever fake mode the caller has entered
(``torch._subclasses.fake_tensor.FakeTensorMode`` in ``launch.dryrun``), so
that no byte is allocated; outside one they are ordinary zero tensors.
Tokens are int64 (the port's token type: ``data.SyntheticLM`` yields
int64, and an embedding is indexed by it), frame and vision embeddings
bf16, as in the JAX package.  ``batch`` is the rows one rank takes: the
shape's global batch unless the caller splits it over data-parallel ranks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                batch: Optional[int] = None) -> dict:
    """The batch of a train or prefill cell: ``tokens`` [B, seq_len], and
    ``audio_embeds`` [B, frames, d_model] or ``vision_embeds`` [B,
    vision_seq, vision_embed_dim] where the config has them."""
    B = shape.global_batch if batch is None else batch
    out = {"tokens": torch.zeros((B, shape.seq_len), dtype=torch.int64)}
    if cfg.encoder_layers:
        out["audio_embeds"] = torch.zeros(
            (B, cfg.max_source_positions, cfg.d_model), dtype=torch.bfloat16)
    if cfg.vision_embed_dim:
        out["vision_embeds"] = torch.zeros(
            (B, cfg.vision_seq, cfg.vision_embed_dim), dtype=torch.bfloat16)
    return out


def decode_specs(model, cfg: ArchConfig, shape: ShapeConfig,
                 batch: Optional[int] = None):
    """(tokens [rows, 1], the cache of ``model.init_cache(B, seq_len)``,
    the cache index) for one decode step.  ``batch`` is B, the global
    batch ``Model.init_cache`` lays the cache out from (the shape's by
    default; a data-parallel rank built without a grid passes its own
    rows, its whole cache); ``rows`` are the rank's rows of it, B for one
    process (``Model.cache_layout``).  The index is a Python int, as
    ``Model.decode_step`` takes it: the cache's last row, so the step
    attends over the whole cache, as the JAX package's traced index leaves
    every row to the mask."""
    B = shape.global_batch if batch is None else batch
    cache = model.init_cache(B, shape.seq_len)
    rows = cache.layout.rows if cache.layout is not None else B
    tokens = torch.zeros((rows, 1), dtype=torch.int64, device=model.device)
    return tokens, cache, shape.seq_len - 1
