"""internvl2-2b — InternViT (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The vision tower is a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings
(B, 1024, 1024-dim InternViT features), projected into the LM and
prepended to the token sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    vision_embed_dim=1024,
    vision_seq=1024,
    rope_theta=1e4,
)
