"""olmoe-1b-7b — 64-expert top-8 MoE, every layer.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 (dropless in the paper; capacity-based here
with cf=1.25 — see DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    n_experts_per_tok=8,
    moe_d_ff=1024,
    moe_layer_period=1,
    rope_theta=1e4,
)
