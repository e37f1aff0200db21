"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Attention every 8th layer (index 4 in each
period-8 block), MoE every other layer.  SSM blocks use the SSD (mamba2)
formulation — the TPU-friendly chunked form (see DESIGN.md §2); Jamba's
original Mamba-1 d_state=16 is kept.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    n_experts_per_tok=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,            # MoE at odd layer indices (1,3,5,...)
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    rope_theta=1e4,
    sub_quadratic=True,
)
