"""mamba2-130m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  24L d_model=768 d_ff=0 (no MLP blocks)
vocab=50280, ssm_state=128, expand=2 (d_inner=1536, 24 heads of 64).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                        # pure mamba blocks, no MLP sublayer
    vocab_size=50280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    tie_embeddings=True,
    sub_quadratic=True,
)
