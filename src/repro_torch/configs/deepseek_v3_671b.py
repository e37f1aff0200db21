"""deepseek-v3-671b — MLA + 256-expert top-8 MoE + MTP.

[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, 1 shared + 256 routed experts top-8, first 3 layers dense
(d_ff=18432 per the HF config), MLA with q_lora=1536 kv_lora=512
nope=128 rope=64 v=128, multi-token-prediction head.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                    # dense layers (first 3)
    vocab_size=129280,
    head_dim=192,                  # qk_nope + qk_rope
    n_experts=256,
    n_experts_per_tok=8,
    n_shared_experts=1,
    moe_d_ff=2048,                 # per-expert FFN width (assigned d_ff)
    moe_layer_period=1,
    first_dense_layers=3,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
    mtp=True,
)
