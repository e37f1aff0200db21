"""Architecture configs: the 10 assigned architectures + reduced smoke
variants + the input-shape grid.

Every field is structural (layer counts, dims, flavors); training-time
policy (sharding, remat, optimizer width) lives in ``RunConfig`` so the same
arch can be lowered under different distribution strategies during the perf
hillclimb.

This is the PyTorch port's own copy of ``repro.configs.base``: the
``ArchConfig`` fields and ``reduced()`` are kept identical to the JAX
package's (a test holds them equal); only ``RunConfig.attn_impl`` names
the port's two attention paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None      # per-expert FFN dim when != d_ff
    moe_layer_period: int = 1           # every k-th layer is MoE
    moe_layer_offset: int = 0           # jamba: MoE at odd indices
    first_dense_layers: int = 0         # deepseek-v3: first 3 layers dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- attention ---------------------------------------------------
    attn_type: str = "gqa"              # gqa | mla
    rope_theta: float = 1e4
    rotary_fraction: float = 1.0        # chatglm3: 0.5 ("RoPE 2d")
    # MLA dims (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ---------------------------------------------------------
    mlp_type: str = "swiglu"            # swiglu | relu2 | gelu

    # --- SSM (mamba2 / jamba) -----------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_n_groups: int = 1
    ssm_chunk: int = 256

    # --- layer pattern (hybrid) ----------------------------------------
    # repeating pattern of layer kinds; () means all-attention.
    layer_pattern: tuple[str, ...] = ()

    # --- encoder-decoder (whisper) --------------------------------------
    encoder_layers: int = 0
    max_source_positions: int = 0       # whisper: 1500 post-conv frames

    # --- VLM stub (internvl2) -------------------------------------------
    vision_embed_dim: int = 0
    vision_seq: int = 0

    # --- misc ----------------------------------------------------------
    tie_embeddings: bool = False
    mtp: bool = False                   # multi-token prediction head
    norm_eps: float = 1e-5
    sub_quadratic: bool = False         # may run long_500k

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def pattern(self) -> tuple[str, ...]:
        return self.layer_pattern or ("attn",) * 1

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def is_moe_layer(self, idx: int) -> bool:
        if not self.n_experts:
            return False
        if idx < self.first_dense_layers:
            return False
        return (idx - self.moe_layer_offset) % self.moe_layer_period == 0

    # parameter counts (for MODEL_FLOPS = 6·N·D roofline term) -----------
    def param_counts(self) -> dict[str, float]:
        """Returns {'total': N, 'active': N_active} (active < total for MoE)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim or 0
        H, K = self.n_heads, self.n_kv_heads

        def attn_params():
            if self.attn_type == "mla":
                qk = self.qk_nope_head_dim + self.qk_rope_head_dim
                p = 0
                p += d * self.q_lora_rank + self.q_lora_rank * H * qk \
                    if self.q_lora_rank else d * H * qk
                p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * H * (self.qk_nope_head_dim
                                              + self.v_head_dim)
                p += H * self.v_head_dim * d
                return p
            return d * H * hd + 2 * d * K * hd + H * hd * d

        def mlp_params(width):
            mult = 3 if self.mlp_type == "swiglu" else 2
            return mult * d * width

        def ssm_params():
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            G, N = self.ssm_n_groups, self.ssm_state
            p = d * (2 * d_in + 2 * G * N + nh)      # in_proj (x,z,B,C,dt)
            p += self.ssm_conv * (d_in + 2 * G * N)  # depthwise conv
            p += 2 * nh + nh                          # A, D, dt_bias
            p += d_in * d                             # out_proj
            return p

        total = active = 0.0
        for i in range(self.n_layers):
            kind = self.pattern[i % len(self.pattern)]
            if kind == "mamba":
                total += ssm_params(); active += ssm_params()
            else:
                total += attn_params(); active += attn_params()
            if self.is_moe_layer(i):
                e = mlp_params(self.expert_d_ff)
                total += d * self.n_experts + self.n_experts * e
                active += d * self.n_experts + self.n_experts_per_tok * e
                if self.n_shared_experts:
                    s = mlp_params(self.n_shared_experts * self.expert_d_ff)
                    total += s; active += s
            else:
                total += mlp_params(ff); active += mlp_params(ff)
        emb = V * d * (1 if self.tie_embeddings else 2)
        total += emb; active += emb
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_params() + mlp_params(ff))
            # decoder cross-attention
            dec_x = self.n_layers * attn_params()
            total += enc + dec_x; active += enc + dec_x
        return {"total": total, "active": active}

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test config of the same family: tiny dims, same structure."""
        pat = self.layer_pattern
        n_layers = max(2, len(pat)) if pat else 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else None,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            n_experts_per_tok=min(self.n_experts_per_tok, 2),
            moe_d_ff=32 if self.moe_d_ff is not None else None,
            first_dense_layers=min(self.first_dense_layers, 1),
            moe_layer_offset=min(self.moe_layer_offset, 1),
            # no capacity drops at smoke scale: decode must match prefill
            capacity_factor=16.0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            encoder_layers=min(self.encoder_layers, 2),
            max_source_positions=16 if self.max_source_positions else 0,
            vision_embed_dim=32 if self.vision_embed_dim else 0,
            vision_seq=8 if self.vision_seq else 0,
        )


# ----------------------------------------------------------------------
# input shapes (assigned grid)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """long_500k only for sub-quadratic archs (skip noted in DESIGN.md §4)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes


# ----------------------------------------------------------------------
# run-time policy (distribution / numerics) — hillclimb lever, not arch
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunConfig:
    fsdp: bool = False            # shard params/opt-state over data axis
    batch_axes: str = "dp"        # "dp" | "all": small models (no TP need)
                                  # shard batch over every mesh axis
    remat: bool = True            # scan-level activation checkpointing
    opt_8bit: bool = False        # int8 Adam moments (error-bounded)
    grad_compression: bool = False  # fp8 error-feedback gradient allreduce
    sync_mode: str = "barrier"    # barrier (baseline) | bucketed
                                  # (layer-wise overlap per the MXDAG plan)
    moe_combine: str = "psum"     # psum | psum_scatter
    attn_impl: str = "kernel"     # kernel (hand-written CUDA flash
                                  # attention; JAX "pallas") | plain
                                  # (masked einsum; JAX "xla"/"xla_flash")
    ssm_chunk: int = 0            # override ArchConfig.ssm_chunk (0 = keep)
    seq_shard: bool = False       # shard activations' seq dim over "model"
                                  # (SP for attention-free archs)
    microbatches: int = 1
    logits_fp32: bool = True
