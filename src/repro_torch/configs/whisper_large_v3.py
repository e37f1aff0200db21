"""whisper-large-v3 — encoder-decoder audio backbone (frontend stubbed).

[arXiv:2212.04356; unverified]  32L d_model=1280 20H d_ff=5120
vocab=51866.  The conv/mel frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings
(B, 1500, d_model); 32 encoder + 32 decoder layers, GELU MLPs,
decoder cross-attends to encoder states.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                   # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    max_source_positions=1500,
    rope_theta=1e4,
)
