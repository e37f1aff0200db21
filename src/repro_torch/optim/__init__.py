"""Optimizer: AdamW with a cosine schedule, global-norm clipping and
optional 8-bit moments; fp8 error-feedback gradient compression."""
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule

__all__ = ["AdamW", "AdamWConfig", "compression", "cosine_schedule"]
