"""Optimizer: AdamW with a cosine schedule and global-norm clipping."""
from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule

__all__ = ["AdamW", "AdamWConfig", "cosine_schedule"]
