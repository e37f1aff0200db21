"""Deterministic synthetic data pipeline: the port of the JAX package's
``repro.data.pipeline``.

A *learnable* token stream (per-sample affine progressions ``tok_t =
(phase + stride·t) mod V`` mixed with noise tokens), fully deterministic in
(seed, step): a restart from a checkpoint resumes the exact same stream.
The batch is drawn with numpy, as in JAX, so both give the same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise_prob: float = 0.05


class SyntheticLM:
    """Stateless-per-step synthetic LM stream: ``batch_at(step)``."""

    def __init__(self, cfg: DataConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)

    def _host_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        phase = rng.integers(0, V, size=(B, 1))
        stride = rng.integers(1, min(V - 1, 64), size=(B, 1))
        t = np.arange(S)[None, :]
        toks = (phase + stride * t) % V
        noise = rng.random((B, S)) < cfg.noise_prob
        toks = np.where(noise, rng.integers(0, V, size=(B, S)), toks)
        return toks.astype(np.int32)

    def batch_at(self, step: int) -> dict:
        """{"tokens": int64 [B, S]} on the pipeline's device."""
        toks = torch.from_numpy(self._host_batch(step)).long()
        return {"tokens": toks.to(self.device)}
