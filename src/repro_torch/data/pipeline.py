"""Deterministic synthetic data pipeline: the port of the JAX package's
``repro.data.pipeline``.

A *learnable* token stream (per-sample affine progressions ``tok_t =
(phase + stride·t) mod V`` mixed with noise tokens), fully deterministic in
(seed, step): a restart from a checkpoint resumes the exact same stream.
The batch is drawn with numpy, as in JAX, so both give the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

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
    """Stateless-per-step synthetic LM stream: ``batch_at(step)``, or
    iterated from step 0.

    ``block`` (``(k, n)``): hand out only the k-th of n equal blocks of
    each batch's rows, the counterpart of the JAX package's
    ``make_array_from_callback`` over a sharding of the batch: a rank
    that takes its rows of the global batch gets them without the rest.
    The rows are ``_host_batch``'s, bit for bit."""

    def __init__(self, cfg: DataConfig, device: torch.device,
                 block: Optional[tuple[int, int]] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if block is not None:
            k, n = block
            if not 0 <= k < n or cfg.global_batch % n:
                raise ValueError(f"block {block}: a batch of "
                                 f"{cfg.global_batch} rows in {n} equal "
                                 f"blocks, k in [0, {n})")
        self.block = block

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
        """{"tokens": int64 [B, S]} on the pipeline's device (with
        ``block``, its rows alone)."""
        toks = self._host_batch(step)
        if self.block is not None:
            k, n = self.block
            b = toks.shape[0] // n
            toks = toks[k * b:(k + 1) * b]
        return {"tokens": torch.from_numpy(toks).long().to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
