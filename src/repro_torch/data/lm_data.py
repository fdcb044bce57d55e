"""Synthetic LM token pipeline: a deterministic Zipf-ish token stream with
local structure (so loss actually decreases), sharded host->device feed with
a resumable cursor.

A copy of the JAX package's ``data/lm_data.py`` (numpy only): the same
seed and step give the same tokens in both packages, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Order-2 Markov-ish stream: next token depends on previous two through
    a hashed transition — learnable structure at any vocab size."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed))
        self._mix_a = int(rng.integers(1, 2**31 - 1)) | 1
        self._mix_b = int(rng.integers(1, 2**31 - 1))
        # Zipf-ish marginal for the noise branch
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._marginal = probs / probs.sum()

    def _next(self, rng, prev1, prev2):
        v = self.cfg.vocab_size
        det = ((prev1 * self._mix_a + prev2 * 31 + self._mix_b) % v)
        noise = rng.choice(v, size=prev1.shape, p=self._marginal)
        pick = rng.random(prev1.shape) < 0.75
        return np.where(pick, det, noise).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic function of (seed, step) — resume-exact."""
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        toks[:, 1] = rng.integers(0, cfg.vocab_size, b)
        for t in range(2, s + 1):
            toks[:, t] = self._next(rng, toks[:, t - 1], toks[:, t - 2])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
