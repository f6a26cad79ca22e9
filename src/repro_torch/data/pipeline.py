"""Deterministic synthetic token pipeline, host-sharded.

Sequences follow a seeded affine-markov process with noise, so models can
genuinely learn (loss decreases) while the stream stays fully reproducible
across restarts — a requirement for the checkpoint-restart-vs-SHIFT
comparison (Fig. 8): after a crash-restart the baseline must see the SAME
batches it would have seen, which a stateless index->batch map provides.
"""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    """Stateless map: global step -> this rank's batch."""

    def __init__(self, vocab: int, seq_len: int, batch_per_rank: int,
                 rank: int = 0, world: int = 1, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch_per_rank
        self.rank = rank
        self.world = world
        self.seed = seed
        rng = np.random.RandomState(seed)
        self.a = int(rng.randint(3, 23)) * 2 + 1   # odd multiplier
        self.c = int(rng.randint(1, vocab))
        self.noise = 0.05

    def batch_at(self, step: int) -> np.ndarray:
        """(batch, seq_len + 1) int32 tokens (inputs+targets overlap)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * self.world + self.rank)
            & 0x7FFFFFFF)
        B, S, V = self.batch, self.seq_len, self.vocab
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.randint(0, V, size=B)
        noise_mask = rng.rand(B, S) < self.noise
        noise_vals = rng.randint(0, V, size=(B, S))
        for t in range(S):
            nxt = (toks[:, t] * self.a + self.c) % V
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_vals[:, t], nxt)
        return toks
