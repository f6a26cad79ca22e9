"""The benchmark's one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and draws the inputs from ``--seed``.

Two shapes of traffic, by the mix's ``kind``:

- ``train``: a pool of token batches from a seeded affine-Markov process
  with noise (a copy of ``repro_torch.data.pipeline.SyntheticDataset``'s
  process, drawn for the whole pool at once): each row starts at a random
  token, and token t+1 is (a * token t + c) mod V, or a random token with
  probability ``noise``. Learnable, so the loss can fall; every row
  differs.
- ``closed_loop``: a stream of requests, each prompt length and output
  length drawn uniformly over its range (bounds included), independently
  of every other, and token ids uniform over the vocabulary.

The same seed gives the same inputs; any whole number is a seed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _rngs(seed: int, n: int):
    """``n`` independent numpy generators from one seed of any size."""
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(abs(int(seed))).spawn(n)]


def train_pool(seed: int, params: dict, vocab: int) -> np.ndarray:
    """(pool_batches, batch, seq_len + 1) int64 tokens; batch i feeds step
    i (inputs tokens[:, :-1], targets tokens[:, 1:])."""
    rules, draws = _rngs(seed, 2)
    a = int(rules.integers(3, 23)) * 2 + 1       # odd multiplier
    c = int(rules.integers(1, vocab))
    P, B, S = params["pool_batches"], params["batch"], params["seq_len"]
    rows = P * B
    toks = np.empty((rows, S + 1), dtype=np.int64)
    toks[:, 0] = draws.integers(0, vocab, size=rows)
    noise = draws.random((rows, S)) < params["noise"]
    noise_vals = draws.integers(0, vocab, size=(rows, S))
    for t in range(S):
        nxt = (toks[:, t] * a + c) % vocab
        toks[:, t + 1] = np.where(noise[:, t], noise_vals[:, t], nxt)
    return toks.reshape(P, B, S + 1)


def requests(seed: int, params: dict,
             vocab: int) -> Iterator[Tuple[np.ndarray, int]]:
    """The closed loop's request stream: (prompt int32 tokens, output
    tokens) in the order the callers send them."""
    plen_rng, out_rng, tok_rng = _rngs(seed, 3)
    (plo, phi), (olo, ohi) = params["prompt_len"], params["output_len"]
    while True:
        n = int(plen_rng.integers(plo, phi + 1))
        yield (tok_rng.integers(0, vocab, size=n, dtype=np.int32),
               int(out_rng.integers(olo, ohi + 1)))
