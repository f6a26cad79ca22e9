"""Operation and byte counts of the model and its kernels, and the chip's
peaks: the arithmetic behind every ``mfu`` and ``roofline`` metric.

Counts are of useful work only: the tokens requested (never the padding),
the causal pairs of attention (a query and the keys at or before it),
each input byte read once and each output byte written once. Recompute
under remat is not counted. So a share of a peak can only read high if
the time is short, never because the work was counted twice.

``m`` is a configuration's ``model`` dict (``bench/configs/*.json``).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its full 700 W: bf16 tensor-core operations
# a second and HBM3 bytes a second (NVIDIA's data sheet).
PEAK_BF16_OPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
F32 = 4


def head_dim(m) -> int:
    return m["head_dim"] or m["d_model"] // m["n_heads"]


def layer_matmul_params(m) -> int:
    """Weights one dense layer multiplies a token by: q, k, v, o and the
    gated MLP's three matrices."""
    D, H, KV, F = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    hd = head_dim(m)
    return D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F


def head_params(m) -> int:
    return m["d_model"] * m["vocab"]


def causal_pairs(n: int) -> int:
    """(query, key) pairs of causal attention over n tokens."""
    return n * (n + 1) // 2


def attention_ops(m, pairs: int) -> float:
    """Forward operations of every layer's attention over ``pairs``
    (query, key) pairs: q k^T and p v, 2 * hd each, for every head."""
    return 4.0 * m["n_layers"] * m["n_heads"] * head_dim(m) * pairs


def prefill_ops(m, n: int) -> float:
    """A prompt of ``n`` tokens through every layer, and the head at its
    last position (the prefill computes one row of logits)."""
    return 2.0 * m["n_layers"] * layer_matmul_params(m) * n \
        + attention_ops(m, causal_pairs(n)) + 2.0 * head_params(m)


def decode_ops(m, attended: int) -> float:
    """One generated token that attends ``attended`` cache rows (itself
    included), through every layer and the head."""
    return 2.0 * (m["n_layers"] * layer_matmul_params(m) + head_params(m)) \
        + attention_ops(m, attended)


def train_ops(m, batch: int, seq: int) -> float:
    """One train step over ``batch`` rows of ``seq`` tokens: forward (2
    operations a weight a token) and backward (4), and attention's causal
    pairs forward (4 hd) and backward (8 hd: dS, dV, dQ, dK)."""
    tokens = batch * seq
    weights = m["n_layers"] * layer_matmul_params(m) + head_params(m)
    return 6.0 * weights * tokens \
        + 3.0 * attention_ops(m, batch * causal_pairs(seq))


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the bf16 peak and the bytes over HBM's."""
    return max(ops / PEAK_BF16_OPS, nbytes / PEAK_HBM_BYTES)


def flash_fwd_bound(B, S, H, KV, hd, elem=BF16) -> float:
    """B1 forward, causal, Sq = Sk = S: q, k, v read, o and the float32
    logsumexp written."""
    ops = 4.0 * B * H * hd * causal_pairs(S)
    nbytes = elem * B * S * hd * (2 * H + 2 * KV) + F32 * B * H * S
    return bound_s(ops, nbytes)


def flash_bwd_bound(B, S, H, KV, hd, elem=BF16) -> float:
    """The whole attention backward (B2a, B2b and the delta), causal:
    dS = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q, 2 hd each a
    pair (the recomputed scores not counted); q, k, v, o, do, the
    logsumexp read, dq, dk, dv written."""
    ops = 8.0 * B * H * hd * causal_pairs(S)
    nbytes = elem * B * S * hd * (3 * H + 2 * KV) + F32 * B * H * S \
        + elem * B * S * hd * (H + 2 * KV)
    return bound_s(ops, nbytes)


def decode_bound(attended_rows: int, B, H, KV, hd, elem=BF16) -> float:
    """B3 over a batch of B rows that attend ``attended_rows`` cache rows
    in all: those rows' K and V read, each row's query read and output
    written."""
    ops = 4.0 * H * hd * attended_rows
    nbytes = elem * (2 * KV * hd * attended_rows + 2 * B * H * hd)
    return bound_s(ops, nbytes)
