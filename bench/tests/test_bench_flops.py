"""The operation and byte counts behind mfu and the rooflines, against
counts worked out by hand at small shapes, and against PyTorch's own
operation counter on the plain reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import flops, harness

M = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, d_ff=16, vocab=10,
         head_dim=None, rope_theta=10000.0, norm_eps=1e-5, act="silu",
         tie_embeddings=False)


def test_weights_a_token_meets():
    # q 8x(2x4), k and v 8x(1x4), o (2x4)x8, gate/up 8x16, down 16x8
    assert flops.layer_matmul_params(M) == 64 + 32 + 32 + 64 + 384
    assert flops.head_params(M) == 80


def test_prefill_ops_by_hand():
    # 3 tokens: 2 x 2 layers x 576 x 3, attention 4 x 2 x 2 x 4 over 6
    # causal pairs, and one head row 2 x 80
    assert flops.prefill_ops(M, 3) == 6912 + 384 + 160


def test_decode_ops_by_hand():
    assert flops.decode_ops(M, 5) == 2 * (2 * 576 + 80) + 64 * 5


def test_train_ops_by_hand():
    # 6 x (1152 + 80) a token over 2 x 3 tokens, and three times the
    # forward attention over 2 x 6 causal pairs
    assert flops.train_ops(M, 2, 3) == 6 * 1232 * 6 + 3 * 64 * 12


def test_bounds_by_hand():
    ops, nbytes = 4 * 2 * 4 * 10, 2 * 4 * 4 * 6 + 4 * 2 * 4
    assert flops.flash_fwd_bound(1, 4, 2, 1, 4) == pytest.approx(
        max(ops / flops.PEAK_BF16_OPS, nbytes / flops.PEAK_HBM_BYTES))
    ops, nbytes = 8 * 2 * 4 * 10, 2 * 16 * 8 + 32 + 2 * 16 * 4
    assert flops.flash_bwd_bound(1, 4, 2, 1, 4) == pytest.approx(
        max(ops / flops.PEAK_BF16_OPS, nbytes / flops.PEAK_HBM_BYTES))
    ops, nbytes = 4 * 2 * 4 * 7, 2 * (2 * 1 * 4 * 7 + 2 * 2 * 2 * 4)
    assert flops.decode_bound(7, 2, 2, 1, 4) == pytest.approx(
        max(ops / flops.PEAK_BF16_OPS, nbytes / flops.PEAK_HBM_BYTES))


def test_the_bound_is_the_larger_of_its_two_times():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("S", [3, 8])
def test_counts_agree_with_pytorchs_counter_on_the_reference(S):
    """The reference computes every (query, key) pair and every row's
    logits, so the counter sees the whole S x S square and S head rows
    where the benchmark counts S(S+1)/2 pairs and one row."""
    ref = harness.load_reference("dense_lm")
    P = ref.make_params(M, 0, "cpu", torch.float32)
    tokens = torch.arange(S)[None] % M["vocab"]
    with FlopCounterMode(display=False) as fc:
        ref.logits(M, P, ref.hidden(M, P, tokens))
    square = flops.attention_ops(M, S * S)
    counted = flops.prefill_ops(M, S) \
        - flops.attention_ops(M, flops.causal_pairs(S)) \
        - 2 * flops.head_params(M) + square + 2 * flops.head_params(M) * S
    assert fc.get_total_flops() == counted
