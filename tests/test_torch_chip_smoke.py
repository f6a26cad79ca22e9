"""chip_smoke.py's flash-attention checks, run on the CPU at its cases on
the edges of the bf16 body's 128-row query blocks and K/V tiles: the
planted faults of the plain version (a key off by one, 64 keys dropped,
keys [128, 256) dropped) are each rejected by the limits that hold the
kernel on the card, and the fused-QKV case hands over strided views.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

EDGE_CASES = [c for c in CS.flash_cases()
              if c[0].startswith(("tile edge", "fused"))]


def _id(case):
    label, B, H, KV, Sq, Sk, hd, dt, causal, layout = case
    return f"{label}-Sq{Sq}-Sk{Sk}-hd{hd}-{'causal' if causal else 'full'}"


def test_edge_cases_cover_both_head_dims_and_layouts():
    hds = {c[6] for c in EDGE_CASES}
    assert hds == {64, 128}
    assert {c[9] for c in EDGE_CASES} == {"contiguous", "fused"}
    lengths = {c[4] for c in EDGE_CASES} | {c[5] for c in EDGE_CASES}
    assert {127, 128, 129, 255, 257} <= lengths
    assert all(c[7] == torch.bfloat16 for c in EDGE_CASES)
    # causal with Sq > Sk and Sq < Sk, and non-causal
    kinds = {(c[8], (c[4] > c[5]) - (c[4] < c[5])) for c in EDGE_CASES}
    assert {(True, 1), (True, -1), (False, 1), (False, -1)} <= kinds


@pytest.mark.parametrize("case", EDGE_CASES, ids=[_id(c) for c in EDGE_CASES])
def test_planted_faults_are_rejected_at_tile_edges(case):
    label, B, H, KV, Sq, Sk, hd, dt, causal, layout = case
    gen = torch.Generator().manual_seed(0)
    q, k, v = CS.flash_inputs(gen, B, H, KV, Sq, Sk, hd, dt, layout, "cpu")
    if layout == "fused":
        assert q.stride()[1:] == ((H + 2 * KV) * hd, hd, 1)
        assert k.data_ptr() - q.data_ptr() == 2 * H * hd
    o_ref, _ = CS.FR.flash_attention_ref(q, k, v, causal=causal)
    ok, _, _ = CS.agreement("flash_attention", o_ref, o_ref)
    assert ok
    faults = CS.flash_faults(q, k, v, causal)
    want = {"one key off"}
    if Sk > 64 and (Sq > 64 or not causal):
        want.add("64-key chunk dropped")
    if Sk >= 192 and (Sq >= 192 or not causal):
        want.add("keys [128, 256) dropped")
    assert set(faults) == want
    for fault, planted in faults.items():
        caught, _, _ = CS.agreement("flash_attention", planted, o_ref)
        assert not caught, f"the limits pass '{fault}'"
