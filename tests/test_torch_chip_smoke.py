"""chip_smoke.py's flash-attention checks, run on the CPU at its cases on
the edges of the bf16 bodies' 128-row work tiles, K/V tiles and query
stages: the planted faults of the plain forward (a key off by one, 64 keys
dropped, keys [128, 256) dropped) and of the plain backward (delta left
out, a K/V tile dropped, the causal edge off by one, keys or queries
[128, 256) dropped, one head of a GQA group) are each rejected by the
limits that hold the kernels on the card, and the fused-QKV case hands over
strided views. The ptxas report of the ``hopper`` kernels fails the run on a
stack frame, a spill or a serialised ``wgmma``.
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


# B2's cases on the edges of its work tiles, K/V tiles and q stages
BWD_EDGE_CASES = [c for c in CS.bwd_cases()
                  if c[0].startswith(("tile edge", "fused"))]


def _bwd_id(case):
    label, B, H, KV, Sq, Sk, hd, dt, causal, layout = case
    return (f"{label}-Sq{Sq}-Sk{Sk}-hd{hd}-G{H // KV}-"
            f"{'causal' if causal else 'full'}")


def test_bwd_edge_cases_cover_head_dims_orientations_gqa_and_layouts():
    assert {c[6] for c in BWD_EDGE_CASES} == {64, 128}
    assert all(c[7] == torch.bfloat16 for c in BWD_EDGE_CASES)
    assert {c[9] for c in BWD_EDGE_CASES} == {"contiguous", "fused"}
    for hd in (64, 128):
        mine = [c for c in BWD_EDGE_CASES if c[6] == hd]
        lengths = {c[4] for c in mine} | {c[5] for c in mine}
        assert {127, 128, 129, 255, 257} <= lengths
        # causal with Sq > Sk and Sq < Sk, and non-causal
        kinds = {(c[8], (c[4] > c[5]) - (c[4] < c[5])) for c in mine}
        assert {(True, 1), (True, -1), (False, 1), (False, -1)} <= kinds
        assert any(c[2] // c[3] == 4 for c in mine)          # GQA, G = 4
        assert any(c[9] == "fused" for c in mine)


@pytest.mark.parametrize("case", BWD_EDGE_CASES,
                         ids=[_bwd_id(c) for c in BWD_EDGE_CASES])
def test_bwd_planted_faults_are_rejected_at_tile_edges(case):
    """On the CPU the plain backward passes ``grad_agreement`` against
    itself, and the same limits reject every planted fault, the second B2
    work tile's keys or queries dropped included."""
    label, B, H, KV, Sq, Sk, hd, dt, causal, layout = case
    gen = torch.Generator().manual_seed(2)
    q, k, v = CS.flash_inputs(gen, B, H, KV, Sq, Sk, hd, dt, layout, "cpu")
    do, = CS.rand_like_cases(gen, [(B, Sq, H, hd)], dt, "cpu")
    o, lse = CS.FR.flash_attention_ref(q, k, v, causal=causal)
    ref = CS.FR.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    assert all(CS.grad_agreement(g, g)[0] for g in ref)
    faults = CS.bwd_faults(q, k, v, o, lse, do, causal)
    want = {"delta left out", "64-row K/V tile dropped"}
    if causal:
        want.add("causal edge off by one")
    # each drop is planted wherever it changes a seen pair
    if Sk > 128 and (not causal or Sq > 128):
        want.add("keys [128, 256) dropped")
    if Sq > 128:
        want.add("queries [128, 256) dropped")
    if H > KV:
        want.add("first head of each group only")
    assert set(faults) == want
    for fault, planted in faults.items():
        caught = not all(CS.grad_agreement(g, r)[0]
                         for g, r in zip(planted, ref))
        assert caught, f"the limits pass '{fault}'"


_PTXAS_NAME = "_ZN6hopper9dq_kernelILi64EEEv14CUtensorMap_stNS_6ParamsE"


def _ptxas_log(stack=0, stores=0, loads=0, warning=""):
    return "\n".join([
        f"ptxas info    : Compiling entry function '{_PTXAS_NAME}' "
        "for 'sm_90a'",
        f"ptxas info    : Function properties for {_PTXAS_NAME}",
        f"    {stack} bytes stack frame, {stores} bytes spill stores, "
        f"{loads} bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        warning])


@pytest.mark.parametrize("log, faulty", [
    (_ptxas_log(), False),
    (_ptxas_log(stack=8), True),
    (_ptxas_log(stores=16, loads=16), True),
    (_ptxas_log(loads=4), True),
    (_ptxas_log(warning="ptxas warning : (C7512) Potential Performance "
                "Loss: wgmma.mma_async instructions are serialized"), True),
    (_ptxas_log().replace("hopper", "simt"), True),
    ("", True),
], ids=["clean", "stack", "spill", "spill-load", "C7512", "no-instance",
        "no-log"])
def test_ptxas_report_fails_on_stack_spill_or_serialised_wgmma(log, faulty):
    """``print_ptxas`` fails the run on any ``hopper`` instance with a
    stack frame or a spill, on a C75xx warning, and when the build left no
    report of a ``hopper`` instance to check."""
    report, faults = CS.ptxas_report(log, "hopper")
    assert bool(faults) == faulty
    if "hopper" in log:
        assert report[0].startswith(_PTXAS_NAME)
        assert "Used 168 registers" in report[0]
