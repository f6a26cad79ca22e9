"""chip_smoke.py's flash-attention checks, run on the CPU at its cases on
the edges of the bf16 bodies' 128-row work tiles, K/V tiles and query
stages: the planted faults of the plain forward (a key off by one, 64 keys
dropped, keys [128, 256) dropped) and of the plain backward (delta left
out, a K/V tile dropped, the causal edge off by one, keys or queries
[128, 256) dropped, one head of a GQA group) are each rejected by the
limits that hold the kernels on the card, and the fused-QKV case hands over
strided views. The ptxas report of the ``hopper`` kernels fails the run on a
stack frame, a spill or a serialised ``wgmma``. The ddp phase's payload
check accepts the port's bucketed all-reduce on the CPU and rejects two
planted faults: a bucket left unreduced and one element changed.
"""

import re
import sys
from pathlib import Path

import numpy as np
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


# B4's cases: the bf16 ones run the wgmma body
SSD_BF16_CASES = [c for c in CS.ssd_cases() if c[6] == torch.bfloat16]


def _ssd_id(case):
    label, B, T, H, P, N, dt, layout = case
    return f"{label}-B{B}-T{T}-H{H}-P{P}-N{N}-{layout}".replace(" ", "_")


def test_ssd_bf16_cases_cover_the_wgmma_body():
    """Whole chunks (T = 128), the zamba2 prefill contiguous and strided,
    one batch row, an odd H (a block holding one head) at both widths, and
    ragged chunks."""
    shapes = {(c[4], c[5]) for c in SSD_BF16_CASES}
    assert shapes == set(CS.SO.SHAPES)
    assert any(c[2] == 128 for c in SSD_BF16_CASES)
    assert {c[7] for c in SSD_BF16_CASES if c[2] == 512} \
        >= {"model", "contiguous"}
    assert any(c[1] == 1 for c in SSD_BF16_CASES)
    assert {(c[4], c[5]) for c in SSD_BF16_CASES if c[3] % 2} \
        == set(CS.SO.SHAPES)
    assert any(c[2] % 64 for c in SSD_BF16_CASES)
    assert {c[7] for c in SSD_BF16_CASES} == {"model", "contiguous",
                                              "strided"}


@pytest.mark.parametrize("case", SSD_BF16_CASES,
                         ids=[_ssd_id(c) for c in SSD_BF16_CASES])
def test_ssd_bf16_cases_are_layouts_the_tma_body_reads(case):
    """Every bf16 case hands the kernel xh, B and C that its tensor maps
    read, as the Mamba2 block does; the refusal case's do not."""
    label, B, T, H, P, N, dt, layout = case
    gen = torch.Generator().manual_seed(0)
    ins = CS.ssd_inputs(gen, B, T, H, P, N, dt, layout, "cpu")
    CS.SO._check(*ins)
    if layout != "contiguous":
        assert not ins[3].is_contiguous()
    bad = CS.ssd_inputs(gen, 1, 8, 3, 64, 64, dt, "model", "cpu")
    with pytest.raises(ValueError, match="16-byte aligned"):
        CS.SO._check(*bad)


SSD_SMALL = [c for c in SSD_BF16_CASES if c[1] * c[2] * c[3] <= 2048]


@pytest.mark.parametrize("case", SSD_SMALL,
                         ids=[_ssd_id(c) for c in SSD_SMALL])
def test_ssd_planted_faults_are_rejected(case):
    """On the CPU the plain scan passes ``ssd_agreement`` against itself,
    and the same limits reject every planted fault that changes the scan
    at this length."""
    label, B, T, H, P, N, dt, layout = case
    gen = torch.Generator().manual_seed(3)
    ins = CS.ssd_inputs(gen, B, T, H, P, N, dt, layout, "cpu")
    y_ref, h_ref = CS.SR.ssd_scan_ref(*ins)
    assert CS.ssd_agreement(y_ref, y_ref)[0]
    assert CS.ssd_agreement(h_ref, h_ref)[0]
    faults = CS.ssd_faults(T)
    assert len(faults) == (6 if T > 64 else 4)
    for fault in faults:
        fy, fh = CS.plain_ssd(*ins, fault)
        caught = not (CS.ssd_agreement(fy, y_ref)[0]
                      and CS.ssd_agreement(fh, h_ref)[0])
        assert caught, f"the limits pass '{fault}'"


_SSD_HOPPER = ("_ZN44_GLOBAL__N__59bf1801_11_ssd_scan_cu_ssd_scan6hopper10"
               "ssd_kernelE14CUtensorMap_stS1_S1_S1_NS_6ParamsEii")
_SSD_SIMT = "_ZN12_GLOBAL__N_110ssd_kernelIfLi64ELi64EEEvNS_6ParamsE"


def _ssd_log(name, stack=0, spill=0):
    return [f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {stack} bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads",
            "ptxas info    : Used 168 registers, used 16 barriers"]


@pytest.mark.parametrize("hopper, simt, faulty", [
    ({}, {}, False),
    ({"spill": 8}, {}, True),
    ({"stack": 16}, {}, True),
    ({}, {"stack": 16}, False),
    (None, {}, True),
], ids=["clean", "spill", "stack", "float32-body-not-checked",
        "no-wgmma-body"])
def test_ptxas_report_checks_the_ssd_wgmma_body(hopper, simt, faulty):
    """``print_ptxas("ssd_scan", "hopper")`` reads only the bf16 body,
    which sits in namespace ``hopper`` and keeps "ssd_kernel" in its name
    (the profile's "scan kernel" group); the float32 body is not held to
    it, and a build without the bf16 body fails."""
    lines = _ssd_log(_SSD_SIMT, **simt)
    if hopper is not None:
        lines += _ssd_log(_SSD_HOPPER, **hopper)
    report, faults = CS.ptxas_report("\n".join(lines), "hopper")
    assert bool(faults) == faulty
    assert all("hopper" in r for r in report)
    assert "ssd_kernel" in _SSD_HOPPER


# B5's cases: the bf16 ones run the wgmma body; two take extreme decays
RWKV_EXTREME_CASES = [c for c in CS.rwkv_cases()
                      if c[0].startswith(CS.RWKV_EXTREME)]


def test_rwkv_cases_add_extreme_decays_at_two_sizes():
    """The extreme-decay cases are bf16 in the model's layout, at (2, 130,
    8) and at rwkv6-3b's prefill (4, 512, 40); they come after the earlier
    cases, whose inputs the shared generator keeps as they were."""
    assert [c[1:] for c in RWKV_EXTREME_CASES] == [
        (2, 130, 8, torch.bfloat16, "model"),
        (4, 512, 40, torch.bfloat16, "model")]
    cases = CS.rwkv_cases()
    assert cases[-4:-2] == RWKV_EXTREME_CASES
    assert sum(c[5] == "strided" for c in cases) == 8


def test_rwkv_cases_cut_chains_between_blocks():
    """The last two cases, bf16 in both layouts, have more (b, h) chains
    than an H100 has SMs (132) and a chunk count per chain (4) that does
    not divide the chunks a block takes, so the bf16 body hands chains
    from one block to the next, with a ragged last chunk."""
    cut = [c for c in CS.rwkv_cases() if c[0] == CS.RWKV_CUT]
    assert cut == CS.rwkv_cases()[-2:]
    assert [c[1:] for c in cut] == [(3, 200, 50, torch.bfloat16, "model"),
                                    (3, 200, 50, torch.bfloat16, "strided")]
    B, T, H = cut[0][1:4]
    chains, chunks = B * H, -(-T // 64)
    per = max(-(-chains * chunks // 132), chunks)
    assert chains > 132 and T % 64 and per % chunks


def test_extreme_decays_hold_exact_zeros_and_ones():
    """Every 7th channel decays to exactly 0, channels 1, 10, 19, ... not
    at all (exactly 1), and the rest range from near 1 to underflow."""
    gen = torch.Generator().manual_seed(5)
    r, k, v, w, u = CS.rwkv_case_inputs(gen, RWKV_EXTREME_CASES[0], "cpu")
    assert r.dtype == k.dtype == v.dtype == torch.bfloat16
    assert w.dtype == torch.float32 and w.is_contiguous()
    ones = torch.arange(64) % 9 == 1
    zeros = (torch.arange(64) % 7 == 0) & ~ones
    assert (w[..., ones] == 1).all() and (w[..., zeros] == 0).all()
    rest = w[..., ~(ones | zeros)]
    assert rest.max() > 0.9 and (rest == 0).any()
    model = CS.rwkv_inputs(torch.Generator().manual_seed(5), 2, 130, 8,
                           torch.bfloat16, "model", "cpu")
    assert (model[3] > 0).all() and (model[3] < 1).all()


def test_rwkv_planted_faults_are_rejected_at_extreme_decays():
    """On the CPU the plain scan passes ``ssd_agreement`` against itself
    at the small extreme-decay case, and the same limits reject every
    planted fault (T = 130 is not a whole chunk, so all five)."""
    gen = torch.Generator().manual_seed(5)
    ins = CS.rwkv_case_inputs(gen, RWKV_EXTREME_CASES[0], "cpu")
    y_ref, S_ref = CS.RR.rwkv6_scan_ref(*ins)
    assert CS.ssd_agreement(y_ref, y_ref)[0]
    assert CS.ssd_agreement(S_ref, S_ref)[0]
    faults = CS.rwkv_faults(130)
    assert len(faults) == 5
    for fault in faults:
        fy, fs = CS.plain_rwkv(*ins, fault)
        caught = not (CS.ssd_agreement(fy, y_ref)[0]
                      and CS.ssd_agreement(fs, S_ref)[0])
        assert caught, f"the limits pass '{fault}'"


def _flaky(part):
    """A scan whose second run differs from its first in the last bit of
    one element of ``part`` (0: y, 1: the state)."""
    calls = []

    def scan(*ins):
        out = list(CS.RR.rwkv6_scan_ref(*ins))
        if calls:
            out[part] = out[part].clone()
            out[part].view(-1)[7] = torch.nextafter(
                out[part].view(-1)[7], torch.tensor(float("inf")))
        calls.append(1)
        return tuple(out)
    return scan


@pytest.mark.parametrize("part", [None, 0, 1], ids=["same", "y", "state"])
def test_rwkv_repeat_sees_one_bit_in_y_or_the_state(part):
    """``rwkv_repeat`` returns the first run and whether the second gave
    the same bits: one ulp of one element of y or of the state is seen."""
    gen = torch.Generator().manual_seed(0)
    ins = CS.rwkv_inputs(gen, 1, 9, 2, torch.bfloat16, "model", "cpu")
    scan = CS.RR.rwkv6_scan_ref if part is None else _flaky(part)
    (y, S), same = CS.rwkv_repeat(scan, ins)
    y_ref, S_ref = CS.RR.rwkv6_scan_ref(*ins)
    assert torch.equal(y, y_ref) and torch.equal(S, S_ref)
    assert same == (part is None)


@pytest.mark.parametrize("part", [None, 1], ids=["repeats", "differs"])
def test_check_rwkv_fails_a_scan_that_does_not_repeat(monkeypatch, part):
    """``check_rwkv`` runs each case twice through the wrapper and fails
    the run when the second differs, even where both agree with the plain
    scan (here on the CPU, at one small case)."""
    monkeypatch.setattr(CS, "rwkv_cases", lambda: [
        ("tiny", 1, 70, 2, torch.bfloat16, "model")])
    scan = CS.RR.rwkv6_scan_ref if part is None else _flaky(part)
    monkeypatch.setattr(CS.RO, "rwkv6_scan", scan)
    if part is None:
        CS.check_rwkv("cpu")
    else:
        with pytest.raises(SystemExit):
            CS.check_rwkv("cpu")


_RWKV_HOPPER = ("_ZN46_GLOBAL__N__7ed12bfc_13_rwkv6_scan_cu_0a5a1a2b6hopper12"
                "rwkv6_kernelE14CUtensorMap_stS1_S1_S1_NS_6ParamsEi")
_RWKV_SIMT = ("_ZN46_GLOBAL__N__7ed12bfc_13_rwkv6_scan_cu_0a5a1a2b12"
              "rwkv6_kernelENS_6ParamsE")


@pytest.mark.parametrize("hopper, simt, faulty", [
    ({}, {}, False),
    ({"spill": 120}, {}, True),
    ({"stack": 256}, {}, True),
    ({}, {"stack": 16}, False),
    (None, {}, True),
], ids=["clean", "spill", "stack", "float32-body-not-checked",
        "no-wgmma-body"])
def test_ptxas_report_checks_the_rwkv6_wgmma_body(hopper, simt, faulty):
    """``print_ptxas("rwkv6_scan", "hopper")``, which ``main`` runs, reads
    only B5's bf16 body (namespace ``hopper``, "rwkv6_kernel" kept in its
    name for the profile's "scan kernel" group); the float32 body is not
    held to it, and a build without the bf16 body fails."""
    assert 'print_ptxas("rwkv6_scan", "hopper")' in Path(
        CS.__file__).read_text()
    lines = _ssd_log(_RWKV_SIMT, **simt)
    if hopper is not None:
        lines += _ssd_log(_RWKV_HOPPER, **hopper)
    report, faults = CS.ptxas_report("\n".join(lines), "hopper")
    assert bool(faults) == faulty
    assert all("hopper" in r for r in report)
    assert "rwkv6_kernel" in _RWKV_HOPPER


# B3's cases, by label
DECODE_CASES = {c[0]: c for c in CS.decode_cases() if c[6] == torch.bfloat16}


def test_decode_cases_cover_the_bf16_body_paths():
    """Every row in one chunk (G = 8, and G = 1 at hd = 64), chunk counts
    that differ within the batch and reach the last, partial chunk of S
    (G = 8, and G = 1 at hd = 64), a group of 12 heads (8 and 4 a block),
    the empty row, and zamba2's serving case as it was."""
    chunk = 64
    for label, G, hd in (("one chunk each", 8, 128),
                         ("MHA hd=64 one chunk each", 1, 64)):
        _, B, H, KV, S, d, dt, lens = DECODE_CASES[label]
        assert (H // KV, d) == (G, hd) and S > chunk
        assert max(lens) == chunk and min(lens) >= 1
    for label, G, hd in (("chunk counts differ", 8, 128),
                         ("MHA hd=64 chunk counts differ", 1, 64)):
        _, B, H, KV, S, d, dt, lens = DECODE_CASES[label]
        counts = [-(-min(n, S) // chunk) for n in lens]
        assert (H // KV, d) == (G, hd)
        assert len(set(counts)) == B and max(lens) >= S
        assert min(counts) == 1 or S % chunk
    _, B, H, KV, S, hd, dt, lens = DECODE_CASES["12 heads a K/V head"]
    assert H // KV == 12
    assert 0 in DECODE_CASES["yi-6b heads, an empty row"][7]
    assert DECODE_CASES["zamba2 serving"][1:] == (
        4, 32, 32, CS.SERVE_MAX_LEN, 64, torch.bfloat16, [528] * 4)


def _flaky_decode(calls):
    """The plain version, with one ulp added to one element of the output
    of every call after the first."""
    def decode(*ins):
        o = CS.DR.decode_attention_ref(*ins)
        if calls:
            o = o.clone()
            o.view(-1)[7] = torch.nextafter(o.view(-1)[7],
                                            torch.tensor(float("inf"),
                                                         dtype=o.dtype))
        calls.append(1)
        return o
    return decode


@pytest.mark.parametrize("flaky", [False, True], ids=["same", "one-bit"])
def test_decode_repeat_sees_one_bit(flaky):
    """``decode_repeat`` returns the first run and whether the second gave
    the same bits: one ulp of one element is seen."""
    gen = torch.Generator().manual_seed(0)
    q, kc, vc = CS.rand_like_cases(gen, [(2, 4, 16), (2, 9, 2, 16),
                                         (2, 9, 2, 16)], torch.bfloat16,
                                   "cpu")
    ln = torch.tensor([9, 3])
    fn = _flaky_decode([]) if flaky else CS.DR.decode_attention_ref
    o, same = CS.decode_repeat(fn, (q, kc, vc, ln))
    assert torch.equal(o, CS.DR.decode_attention_ref(q, kc, vc, ln))
    assert same == (not flaky)


@pytest.mark.parametrize("flaky", [False, True], ids=["repeats", "differs"])
def test_check_decode_fails_a_kernel_that_does_not_repeat(monkeypatch,
                                                          flaky):
    """``check_decode`` runs each case twice through the wrapper and fails
    the run when the second differs, even where both agree with the plain
    version (here on the CPU, at one small case)."""
    monkeypatch.setattr(CS, "decode_cases", lambda: [
        ("tiny", 2, 8, 2, 130, 16, torch.bfloat16, [130, 5])])
    fn = _flaky_decode([]) if flaky else CS.DR.decode_attention_ref
    monkeypatch.setattr(CS.DO, "decode_attention", fn)
    if flaky:
        with pytest.raises(SystemExit):
            CS.check_decode("cpu")
    else:
        CS.check_decode("cpu")


_DECODE_HOPPER = ("_ZN41_GLOBAL__N__095d471f_9_decode_cu_7dbeda1b6hopper13"
                  "decode_kernelILi128ELb0EEEvNS_6ParamsEi")
_DECODE_SIMT = ("_ZN41_GLOBAL__N__095d471f_9_decode_cu_7dbeda1b21"
                "decode_partial_kernelILi128EEEvNS_6ParamsE")


@pytest.mark.parametrize("hopper, simt, faulty", [
    ({}, {}, False),
    ({"spill": 4}, {}, True),
    ({"stack": 64}, {}, True),
    ({}, {"stack": 16}, False),
    (None, {}, True),
], ids=["clean", "spill", "stack", "float32-body-not-checked",
        "no-bf16-body"])
def test_ptxas_report_checks_the_decode_bf16_body(hopper, simt, faulty):
    """``print_ptxas("decode", "hopper")``, which ``main`` runs, reads only
    B3's bf16 body (namespace ``hopper``, "decode_kernel" in its name, as
    the profile's B3 count reads it); the float32 body's two kernels are
    not held to it, and a build without the bf16 body fails."""
    assert 'print_ptxas("decode", "hopper")' in Path(CS.__file__).read_text()
    lines = _ssd_log(_DECODE_SIMT, **simt)
    if hopper is not None:
        lines += _ssd_log(_DECODE_HOPPER, **hopper)
    report, faults = CS.ptxas_report("\n".join(lines), "hopper")
    assert bool(faults) == faulty
    assert all("hopper" in r for r in report)


def test_the_profile_counts_every_b3_device_kernel():
    """The decode step's B3 count reads the names of every kernel that
    ``decode.cu`` launches: the bf16 body's one and the float32 body's
    two."""
    source = (Path(CS.__file__).parent / "src/repro_torch/kernels/"
              "decode_attention/csrc/decode.cu").read_text()
    launched = set(re.findall(r"(\w+_kernel)(?:<[^>]*>)?<<<", source))
    assert launched and all(any(w in name for w in CS.B3_KERNELS)
                            for name in launched)
    assert all(w in source for w in CS.B3_KERNELS)


# ---------------------------------------------------------------------------
# the ddp phase's payload check: the fabric's sum, bit for bit
# ---------------------------------------------------------------------------


def _port_allreduce(skip_bucket=None):
    """Seeded float32 gradient vectors of 2 ranks through the port's
    bucketed all-reduce on the CPU (64 KiB buckets), the bucket
    ``skip_bucket`` never issued: (inputs, outputs, bucket bounds)."""
    from repro_torch.collectives import build_world

    _, _, world = build_world(n_ranks=2, channels=2,
                              max_chunk_bytes=1 << 14)
    rng = np.random.RandomState(5)
    vecs = [rng.standard_normal(100_003).astype(np.float32)
            for _ in range(2)]
    inputs = [v.copy() for v in vecs]
    bounds = world.aligned_bucket_bounds(vecs[0].size, 4, 1 << 16)
    world.wait_all([world.allreduce_async([v[lo:hi] for v in vecs])
                    for i, (lo, hi) in enumerate(bounds)
                    if i != skip_bucket])
    return inputs, vecs, bounds


def test_ddp_sum_check_accepts_the_fabrics_sum():
    inputs, outputs, bounds = _port_allreduce()
    assert len(bounds) > 4
    assert CS.fabric_sum_faults(inputs, outputs) == []


@pytest.mark.parametrize("fault", ["one bucket left unreduced",
                                   "one element changed"])
def test_ddp_sum_check_rejects_planted_faults(fault):
    if fault == "one bucket left unreduced":
        inputs, outputs, bounds = _port_allreduce(skip_bucket=3)
    else:
        inputs, outputs, _ = _port_allreduce()
        outputs[1][77_777] = np.nextafter(outputs[1][77_777],
                                          np.float32(np.inf))
    faults = CS.fabric_sum_faults(inputs, outputs)
    if fault == "one bucket left unreduced":
        lo, hi = bounds[3]
        assert len(faults) == 2 and f"first at {lo}" in faults[0]
    else:
        assert faults == ["rank 1: 1 of 100003 elements differ from the "
                          "float32 sum, first at 77777"]
