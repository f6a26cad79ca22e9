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
planted faults: a bucket left unreduced and one element changed. The
families phase's shapes (llama-3.2-vision's cross prefill over 1600 image
keys and cross decode, musicgen-medium, starcoder2-3b) are kernel cases,
the cross cases' planted faults are rejected, and its per-layer attention
check rejects a fault dropping the last image key of one cross block.
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
    assert hds == {64, 112, 128}        # kimi-k2's 112: 128-column tiles
    for hd in hds:
        mine = [c for c in EDGE_CASES if c[6] == hd]
        assert {127, 128, 129, 255, 257} <= {c[4] for c in mine}
        assert any(c[9] == "fused" for c in mine)
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
    assert {c[6] for c in BWD_EDGE_CASES} == {64, 112, 128}
    assert all(c[7] == torch.bfloat16 for c in BWD_EDGE_CASES)
    assert {c[9] for c in BWD_EDGE_CASES} == {"contiguous", "fused"}
    for hd in (64, 112, 128):
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


def _campaign_attention_shapes():
    """(B, H, KV, Sq, Sk, hd, dtype) of every attention call of the ddp
    smoke cell on the CPU, recorded through the plain route."""
    seen = set()

    def route(q, k, v, causal=True, scale=None):
        assert causal
        seen.add((q.shape[0], q.shape[2], k.shape[2], q.shape[1],
                  k.shape[1], q.shape[3], q.dtype))
        return CS.plain_train(q, k, v, causal=causal, scale=scale)

    scenario, workload, kw = CS.CAMPAIGN_SMOKE[1]
    with CS.plain_attention(route):
        CS.campaign_cell("cpu", scenario, workload, **kw)
    return seen


def test_campaign_attention_shapes_are_kernel_cases():
    """The campaign phase's attention shapes, the smoke model's and
    gpt2-124m's at full width on the same 2 x 32 tokens a rank, are
    cases of both B1's and B2's checks against their plain versions."""
    (B, H, KV, Sq, Sk, hd, dt), = _campaign_attention_shapes()
    cfg = CS.gpt2_124m.config()
    want = {(B, H, KV, Sq, Sk, hd, dt, True, "contiguous"),
            (B, cfg.n_heads, cfg.n_kv_heads, Sq, Sk,
             cfg.d_model // cfg.n_heads, dt, True, "contiguous")}
    for cases in (CS.flash_cases(), CS.bwd_cases()):
        assert want <= {c[1:] for c in cases}


def test_campaign_loss_limit_rejects_planted_faults():
    """The smoke cells' card-against-CPU loss limit, on the CPU: the ddp
    cell against itself passes, and its planted faults of the plain
    attention are each rejected."""
    scenario, workload, kw = CS.CAMPAIGN_SMOKE[1]
    clean, _, _ = CS.campaign_cell("cpu", scenario, workload, **kw)
    again, _, _ = CS.campaign_cell("cpu", scenario, workload, **kw)
    assert CS.losses_rel(again.loss_trace, clean.loss_trace) == 0.0
    faults = CS.campaign_loss_faults("cpu", scenario, workload, kw,
                                     clean.loss_trace)
    assert set(faults) == set(CS.CAMPAIGN_LOSS_FAULTS)
    assert all(rel > CS.CAMPAIGN_LOSS_REL for rel in faults.values())


def test_yi6b_admissions_at_their_own_length_are_timed_kernel_cases():
    """``TPServeEngine.admit`` prefills a dense prompt at its own length,
    so yi-6b's B1 runs at a ragged S: each of ADMIT_LENS, past the first
    and up to the last 128-row query block of the longest prompt, is a
    causal bf16 case at B = 1 with yi-6b's heads and a timed shape."""
    cfg = CS.yi_6b.config()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    flash = {c[1:] for c in CS.flash_cases()}
    assert len(CS.ADMIT_LENS) == 3
    for S in CS.ADMIT_LENS:
        assert S % 128 and 1024 < S < 3584
        assert (1, H, KV, S, S, hd, torch.bfloat16, True,
                "contiguous") in flash
        assert (f"yi-6b admission S={S}", 1, H, KV, S, hd) in CS.FLASH_TIMED
    assert max(CS.ADMIT_LENS) // 128 == 3584 // 128 - 1


def test_moe_cases_cover_llama4_and_the_serving_campaign():
    """B1 and B3 hold the moe paths' shapes: llama4-maverick's prefill,
    admission and decode at full width (5 query heads a K/V head, hd
    128), and the serving campaign's smoke admission and decode (hd 16,
    a length past the cache end); B1's and B3's timed shapes include
    llama4-maverick's."""
    cfg = CS.llama4_maverick.config()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    assert (H // KV, hd) == (5, 128)
    flash = {c[1:] for c in CS.flash_cases()}
    bf = torch.bfloat16
    for B, S in ((4, 512), (1, CS.SCHED_PREFILL)):
        assert (B, H, KV, S, S, hd, bf, True, "contiguous") in flash
    smoke = CS.llama4_maverick.smoke_config()
    sm = (smoke.n_heads, smoke.n_kv_heads, smoke.hd)
    assert (1, *sm[:2], 12, 12, sm[2], bf, True, "contiguous") in flash
    decode = {c[0]: c[1:] for c in CS.decode_cases()}
    B, h, kv, S, d, dt, lens = decode["llama4 serving"]
    assert (h, kv, S, d, dt) == (H, KV, CS.SERVE_MAX_LEN, hd, bf)
    assert lens == [n + CS.N_NEW // 2 for n in CS.PROMPT_LENS]
    B, h, kv, S, d, dt, lens = decode["moe smoke decode"]
    assert (B, h, kv, S, d, dt) == (2, *sm[:2], 32, sm[2], bf)
    assert max(lens) > S
    assert ("llama4 prefill", 4, H, KV, 512, hd) in CS.FLASH_TIMED
    assert any(t[0] == "llama4 serving" and t[1:6] ==
               (4, H, KV, CS.SERVE_MAX_LEN, hd) for t in CS.DECODE_TIMED)


def _serving_attention_shapes():
    """(kind, B, H, KV, Sq or S, hd, dtype) of every attention call of the
    serving campaign's rail_kill_striped cell on the CPU."""
    seen = set()

    def train(q, k, v, causal=True, scale=None):
        seen.add(("B1", q.shape[0], q.shape[2], k.shape[2], q.shape[1],
                  q.shape[3], q.dtype))
        return CS.plain_train(q, k, v, causal=causal, scale=scale)

    def decode(q, kc, vc, lens):
        seen.add(("B3", q.shape[0], q.shape[1], kc.shape[2], kc.shape[1],
                  q.shape[2], q.dtype))
        return CS.DR.decode_attention_ref(q, kc, vc, lens)

    with CS.plain_attention(train, decode):
        r, _, _, _ = CS.serving_cell("cpu", "rail_kill_striped")
    assert r.ok
    return seen


def test_serving_campaign_attention_shapes_are_kernel_cases():
    flash = {c[1:7] + (c[7],) for c in CS.flash_cases()}
    decode = {c[1:7] for c in CS.decode_cases()}
    shapes = _serving_attention_shapes()
    assert {s[0] for s in shapes} == {"B1", "B3"}
    for kind, B, H, KV, S, hd, dt in shapes:
        if kind == "B1":
            assert (B, H, KV, S, S, hd, dt) in flash
        else:
            assert (B, H, KV, S, hd, dt) in decode


def test_moe_memory_reckoning_is_the_params_in_bf16():
    cfg = CS.moe_config()
    assert (cfg.n_layers, cfg.param_dtype) == (2, torch.bfloat16)
    assert cfg.param_count() == 34_408_391_680
    assert round(CS.param_gb(cfg), 1) == 68.8
    three = CS.llama4_maverick.config(n_layers=3, param_dtype=torch.bfloat16)
    assert CS.param_gb(three) > 80


def test_moe_attention_check_rejects_a_one_layer_fault():
    """At smoke width on the CPU (where the wrappers are the plain
    versions): each layer's attention on the recorded inputs of a prefill
    and 4 decode steps reads 0; a planted fault of the plain attention in
    one layer is rejected in that layer alone."""
    cfg = CS.llama4_maverick.smoke_config(n_layers=3)
    model = CS.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = CS.ServeEngine(model, params,
                            max_len=40, device="cpu")
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, cfg.vocab, size=(2, 30)).astype(np.int32)
    feed = [torch.as_tensor(rng.randint(1, cfg.vocab, size=(2, 1)))
            for _ in range(4)]
    records, routes = [], []
    with CS.recording_attention(records), CS.recording_routes(routes):
        logits = CS.teacher_forced(engine, prompts, feed)
    assert len(records) == len(routes) == 5 * cfg.n_layers
    assert torch.equal(logits, CS.teacher_forced(engine, prompts, feed))
    assert CS.moe_attention_layers(records, cfg) == [0.0] * cfg.n_layers
    faulted = CS.moe_attention_layers(records, cfg, fault_layer=1)
    assert faulted[0] == faulted[2] == 0.0
    assert faulted[1] > CS.MOE_ATTN_REL_L2
    # the decode calls alone also see the fault
    decode_only = [r for r in records if r[3] is not None]
    assert CS.moe_attention_layers(decode_only, cfg, fault_layer=1)[1] \
        > CS.MOE_ATTN_REL_L2


def test_kimi_memory_reckoning_is_two_layers_in_bf16():
    """KIMI_LAYERS of kimi-k2's 61 layers in bf16: 72.82 GB at 2 (3 would
    not fit the card), head dim 112, top-8 of 384 experts."""
    cfg = CS.kimi_config()
    assert CS.KIMI_LAYERS == 2
    assert (cfg.n_layers, cfg.param_dtype) == (2, torch.bfloat16)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == (112, 8)
    assert (cfg.n_experts, cfg.top_k) == (384, 8)
    assert round(CS.param_gb(cfg), 2) == 72.82
    one = CS.kimi_k2_1t.config(n_layers=1, param_dtype=torch.bfloat16)
    assert round(CS.param_gb(one), 2) == 38.76
    three = CS.kimi_k2_1t.config(n_layers=3, param_dtype=torch.bfloat16)
    assert CS.param_gb(three) > 80


def test_kimi_cases_cover_head_dim_112():
    """B1, B2a/B2b and B3 hold kimi-k2's shapes at hd 112 against their
    plain versions: its prefill and admission, the tile edges and float32;
    its decode (serving lengths, every row in one chunk, float32) and G = 1
    at hd 112; its attention's backward in both dtypes and ragged causal.
    The timed shapes include kimi-k2's, with the SDPA backend named."""
    cfg = CS.kimi_config()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf, f32 = torch.bfloat16, torch.float32
    flash = [c for c in CS.flash_cases() if c[6] == hd]
    got = {c[1:] for c in flash}
    for B, S in ((4, 512), (1, CS.SCHED_PREFILL)):
        assert (B, H, KV, S, S, hd, bf, True, "contiguous") in got
    assert any(c[7] == f32 and c[2] > c[3] and c[4] != c[5] for c in flash)
    assert {c[0] for c in flash if c[0].startswith("tile edge")} \
        >= {f"tile edge S={S}" for S in (127, 128, 129, 255, 257)}
    decode = {c[0]: c[1:] for c in CS.decode_cases() if c[5] == hd}
    lens = [n + CS.N_NEW // 2 for n in CS.PROMPT_LENS]
    assert decode["kimi serving"] == (4, H, KV, CS.SERVE_MAX_LEN, hd, bf,
                                      lens)
    assert decode["kimi serving f32"][5] == f32
    assert max(decode["kimi one chunk each"][6]) == 64
    assert any(h == kv for _, h, kv, *_ in decode.values())      # G = 1
    bwd = {c[1:] for c in CS.bwd_cases() if c[6] == hd}
    for dt in (bf, f32):
        assert (2, H, KV, 1024, 1024, hd, dt, True, "contiguous") in bwd
    assert any(c[3] % 128 and c[7] for c in bwd)       # ragged causal
    assert ("kimi prefill", 4, H, KV, 512, hd) in CS.FLASH_TIMED
    assert any(t[0] == "kimi serving" and t[1:6] ==
               (4, H, KV, CS.SERVE_MAX_LEN, hd) for t in CS.DECODE_TIMED)
    assert CS.KIMI_BWD_TIMED == (2, H, KV, 1024, hd)
    assert {"kimi prefill", "kimi serving", "kimi attention"} \
        == set(CS.NAMED_BACKEND)


def test_sdpa_backend_names_pytorchs_own_choice():
    """The backend named beside SDPA's time is PyTorch's pick for the same
    arguments (on the CPU here), a name of ``SDPBackend``."""
    from torch.nn.attention import SDPBackend
    q, k = torch.randn(2, 16, 8, 112), torch.randn(2, 16, 2, 112)

    def sdpa(q, k, v, choice=torch.nn.functional.scaled_dot_product_attention):
        return choice(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), is_causal=True, enable_gqa=True)
    got = CS.sdpa_backend(sdpa, (q, k, k))["library_backend"]
    want = int(torch._fused_sdp_choice(q.transpose(1, 2), k.transpose(1, 2),
                                       k.transpose(1, 2), is_causal=True,
                                       enable_gqa=True))
    assert got == {int(b): n.lower()
                   for n, b in SDPBackend.__members__.items()}[want]


def _kimi_smoke_engine(n_layers=2):
    cfg = CS.kimi_k2_1t.smoke_config(dtype=torch.float32, head_dim=112,
                                     n_layers=n_layers)
    model = CS.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, CS.ServeEngine(model, params, max_len=40, device="cpu")


def test_kimi_launch_counts_are_one_a_layer_and_step():
    """The counts the kimi phase wants, on the CPU at smoke width and hd
    112 (where the wrappers' plain versions count): one flash attention a
    layer and prefill, one decode attention a layer and decode step,
    nothing else, for generate and for the scheduler's admissions."""
    cfg, engine = _kimi_smoke_engine()
    L = cfg.n_layers
    prompts = np.random.RandomState(0).randint(1, cfg.vocab, (4, 12))
    CS.zero_counts()
    engine.generate(prompts, 5)
    plain = CS.read_counts()
    want = CS.step_launches(L, 1, 5)
    assert plain["flash_attention_ref"] == want["flash_attention"] == L
    assert plain["decode_attention_ref"] == want["decode_attention"] == 5 * L
    assert all(plain[k] == 0 for k in CS.KERNELS)
    assert sum(plain.values()) == L + 5 * L
    tp = CS.TPServeEngine(engine.model, None, world=None, max_len=40,
                          local=engine, device="cpu")
    sched = CS.RequestScheduler(tp, n_slots=2, prefill_len=16)
    for n in (3, 6, 4):
        sched.submit(prompts[0, :n + 4], n)
    CS.zero_counts()
    sched.run()
    plain = CS.read_counts()
    assert plain["flash_attention_ref"] == 3 * L
    assert plain["decode_attention_ref"] == sched.decode_steps * L


def test_kimi_attention_check_rejects_a_one_layer_fault_at_hd_112():
    """kimi-k2's smoke model at hd 112 on the CPU: each layer's attention on
    the recorded inputs reads 0, a planted fault in one layer is rejected
    in that layer alone, and top-2 routes are recorded a token."""
    cfg, engine = _kimi_smoke_engine(n_layers=3)
    rng = np.random.RandomState(1)
    prompts = rng.randint(1, cfg.vocab, size=(2, 30)).astype(np.int32)
    feed = [torch.as_tensor(rng.randint(1, cfg.vocab, size=(2, 1)))
            for _ in range(4)]
    records, routes = [], []
    with CS.recording_attention(records), CS.recording_routes(routes):
        CS.teacher_forced(engine, prompts, feed)
    assert len(records) == len(routes) == 5 * cfg.n_layers
    assert routes[0].shape == (60, cfg.top_k)
    assert CS.routes_differ(routes, routes) == 0.0
    assert CS.moe_attention_layers(records, cfg) == [0.0] * cfg.n_layers
    faulted = CS.moe_attention_layers(records, cfg, fault_layer=2)
    assert faulted[0] == faulted[1] == 0.0
    assert faulted[2] > CS.MOE_ATTN_REL_L2


def test_routes_differ_counts_choices_not_positions():
    """One expert of one token's top-3 changed is one choice in six, in
    whatever order the choices come."""
    a = [torch.tensor([[1, 2, 3], [4, 5, 6]])]
    b = [torch.tensor([[3, 1, 2], [6, 7, 4]])]
    assert CS.routes_differ(a, b) == pytest.approx(1 / 6)
    assert CS.routes_differ([torch.tensor([[2], [5]])],
                            [torch.tensor([[2], [4]])]) == 0.5


class _Engine:
    """Stands in for a ServeEngine: each decode step launches B3 once for
    each of ``layers`` layers, as counted by the wrapper."""

    def __init__(self, layers):
        self.layers = layers

    def _decode(self, cache, tok):
        CS.DO.decode_attention.launches += self.layers
        return torch.zeros(tok.shape[0], 1, 5), cache


@pytest.mark.parametrize("kernels, kept, windows", [
    ([32.0], 32.0, 1),                  # one kernel a launch: final
    ([31.75, 32.0], 32.0, 2),           # one record lost, then whole
    ([31.75, 31.75, 31.75], 31.75, 3),  # short every time: kept short
    ([64.0], 64.0, 1),                  # two kernels a launch: final
])
def test_profile_steps_takes_a_short_decode_window_again(monkeypatch, kernels,
                                                         kept, windows):
    """A decode window whose profiler reads fewer B3 device kernels than
    the wrapper counted launches is taken again, at most three in all; a
    reading of as many or more ends it. The kept reading is what the
    serving phases hold to one a layer, so 31.75 and 64 still fail them."""
    planted = iter(kernels)

    def window(fn, wall_ms, n=1, shapes=False):
        fn()
        return {"b3_kernels_per_step": next(planted) if n == 4 else 0.0}

    monkeypatch.setattr(CS, "device_window", window)
    monkeypatch.setattr(CS.DO.decode_attention, "launches", 0, raising=False)
    prefill = lambda: (torch.zeros(4, 3, 5), None)  # noqa: E731
    step = CS.profile_steps(_Engine(32), prefill, 1.0, 1.0)["decode_step"]
    assert step["b3_kernels_per_step"] == kept
    assert step["b3_calls_per_step"] == 32
    assert step["b3_readings"] == kernels[:windows]
    assert CS.DO.decode_attention.launches == 4 * 32 * windows


def test_tp_serving_run_masks_a_nic_kill_at_smoke_width():
    """The full-width TP run's loop, on the CPU at smoke width: over the
    world, healthy and with the NIC killed mid-decode, the tokens equal
    the world=None run's, with no reconstruction mismatch and fallbacks
    under the kill."""
    cfg = CS.llama4_maverick.smoke_config()
    model = CS.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    engine = CS.ServeEngine(model, params,
                            max_len=CS.SERVE_MAX_LEN, device="cpu")
    rng = np.random.RandomState(2)
    requests = [(rng.randint(1, cfg.vocab, size=int(rng.randint(16, 100))
                             ).astype(np.int32), 8) for _ in range(4)]
    ref, local = CS.tp_serving_run(model, engine, requests)
    assert local["tokens"] == 32 and "virtual_ms" not in local
    for kill in (None, CS.TP_FULL_NIC):
        tokens, r = CS.tp_serving_run(model, engine, requests,
                                      CS.TP_FULL_WORLD, kill)
        assert tokens == ref
        assert r["reconstruction_mismatches"] == 0
        assert (r["fallbacks"] >= 1) == (kill is not None)
        assert r["steps"] == {"admit": 4, "decode": 7}


def test_families_cases_cover_the_new_shapes():
    """B1 and B3 hold the families phase's shapes: llama-3.2-vision's self
    and cross prefill (1600 image keys: 12.5 key tiles, the last partial)
    and decode at full width, musicgen-medium's MHA at hd 64 and
    starcoder2-3b's 12 query heads a K/V head at hd 128; the timed shapes
    include the vlm cross prefill and cross decode."""
    bf = torch.bfloat16
    flash = {c[1:] for c in CS.flash_cases()}
    decode = {c[0]: c[1:] for c in CS.decode_cases()}
    lens = [n + CS.N_NEW // 2 for n in CS.PROMPT_LENS]
    vlm = CS.vlm_config()
    n_img = vlm.n_image_tokens
    assert n_img == CS.VLM_IMAGE_TOKENS and n_img % 128 == 64
    H, KV, hd = vlm.n_heads, vlm.n_kv_heads, vlm.hd
    assert (4, H, KV, 512, 512, hd, bf, True, "contiguous") in flash
    assert (4, H, KV, 512, n_img, hd, bf, False, "contiguous") in flash
    assert decode["vlm cross decode"] == (4, H, KV, n_img, hd, bf,
                                          [n_img] * 4)
    assert decode["vlm serving"] == (4, H, KV, CS.SERVE_MAX_LEN, hd, bf,
                                     lens)
    for arch, label, G, d in ((CS.musicgen_medium, "musicgen", 1, 64),
                              (CS.starcoder2_3b, "starcoder2-3b", 12, 128)):
        cfg = arch.config()
        H, KV = cfg.n_heads, cfg.n_kv_heads
        assert (H // KV, cfg.hd) == (G, d)
        assert (4, H, KV, 512, 512, d, bf, True, "contiguous") in flash
        assert decode[f"{label} serving"] == (4, H, KV, CS.SERVE_MAX_LEN, d,
                                              bf, lens)
    smoke = CS.llama32_vision_90b.smoke_config()
    assert (2, smoke.n_heads, smoke.n_kv_heads, 12, smoke.n_image_tokens,
            smoke.hd, bf, False, "contiguous") in flash
    assert ("vlm cross prefill", 4, 64, 8, 512, n_img, 128) \
        in CS.FLASH_CROSS_TIMED
    assert any(t[0] == "vlm cross decode" and t[1:6] == (4, 64, 8, n_img, 128)
               for t in CS.DECODE_TIMED)


def test_vlm_cross_faults_are_rejected():
    """The planted faults of the cross cases' plain versions, on the CPU:
    the smoke cross prefill (one key of 16 dropped) and the full-width
    cross decode (the last of 1600 image rows, or a 64-row chunk,
    dropped) are each rejected by the kernel limits."""
    gen = torch.Generator().manual_seed(0)
    label, B, H, KV, Sq, Sk, hd, dt, causal, layout = next(
        c for c in CS.flash_cases() if c[0] == "vlm smoke cross")
    q, k, v = CS.flash_inputs(gen, B, H, KV, Sq, Sk, hd, dt, layout, "cpu")
    o_ref, _ = CS.FR.flash_attention_ref(q, k, v, causal=causal)
    faults = CS.flash_faults(q, k, v, causal)
    assert set(faults) == {"one key off"}
    assert not CS.agreement("flash_attention", faults["one key off"],
                            o_ref)[0]
    _, B, H, KV, S, hd, dt, lens = DECODE_CASES["vlm cross decode"]
    q, kc, vc = CS.rand_like_cases(gen, [(B, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd)], dt, "cpu")
    ln = torch.tensor(lens, dtype=torch.int32)
    o_ref = CS.DR.decode_attention_ref(q, kc, vc, ln)
    faults = CS.decode_faults(q, kc, vc, ln)
    assert set(faults) == {"length off by one", "64-row chunk dropped"}
    for fault, planted in faults.items():
        caught, _, rel = CS.agreement("decode_attention", planted, o_ref)
        assert not caught, fault


def test_vlm_memory_reckoning_is_ten_layers_in_bf16():
    cfg = CS.vlm_config()
    assert (cfg.n_layers, cfg.param_dtype) == (10, torch.bfloat16)
    assert CS.vlm_layout(cfg) == (2, 4)
    assert round(cfg.param_count() / 1e9, 2) == 10.96
    assert round(CS.param_gb(cfg), 1) == 21.9
    assert CS.param_gb(cfg) + CS.VLM_HEADROOM_GB < 80
    whole = CS.llama32_vision_90b.config(param_dtype=torch.bfloat16)
    assert CS.param_gb(whole) > 80


def test_vlm_attention_check_rejects_a_last_key_fault():
    """At smoke width on the CPU (where the wrappers are the plain
    versions): each layer's attention, self and cross, on the recorded
    inputs of a prefill over images and 4 decode steps reads 0; a planted
    fault dropping the last image key of one cross block is rejected in
    that layer alone, in the decode calls too."""
    cfg = CS.llama32_vision_90b.smoke_config()
    model = CS.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params["cross_blocks"]["gate"].fill_(CS.VLM_GATE)
    engine = CS.ServeEngine(model, params, max_len=40, device="cpu")
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(1, cfg.vocab, size=(2, 30)),
             "image_embeds": rng.randn(2, cfg.n_image_tokens, cfg.d_model)}
    prefill = CS.make_prefill_step(model, max_len=40)
    records = []
    with CS.recording_attention(records):
        _, cache = prefill(engine.params, batch)
        for _ in range(4):
            _, cache = model.decode_step(engine.params, cache,
                                         torch.ones(2, 1, dtype=torch.long))
    L = cfg.n_layers
    assert len(records) == 5 * L
    G, E = CS.vlm_layout(cfg)
    cross = [g * (E + 1) for g in range(G)]
    assert [i for i, r in enumerate(records[:L]) if r[4] is not None] == cross
    assert CS.moe_attention_layers(records, cfg) == [0.0] * L
    faults = (CS.last_key_dropped, CS.one_row_short)
    faulted = CS.moe_attention_layers(records, cfg, cross[-1], faults)
    assert faulted[cross[-1]] > CS.MOE_ATTN_REL_L2
    assert all(r == 0.0 for i, r in enumerate(faulted) if i != cross[-1])
    decode_only = records[L:]
    assert CS.moe_attention_layers(decode_only, cfg, cross[-1],
                                   faults)[cross[-1]] > CS.MOE_ATTN_REL_L2


# ---------------------------------------------------------------------------
# the launch phase's parts that run without a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(CS.LAUNCH_ANCHORS))
def test_launch_anchors_are_the_hook_dryruns(arch):
    r = CS.readiness_report(arch)
    assert (r["n_buckets"], r["n_segments"]) == CS.LAUNCH_ANCHORS[arch]


def test_launch_memory_check_rejects_a_prediction_planted_20_percent_low(
        monkeypatch):
    """The launch phase's memory cell at gpt2-124m's full-width train step
    (remat full), its card reading stood in for by the dry-run's own
    prediction: passed as it is, and refused when the prediction is
    planted 20 % low (past the 10 % that rules above 640 MiB)."""
    cfg = CS.gpt2_124m.config()
    shape = CS.CC.Shape("gpt2 train", CS.TRAIN_S, CS.TRAIN_B, "train")
    params = CS.DRY.meta_params(cfg)
    opt = CS.AdamWConfig()
    real = CS.DRY._trace_pass(cfg, shape, CS.make_debug_mesh(1, 1), opt)
    temp = real["memory"]["temp_size_in_bytes"]
    assert temp > 10 * CS.MEM_ABS
    monkeypatch.setattr(CS, "step_peak",
                        lambda run, args: (temp, CS.DRY.MemoryLog()))
    cell = CS.memory_cell("gpt2 full", cfg, shape, None, {}, params, opt)
    assert cell["predicted_bytes"] == temp and cell["rel_err"] == 0

    def planted(*a, **k):
        out = dict(real)
        out["memory"] = dict(real["memory"], temp_size_in_bytes=int(
            0.8 * temp))
        return out
    monkeypatch.setattr(CS.DRY, "_trace_pass", planted)
    with pytest.raises(SystemExit):
        CS.memory_cell("gpt2 full", cfg, shape, None, {}, params, opt)


def test_launch_memory_limit_is_ten_percent_or_64_mib():
    """The limit is 10 % of the measured peak or a floor of 64 KiB, the
    larger (the floor was 64 MiB; it is now 64 KiB, so 10 % rules at every
    step the phase measures)."""
    assert CS.MEM_ABS == 64 << 10
    for measured in (1 << 10, 1 << 20, 330 << 20, 10 << 30):
        ok, limit = CS.memory_agrees(measured, measured)
        assert ok and limit == max(0.1 * measured, 64 << 10)
        assert not CS.memory_agrees(measured + limit + 1, measured)[0]
    assert not CS.memory_agrees(int(0.8 * (1 << 30)), 1 << 30)[0]


# each launch memory cell's step peak on an H100 above its baseline, bytes
# (chip_smoke.py's launch line on an NVIDIA H100 80GB HBM3 at 700 W)
LAUNCH_MEASURED = {"gpt2-124m train none": 10877994496,
                   "gpt2-124m train full": 6855919104,
                   "gpt2-124m train dots": 8819901952,
                   "yi-6b prefill": 346294784, "yi-6b decode": 741376,
                   "zamba2-1.2b prefill": 460393472,
                   "rwkv6-3b prefill": 268759552}


@pytest.mark.parametrize("cell", list(LAUNCH_MEASURED))
def test_launch_memory_limit_refuses_20_percent_low_at_every_cell(cell):
    measured = LAUNCH_MEASURED[cell]
    assert CS.memory_agrees(measured, measured)[0]
    assert not CS.memory_agrees(int(0.8 * measured), measured)[0]
    assert not CS.memory_agrees(int(1.2 * measured) + 1, measured)[0]


def test_launch_memory_cell_rejects_a_planted_low_prediction_at_decode(
        monkeypatch):
    """The memory cell at yi-6b's full-width decode step (B=4, a 544-row
    cache; 0.7 MiB), its card reading stood in for by the dry-run's own
    prediction: passed as it is, refused when the prediction is planted
    20 % low."""
    cfg = CS.yi_6b.config(param_dtype=torch.bfloat16)
    shape = CS.CC.Shape("decode", CS.SERVE_MAX_LEN, CS.LAUNCH_B, "decode")
    params = CS.DRY.meta_params(cfg)
    real = CS.DRY._trace_pass(cfg, shape, CS.make_debug_mesh(1, 1))
    temp = real["memory"]["temp_size_in_bytes"]
    assert temp == LAUNCH_MEASURED["yi-6b decode"]
    monkeypatch.setattr(CS, "step_peak",
                        lambda run, args: (temp, CS.DRY.MemoryLog()))
    assert CS.memory_cell("yi-6b decode", cfg, shape, None, {},
                          params)["rel_err"] == 0

    def planted(*a, **k):
        return dict(real, memory=dict(real["memory"], temp_size_in_bytes=int(
            0.8 * temp)))
    monkeypatch.setattr(CS.DRY, "_trace_pass", planted)
    with pytest.raises(SystemExit):
        CS.memory_cell("yi-6b decode", cfg, shape, None, {}, params)


@pytest.mark.parametrize("phase", ["moe", "vlm", "kimi"])
def test_memory_check_needs_the_setup_peak_and_the_prefill_step(
        phase, monkeypatch):
    """``memory_check`` needs the larger of the set-up's traced peak (the
    float32 draws of ``model.init``) and the prefill step's bytes, and
    refuses a card with less free: the vlm's set-up (32.6 GB) is ~10 GB
    above its prefill step."""
    cfg, headroom = {"moe": (CS.moe_config(), CS.MOE_HEADROOM_GB),
                     "vlm": (CS.vlm_config(), CS.VLM_HEADROOM_GB),
                     "kimi": (CS.kimi_config(), CS.MOE_HEADROOM_GB)}[phase]
    monkeypatch.setattr(CS.torch.cuda, "mem_get_info",
                        lambda: (int(80e9), int(85e9)))
    free, total, dry = CS.memory_check(cfg, headroom, phase)
    assert dry["need_gb"] == max(dry["setup_gb"], dry["prefill_gb"])
    assert dry["setup_gb"] > CS.param_gb(cfg)
    if phase == "vlm":
        assert dry["setup_gb"] > dry["prefill_gb"] + 10
    below = int((dry["need_gb"] - 0.01) * 1e9)
    monkeypatch.setattr(CS.torch.cuda, "mem_get_info",
                        lambda: (below, int(85e9)))
    with pytest.raises(SystemExit):
        CS.memory_check(cfg, headroom, phase)


def test_launch_remat_launch_expectations_match_the_plain_counts():
    """One train step of gpt2's smoke model on the CPU under each remat:
    the plain forward runs as often as the phase wants B1 to run, the
    plain backward as often as B2a (and B2b) run."""
    cfg = CS.gpt2_124m.smoke_config(dtype=torch.float32)
    params = CS.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (2, 17))
    for remat in CS.REMATS:
        model = CS.build_model(CS.dataclasses.replace(cfg, remat=remat),
                               device="cpu")
        CS.zero_counts()
        CS.value_and_grad(model, params, {"tokens": tokens})
        n = CS.read_counts()
        want = CS.remat_step_launches(remat, cfg.n_layers)
        assert n["flash_attention_ref"] == want["flash_attention"]
        assert n["flash_attention_bwd_ref"] == want["flash_bwd_dq"] \
            == want["flash_bwd_dkv"]
        assert all(n[k] == 0 for k in CS.KERNELS)
    assert CS.remat_step_launches("none", 12)["flash_attention"] == 12
    assert CS.remat_step_launches("dots", 12)["flash_attention"] == 24


def test_launch_prefill_expectations_are_the_configs_layers():
    from repro_torch.models.lm import hybrid_layout
    assert CS.LAUNCH_PREFILL["yi-6b"] == {
        "flash_attention": CS.yi_6b.config().n_layers}
    z = CS.zamba2_1p2b.config()
    assert CS.LAUNCH_PREFILL["zamba2-1.2b"] == {
        "ssd_scan": z.n_layers, "flash_attention": hybrid_layout(z)[0]}
    assert CS.LAUNCH_PREFILL["rwkv6-3b"] == {
        "rwkv6_scan": CS.rwkv6_3b.config().n_layers}


# ---------------------------------------------------------------------------
# the examples phase: its checks on CPU runs of the port's entry points
# ---------------------------------------------------------------------------

# what a kernel's plain version counts on the CPU, by the kernel's name
AS_CARD = {"flash_attention": "flash_attention_ref",
           "flash_bwd_dq": "flash_attention_bwd_ref",
           "flash_bwd_dkv": "flash_attention_bwd_ref",
           "decode_attention": "decode_attention_ref",
           "ssd_scan": "ssd_scan_ref", "rwkv6_scan": "rwkv6_scan_ref"}


def _counted(run):
    """``run()``'s result and the launches the card would count for it:
    on the CPU every wrapper runs its plain version, which counts."""
    CS.zero_counts()
    out = run()
    n = CS.read_counts()
    assert all(n[k] == 0 for k in CS.KERNELS), n
    card = {k: 0 for k in CS.KERNELS + CS.PLAIN}
    card.update({k: n[p] for k, p in AS_CARD.items()})
    return out, card


def _serve_cpu(arch):
    cfg = CS.CC.smoke_config(arch)
    tp = cfg.family in CS.KV_CACHE_FAMILIES
    argv = ["--arch", arch, "--device", "cpu"] + (["--tp"] if tp else [])
    (tokens, stats), n = _counted(lambda: CS.EX_SERVE.main(argv))
    return cfg, tp, tokens, stats, n


def _example_kernel_calls(arch):
    """Every kernel call of ``arch``'s ``serve_decode`` run at its defaults
    on the CPU, by kernel: B1 (B, H, KV, Sq, Sk, hd, dtype, causal), B3
    (B, H, KV, S, hd, dtype) with its lengths, B4 (B, T, H, P, N, dtype,
    layout), B5 (B, T, H, dtype, layout)."""
    seen = {"B1": set(), "B3": {}, "B4": set(), "B5": set()}

    def train(q, k, v, causal=True, scale=None):
        seen["B1"].add((q.shape[0], q.shape[2], k.shape[2], q.shape[1],
                        k.shape[1], q.shape[3], q.dtype, causal))
        return CS.plain_train(q, k, v, causal=causal, scale=scale)

    def decode(q, kc, vc, lens):
        seen["B3"].setdefault((q.shape[0], q.shape[1], kc.shape[2],
                               kc.shape[1], q.shape[2], q.dtype),
                              set()).update(lens.tolist())
        return CS.DR.decode_attention_ref(q, kc, vc, lens)

    def ssd(xh, dt, A, Bm, Cm, return_state=False):
        layout = "model" if xh.is_contiguous() and not Bm.is_contiguous() \
            else "other"
        seen["B4"].add((*xh.shape[:2], *xh.shape[2:], Bm.shape[-1],
                        xh.dtype, layout))
        y, h = CS.SR.ssd_scan_ref(xh, dt, A, Bm, Cm)
        return (y, h) if return_state else y

    def rwkv(r, k, v, w, u):
        layout = "model" if all(t.is_contiguous() for t in (r, k, v, w)) \
            else "other"
        seen["B5"].add((*r.shape[:3], r.dtype, layout))
        return CS.RR.rwkv6_scan_ref(r, k, v, w, u)

    with CS.plain_attention(train, decode), CS.scan_swapped(ssd), \
            CS.swapped("rwkv6_scan", rwkv), \
            CS.redirect_stdout(CS.io.StringIO()):
        CS.EX_SERVE.main(["--arch", arch, "--device", "cpu"])
    return seen


@pytest.mark.parametrize("arch", CS.CC.list_archs())
def test_examples_kernel_calls_are_kernel_cases(arch):
    """Each shape at which an arch's bf16 smoke model runs a kernel in
    ``serve_decode`` is one of the kernel cases held against the plain
    version on the card (with their planted faults and bitwise repeats),
    and the B3 case spans the run's cache lengths. (rwkv6's B5 prefill,
    (4, 16, 2), is held at the model's level: example_logits.)"""
    flash = {c[1:9] for c in CS.flash_cases()}
    decode = {c[1:7]: c[7] for c in CS.decode_cases()}
    ssd = {c[1:] for c in CS.ssd_cases()}
    seen = _example_kernel_calls(arch)
    assert seen["B1"] or seen["B5"]
    assert seen["B1"] <= flash
    for shape, lens in seen["B3"].items():
        assert shape in decode
        assert (min(lens), max(lens)) == (min(decode[shape]),
                                          max(decode[shape]))
    assert seen["B4"] <= ssd
    family = CS.CC.smoke_config(arch).family
    assert bool(seen["B4"]) == (family == "hybrid")
    assert bool(seen["B5"]) == (family == "rwkv6")


@pytest.mark.parametrize("arch", CS.CC.list_archs())
def test_examples_logits_check_rejects_planted_faults(arch):
    """The examples phase's logits check on the CPU, where the kernel path
    is the plain one: each arch's run passes it, each of its planted
    faults (one a kernel of its path) lies past the limit, and a reading
    off the plain path, with a token not its own or with non-finite
    logits fails it."""
    cfg = CS.CC.smoke_config(arch)
    with CS.redirect_stdout(CS.io.StringIO()):
        tokens, _ = CS.EX_SERVE.main(["--arch", arch, "--device", "cpu"])
    reading = CS.example_logits(cfg, tokens, "cpu")
    assert CS.example_logits_faults(reading) == []
    assert set(reading["faults"]) == set(CS.example_faults(cfg))
    assert reading["rel_l2"] == 0 and reading["greedy_tokens_differ"] == 0
    planted = {"off the plain path": dict(
                   reading, rel_l2=2 * CS.LOGITS_REL_L2),
               "a token not its own": dict(reading, greedy_tokens_differ=1),
               "non-finite logits": dict(reading, finite=False),
               "a fault within the limit": dict(reading, faults=dict(
                   reading["faults"], planted=CS.LOGITS_REL_L2))}
    for fault, bad in planted.items():
        assert CS.example_logits_faults(bad), fault


@pytest.mark.parametrize("arch", CS.CC.list_archs())
def test_examples_serve_launch_expectations_are_the_cpu_counts(arch):
    """Each arch's ``serve_decode`` run at its defaults on the CPU passes
    the phase's check with its own TP line: its plain versions ran
    exactly as often as the phase wants each kernel to run."""
    cfg, tp, tokens, stats, n = _serve_cpu(arch)
    assert CS.serve_example_faults(cfg, tokens, stats, stats, n, tp) == []
    assert n["flash_attention"] + n["rwkv6_scan"] > 0


def test_examples_serve_check_rejects_planted_faults():
    cfg, tp, tokens, stats, n = _serve_cpu("llama4-maverick-400b-a17b")
    assert tp and CS.serve_example_faults(cfg, tokens, stats, stats, n,
                                          tp) == []
    plain = dict(n, flash_attention_ref=1)
    short = dict(n, decode_attention=n["decode_attention"] - 1)
    bad = tokens.copy()
    bad[0, -1] = cfg.vocab
    planted = {
        "a plain launch": (tokens, stats, stats, plain, tp),
        "a B3 launch missing": (tokens, stats, stats, short, tp),
        "sync rounds differ from the CPU's": (
            tokens, stats, dict(stats, sync_rounds=stats["sync_rounds"] + 1),
            n, tp),
        "peak live collectives differ from the CPU's": (
            tokens, stats, dict(stats, peak_live_collectives=stats[
                "peak_live_collectives"] - 1), n, tp),
        "a reconstruction mismatch": (
            tokens, dict(stats, reconstruction_mismatches=1), stats, n, tp),
        "a token out of the vocabulary": (bad, stats, stats, n, tp),
        "the TP run left out": (tokens, None, stats, n, tp),
    }
    for fault, args in planted.items():
        assert CS.serve_example_faults(cfg, *args), fault


@pytest.mark.parametrize("baseline", [False, True])
def test_examples_ddp_check_rejects_planted_faults(baseline):
    """``train_ddp_shift`` on the CPU (the reduced model, 4 steps, the NIC
    killed after step 2) passes the phase's check, launches included (the
    baseline's crashed step computed its gradients too), and each planted
    fault fails it."""
    argv = ["--steps", "4", "--fail-at", "2", "--device", "cpu"] \
        + (["--baseline"] if baseline else [])
    run, n = _counted(lambda: CS.EX_TRAIN.main(argv))
    L = 4                               # the reduced model's layers
    check = lambda r, launches=n: CS.ddp_example_faults(  # noqa: E731
        r, launches, baseline, L, steps=4)
    assert check(run) == []
    if baseline:
        assert n["flash_bwd_dq"] == (6 + 1) * 2 * L
    else:
        assert n["flash_bwd_dq"] == 4 * 2 * L and run.fallbacks >= 1
    replace = CS.dataclasses.replace
    planted = {"a plain launch": (run, dict(n, flash_attention_ref=1)),
               "a B1 launch missing": (run, dict(
                   n, flash_attention=n["flash_attention"] - 1)),
               "a NaN loss": (replace(run, timeline=run.timeline[:-1] + [
                   run.timeline[-1][:2] + (float("nan"),)]), n),
               "the last step missing": (replace(
                   run, timeline=run.timeline[:-1], final_step=3), n)}
    if baseline:
        planted["no restart"] = (replace(run, restarts=0), n)
        planted["a fallback"] = (replace(run, fallbacks=1), n)
    else:
        planted["0 fallbacks"] = (replace(run, fallbacks=0), n)
        planted["a restart under SHIFT"] = (replace(run, restarts=1), n)
    for fault, (r, launches) in planted.items():
        assert check(r, launches), fault
