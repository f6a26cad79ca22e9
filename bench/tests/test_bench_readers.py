"""The kernels the readers count (``bench/kernels/*.json``) and the
serving readers' arithmetic, worked out by hand."""

import re

import pytest

from bench import flops, harness, program
from bench.record import Record
from bench.trace import TraceStats

KERNELS = harness.kernels()
MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=128, head_dim=None)


def _metric(name):
    return harness.load_file(harness.metric_file(name), "m").read


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_a_kernel_file_names_its_counters_kernels_and_span(kernel):
    spec = KERNELS[kernel]
    assert set(spec) == {"counters", "device_kernels", "span"}
    for path in spec["counters"].values():
        mod, attr = program._owner(path)
        assert isinstance(getattr(mod, attr).launches, int)
    re.compile(spec["device_kernels"])
    if spec["span"]:
        mod, attr = program._owner(spec["span"])
        assert callable(getattr(mod, attr))


def test_every_counter_is_read_by_its_name():
    names = [n for spec in KERNELS.values() for n in spec["counters"]]
    assert sorted(program.launches()) == sorted(names)
    assert len(set(names)) == len(names)


def test_a_span_is_put_on_only_while_traced_and_taken_off():
    mod, attr = program._owner(KERNELS["B2"]["span"])
    fn = getattr(mod, attr)
    with program.spans(False):
        assert getattr(mod, attr) is fn
    with program.spans(True):
        assert getattr(mod, attr).__wrapped__ is fn
    assert getattr(mod, attr) is fn
    with pytest.raises(RuntimeError):
        with program.spans(True):
            raise RuntimeError
    assert getattr(mod, attr) is fn


def _served(lens, device_s, launches=None, prefill_len=512):
    trace = TraceStats(window_s=1.0, busy_s=1.0,
                       kernel_s={"flash_fwd_kernel<64>": device_s})
    L = MODEL["n_layers"]
    return Record(model=MODEL, traffic={"prefill_len": prefill_len},
                  trace=trace, admitted_lens=lens,
                  admit_s=[0.5] * len(lens),
                  launches={"B1": L * len(lens) if launches is None
                            else launches})


def test_the_serving_b1_bound_counts_each_prompts_own_length():
    # hd 16 over 4 heads, 2 KV heads, causal: 4 hd H pairs operations,
    # q k v o in bf16 and the float32 logsumexp
    def by_hand(n):
        ops = 4.0 * 4 * 16 * n * (n + 1) / 2
        nbytes = 2 * n * 16 * (2 * 4 + 2 * 2) + 4 * 4 * n
        return max(ops / flops.PEAK_BF16_OPS, nbytes / flops.PEAK_HBM_BYTES)

    rec = _served([100, 300], 1e-3)
    want = 100.0 * 2 * (by_hand(100) + by_hand(300)) / 1e-3
    assert _metric("B1_roofline.serve")(rec) == pytest.approx(want)
    # the padding to prefill_len is work the bound does not count
    assert _metric("B1_roofline.serve")(_served([100, 300], 1e-3,
                                                prefill_len=4096)) \
        == pytest.approx(want)
    # calls that are not one a layer an admission read nothing
    assert _metric("B1_roofline.serve")(_served([100, 300], 1e-3,
                                                launches=5)) is None


def test_padding_share_by_hand():
    rec = _served([100, 300, 512], 1e-3)
    assert _metric("padding_share.serve")(rec) == pytest.approx(
        100.0 * (3 * 512 - 912) / (3 * 512))


def test_mfu_admit_by_hand():
    rec = _served([100, 300], 1e-3)
    ops = flops.prefill_ops(MODEL, 100) + flops.prefill_ops(MODEL, 300)
    assert _metric("mfu.admit")(rec) == pytest.approx(
        100.0 * ops / (1.0 * flops.PEAK_BF16_OPS))
    rec.admit_s = [0.5]              # spans and admissions disagree
    assert _metric("mfu.admit")(rec) is None


def test_a_field_that_no_kind_set_reads_none():
    rec = Record(model={}, traffic={}, steps=3)
    assert rec.steps == 3 and rec.tokens is None and rec.launches == {}
    assert rec.setup_s == 0.0 and rec.trace is None
