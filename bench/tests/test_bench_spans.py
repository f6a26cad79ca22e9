"""The reduction of the program's spans (``bench/spans.py``): on stand-in
events, rules (a), (b) and (c), once per name, self time, idle time
clipped to the window, the idle gaps named by the innermost program span
and the readings' None; on whole runs of the cells cut small, one span an
admission, a decoding tick and a step; on the card, no span opened after
a launch put down to it, the train step's parts covering the busy time
and the port's kernels linked to their wrappers' spans."""

import copy
import re

import pytest
import torch

from bench import harness, measure, program, spans, trace
from bench.tests.cells import CELLS, small
from bench.tests.test_bench_trace import EVENTS, MS, Ev


class SEv(Ev):
    """A stand-in event with the autograd fields; program spans are user
    annotations, as bench ranges are."""

    def __init__(self, kind, name, start, end, thread=1, corr=0, seq=-1,
                 fwd=0):
        super().__init__(kind, name, start, end, thread, corr)
        self.seq, self.fwd = seq, fwd

    def sequence_nr(self):
        return self.seq

    def fwd_thread_id(self):
        return self.fwd

    def is_user_annotation(self):
        return self.n.startswith(("bench.", spans.PREFIX))


def ms(x):
    return int(x * MS)


def cpu(name, s, e, thread=1, corr=0, seq=-1, fwd=0):
    return SEv("CPU", name, ms(s), ms(e), thread, corr, seq, fwd)


def kernel(name, s, e, corr):
    return SEv("CUDA", name, ms(s), ms(e), corr=corr)


def prog(name, s, e, thread=1):
    return cpu(spans.PREFIX + name, s, e, thread)


EVAL = spans.EVALUATE
# one train step: the forward on thread 1, the backward on the autograd
# engine's thread 2, AdamW past the window's end; each kernel's launch
# is a runtime call with the kernel's correlation id
STEP = [
    cpu("bench.window", 0, 100), cpu("bench.step", 5, 99),
    prog("train.forward", 10, 30),
    cpu("aten::embedding", 11, 12, seq=5),
    cpu("cudaLaunchKernel", 11.5, 11.6, corr=101),
    kernel("embed", 12, 14, 101),
    cpu("aten::detach", 19, 19.5, seq=6),   # saw node 6 as the next
    prog("model.head", 20, 28),
    cpu("aten::mm", 21, 23, seq=6),         # made node 6
    cpu("cudaLaunchKernel", 21.5, 21.6, corr=102),
    kernel("gemm", 22, 26, 102),
    cpu("aten::sum", 29, 29.5, seq=7),
    cpu("cudaLaunchKernel", 29.1, 29.2, corr=103),
    kernel("reduce", 29.5, 30, 103),
    prog("train.backward", 40, 70),
    cpu(EVAL + "SumBackward0", 41, 43, thread=2, seq=7, fwd=1),
    cpu("cudaLaunchKernel", 41.5, 41.6, thread=2, corr=104),
    kernel("fill", 42, 44, 104),
    cpu(EVAL + "MmBackward0", 44, 50, thread=2, seq=6, fwd=1),
    cpu("cudaLaunchKernel", 45, 45.1, thread=2, corr=105),
    kernel("gemm", 46, 55, 105),
    prog("model.head", 47, 49, thread=2),   # the head run again
    cpu("cudaLaunchKernel", 47.5, 47.6, thread=2, corr=108),
    kernel("head_again", 55, 56, 108),
    cpu(EVAL + "EmbeddingBackward0", 56, 60, thread=2, seq=5, fwd=1),
    prog("kernel.B2", 56.5, 59, thread=2),
    cpu("cudaLaunchKernel", 57, 57.1, thread=2, corr=106),
    kernel("dq_kernel", 58, 62, 106),
    kernel("lost_launch", 65, 66, 999),
    cpu("aten::copy_", 65.5, 67),
    prog("train.adamw", 75, 110),
    cpu("cudaLaunchKernel", 76, 76.1, corr=107),
    kernel("adam", 80, 105, 107),
    cpu("aten::mm", 90, 91, corr=105),      # an operation's own number
]


def put(events):
    host, dev = spans.rows(events)
    return {act[2] + f"@{act[0] // MS}": sorted({sp[2][len(spans.PREFIX):]
                                                 for sp in found})
            for act, found in spans.put_down(host, dev)}


def test_each_rule_puts_a_kernel_where_it_belongs():
    assert put(STEP) == {
        # (a): the spans open on the launching thread
        "embed@12": ["train.forward"],
        "gemm@22": ["model.head", "train.forward"],
        "reduce@29": ["train.forward"],
        # (c): the backward's caller; (b) adds nothing for a node made
        # outside any span but the forward pass
        "fill@42": ["train.backward"],
        # (b): the node made in model.head, not the one before it that
        # only saw its number; the forward pass is left out
        "gemm@46": ["model.head", "train.backward"],
        # (a) on the engine's thread and (b): one name
        "head_again@55": ["model.head", "train.backward"],
        "dq_kernel@58": ["kernel.B2", "train.backward"],
        "lost_launch@65": [],
        "adam@80": ["train.adamw"],
    }


def test_the_reduction_of_a_step():
    st = spans.reduce(STEP)
    assert st.window_s == pytest.approx(0.1)
    # busy: 2 + 4 + 0.5 + 2 + [46, 56] 10 + 4 + 1 + [80, 100] 20
    assert st.busy_s == pytest.approx(0.0435)
    sp = {n[len(spans.PREFIX):]: s for n, s in st.spans.items()}
    assert sp["model.head"].count == 2
    assert sp["train.forward"].count == 1
    # an activity counts once for each name
    assert sp["model.head"].device_s == pytest.approx(0.004 + 0.009 + 0.001)
    assert st.device_s("model.head", "train.forward") == pytest.approx(
        0.002 + 0.004 + 0.0005 + 0.009 + 0.001)
    assert sp["train.backward"].device_s == pytest.approx(0.016)
    assert sp["kernel.B2"].device_s == pytest.approx(0.004)
    # the step's parts hold every activity whose launch the trace has
    parts = st.device_s("train.forward", "train.backward", "train.adamw")
    assert parts == pytest.approx(st.busy_s - 0.001)
    # self time less the nested span; host time clipped to the window
    assert sp["train.forward"].host_s == pytest.approx(0.020)
    assert sp["train.forward"].self_s == pytest.approx(0.012)
    assert sp["train.adamw"].host_s == pytest.approx(0.025)
    assert sp["train.adamw"].device_s == pytest.approx(0.020)
    # idle inside the spans, clipped to the window
    assert sp["train.adamw"].idle_s == pytest.approx(0.005)
    assert sp["model.head"].idle_s == pytest.approx(0.004)
    assert sp["train.backward"].idle_s == pytest.approx(0.030 - 0.017)


def test_the_skew_is_the_most_an_activity_precedes_its_launch():
    assert spans.reduce(STEP).skew_s == 0.0
    early = [cpu("cudaLaunchKernel", 80.3, 80.4, corr=107)
             if e.n == "cudaLaunchKernel" and e.corr == 107 else e
             for e in STEP]
    assert spans.reduce(early).skew_s == pytest.approx(0.0003)


def test_the_idle_gaps_name_the_innermost_program_span():
    gaps = spans.reduce(STEP).idle_gaps
    assert gaps[0] == ("bench.step > repro_torch.train.backward > "
                       "aten::copy_", pytest.approx(0.014))
    assert gaps[1] == ("host idle", pytest.approx(0.012))
    assert gaps[2] == ("bench.step > repro_torch.train.forward",
                       pytest.approx(0.012))


def _plain(events):
    return [SEv(e.kind, e.n, e.s, e.e, e.thread, e.corr) for e in events]


def test_a_trace_without_program_spans():
    """The reduction of the trace tests' own events: no span, and the
    window, busy time and idle gaps of ``trace.reduce``."""
    events = _plain(EVENTS)
    st, plain = spans.reduce(events), trace.reduce(events)
    assert st.spans == {}
    assert (st.window_s, st.busy_s) == (plain.window_s, plain.busy_s)
    assert st.idle_gaps == plain.idle_gaps
    assert st.by_names == {frozenset(): pytest.approx(
        sum(plain.kernel_s.values()))}


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_a_reading_without_its_span_is_none(name):
    read = spans.READINGS[name]
    assert read(None) is None
    assert read(spans.reduce(_plain(EVENTS))) is None


def test_the_readings_of_a_step():
    st = spans.reduce(STEP)
    got = {k: f(st) for k, f in spans.READINGS.items()}
    assert got == {"decode_idle_share.serve": None,
                   "admit_idle_share.serve": None,
                   "head_share.train": None,       # no model.loss span
                   "adamw_share.train": pytest.approx(100 * 20 / 43.5)}


@pytest.fixture
def reduced(monkeypatch):
    """Each traced run's span reduction, taken beside ``trace.reduce``."""
    got = []
    plain = trace.reduce

    def both(events):
        got.append(spans.reduce(events))
        return plain(events)

    monkeypatch.setattr(trace, "reduce", both)
    return got


@pytest.mark.parametrize("name", CELLS)
def test_a_small_cell_opens_one_span_an_admission_a_tick_and_a_step(
        name, reduced):
    out = measure.measure(small(name), 5, 0.3, True, "cpu", 0.0)
    rec, st = out["record"], reduced[0]
    count = {n[len(spans.PREFIX):]: sp.count for n, sp in st.spans.items()}
    if rec.steps is not None:
        assert rec.steps > 0 and count["train.adamw"] == rec.steps
        assert count["train.forward"] == count["train.backward"] == rec.steps
    else:
        assert rec.admitted_lens and len(rec.decode_s) > 0
        assert count["sched.admit"] == len(rec.admit_s) \
            == len(rec.admitted_lens)
        assert count["sched.decode"] == len(rec.decode_s)
    assert all(sp.device_s == 0.0 for sp in st.spans.values())


# the cells at small widths the card's kernels take (head dims 64, 128)
CARD_MODEL = {
    "gpt2-124m.train_b64": dict(n_layers=2, d_model=128, n_heads=2,
                                n_kv_heads=2, d_ff=256, vocab=512),
    "yi-6b.doc_qa": dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
                         d_ff=512, vocab=512),
}
CARD_TRAFFIC = {
    "gpt2-124m.train_b64": dict(batch=2, seq_len=256),
    "yi-6b.doc_qa": dict(callers=8, n_slots=8, prefill_len=128,
                         max_len=192, prompt_len=[16, 128],
                         output_len=[4, 32], checked_requests=2),
}


def _card_cell(name):
    cell = copy.deepcopy(harness.resolve(harness.load_manifest(), name))
    cell.config["model"].update(CARD_MODEL[name])
    cell.traffic.update(CARD_TRAFFIC[name])
    return cell


def _three_steps(device, monkeypatch):
    """The raw rows of three traced train steps on the card."""
    import repro_torch.launch as launch
    import repro_torch.models as models
    import repro_torch.optim as optim
    cell = _card_cell("gpt2-124m.train_b64")
    m, t = cell.config["model"], cell.traffic
    cfg = program.model_config(m)
    model = models.build_model(cfg, device=device)
    params = harness.load_reference("dense_lm").make_params(
        m, 1, device, cfg.param_dtype)
    opt = optim.AdamWConfig(**t["optimizer"])
    state = optim.adamw_init(params, opt)
    step = launch.make_train_step(model, opt)
    batch = {"tokens": torch.randint(0, m["vocab"], (t["batch"],
                                                     t["seq_len"] + 1),
                                     device=device)}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize(device)
    got = []
    plain = trace.reduce
    monkeypatch.setattr(trace, "reduce",
                        lambda ev: (got.append(spans.rows(ev)), plain(ev))[1])
    tracer = trace.Tracer(True)
    tracer.start()
    with tracer.window():
        for _ in range(3):
            params, state, _ = step(params, state, batch)
        torch.cuda.synchronize(device)
    tracer.stop()
    return got[0]


def _linked(rows, kernel):
    """The window's device seconds of ``kernel``'s kernels by name, and
    of those put down to its wrapper's span ``kernel.<kernel>``."""
    host, dev = rows
    w0, w1 = spans.window(host)
    rx = re.compile(harness.kernels()[kernel]["device_kernels"])
    mine = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in dev
            if rx.search(n) and min(e, w1) > max(s, w0)]
    by_name = sum(e - s for s, e, _, _ in mine)
    linked = sum(e - s for (s, e, _, _), found in spans.put_down(host, mine)
                 if spans.PREFIX + "kernel." + kernel in {sp[2]
                                                          for sp in found})
    return by_name, linked


@pytest.mark.card
def test_on_the_card_spans_precede_their_launches_cover_and_link(
        card, monkeypatch):
    train = _three_steps(card, monkeypatch)
    got = []
    plain = trace.reduce
    monkeypatch.setattr(trace, "reduce",
                        lambda ev: (got.append(spans.rows(ev)), plain(ev))[1])
    out = measure.measure(_card_cell("yi-6b.doc_qa"), 5, 1.0, True, card,
                          0.0)
    assert out["correct"]
    serve = got[0]
    for host, dev in (train, serve):
        launch = spans.launches(host)
        for act, found in spans.put_down(host, dev):
            assert all(sp[0] <= launch[act[3]][0] for sp in found), found
        # the device's clock against the host's: printed, not held, since
        # it drifts by up to a millisecond within a session
        print("clock skew_s", spans.reduce_rows(host, dev).skew_s)
    st = spans.reduce_rows(*train)
    parts = st.device_s("train.forward", "train.backward", "train.adamw")
    assert parts == pytest.approx(st.busy_s, rel=0.02)
    for rows, kernel in ((train, "B1"), (train, "B2"), (serve, "B1"),
                         (serve, "B3")):
        by_name, linked = _linked(rows, kernel)
        assert by_name > 0
        assert linked == pytest.approx(by_name, rel=0.01), kernel
