"""Every tail is over all its samples and every rate over the whole
window: a stall planted in one step must move them."""

import statistics
import time

import numpy as np
import pytest

from bench import harness, readers
from bench.kinds import closed_loop
from bench.record import Record
from repro_torch.serving import RequestScheduler


def _metric(name):
    return harness.load_file(harness.metric_file(name), "m").read


def test_p95_is_over_every_sample():
    samples = [0.010] * 100
    assert readers.p95_ms(samples) == pytest.approx(10.0)
    stalled = samples[:94] + [1.0] * 6
    assert readers.p95_ms(stalled) > 500.0
    assert readers.p95_ms(stalled) == pytest.approx(
        statistics.quantiles(stalled, n=20)[18] * 1e3)
    assert readers.median_ms(stalled) == pytest.approx(10.0)


def test_rates_are_all_the_work_over_all_the_window():
    t = {"batch": 4, "seq_len": 8}
    rec = Record(model={}, traffic=t, window_s=2.0, steps=10, tokens=300)
    assert _metric("train_tokens_per_s")(rec) == pytest.approx(160.0)
    assert _metric("serve_tokens_per_s")(rec) == pytest.approx(150.0)


class _Engine:
    """A stand-in for the TP engine: every token is 1, and one chosen
    decode call sleeps."""

    def __init__(self, stall_at=None, stall_s=0.0):
        self.calls, self.stall_at, self.stall_s = 0, stall_at, stall_s

    def start_batch(self, n_slots, prefill_len):
        self.n = n_slots

    def admit(self, slot, prompt):
        return 1

    def decode_batch(self, feed):
        self.calls += 1
        if self.calls == self.stall_at:
            time.sleep(self.stall_s)
        return np.ones(self.n, dtype=np.int32)


def _loop(engine, ticks=60):
    sched = RequestScheduler(engine, n_slots=4, prefill_len=8)
    stream = iter([(np.arange(4, dtype=np.int32), 5)] * 1000)
    loop = closed_loop.Loop(sched, stream, dict(
        n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, d_ff=8, vocab=16,
        head_dim=None))
    for c in range(4):
        loop.submit(c, time.perf_counter())
        loop.tick()
    loop.t_open = t0 = time.perf_counter()
    for _ in range(ticks):
        t1 = loop.tick()
    return loop, t1 - t0


def test_a_stall_in_one_step_moves_the_tails_and_the_rate():
    calm, w0 = _loop(_Engine())
    stalled, w1 = _loop(_Engine(stall_at=30, stall_s=0.3))
    assert stalled.tokens == calm.tokens            # the same work
    assert stalled.tokens / w1 < 0.8 * calm.tokens / w0
    # each of the four requests in flight waited through the stall: as a
    # gap between deliveries, or as its time to first token
    assert sum(g > 0.25 for g in stalled.itl + stalled.ttft) == 4
    assert max(stalled.itl) > 0.3 > max(calm.itl + calm.ttft)
    assert len(stalled.itl) == len(calm.itl)


def test_requests_are_counted_from_their_submission():
    loop, _ = _loop(_Engine(), ticks=30)
    # 4 callers, 5 tokens a request: a completion every fourth step
    # from each caller, all four in step
    assert len(loop.ttft) > 0 and loop.admitted > 0
    assert loop.tokens == 30 * 4 + loop.admitted
