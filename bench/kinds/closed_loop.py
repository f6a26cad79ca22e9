"""Serving cells: a closed loop of callers over the program's
``RequestScheduler`` on a ``TPServeEngine(world=None)``.

Each caller sends its next request the moment its last one completes
(no think time). A scheduler tick (``step()``) admits the queued
requests, each prefilled alone, right-padded to ``prefill_len`` and
spliced into its slot, then decodes one token for every slot. During
set-up the callers join one a tick, so that their phases are staggered;
the window opens once all have joined and closes at the end of the first
tick that ends ``seconds`` or more after it opened, so it holds whole
ticks.

A delivery is a ``step()`` return that gave a request tokens. Over the
window the run keeps every delivery: the tokens, each time to first
token (from the request's submission inside the window to its first
delivery) and each gap between two deliveries of one request.

In a ``--trace 1`` run the scheduler is handed :class:`SpanEngine`,
which delegates to the engine and times each ``admit`` and
``decode_batch`` between two synchronisations.

After the window the engine and its cache are freed, and the plain
reference runs over a sample of the requests completed in the window,
drawn from the seed with the longest among them: the prompt and the
served tokens, each served token's logit held against the reference's
best at the position that chose it (:func:`bench.correct.served_gap`).
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.models as models
import repro_torch.serving as serving
from bench import correct, flops, harness, program, traffic
from bench.record import Outcome, Record
from bench.trace import Tracer


class SpanEngine:
    """Delegates to a ``TPServeEngine`` and, while ``recording``, times
    each ``admit`` and ``decode_batch`` between synchronisations and keeps
    each decode call's rows attended (every slot's cache length + 1, at
    most ``max_len``: a free slot decodes too)."""

    def __init__(self, inner, device, max_len: int):
        self.inner, self.device, self.max_len = inner, device, max_len
        self.recording = False
        self.admit_s, self.decode_s, self.attended = [], [], []

    def start_batch(self, n_slots: int, prefill_len: int) -> None:
        self.lens = np.zeros(n_slots, dtype=np.int64)
        self.inner.start_batch(n_slots, prefill_len)

    def _timed(self, name, fn, *args):
        program.sync(self.device)
        t0 = program.clock()
        with torch.profiler.record_function(f"bench.{name}"):
            out = fn(*args)
        program.sync(self.device)
        return out, program.clock() - t0

    def admit(self, slot: int, prompt) -> int:
        tok, dt = self._timed("admit", self.inner.admit, slot, prompt)
        self.lens[slot] = int(np.asarray(prompt).size)
        if self.recording:
            self.admit_s.append(dt)
        return tok

    def decode_batch(self, feed):
        attended = int(np.minimum(self.lens + 1, self.max_len).sum())
        out, dt = self._timed("decode", self.inner.decode_batch, feed)
        self.lens += 1
        if self.recording:
            self.decode_s.append(dt)
            self.attended.append(attended)
        return out


class Loop:
    """The callers, the scheduler and the window's accounting."""

    def __init__(self, sched, stream, m):
        self.sched, self.stream, self.m = sched, stream, m
        self.live = {}            # caller -> its request in flight
        self.submitted = {}       # rid -> submission time
        self.last = {}            # rid -> time of its last delivery
        self.done_at = {}         # rid -> time of its completion
        self.t_open = None
        self.tokens, self.ops, self.ticks = 0, 0.0, 0
        self.admitted_lens = []   # each prompt admitted in the window
        self.ttft, self.itl = [], []

    @property
    def admitted(self) -> int:
        return len(self.admitted_lens)

    def submit(self, caller: int, now: float) -> None:
        prompt, n = next(self.stream)
        req = self.sched.submit(prompt, n)
        self.live[caller] = req
        self.submitted[req.rid] = now

    def tick(self) -> float:
        """One ``step()``; account its deliveries; resubmit for the callers
        whose request completed. Returns the step's return time."""
        held = {c: len(r.tokens) for c, r in self.live.items()}
        self.sched.step()
        now = program.clock()
        inside = self.t_open is not None
        self.ticks += inside
        for caller, req in list(self.live.items()):
            got = len(req.tokens) - held[caller]
            if got == 0:
                continue
            if inside:
                self.tokens += got
                n = req.prompt.size
                if held[caller] == 0:
                    self.admitted_lens.append(n)
                for j in range(held[caller], len(req.tokens)):
                    self.ops += flops.prefill_ops(self.m, n) if j == 0 \
                        else flops.decode_ops(self.m, n + j)
                sent = self.submitted[req.rid]
                if held[caller] == 0 and sent >= self.t_open:
                    self.ttft.append(now - sent)
                if req.rid in self.last and self.last[req.rid] >= self.t_open:
                    self.itl.append(now - self.last[req.rid])
            self.last[req.rid] = now
            if req.state == serving.scheduler.DONE:
                self.done_at[req.rid] = now
                self.submit(caller, now)
        return now


def checked_sample(reqs, t_open, t_close, done_at, k: int, seed: int):
    """``k`` requests completed in the window, drawn from the seed, the
    one with the most served tokens (then the longest prompt) first."""
    done = [r for r in reqs if t_open < done_at.get(r.rid, -1.0) <= t_close]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), r.prompt.size, -r.rid))
    rest = [r for r in done if r.rid != longest.rid]
    rng = np.random.default_rng([abs(int(seed)), 1])
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(picks)]


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False) -> Outcome:
    """One run; ``control`` also reads the gap of the tokens that the
    e4m3 reference puts first (``served_gap.control``), which the
    benchmark's own runs never do."""
    m, t = cell.config["model"], cell.traffic
    ref = harness.load_reference(cell.config["reference"])
    cfg = program.model_config(m)
    model = models.build_model(cfg, device=device)
    weights = ref.make_params(m, seed, device, cfg.dtype)
    engine = serving.TPServeEngine(model, weights, world=None,
                                   max_len=t["max_len"], device=device)
    if trace:
        engine = SpanEngine(engine, device, t["max_len"])
    sched = serving.RequestScheduler(engine, n_slots=t["n_slots"],
                                     prefill_len=t["prefill_len"])
    loop = Loop(sched, traffic.requests(seed, t, m["vocab"]), m)
    program.note(t_start, "model, weights, engine and cache")
    for caller in range(t["callers"]):
        loop.submit(caller, program.clock())
        loop.tick()
    program.note(t_start, f"{t['callers']} callers joined")

    program.settle()
    tracer = Tracer(trace)
    with program.spans(trace):
        before = program.launches()
        tracer.start()
        with tracer.window():
            loop.t_open = t_open = program.clock()
            if trace:
                engine.recording = True
            while True:
                t_close = loop.tick()
                if t_close - t_open >= seconds:
                    break
            if trace:
                engine.recording = False
        tracer.stop()
        launched = program.launches_since(before)
    peak = program.memory_peak(device)

    attempted = sum(t_open <= s < t_close for s in loop.submitted.values())
    failed = sum(r.state == serving.scheduler.FAILED
                 or (r.state == serving.scheduler.DONE
                     and len(r.tokens) != r.n_tokens)
                 for r in sched.requests)
    record = Record(model=m, traffic=t, setup_s=t_open - t_start,
                    window_s=t_close - t_open, trace=tracer.stats,
                    launches=launched, tokens=loop.tokens, ttft_s=loop.ttft,
                    itl_s=loop.itl, useful_ops=loop.ops,
                    admitted_lens=loop.admitted_lens)
    if trace:
        record.admit_s, record.decode_s = engine.admit_s, engine.decode_s
        record.decode_attended = engine.attended
    program.note(t_start, f"window closed: {loop.tokens} tokens, "
                 f"{loop.admitted} admissions, {loop.ticks} ticks")
    sample = [(r.prompt, np.asarray(r.tokens, dtype=np.int64))
              for r in checked_sample(sched.requests, t_open, t_close,
                                      loop.done_at, t["checked_requests"],
                                      seed)]
    del sched, engine, loop, model
    program.release(device)

    gaps = [request_gap(ref, m, weights, prompt, served, device)
            for prompt, served in sample]
    readings = {"served_gap": max(gaps) if gaps else float("inf")}
    if control:
        readings["served_gap.control"] = max(
            request_gap(ref, m, weights, prompt, served, device, fp8=True)
            for prompt, served in sample)
    program.note(t_start, f"reference over {len(sample)} requests")
    return Outcome(record=record, readings=readings, attempted=attempted,
                   failed=failed, memory_peak_bytes=peak)


def request_gap(ref, m, weights, prompt, served, device, fp8=False) -> float:
    """The widest gap of a request's served tokens below the reference's
    best; with ``fp8`` that of the tokens the e4m3 reference puts first
    at the same positions (the control)."""
    p = torch.as_tensor(np.asarray(prompt, dtype=np.int64), device=device)
    s = torch.as_tensor(served, device=device)
    with ref.exact_float32():
        exact = ref.served_logits(m, weights, p, s)
        chosen = s
        if fp8:
            chosen = ref.served_logits(m, weights, p, s, fp8=True).argmax(-1)
    return correct.served_gap(exact, chosen)
