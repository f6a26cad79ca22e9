"""The program's own spans in a profiler trace: the ``repro_torch.*``
host ranges that the port opens at its layer boundaries while a profiler
runs (``repro_torch.spans``), reduced to what each span held.

For each span name, over the ``bench.window`` range: the instances that
start in it (``count``), their host seconds clipped to the window
(``host_s``), the same less the part covered by the program spans nested
in them (``self_s``), the device seconds of the kernels put down to the
name (``device_s``) and the device's idle seconds inside the name's
intervals (``idle_s``). The ranges are the profiler's own host events, and
no clock is translated; but the device's timestamps can drift from the
host's within one profiling session (up to 1.2 ms over 1 s on an H100
machine, with kernels then read as starting before their own launch).
``skew_s`` is the most by which an activity of the window starts before
its launch: a lower bound on the drift, and about what an ``idle_s`` may
be off at each edge of a span.

A device activity (kernel, copy, set) is put down to spans by its launch:
the CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``, ...) whose correlation id is the activity's own. The
port's kernels, launched from C through ctypes, are linked so as well
(``trace.reduce``'s ``range_kernels`` follows ``linked_correlation_id``,
the operation open at the launch, which a ctypes launch inside a range
does not have):

(a) every program span open on the launching thread at the launch;
(b) where the launch lies inside an ``autograd::engine::evaluate_function``
    event, the program spans open around the forward operation that made
    the node (the event's ``sequence_nr`` on its ``fwd_thread_id``), less
    any that holds the whole forward of the backward it feeds (a pass,
    such as ``train.forward``, whose backward is (c)'s);
(c) where that launch is on another thread than the forward's (the
    autograd engine's device thread), the program spans open at the
    launch on the forward's thread, which called into autograd.

An activity counts once for each span name it is put down to. An
activity whose launch the trace does not hold is put down to no span.

``python3 bench/spans.py`` takes ``bench/run.py``'s arguments and runs
the cell traced, with this reduction beside the trace's own, and prints
one line a span and the readings of :data:`READINGS` on standard error.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

PREFIX = "repro_torch."
EVALUATE = "autograd::engine::evaluate_function: "


@dataclass
class Span:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0


@dataclass
class SpanTrace:
    window_s: float
    busy_s: float
    spans: Dict[str, Span]                      # by full name
    # device seconds by the set of span names an activity is put down to
    by_names: Dict[FrozenSet[str], float] = field(default_factory=dict)
    # the longest idle gaps, named by what the host was doing
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    # the most by which an activity starts before its own launch
    skew_s: float = 0.0

    def device_s(self, *names: str) -> float:
        """Device seconds of the activities put down to any of ``names``
        (each activity once)."""
        want = {PREFIX + n for n in names}
        return sum(s for key, s in self.by_names.items() if key & want)

    def get(self, name: str) -> Optional[Span]:
        return self.spans.get(PREFIX + name)


class Threads:
    """The program spans of each thread, nested, for the spans open at a
    time: ``chain(thread, t)``, outermost first."""

    def __init__(self, spans):
        self.by_thread: Dict[int, Tuple[List[int], list, List[int]]] = {}
        per = defaultdict(list)
        for sp in spans:
            per[sp[3]].append(sp)
        for thread, rows in per.items():
            rows.sort(key=lambda r: (r[0], -r[1]))
            parent, stack = [], []
            for i, (s, e, _, _) in enumerate(rows):
                while stack and rows[stack[-1]][1] < s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.by_thread[thread] = ([r[0] for r in rows], rows, parent)

    def chain(self, thread: int, t: int) -> list:
        """The spans (start, end, name, thread) open at ``t`` on
        ``thread``, outermost first."""
        got = self.by_thread.get(thread)
        if got is None:
            return []
        starts, rows, parent = got
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and rows[i][1] < t:
            i = parent[i]
        out = []
        while i >= 0:
            out.append(rows[i])
            i = parent[i]
        return out[::-1]

    def children(self):
        """(span, its direct children) for every span of every thread."""
        for _, rows, parent in self.by_thread.values():
            kids = defaultdict(list)
            for i, p in enumerate(parent):
                if p >= 0:
                    kids[p].append(rows[i])
            for i, row in enumerate(rows):
                yield row, kids.get(i, [])


def rows(events):
    """Raw profiler events as (host events, device activities), tuples:
    host (start, end, name, thread, correlation, sequence_nr, fwd_thread),
    device (start, end, name, correlation)."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in events:
        kind, start = e.device_type(), e.start_ns()
        if kind == DeviceType.CPU:
            cpu.append((start, start + e.duration_ns(), e.name(),
                        e.start_thread_id(), e.correlation_id(),
                        e.sequence_nr(), e.fwd_thread_id()))
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((start, start + e.duration_ns(), e.name(),
                        e.correlation_id()))
    return cpu, dev


def window(cpu) -> Tuple[int, int]:
    """The ``bench.window`` range's start and end."""
    from bench.trace import WINDOW
    wins = [(s, e) for s, e, n, *_ in cpu if n == WINDOW]
    if not wins:
        raise RuntimeError("the trace holds no bench.window range")
    return wins[0]


def launches(cpu) -> Dict[int, Tuple[int, int]]:
    """The start and thread of each CUDA API call
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)
    by its correlation id, which is that of the activities it launched (an
    operation may carry the same number in another count)."""
    return {c: (s, t) for s, _, n, t, c, _, _ in cpu if n.startswith("cu")}


def put_down(cpu, dev) -> Iterator[Tuple[tuple, List[tuple]]]:
    """Each device activity with the program spans it is put down to, by
    rules (a), (b) and (c) (the spans as (start, end, name, thread))."""
    threads = Threads([(s, e, n, t) for s, e, n, t, *_ in cpu
                       if n.startswith(PREFIX)])
    launch = launches(cpu)
    evaluate = Threads([(s, e, (q, f), t) for s, e, n, t, _, q, f in cpu
                        if n.startswith(EVALUATE) and q >= 0])
    # the forward operation that made node q on thread t: the last to
    # start with that number (those before it only saw it as the next)
    fwd_op: Dict[Tuple[int, int], int] = {}
    for s, _, n, t, _, q, f in cpu:
        if q >= 0 and f <= 0 and s >= fwd_op.get((t, q), s):
            fwd_op[(t, q)] = s
    passes = _passes(threads, evaluate, fwd_op)
    for act in dev:
        at = launch.get(act[3])
        if at is None:
            yield act, []
            continue
        t_launch, thread = at
        found = dict.fromkeys(threads.chain(thread, t_launch))       # (a)
        ev = evaluate.chain(thread, t_launch)
        if ev:
            seq, fwd_thread = ev[-1][2]
            start = fwd_op.get((fwd_thread, seq))
            if start is not None:                                     # (b)
                found.update(dict.fromkeys(
                    sp for sp in threads.chain(fwd_thread, start)
                    if sp not in passes))
            if fwd_thread != thread:                                  # (c)
                found.update(dict.fromkeys(
                    threads.chain(fwd_thread, t_launch)))
        yield act, list(found)


def _passes(threads, evaluate, fwd_op) -> set:
    """The program spans that hold the whole forward of a backward: for
    the evaluate events of each backward (those that ran inside one
    program span of the forward's thread, or inside none), the spans open
    at both its first and its last node's forward operation."""
    ends: Dict[tuple, List[int]] = {}
    for _, rows, _ in evaluate.by_thread.values():
        for s, _, (seq, fwd_thread), _ in rows:
            caller = threads.chain(fwd_thread, s)
            key = (fwd_thread, caller[-1] if caller else None)
            lo, hi = ends.get(key, (seq, seq))
            ends[key] = [min(lo, seq), max(hi, seq)]
    out = set()
    for (fwd_thread, _), (lo, hi) in ends.items():
        a, b = fwd_op.get((fwd_thread, lo)), fwd_op.get((fwd_thread, hi))
        if a is not None and b is not None:
            out |= set(threads.chain(fwd_thread, a)) \
                & set(threads.chain(fwd_thread, b))
    return out


def _clip(s: int, e: int, w0: int, w1: int) -> Tuple[int, int]:
    return max(s, w0), min(e, w1)


def _overlap(a, b) -> int:
    """The length of the intersection of two sorted, merged interval
    lists."""
    out, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def reduce(events) -> SpanTrace:
    """Reduce raw profiler events (``kineto_results.events()``)."""
    return reduce_rows(*rows(events))


def reduce_rows(cpu, dev) -> SpanTrace:
    """Reduce the events as :func:`rows` gives them."""
    from bench.trace import _merge
    w0, w1 = window(cpu)
    acts = []
    for act in dev:
        s, e = _clip(act[0], act[1], w0, w1)
        if e > s:
            acts.append((s, e) + act[2:])
    busy = _merge([(s, e) for s, e, *_ in acts])
    launch = launches(cpu)
    skew = max([0] + [launch[c][0] - s for s, e, _, c in dev
                      if c in launch and e > w0 and s < w1])
    by_names: Dict[FrozenSet[str], float] = defaultdict(float)
    for (s, e, *_), found in put_down(cpu, acts):
        by_names[frozenset(sp[2] for sp in found)] += (e - s) / 1e9

    threads = Threads([(s, e, n, t) for s, e, n, t, *_ in cpu
                       if n.startswith(PREFIX)])
    spans: Dict[str, Span] = defaultdict(Span)
    held = defaultdict(list)
    for (s, e, name, _), kids in threads.children():
        cs, ce = _clip(s, e, w0, w1)
        if ce <= cs:
            continue
        sp = spans[name]
        sp.count += w0 <= s < w1
        sp.host_s += (ce - cs) / 1e9
        sp.self_s += (ce - cs - sum(max(0, b - a) for a, b in (
            _clip(ks, ke, cs, ce) for ks, ke, _, _ in kids))) / 1e9
        held[name].append((cs, ce))
    for name, sp in spans.items():
        union = _merge(held[name])
        sp.idle_s = (sum(e - s for s, e in union)
                     - _overlap(union, busy)) / 1e9
        sp.device_s = sum(sec for key, sec in by_names.items()
                          if name in key)
    return SpanTrace(window_s=(w1 - w0) / 1e9,
                     busy_s=sum(e - s for s, e in busy) / 1e9,
                     spans=dict(spans), by_names=dict(by_names),
                     idle_gaps=_gaps(cpu, threads, busy, w0, w1),
                     skew_s=skew / 1e9)


def _gaps(cpu, threads, busy, w0: int, w1: int, n: int = 10):
    """The ``n`` longest idle gaps of the window, each named as
    ``trace.host_at`` names it with the innermost program span open then
    (on any thread) after the bench range: ``bench.decode >
    repro_torch.serve.decode.step > aten::mm``."""
    from bench.trace import host_at
    edges = [w0] + [x for se in busy for x in se] + [w1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:n]
    other = sorted((s, e, nm, t, c) for s, e, nm, t, c, *_ in cpu
                   if not nm.startswith(PREFIX))
    starts = [c[0] for c in other]
    out = []
    for s, e in gaps:
        inner = max((ch[-1] for ch in (threads.chain(t, s)
                                       for t in threads.by_thread) if ch),
                    default=None)
        parts = host_at(other, starts, s).split(" > ")
        if parts == ["host idle"]:
            parts = []
        if inner is not None:
            at = 1 if parts and parts[0].startswith("bench.") else 0
            parts.insert(at, inner[2])
        out.append((" > ".join(parts) or "host idle", (e - s) / 1e9))
    return out


def idle_share(st: Optional[SpanTrace], name: str) -> Optional[float]:
    """The device's idle share of the host time inside span ``name``."""
    sp = st.get(name) if st is not None else None
    if sp is None or sp.host_s <= 0:
        return None
    return 100.0 * sp.idle_s / sp.host_s


def busy_share(st: Optional[SpanTrace], *names: str) -> Optional[float]:
    """The device time put down to ``names`` (every one of them present)
    over the window's busy time."""
    if st is None or st.busy_s <= 0 or any(st.get(n) is None for n in names):
        return None
    return 100.0 * st.device_s(*names) / st.busy_s


# what a per-layer metric reads from the reduction, by the metric's name
READINGS = {
    "decode_idle_share.serve": lambda st: idle_share(st, "sched.decode"),
    "admit_idle_share.serve": lambda st: idle_share(st, "sched.admit"),
    "head_share.train": lambda st: busy_share(st, "model.head",
                                              "model.loss"),
    "adamw_share.train": lambda st: busy_share(st, "train.adamw"),
}


def lines(st: SpanTrace) -> List[str]:
    """The clock's skew, then one line a span: its count, host, self,
    device and idle seconds."""
    return [f"clock skew_s {st.skew_s!r}"] + [f"span {name} count {sp.count} host_s {sp.host_s!r} self_s "
            f"{sp.self_s!r} device_s {sp.device_s!r} idle_s {sp.idle_s!r}"
            for name, sp in sorted(st.spans.items())]


def main(argv=None) -> int:
    """``bench/run.py`` with ``--trace 1``, the reduction taken beside the
    trace's own; the spans and the readings follow the result line."""
    from bench import run, trace
    got = []
    plain = trace.reduce

    def both(events):
        got.append(reduce(events))
        return plain(events)

    trace.reduce = both
    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    rc = run.main(argv)
    if rc or not got:
        return rc or 1
    st = got[0]
    for line in lines(st):
        print(line, file=sys.stderr)
    print(json.dumps({
        "readings": {k: f(st) for k, f in READINGS.items()},
        "window_s": st.window_s, "busy_s": st.busy_s, "skew_s": st.skew_s,
        "spans": {n: vars(sp) for n, sp in sorted(st.spans.items())},
        "idle_gaps": st.idle_gaps}), flush=True)
    return 0


if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
