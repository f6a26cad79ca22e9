"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to what the per-layer metrics read.

The window is the span of a ``bench.window`` range that the run opens
and closes inside the profiler. The reduction reads the profiler's raw
events (not its event tree): every device activity (kernels, copies,
sets) clipped to the window, the device's busy time as the union of
their intervals, the time of each kernel by name, and the device time of
the kernels that were launched inside a named ``bench.*`` range of the
host (a kernel's launch links to the host operation that was open when
it was issued, and that operation to the ranges around it on its
thread). That link holds for the kernels PyTorch's operations launch;
the port's own kernels, launched from C through ctypes, are not linked
to the range they were launched in (a chip run read 0.14 s in the
backward's range against 0.26 s of B2a and B2b kernels alone), so they
are read by name. The profiler can lose an event's record, so counts of
calls come from the kernels' own launch counters, never from the trace.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

WINDOW = "bench.window"


@dataclass
class TraceStats:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]                  # device time by name
    # device seconds by bench range, then by kernel name
    range_kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def matching(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernel_s.items() if rx.search(name))

    def in_range(self, range_name: str, but: str = r"(?!)") -> float:
        """Device seconds of the kernels linked to the bench range
        ``range_name``, leaving out those whose name matches ``but``."""
        rx = re.compile(but)
        return sum(s for name, s in self.range_kernels.get(range_name,
                                                           {}).items()
                   if not rx.search(name))


class Tracer:
    """``with tracer.window():`` around the measured window; a no-op when
    not enabled. ``stats`` holds the reduction after ``stop()``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.stats: Optional[TraceStats] = None

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(WINDOW):
            yield

    def stop(self) -> None:
        if not self.enabled:
            return
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        t2 = time.perf_counter()
        self.stats = reduce(events)
        print(f"trace: profiler stopped in {t1 - t0:.1f} s, {len(events)} "
              f"events read in {t2 - t1:.1f} s, reduced in "
              f"{time.perf_counter() - t2:.1f} s", file=sys.stderr)
        self.prof = None


def label(fn, name: str):
    """``fn`` wrapped in a ``bench.<name>`` host range."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(f"bench.{name}"):
            return fn(*args, **kwargs)
    wrapped.__wrapped__ = fn
    return wrapped


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its trailing argument list and its return
    type, cut to ``width``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def reduce(events) -> TraceStats:
    """Reduce raw profiler events (``kineto_results.events()``)."""
    cpu, dev = [], []
    for e in events:
        kind = e.device_type()
        start = e.start_ns()
        if kind == DeviceType.CPU:
            cpu.append((start, start + e.duration_ns(), e.name(),
                        e.start_thread_id(), e.correlation_id()))
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            # kernels, copies and sets; a host range's shadow on the
            # device timeline is no device work
            dev.append((start, start + e.duration_ns(), e.name(),
                        e.linked_correlation_id()))
    wins = [(s, e) for s, e, n, _, _ in cpu if n == WINDOW]
    if not wins:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = wins[0]
    window_s = (w1 - w0) / 1e9

    clipped = []
    kernel_s: Dict[str, float] = {}
    for s, e, name, corr in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e, name, corr))
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e9
    busy = _merge([(s, e) for s, e, _, _ in clipped])
    busy_s = sum(e - s for s, e in busy) / 1e9

    # the host operation each kernel was launched from, and the bench
    # ranges open on that operation's thread when it started
    op_of = {c: (s, t) for s, _, _, t, c in cpu}
    ranges: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
    for s, e, n, t, _ in cpu:
        if n.startswith("bench.") and n != WINDOW:
            ranges.setdefault((n, t), []).append((s, e))
    starts = {key: ([s for s, _ in sorted(v)], sorted(v))
              for key, v in ranges.items()}
    range_kernels: Dict[str, Dict[str, float]] = {}
    for s, e, name, corr in clipped:
        if corr not in op_of:
            continue
        at, thread = op_of[corr]
        for (rname, rthread), (st, spans) in starts.items():
            if rthread != thread:
                continue
            i = bisect.bisect_right(st, at) - 1
            if i >= 0 and spans[i][0] <= at <= spans[i][1]:
                per = range_kernels.setdefault(rname, {})
                per[name] = per.get(name, 0.0) + (e - s) / 1e9

    by_short: Dict[str, float] = {}
    for name, sec in kernel_s.items():
        by_short[short(name)] = by_short.get(short(name), 0.0) + sec
    top_ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:10]

    gaps = []
    edges = [w0] + [x for se in busy for x in se] + [w1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    cpu.sort()
    cpu_starts = [c[0] for c in cpu]
    return TraceStats(window_s=window_s, busy_s=busy_s, kernel_s=kernel_s,
                      range_kernels=range_kernels, top_ops=top_ops,
                      idle_gaps=[(host_at(cpu, cpu_starts, s), (e - s) / 1e9)
                                 for s, e in gaps])


LOOKBACK_NS = 5_000_000_000   # host operations longer than this are not named


def host_at(cpu, starts, t: int) -> str:
    """What the host was doing at ``t``: the innermost bench range and
    the innermost other operation open then, on any thread (``cpu``
    sorted by start, ``starts`` their starts)."""
    inner_range, inner_op = None, None
    lo = bisect.bisect_left(starts, t - LOOKBACK_NS)
    for s, e, n, _, _ in cpu[lo:bisect.bisect_right(starts, t)]:
        if t <= e and n != WINDOW:
            if n.startswith("bench."):
                if inner_range is None or s >= inner_range[0]:
                    inner_range = (s, n)
            elif inner_op is None or s >= inner_op[0]:
                inner_op = (s, n)
    parts = [x[1] for x in (inner_range, inner_op) if x is not None]
    return " > ".join(parts) if parts else "host idle"
