"""Arithmetic the metric readers (``bench/metrics/*.py``) share. Each
function returns None where the run holds nothing to read."""

from __future__ import annotations

import statistics
from typing import List, Optional

from bench import flops, harness


def p95_ms(samples: Optional[List[float]]) -> Optional[float]:
    """The 95th percentile over every sample (seconds in, ms out)."""
    if not samples or len(samples) < 2:
        return None
    return statistics.quantiles(samples, n=20)[18] * 1e3


def median_ms(samples: Optional[List[float]]) -> Optional[float]:
    if not samples:
        return None
    return statistics.median(samples) * 1e3


def idle_share(rec) -> Optional[float]:
    """Share of the traced window with nothing running on the device."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def share(bound_s: float, device_s: float) -> Optional[float]:
    """A roofline share: the least time over the time taken, in %."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def kernel_pattern(kernel: str) -> str:
    """The names of ``kernel``'s device kernels in the profiler's trace
    (``bench/kernels/<kernel>.json``)."""
    return harness.kernels()[kernel]["device_kernels"]


def kernel_s(rec, kernel: str) -> float:
    return rec.trace.matching(kernel_pattern(kernel))


def shape(m):
    return m["n_heads"], m["n_kv_heads"], flops.head_dim(m)
