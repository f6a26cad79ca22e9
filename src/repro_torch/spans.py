"""Named host ranges at the port's layer boundaries, for ``torch.profiler``.

``with span("serve.decode.step"):`` opens the profiler range
``repro_torch.serve.decode.step`` while a profiler is running, and does
nothing otherwise: with no profiler, a span costs one check and returns
one shared no-op context. There is no flag, no environment variable and
no exporter: the profiler keeps the ranges in memory with its own
events, so they are on the clock of the device activity it records, and
an operator reads them in their own ``torch.profiler`` session (the
names are listed in PERF.md with what each covers).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str, on: bool = True):
    """The profiler range ``repro_torch.<name>`` while a profiler runs and
    ``on`` holds; else the shared no-op context."""
    if on and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
