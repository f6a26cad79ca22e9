"""One run of one cell, from its files to the result line.

:func:`measure` runs the cell's kind (``bench/kinds/<kind>.py``) on a
device, reads the metrics and holds the readings to the cell's limits.
The command line (``bench/run.py``) adds the look for a chip, the import
check and the printing; tests call :func:`measure` on the CPU with small
configurations.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import torch

from bench import correct, harness


def device_info(device: torch.device, outcome, trace) -> Dict[str, Any]:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = outcome.memory_peak_bytes
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def breakdown(trace) -> Optional[Dict[str, Any]]:
    if trace is None:
        return None
    return {"device_ops": [[n, s] for n, s in trace.top_ops],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps]}


def diagnose(record) -> None:
    """The trace's device time of each counted kernel and of each bench
    range, beside the launches in the window, on standard error."""
    tr = record.trace
    for name, spec in harness.kernels().items():
        calls = {c: record.launches.get(c) for c in spec["counters"]}
        print(f"trace: {name} {tr.matching(spec['device_kernels'])!r} s "
              f"over launches {calls}", file=sys.stderr)
    for name in sorted(tr.range_kernels):
        print(f"trace: range {name} {tr.in_range(name)!r} s", file=sys.stderr)


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float) -> Dict[str, Any]:
    """Run ``cell`` and return the fields of its result line."""
    device = torch.device(device)
    kind = harness.load_kind(cell.traffic["kind"])
    outcome = kind.run(cell, seed, seconds, trace, device, t_start)
    if outcome.record.trace is not None:
        diagnose(outcome.record)
    names = cell.per_layer if trace else cell.e2e
    metrics = harness.read_metrics(names, cell.units, outcome.record)
    checked = correct.verdict(outcome.readings, cell.limits)
    ok = correct.passed(checked) and outcome.failed == 0 \
        and outcome.attempted > 0
    return dict(correct=ok, attempted=outcome.attempted,
                failed=outcome.failed, metrics=metrics,
                device=device_info(device, outcome, outcome.record.trace),
                checked=checked, breakdown=breakdown(outcome.record.trace),
                record=outcome.record)
