"""What the benchmark takes from the program (``repro_torch``): its model
configuration type, its kernel wrappers' launch counters, and the device.

The kernels and their counters are those that ``bench/kernels/*.json``
name. Nothing here changes what the program does, but for the
``bench.<kernel>`` host ranges that :func:`spans` puts around a wrapper
in a traced run. Entry points are looked up on their modules when a run
calls them, so a test can plant a fault underneath a run.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time
from typing import Dict

import torch

from bench import harness
from bench.trace import label
from repro_torch.models.common import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _owner(path: str):
    """The module and attribute name of ``"module:function"``."""
    module, name = path.split(":")
    return importlib.import_module(module), name


def model_config(m: dict) -> ModelConfig:
    """The program's configuration from a configuration file's ``model``."""
    kw = dict(m)
    for key in ("dtype", "param_dtype"):
        kw[key] = DTYPES[kw[key]]
    return ModelConfig(**kw)


def launches() -> Dict[str, int]:
    """Every counter that ``bench/kernels/*.json`` names, by its name."""
    out = {}
    for spec in harness.kernels().values():
        for name, path in spec["counters"].items():
            mod, attr = _owner(path)
            out[name] = getattr(mod, attr).launches
    return out


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = launches()
    return {k: now[k] - before[k] for k in now}


@contextlib.contextmanager
def spans(enabled: bool):
    """While ``enabled``, each kernel's ``span`` function (its file's) runs
    inside a ``bench.<kernel>`` host range; restored on the way out."""
    held = []
    try:
        for kernel, spec in harness.kernels().items():
            if enabled and spec.get("span"):
                mod, attr = _owner(spec["span"])
                held.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, label(getattr(mod, attr), kernel))
        yield
    finally:
        for mod, attr, fn in reversed(held):
            setattr(mod, attr, fn)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock() -> float:
    return time.perf_counter()


def settle() -> None:
    """Before the window: collect the set-up's garbage and move what is
    left out of the collector's way, so that a collection inside the
    window scans only what the window made."""
    gc.collect()
    gc.freeze()


def note(t_start: float, what: str) -> None:
    """A line on standard error: seconds since ``t_start`` and what is
    done by then (the set-up's phases)."""
    print(f"[{clock() - t_start:8.3f} s] {what}", file=sys.stderr, flush=True)


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device: torch.device) -> None:
    """Hand the freed blocks of the program's state back to the device, so
    that the reference that follows has room."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
