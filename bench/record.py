"""What a run hands to the metric readers (``bench/metrics/*.py``).

A reader takes a :class:`Record` and returns its number, or None where
the run has nothing for it to read (a field left None, no trace)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


class Record:
    """The fields every kind sets: ``model`` (the configuration's
    ``model``), ``traffic`` (the mix's parameters), ``setup_s`` (process
    start to the window's opening), ``window_s`` (the measured window,
    host clock), ``trace`` (``trace.TraceStats`` of a ``--trace 1`` run,
    else None) and ``launches`` (each kernel counter's calls in the
    window). A kind adds its own by keyword; a field that no kind set
    reads None, so a reader of another kind's field finds nothing.

    The kinds here add: training, ``steps`` (completed in the window,
    each of batch x seq tokens); serving, over the window, ``tokens``
    (delivered), ``ttft_s`` (every request's time to its first token),
    ``itl_s`` (every gap between deliveries of one request), ``useful_ops``
    (the model operations of the useful work: flops.prefill_ops of each
    prompt admitted, flops.decode_ops of each token decoded) and
    ``admitted_lens`` (each prompt admitted); serving, traced run only,
    the benchmark's synchronised spans around each admit (``admit_s``) and
    decode_batch (``decode_s``), and each decode call's rows attended
    (``decode_attended``). Times are in seconds."""

    def __init__(self, model: dict, traffic: dict, setup_s: float = 0.0,
                 window_s: float = 0.0, trace: Optional[object] = None,
                 launches: Optional[Dict[str, int]] = None, **fields):
        self.model, self.traffic = model, traffic
        self.setup_s, self.window_s, self.trace = setup_s, window_s, trace
        self.launches = launches or {}
        self.__dict__.update(fields)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return None


@dataclass
class Outcome:
    """A kind's run: the record for the readers, the numbers compared with
    the reference, requests or steps attempted and failed in the window,
    and the device's peak memory, read before the reference ran."""

    record: Record
    readings: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
