"""Continuous-batching request scheduler for the TP serving engine (the
port's own copy of the reference's numpy-only scheduler).

One scheduler tick (:meth:`RequestScheduler.step`) does admission first
— every free slot takes the oldest queued request, prefilled alone at
its own length (right-padded to ``prefill_len`` where the model's outputs
can depend on later positions, as MoE's do) and spliced into the slot
cache (prefill/decode interleave) — then one
batched decode step over all active slots. Requests move through a
small state machine::

    queued -> active -> done
                    \\-> failed   (fabric abort: CollectiveError)

The contract the campaign invariants check: under a MASKABLE fault no
request is ever dropped (none end ``failed``), every completed request
has exactly ``n_tokens`` tokens (no duplicates, no truncation), and the
tokens are byte-identical to the single-host reference run. Under an
unmaskable fault the in-flight requests fail LOUDLY
(:meth:`fail_outstanding`) and the error propagates — degraded
throughput or a clean abort, never silent corruption.

Continuous mode is greedy-only: slot membership changes step to step,
and categorical sampling keys on the batch shape, so only argmax
decoding is schedule-invariant (the static ``generate`` path supports
seeded sampling).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..collectives import CollectiveError
from ..spans import span

QUEUED, ACTIVE, DONE, FAILED = "queued", "active", "done", "failed"


@dataclass
class Request:
    """One generation request and its lifecycle state."""
    rid: int
    prompt: np.ndarray
    n_tokens: int
    state: str = QUEUED
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None


class RequestScheduler:
    """Admission + decode-interleave scheduler over a ``TPServeEngine``."""

    def __init__(self, engine, n_slots: int = 2, prefill_len: int = 16):
        engine.start_batch(n_slots, prefill_len)
        self.engine = engine
        self.n_slots = n_slots
        self.prefill_len = prefill_len
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.requests: List[Request] = []
        self.decode_steps = 0
        self._feed = np.zeros(n_slots, dtype=np.int32)

    def submit(self, prompt: np.ndarray, n_tokens: int) -> Request:
        """Enqueue a request; it is admitted when a slot frees up."""
        if n_tokens < 1:
            raise ValueError("n_tokens must be >= 1")
        req = Request(rid=len(self.requests),
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      n_tokens=n_tokens)
        self.requests.append(req)
        self.queue.append(req)
        return req

    @property
    def pending(self) -> bool:
        """True while any request is queued or actively decoding."""
        return bool(self.queue) or any(r is not None for r in self.slots)

    def _maybe_finish(self, req: Request) -> None:
        if len(req.tokens) >= req.n_tokens:
            req.state = DONE
            self.slots[req.slot] = None

    def step(self) -> bool:
        """One tick: admit into free slots, then one batched decode
        step. Returns :attr:`pending` (False once everything drained).
        Raises ``CollectiveError`` if the fabric aborts mid-step —
        callers handle it via :meth:`fail_outstanding`."""
        for slot in range(self.n_slots):
            if self.slots[slot] is None and self.queue:
                with span("sched.admit"):
                    req = self.queue.popleft()
                    req.slot, req.state = slot, ACTIVE
                    self.slots[slot] = req
                    tok = self.engine.admit(slot, req.prompt)
                    req.tokens.append(tok)
                    self._feed[slot] = tok
                    self._maybe_finish(req)
        if any(r is not None for r in self.slots):
            with span("sched.decode"):
                toks = self.engine.decode_batch(self._feed.copy())
                self.decode_steps += 1
                for slot, req in enumerate(list(self.slots)):
                    if req is None:
                        continue
                    tok = int(toks[slot])
                    req.tokens.append(tok)
                    self._feed[slot] = tok
                    self._maybe_finish(req)
        return self.pending

    def fail_outstanding(self) -> int:
        """Mark every queued/active request ``failed`` (the unmaskable-
        fault path: loud per-request failure, never a silent drop).
        Returns how many requests were failed."""
        n = 0
        for req in self.requests:
            if req.state in (QUEUED, ACTIVE):
                req.state = FAILED
                n += 1
        self.slots = [None] * self.n_slots
        self.queue.clear()
        return n

    def run(self, max_steps: int = 10_000) -> None:
        """Drain the queue to completion. On a fabric abort every
        outstanding request is failed and the error re-raised."""
        steps = 0
        try:
            while self.pending:
                self.step()
                steps += 1
                if steps > max_steps:
                    raise RuntimeError("scheduler exceeded max_steps")
        except CollectiveError:
            self.fail_outstanding()
            raise
