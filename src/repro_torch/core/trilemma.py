"""Executable model of the RDMA Failover Trilemma (§3.1, Appendix C).

The paper verifies these results in Rocq (~3,900 lines). Here the same
definitions — memory model, operations, traces, the sender view σ(T) —
are an executable Python model so the impossibility *counterexamples* can
be machine-checked by the test suite (tests/test_trilemma.py, including
hypothesis sweeps over decision functions; tests/test_torch_trilemma.py
holds this copy's results equal to the JAX package's):

* Lemma 3.1 (Indistinguishability): σ(T_packet_lost) == σ(T_ack_lost),
  yet the correct action differs ⇒ any deterministic decision function of
  the sender view violates either liveness or safety.
* Lemma 3.2 / C.2-C.5 (Non-idempotency): FADD, CAS-under-ABA, two-sided
  Send (receive-WQE consumption) and packed data+flag writes (NCCL LL)
  change state when re-executed.
* Theorem 3.4 (Consensus barrier): the required First-Writer-Wins object
  is a Sticky Register (consensus number 2) which cannot be built
  deterministically from read/write primitives under non-responsive
  omission failures — demonstrated by exhaustive interleaving of the
  2-process race in ``sticky_register_race``.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# C.1 Core definitions
# ---------------------------------------------------------------------------


class Memory:
    """m : Addr -> Val, initially all zero."""

    def __init__(self):
        self._m: Dict[int, int] = {}

    def read(self, a: int) -> int:
        """Load address ``a`` (0 if never written)."""
        return self._m.get(a, 0)

    def write(self, a: int, v: int) -> None:
        """Store ``v`` at address ``a``."""
        self._m[a] = v


@dataclass(frozen=True)
class Write:
    """One-sided RDMA Write (idempotent)."""

    a: int
    v: int


@dataclass(frozen=True)
class Read:
    """One-sided RDMA Read (idempotent, no memory effect)."""

    a: int


@dataclass(frozen=True)
class FADD:
    """Fetch-and-add (non-idempotent: Lemma 3.2)."""

    a: int
    delta: int


@dataclass(frozen=True)
class CAS:
    """Compare-and-swap (non-idempotent under ABA: Lemma C.3)."""

    a: int
    exp: int
    new: int


def exec_op(m: Memory, op) -> Optional[int]:
    """Execute one operation against ``m``; returns the fetched value
    for Read/FADD/CAS, None for Write."""
    if isinstance(op, Write):
        m.write(op.a, op.v)
        return None
    if isinstance(op, Read):
        return m.read(op.a)
    if isinstance(op, FADD):
        old = m.read(op.a)
        m.write(op.a, old + op.delta)
        return old
    if isinstance(op, CAS):
        old = m.read(op.a)
        if old == op.exp:
            m.write(op.a, op.new)
        return old
    raise TypeError(op)


# -- events -----------------------------------------------------------------


class Ev(enum.Enum):
    """Trace-event vocabulary of Appendix C."""

    SEND = "EvSend"
    COMPLETION = "EvCompletion"
    TIMEOUT = "EvTimeout"
    PACKET_LOST = "EvPacketLost"
    ACK_LOST = "EvAckLost"
    RECEIVE = "EvReceive"
    EXECUTE = "EvExecute"
    APP_CONSUME = "EvAppConsume"
    APP_REUSE = "EvAppReuse"


@dataclass(frozen=True)
class Event:
    """One trace event: a kind plus the operation/payload it concerns."""

    kind: Ev
    op: object = None
    payload: Tuple = ()


Trace = Tuple[Event, ...]

SENDER_OBSERVABLE = (Ev.SEND, Ev.COMPLETION, Ev.TIMEOUT)


def sender_view(trace: Trace) -> Trace:
    """σ(T): project to sender-observable events (the central abstraction —
    network losses and receiver execution are invisible to the sender)."""
    return tuple(e for e in trace if e.kind in SENDER_OBSERVABLE)


# ---------------------------------------------------------------------------
# C.2 Lemma 3.1 — the two indistinguishable traces
# ---------------------------------------------------------------------------

A_DATA = 0x100
V1 = 7
V_NEW = 9


def trace_packet_lost(op=Write(A_DATA, V1)) -> Trace:
    """T1: the request was lost; the operation never executed."""
    return (Event(Ev.SEND, op), Event(Ev.PACKET_LOST, op),
            Event(Ev.TIMEOUT, op))


def trace_ack_lost(op=Write(A_DATA, V1)) -> Trace:
    """T2: executed, consumed, the buffer was reused, then the ACK was lost."""
    return (Event(Ev.SEND, op), Event(Ev.RECEIVE, op),
            Event(Ev.EXECUTE, op), Event(Ev.APP_CONSUME, None, (A_DATA, V1)),
            Event(Ev.APP_REUSE, None, (A_DATA, V_NEW)),
            Event(Ev.ACK_LOST, op), Event(Ev.TIMEOUT, op))


def final_memory(trace: Trace, retransmit: bool) -> Memory:
    """Replay a trace (plus the failover decision) onto receiver memory."""
    m = Memory()
    executed = False
    for e in trace:
        if e.kind is Ev.EXECUTE:
            exec_op(m, e.op)
            executed = True
        elif e.kind is Ev.APP_REUSE:
            a, v = e.payload
            m.write(a, v)
    if retransmit:
        # the backup NIC has no receiver state: the retry executes
        op = next(e.op for e in trace if e.kind is Ev.SEND)
        exec_op(m, op)
        executed = True
    return m, executed


def decision_violates(decide: Callable[[Trace], bool]) -> str:
    """Lemma 3.1 ⇒ Theorem 3.3: any deterministic decision function of the
    sender view violates liveness on T1 or safety on T2.

    Returns which property broke ("liveness" | "safety")."""
    t1, t2 = trace_packet_lost(), trace_ack_lost()
    assert sender_view(t1) == sender_view(t2), "views must be identical"
    d1, d2 = decide(sender_view(t1)), decide(sender_view(t2))
    assert d1 == d2, "deterministic function of identical views"
    if not d1:
        # never retransmitted T1: the write never executes
        _, executed = final_memory(t1, retransmit=False)
        assert not executed
        return "liveness"
    # retransmitted T2: the reused buffer (V_NEW) is silently overwritten
    m, _ = final_memory(t2, retransmit=True)
    assert m.read(A_DATA) == V1 != V_NEW
    return "safety"


# ---------------------------------------------------------------------------
# C.3 Lemma 3.2 — non-idempotency
# ---------------------------------------------------------------------------


def fadd_non_idempotent(a: int = 0, delta: int = 5) -> bool:
    """Lemma 3.2 witness: executing FADD twice != executing it once."""
    m1, m2 = Memory(), Memory()
    exec_op(m1, FADD(a, delta))
    exec_op(m2, FADD(a, delta))
    exec_op(m2, FADD(a, delta))  # the retry
    return m1.read(a) != m2.read(a)


def cas_double_success() -> bool:
    """ABA: retrying CAS(0->1) after a concurrent reset (1->0) succeeds
    twice, violating linearizability."""
    m = Memory()
    r1 = exec_op(m, CAS(0, 0, 1))          # original: succeeds (old=0)
    exec_op(m, Write(0, 0))                # concurrent reset 1 -> 0
    r2 = exec_op(m, CAS(0, 0, 1))          # retry: succeeds AGAIN (old=0)
    return r1 == 0 and r2 == 0             # double success


def send_non_idempotent() -> bool:
    """Lemma C.4: a retried two-sided Send consumes a second receive buffer
    and corrupts the message intended for it."""
    rq: List[int] = [0x10, 0x20, 0x30]     # posted receive buffers
    m = Memory()

    def execute_send(v: int) -> None:
        b = rq.pop(0)
        m.write(b, v)

    execute_send(V1)          # original execution
    execute_send(V1)          # retry after lost ACK (no receiver state)
    # one logical send consumed two buffers; 0x20 now holds a stale copy
    return len(rq) == 1 and m.read(0x20) == V1


def ll_write_after_reuse() -> Tuple[bool, int]:
    """Lemma C.5 (NCCL LL): data+flag packed in one write; flag values are
    recycled (circular buffer), so a stale retry looks fresh — silent data
    corruption."""
    m = Memory()
    F1 = 1
    exec_op(m, Write(A_DATA, (V1 << 8) | F1))       # original write
    # app consumes, reuses the slot for a new value with a *recycled* flag
    exec_op(m, Write(A_DATA, (V_NEW << 8) | F1))
    # ACK of the original was lost; failover retries the packed write
    exec_op(m, Write(A_DATA, (V1 << 8) | F1))
    word = m.read(A_DATA)
    corrupted = (word >> 8) == V1 and (word & 0xFF) == F1
    return corrupted, word >> 8


# ---------------------------------------------------------------------------
# C.4 Theorem 3.4 — consensus hierarchy barrier
# ---------------------------------------------------------------------------


def sticky_register_race(impl_steps_ghost: Sequence[Callable],
                         impl_steps_backup: Sequence[Callable],
                         read_result: Callable[[], Optional[int]]) -> List[Optional[int]]:
    """Drive every interleaving of two step-sequences (the Ghost packet vs
    the Backup recovery) against a candidate First-Writer-Wins
    implementation built from read/write primitives, returning the decided
    value per interleaving. A correct Sticky Register must decide the SAME
    winner for every interleaving in which both complete — read/write
    registers cannot do this (consensus number 1 < 2), which the test
    exhibits by finding conflicting decisions."""
    results = []
    n, m = len(impl_steps_ghost), len(impl_steps_backup)
    for mask in itertools.combinations(range(n + m), n):
        # reset shared state between interleavings
        for step in impl_steps_ghost + impl_steps_backup:
            if hasattr(step, "reset"):
                step.reset()
        gi = bi = 0
        for pos in range(n + m):
            if pos in mask:
                impl_steps_ghost[gi]()
                gi += 1
            else:
                impl_steps_backup[bi]()
                bi += 1
        results.append(read_result())
    return results


def rw_register_consensus_attempt() -> List[Optional[int]]:
    """A natural read/write 'first writer wins' attempt: check-then-write.
    Exhaustive interleaving shows disagreement — the Herlihy boundary."""
    state = {"val": None, "ghost_saw": None, "backup_saw": None}

    def reset():
        state.update(val=None, ghost_saw=None, backup_saw=None)

    def g_read():
        state["ghost_saw"] = state["val"]

    def g_write():
        if state["ghost_saw"] is None:
            state["val"] = "ghost"

    def b_read():
        state["backup_saw"] = state["val"]

    def b_write():
        if state["backup_saw"] is None:
            state["val"] = "backup"

    g_read.reset = reset  # reset once per interleaving via first step
    decided = sticky_register_race([g_read, g_write], [b_read, b_write],
                                   lambda: state["val"])
    return decided
