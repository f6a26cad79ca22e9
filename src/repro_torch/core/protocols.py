"""Communication-library protocol models and their failover semantics (§3.2).

Table 1 of the paper classifies the dominant training protocols by the RDMA
operations they use and the delivery semantics they require:

=====================  ==========================  ==============================
Protocol               Data / Notify ops           Failover classification
=====================  ==========================  ==============================
NCCL (Simple)          Write / Write_Imm           SAFE — idempotent bulk data,
                                                   requires notification ordering
NVSHMEM / MSCCL++      Write / Atomic              UNSAFE — atomics are
                                                   non-idempotent (Lemma 3.2)
NCCL LL / LL128        packed Write (data+flag)    UNSAFE — write-after-reuse
                                                   corrupts (Lemma C.5)
=====================  ==========================  ==============================

``classify_wqe_set`` implements SHIFT's retransmission-safe check; the
``LLChannel`` is used by tests to *demonstrate* the silent-data-corruption
the paper proves for LL-style protocols under naive failover.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np

from . import verbs as V


class Protocol(enum.Enum):
    """The training-communication protocols of the paper's Table 1."""

    NCCL_SIMPLE = "nccl_simple"      # Write* + Write_Imm notify
    NVSHMEM_ATOMIC = "nvshmem"       # Write* + Atomic notify
    MSCCLPP_ATOMIC = "msccl++"       # same semantics as NVSHMEM
    NCCL_LL = "nccl_ll"              # packed 4B data + 4B flag writes
    NCCL_LL128 = "nccl_ll128"        # packed 120B data + 8B flag writes


class FailoverClass(enum.Enum):
    """Whether a protocol's in-flight WQEs may be retransmitted (§3.2)."""

    SAFE = "safe"                # retransmission-safe under SHIFT
    UNSAFE_ATOMIC = "unsafe_atomic"
    UNSAFE_PACKED = "unsafe_packed"


PROTOCOL_CLASS = {
    Protocol.NCCL_SIMPLE: FailoverClass.SAFE,
    Protocol.NVSHMEM_ATOMIC: FailoverClass.UNSAFE_ATOMIC,
    Protocol.MSCCLPP_ATOMIC: FailoverClass.UNSAFE_ATOMIC,
    Protocol.NCCL_LL: FailoverClass.UNSAFE_PACKED,
    Protocol.NCCL_LL128: FailoverClass.UNSAFE_PACKED,
}


def classify_wqe_set(wqes: Iterable) -> FailoverClass:
    """SHIFT's retransmission-safe check (§4.3.2): scan outstanding WQEs for
    atomic operations. Atomics in flight => fallback must be refused and the
    error propagated to the application."""
    for wqe in wqes:
        if getattr(wqe, "opcode", None) in V.ATOMIC_OPCODES:
            return FailoverClass.UNSAFE_ATOMIC
    return FailoverClass.SAFE


# ---------------------------------------------------------------------------
# NCCL LL-style packed channel — used to demonstrate Lemma C.5 empirically.
# ---------------------------------------------------------------------------


@dataclass
class LLSlot:
    """4B data + 4B flag packed into one 8-byte write (NCCL LL)."""
    offset: int  # byte offset within the LL region


class LLChannel:
    """A minimal LL-protocol endpoint over raw verbs.

    The receiver polls flags in memory; the *only* signal is the packed
    flag — there is no Write_Imm, so SHIFT has no receive-side progress
    marker. A naive cross-NIC retransmission can overwrite a slot the
    application has already consumed and reused (silent data corruption).
    """

    FLAG_BASE = 0x5A000000

    def __init__(self, mr: V.MR, n_slots: int = 64):
        self.mr = mr
        self.n_slots = n_slots

    @staticmethod
    def pack(data: int, seq: int) -> bytes:
        """Pack 4B data + 4B flag into one 8-byte LL write."""
        return int(data).to_bytes(4, "little") + int(
            LLChannel.FLAG_BASE + seq).to_bytes(4, "little")

    def slot_addr(self, i: int) -> int:
        """Byte address of LL slot ``i`` (circular)."""
        return self.mr.addr + 8 * (i % self.n_slots)

    def read_slot(self, i: int) -> tuple:
        """Read slot ``i`` back as a (data, flag) pair."""
        raw = bytes(self.mr.slice(self.slot_addr(i), 8))
        data = int.from_bytes(raw[:4], "little")
        flag = int.from_bytes(raw[4:], "little")
        return data, flag

    def poll_slot(self, i: int, seq: int) -> Optional[int]:
        """Receiver-side: returns data once the expected flag is visible."""
        data, flag = self.read_slot(i)
        if flag == self.FLAG_BASE + seq:
            return data
        return None

    def reuse_slot(self, i: int, data: int, seq: int) -> None:
        """Application reuses the slot for a new local value (EvAppReuse)."""
        self.mr.slice(self.slot_addr(i), 8)[:] = np.frombuffer(
            self.pack(data, seq), dtype=np.uint8)
