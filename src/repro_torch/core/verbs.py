"""Simulated ibverbs: the user-space RDMA API surface SHIFT intercepts.

Faithful-to-the-paper details implemented here (not abstracted away):

* WRs are converted into WQEs stored in per-QP work-queue rings that live in
  host memory — SHIFT recovers these for cross-NIC resubmission (§4.1).
* Doorbells are explicit: a WQE posted without ringing the doorbell is NOT
  executed by the NIC — the mechanism behind SHIFT's WR execution fence
  (§4.3.3).
* RC transport: per-message PSNs, receiver ``epsn`` duplicate-drop (so the
  *same* QP gives exactly-once even under ACK loss — losing this state is
  precisely the cross-NIC hazard of §3.1), ACK timeout + retry_cnt, RNR NAK,
  error WCs (first real status, then WR_FLUSH_ERR for the rest) and the
  QP error state.
* Data and ACK delivery are separate simulator events, so failures produce
  both packet-lost and ACK-lost traces (Lemma 3.1's indistinguishable pair).
* Two-sided ops consume receive WQEs (Lemma C.4 non-idempotency is real
  here); atomics (FETCH_ADD / CMP_SWAP) execute on destination memory.

Wall-clock cost of each verb call is the Python execution itself — that is
what the Fig. 7 benchmark measures (standard vs SHIFT-wrapped verbs).
"""

from __future__ import annotations

import enum
import itertools
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fabric import Cluster, RNIC


# ---------------------------------------------------------------------------
# Enums / constants
# ---------------------------------------------------------------------------


class Opcode(enum.Enum):
    """Send-side RDMA work-request opcodes."""

    WRITE = "RDMA_WRITE"
    WRITE_IMM = "RDMA_WRITE_WITH_IMM"
    SEND = "SEND"
    READ = "RDMA_READ"
    FETCH_ADD = "ATOMIC_FETCH_AND_ADD"
    CMP_SWAP = "ATOMIC_CMP_AND_SWP"


ATOMIC_OPCODES = (Opcode.FETCH_ADD, Opcode.CMP_SWAP)
TWO_SIDED_OPCODES = (Opcode.SEND, Opcode.WRITE_IMM)


class QPState(enum.Enum):
    """RC queue-pair state machine states."""

    RESET = "RESET"
    INIT = "INIT"
    RTR = "RTR"
    RTS = "RTS"
    ERR = "ERR"


class WCStatus(enum.Enum):
    """Work-completion status codes (subset of ibv_wc_status)."""

    SUCCESS = "IBV_WC_SUCCESS"
    RETRY_EXC_ERR = "IBV_WC_RETRY_EXC_ERR"
    RNR_RETRY_EXC_ERR = "IBV_WC_RNR_RETRY_EXC_ERR"
    WR_FLUSH_ERR = "IBV_WC_WR_FLUSH_ERR"
    REM_ACCESS_ERR = "IBV_WC_REM_ACCESS_ERR"
    LOC_PROT_ERR = "IBV_WC_LOC_PROT_ERR"
    FATAL_ERR = "IBV_WC_FATAL_ERR"


class WCOpcode(enum.Enum):
    """Work-completion opcodes (what kind of WR completed)."""

    SEND = "IBV_WC_SEND"
    RDMA_WRITE = "IBV_WC_RDMA_WRITE"
    RDMA_READ = "IBV_WC_RDMA_READ"
    FETCH_ADD = "IBV_WC_FETCH_ADD"
    CMP_SWAP = "IBV_WC_COMP_SWAP"
    RECV = "IBV_WC_RECV"
    RECV_RDMA_WITH_IMM = "IBV_WC_RECV_RDMA_WITH_IMM"


SEND_FLAG_SIGNALED = 0x1
SEND_FLAG_FENCE = 0x2

PER_MESSAGE_OVERHEAD = 0.15e-6  # headers/doorbell processing, seconds

_WC_OP_OF = {Opcode.WRITE: WCOpcode.RDMA_WRITE,
             Opcode.WRITE_IMM: WCOpcode.RDMA_WRITE,
             Opcode.SEND: WCOpcode.SEND,
             Opcode.READ: WCOpcode.RDMA_READ,
             Opcode.FETCH_ADD: WCOpcode.FETCH_ADD,
             Opcode.CMP_SWAP: WCOpcode.CMP_SWAP}

_PAYLOAD_OPCODES = (Opcode.WRITE, Opcode.WRITE_IMM, Opcode.SEND)


class _SegmentTimeout:
    """Shared ACK-timeout bookkeeping for one coalesced segment: a single
    scheduled event covers every WQE in the burst; per-WQE completion
    decrements ``remaining`` and the event is cancelled once the whole
    segment is accounted for (lazy heap deletion reclaims it)."""

    __slots__ = ("ev", "remaining")

    def __init__(self):
        self.ev = None
        self.remaining = 0


class VerbsError(RuntimeError):
    """A verbs call failed (bad state, full queue, invalid key, ...)."""


# ---------------------------------------------------------------------------
# WRs / WQEs / WCs
# ---------------------------------------------------------------------------


@dataclass
class SGE:
    """Scatter/gather element: one registered-memory range."""

    addr: int
    length: int
    lkey: int


@dataclass
class SendWR:
    """A send work request (ibv_send_wr, single-SGE subset)."""

    wr_id: int
    opcode: Opcode
    sge: Optional[SGE] = None
    remote_addr: int = 0
    rkey: int = 0
    imm_data: int = 0
    send_flags: int = SEND_FLAG_SIGNALED
    compare_add: int = 0
    swap: int = 0


@dataclass
class RecvWR:
    """A receive work request (ibv_recv_wr, single-SGE subset)."""

    wr_id: int
    sge: Optional[SGE] = None


@dataclass
class WC:
    """A work completion (ibv_wc)."""

    wr_id: int
    status: WCStatus
    opcode: WCOpcode
    byte_len: int = 0
    imm_data: Optional[int] = None
    qp_num: int = 0
    wc_flags: int = 0

    @property
    def is_error(self) -> bool:
        """True unless the status is SUCCESS."""
        return self.status is not WCStatus.SUCCESS


class SendWQE:
    """Driver-converted send WR, resident in the SQ ring (host memory).

    SHIFT copies these on fallback — they stay valid across NIC failures.
    """

    __slots__ = ("idx", "wr_id", "opcode", "local_addr", "length", "lkey",
                 "remote_addr", "rkey", "imm_data", "signaled", "fence",
                 "compare_add", "swap", "psn", "attempts", "acked",
                 "completed", "status", "probe", "timeout_ev", "batch",
                 "tx_time")

    def __init__(self, idx: int, wr: SendWR):
        self.idx = idx
        self.wr_id = wr.wr_id
        self.opcode = wr.opcode
        sge = wr.sge
        if sge is not None:
            self.local_addr = sge.addr
            self.length = sge.length
            self.lkey = sge.lkey
        else:
            self.local_addr = self.length = self.lkey = 0
        self.remote_addr = wr.remote_addr
        self.rkey = wr.rkey
        self.imm_data = wr.imm_data
        flags = wr.send_flags
        self.signaled = bool(flags & SEND_FLAG_SIGNALED)
        self.fence = bool(flags & SEND_FLAG_FENCE)
        self.compare_add = wr.compare_add
        self.swap = wr.swap
        self.attempts = 0
        # probe: sequence-transparent management probe (SHIFT)
        self.acked = self.completed = self.probe = False
        # batch: _SegmentTimeout of the coalesced segment in flight
        self.psn = self.status = self.timeout_ev = self.batch = None
        # tx_time: virtual time of the FIRST serialization attempt —
        # completion latency (telemetry) spans retransmissions
        self.tx_time = None

    def to_wr(self) -> SendWR:
        """Reconstruct a WR from this WQE (SHIFT's 'copying inherent WQEs')."""
        flags = (SEND_FLAG_SIGNALED if self.signaled else 0) | (
            SEND_FLAG_FENCE if self.fence else 0)
        sge = SGE(self.local_addr, self.length, self.lkey) if (
            self.length or self.lkey) else None
        return SendWR(self.wr_id, self.opcode, sge, self.remote_addr,
                      self.rkey, self.imm_data, flags,
                      self.compare_add, self.swap)


class RecvWQE:
    """Driver-converted receive WR, resident in the RQ ring."""

    __slots__ = ("idx", "wr_id", "addr", "length", "lkey", "consumed",
                 "completed", "status")

    def __init__(self, idx: int, wr: RecvWR):
        self.idx = idx
        self.wr_id = wr.wr_id
        self.addr = wr.sge.addr if wr.sge else 0
        self.length = wr.sge.length if wr.sge else 0
        self.lkey = wr.sge.lkey if wr.sge else 0
        self.consumed = False
        self.completed = False
        self.status: Optional[WCStatus] = None

    def to_wr(self) -> RecvWR:
        """Reconstruct a WR from this WQE (SHIFT recv resubmission)."""
        sge = SGE(self.addr, self.length, self.lkey) if (
            self.length or self.lkey) else None
        return RecvWR(self.wr_id, sge)


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

_mr_keys = itertools.count(0x10)
_qp_nums = itertools.count(0x100)
_cq_nums = itertools.count(0x500)


class MR:
    """Registered memory region backed by a numpy uint8 buffer (zero-copy:
    the transport DMAs directly out of / into this buffer)."""

    def __init__(self, pd: "PD", buf: np.ndarray, addr: Optional[int] = None):
        if buf.dtype != np.uint8 or buf.ndim != 1:
            raise VerbsError("MR buffers must be 1-D uint8 views")
        self.pd = pd
        self.buf = buf
        # read-only alias of the same memory: slicing it yields read-only
        # views without per-call flag flips (the zero-copy handoff path)
        self._buf_ro = buf.view()
        self._buf_ro.flags.writeable = False
        self.length = buf.nbytes
        # Registering the same buffer on a second (backup) NIC reuses the
        # same virtual address — only the keys differ (§4.2: SHIFT patches
        # MR keys on resubmission, not addresses).
        self.addr = addr if addr is not None else pd.ctx.nic.host.alloc_addr(
            self.length)
        self.lkey = next(_mr_keys)
        self.rkey = next(_mr_keys)
        pd.ctx.register_mr(self)

    def slice(self, addr: int, length: int) -> np.ndarray:
        """Writable view of registered memory at absolute ``addr``."""
        off = addr - self.addr
        if off < 0 or off + length > self.length:
            raise VerbsError("MR bounds")
        return self.buf[off:off + length]

    def ro_view(self, addr: int, length: int) -> np.ndarray:
        """Read-only view of registered memory — the zero-copy handoff the
        fast datapath ships instead of a ``bytes()`` snapshot. The single
        copy happens at the RNIC-to-memory boundary on the receiver
        (``dst[:] = view``). Ownership rule: the application must not
        mutate the source range until the WR completes (completion-gated
        slot reuse), exactly as on real hardware where the NIC DMA-reads
        at (re)transmit time."""
        off = addr - self.addr
        if off < 0 or off + length > self.length:
            raise VerbsError("MR bounds")
        return self._buf_ro[off:off + length]


class PD:
    """Protection domain (scopes MRs and QPs to one device context)."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.mrs: List[MR] = []


class CompChannel:
    """Completion event channel. In the simulator, 'blocking on the channel
    in a background thread' is modeled as a registered callback actor."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.callback: Optional[Callable[["CQ"], None]] = None
        self.pending: List["CQ"] = []

    def on_event(self, cb: Callable[["CQ"], None]) -> None:
        """Register the completion-event callback (the 'blocked thread')."""
        self.callback = cb

    def _fire(self, cq: "CQ") -> None:
        self.pending.append(cq)
        if self.callback is not None:
            # wake the "background thread" at current virtual time (+eps)
            self.ctx.sim.call(1e-7, self.callback, cq)


class CQ:
    """Completion queue with optional event-channel arming."""

    def __init__(self, ctx: "Context", depth: int,
                 channel: Optional[CompChannel] = None):
        self.ctx = ctx
        self.cqn = next(_cq_nums)
        self.depth = depth
        self.entries: List[WC] = []
        self.channel = channel
        self.armed = False

    def push(self, wc: WC) -> None:
        """Append a WC; fires the comp channel if armed (one per arm)."""
        if len(self.entries) >= self.depth:
            raise VerbsError(f"CQ overflow (depth={self.depth})")
        self.entries.append(wc)
        if self.armed and self.channel is not None:
            self.armed = False  # one event per arm (ibv_req_notify_cq)
            self.channel._fire(self)

    def poll(self, n: int) -> List[WC]:
        """Drain up to ``n`` completions."""
        entries = self.entries
        if not entries:
            return []
        if n >= len(entries):
            self.entries = []
            return entries
        out = entries[:n]
        del entries[:n]
        return out


@dataclass
class QPCap:
    """Queue-pair ring capacities."""

    max_send_wr: int = 512
    max_recv_wr: int = 256


@dataclass
class QPInitAttr:
    """QP creation attributes (ibv_qp_init_attr subset)."""

    send_cq: CQ = None
    recv_cq: CQ = None
    cap: QPCap = field(default_factory=QPCap)
    qp_type: str = "RC"


@dataclass
class QPAttr:
    """Subset of ibv_qp_attr used by modify_qp."""
    qp_state: QPState = None
    dest_gid: str = None
    dest_qp_num: int = None
    rq_psn: int = 0
    sq_psn: int = 0
    timeout: float = None
    retry_cnt: int = None
    rnr_retry: int = None


class QP:
    """An RC queue pair with explicit rings, doorbells and PSN state."""

    def __init__(self, pd: "PD", init: QPInitAttr):
        self.pd = pd
        self.ctx = pd.ctx
        self.qpn = next(_qp_nums)
        self.send_cq = init.send_cq
        self.recv_cq = init.recv_cq
        self.cap = init.cap
        self.qp_type = init.qp_type
        self.state = QPState.RESET
        self.dest_gid: Optional[str] = None
        self.dest_qpn: Optional[int] = None
        # --- send queue ring (bounded: slot = idx % max_send_wr) ---
        # All cursors are ABSOLUTE WQE indices; ring arithmetic is O(1)
        # and the ring never grows past the queue cap (the full check
        # guarantees a recycled slot's previous occupant completed).
        self.sq: List[SendWQE] = []
        self.sq_tail = 0           # next WQE index to post
        self.sq_doorbell = 0       # WQEs [0, doorbell) visible to the NIC
        self.sq_cursor = 0         # next WQE the NIC engine will serialize
        self.sq_completed = 0      # in-order completion watermark
        # --- recv queue ring ---
        self.rq: List[RecvWQE] = []
        self.rq_tail = 0
        self.rq_doorbell = 0
        self.rq_consumed = 0
        self._kick_pending = False  # a coalescing engine start is scheduled
        # --- transport state ---
        self.next_psn = 0
        self.epsn = 0
        self.timeout = pd.ctx.cluster.ack_timeout
        self.retry_cnt = pd.ctx.cluster.retry_cnt
        self.rnr_retry = pd.ctx.cluster.rnr_retry
        self._serializing = 0  # count of in-progress serializations
        # Epoch guards: a QP reset invalidates every in-flight transport
        # event referencing the old rings (prevents 'ghost' deliveries).
        self.epoch = 0
        self.ctx.register_qp(self)

    # ------------------------------------------------------------------
    # state transitions
    # ------------------------------------------------------------------
    def modify(self, attr: QPAttr) -> None:
        """ibv_modify_qp: drive the RESET/INIT/RTR/RTS/ERR transitions."""
        st = attr.qp_state
        if st is QPState.RESET:
            self._reset()
        elif st is QPState.INIT:
            if self.state is not QPState.RESET:
                raise VerbsError(f"modify to INIT from {self.state}")
            self.state = QPState.INIT
        elif st is QPState.RTR:
            if self.state is not QPState.INIT:
                raise VerbsError(f"modify to RTR from {self.state}")
            if attr.dest_gid is None or attr.dest_qp_num is None:
                raise VerbsError("RTR requires dest_gid/dest_qp_num")
            self.dest_gid = attr.dest_gid
            self.dest_qpn = attr.dest_qp_num
            self.epsn = attr.rq_psn
            self.state = QPState.RTR
        elif st is QPState.RTS:
            if self.state is not QPState.RTR:
                raise VerbsError(f"modify to RTS from {self.state}")
            self.next_psn = attr.sq_psn
            if attr.timeout is not None:
                self.timeout = attr.timeout
            if attr.retry_cnt is not None:
                self.retry_cnt = attr.retry_cnt
            if attr.rnr_retry is not None:
                self.rnr_retry = attr.rnr_retry
            self.state = QPState.RTS
            self.ctx.sim.schedule(0.0, self.ctx._engine_kick, self)
        elif st is QPState.ERR:
            self._enter_error(WCStatus.FATAL_ERR, None)
        else:
            raise VerbsError(f"unsupported transition {st}")

    def query(self) -> QPAttr:
        """ibv_query_qp — SHIFT calls this at RTR/RTS time to be able to
        reset the default QP after fallback (the Fig. 7 overhead)."""
        return QPAttr(qp_state=self.state, dest_gid=self.dest_gid,
                      dest_qp_num=self.dest_qpn, rq_psn=self.epsn,
                      sq_psn=self.next_psn, timeout=self.timeout,
                      retry_cnt=self.retry_cnt, rnr_retry=self.rnr_retry)

    def _sq_at(self, idx: int) -> SendWQE:
        return self.sq[idx % self.cap.max_send_wr]

    def _rq_at(self, idx: int) -> RecvWQE:
        return self.rq[idx % self.cap.max_recv_wr]

    def _reset(self) -> None:
        for wqe in self.sq:
            if wqe.timeout_ev is not None:
                wqe.timeout_ev.cancel()
            if wqe.batch is not None and wqe.batch.ev is not None:
                wqe.batch.ev.cancel()
        self.sq = []
        self.rq = []
        self.sq_tail = self.sq_doorbell = 0
        self.sq_cursor = self.sq_completed = 0
        self.rq_tail = self.rq_doorbell = self.rq_consumed = 0
        self.next_psn = 0
        self.epsn = 0
        self._serializing = 0
        self.epoch += 1
        self.state = QPState.RESET

    # ------------------------------------------------------------------
    # posting (driver level: post and doorbell are separable — SHIFT's
    # execution fence depends on that)
    # ------------------------------------------------------------------
    def post_send_wqe(self, wr: SendWR, ring: bool = True) -> SendWQE:
        """Convert ``wr`` into a ring WQE; ``ring=False`` withholds the
        doorbell (SHIFT's execution fence depends on the separation)."""
        if self.state not in (QPState.RTS,):
            if self.state is QPState.ERR:
                raise VerbsError("post_send on QP in ERR state")
            # posting before RTS is allowed at driver level (SHIFT withholds
            # doorbells on not-yet-active QPs); real NICs require RTS to
            # *execute*, which the engine enforces.
        idx = self.sq_tail
        if idx - self.sq_completed >= self.cap.max_send_wr:
            raise VerbsError("send queue full")
        wqe = SendWQE(idx, wr)
        if len(self.sq) < self.cap.max_send_wr:
            self.sq.append(wqe)
        else:
            self.sq[idx % self.cap.max_send_wr] = wqe
        self.sq_tail = idx + 1
        if ring:
            self.ring_sq_doorbell()
        return wqe

    def post_send_chain(self, wrs: Sequence[SendWR],
                        ring: bool = True) -> List[SendWQE]:
        """Post a linked chain of send WRs with ONE doorbell (the real
        ``ibv_post_send`` posts ``wr.next`` chains exactly like this).
        The whole chain lands behind a single doorbell, so the fast
        datapath serializes it as one coalesced segment."""
        cap = self.cap.max_send_wr
        if self.sq_tail - self.sq_completed + len(wrs) > cap:
            raise VerbsError("send queue full")
        if self.state is QPState.ERR:
            raise VerbsError("post_send on QP in ERR state")
        sq = self.sq
        out = []
        idx = self.sq_tail
        for wr in wrs:
            wqe = SendWQE(idx, wr)
            if len(sq) < cap:
                sq.append(wqe)
            else:
                sq[idx % cap] = wqe
            idx += 1
            out.append(wqe)
        self.sq_tail = idx
        if ring:
            self.ring_sq_doorbell()
        return out

    def ring_sq_doorbell(self, upto: Optional[int] = None) -> None:
        """Make WQEs visible to the NIC and kick the engine."""
        self.sq_doorbell = self.sq_tail if upto is None else upto
        self.ctx._engine_kick(self)

    def post_recv_wqe(self, wr: RecvWR, ring: bool = True) -> RecvWQE:
        """Convert ``wr`` into an RQ ring WQE (doorbell separable)."""
        idx = self.rq_tail
        if idx - self.rq_consumed >= self.cap.max_recv_wr:
            raise VerbsError("recv queue full")
        wqe = RecvWQE(idx, wr)
        if len(self.rq) < self.cap.max_recv_wr:
            self.rq.append(wqe)
        else:
            self.rq[idx % self.cap.max_recv_wr] = wqe
        self.rq_tail = idx + 1
        if ring:
            self.rq_doorbell = self.rq_tail
        return wqe

    # ------------------------------------------------------------------
    # error handling
    # ------------------------------------------------------------------
    def _enter_error(self, status: WCStatus, first_wqe: Optional[SendWQE]) -> None:
        """First error gets the real status; everything else flushes."""
        if self.state is QPState.ERR:
            return
        self.state = QPState.ERR
        if first_wqe is not None and not first_wqe.completed:
            self._complete_send(first_wqe, status, force_wc=True)
        for i in range(self.sq_completed, self.sq_tail):
            wqe = self._sq_at(i)
            if not wqe.completed:
                self._complete_send(wqe, WCStatus.WR_FLUSH_ERR, force_wc=True)
        for i in range(self.rq_consumed, self.rq_tail):
            rwqe = self._rq_at(i)
            if not rwqe.completed:
                rwqe.completed = True
                rwqe.status = WCStatus.WR_FLUSH_ERR
                wc = WC(rwqe.wr_id, WCStatus.WR_FLUSH_ERR,
                        WCOpcode.RECV, qp_num=self.qpn)
                wc._rwqe = rwqe
                self.recv_cq.push(wc)

    def _complete_send(self, wqe: SendWQE, status: WCStatus,
                       force_wc: bool = False) -> None:
        if wqe.completed:
            return
        wqe.completed = True
        wqe.status = status
        if wqe.timeout_ev is not None:
            wqe.timeout_ev.cancel()
            wqe.timeout_ev = None
        bt = wqe.batch
        if bt is not None:
            wqe.batch = None
            bt.remaining -= 1
            if bt.remaining <= 0 and bt.ev is not None:
                bt.ev.cancel()
        while (self.sq_completed < self.sq_tail
               and self._sq_at(self.sq_completed).completed):
            self.sq_completed += 1
        if (wqe.signaled or force_wc) and not wqe.probe:
            wc = WC(wqe.wr_id, status, _WC_OP_OF[wqe.opcode], wqe.length,
                    qp_num=self.qpn)
            wc._wqe = wqe
            self.send_cq.push(wc)
        elif wqe.probe and self.ctx._probe_cb.get(self.qpn):
            self.ctx._probe_cb[self.qpn](wqe, status)


# ---------------------------------------------------------------------------
# Context: one open device (RNIC) + its transport engine
# ---------------------------------------------------------------------------


class Context:
    """ibv_context — an opened RNIC. Also hosts the RC transport engine."""

    def __init__(self, cluster: Cluster, nic: RNIC):
        self.cluster = cluster
        self.sim = cluster.sim
        self.nic = nic
        self.qps: Dict[int, QP] = {}
        self._probe_cb: Dict[int, Callable] = {}
        nic.state_listeners.append(self._on_nic_state)

    # -- registries -----------------------------------------------------
    def register_qp(self, qp: QP) -> None:
        """Index a QP by qpn locally and by (gid, qpn) on the wire."""
        self.qps[qp.qpn] = qp
        _qp_registry[(self.nic.gid, qp.qpn)] = qp

    def register_mr(self, mr: MR) -> None:
        """Index an MR by rkey and lkey for wire-side lookups."""
        _mr_registry[(self.nic.host.name, mr.rkey)] = mr
        _mr_registry_lkey[(self.nic.host.name, mr.lkey)] = mr

    def _local_mr(self, lkey: int) -> MR:
        try:
            return _mr_registry_lkey[(self.nic.host.name, lkey)]
        except KeyError:
            raise VerbsError(f"bad lkey {lkey}")

    # -- NIC state ------------------------------------------------------
    def _on_nic_state(self, up: bool) -> None:
        if up:
            for qp in self.qps.values():
                self.sim.call(0.0, self._engine_kick, qp)
            return
        # NIC died: every QP with pending work errors out after the
        # detection latency (footnote 3: failures manifest as error WCs).
        for qp in self.qps.values():
            if qp.state in (QPState.RTS, QPState.RTR) and (
                    qp.sq_completed < qp.sq_doorbell or qp.rq_consumed < qp.rq_doorbell
                    or qp.sq_cursor < qp.sq_doorbell):
                self.sim.call(self.cluster.nic_error_detect_latency,
                              qp._enter_error, WCStatus.FATAL_ERR, None)

    # ------------------------------------------------------------------
    # RC transport engine
    # ------------------------------------------------------------------
    def _engine_kick(self, qp: QP) -> None:
        """Start serializing doorbell'd work if the NIC is free.

        Fast datapath: the start is deferred by one zero-delay event so
        every doorbell rung at the same virtual instant (a burst of
        ``post_send`` calls) lands in ONE coalesced segment instead of N
        single-WQE transfers — the simulator's doorbell coalescing."""
        if qp.state is not QPState.RTS or qp._serializing > 0:
            return
        if qp.sq_cursor >= qp.sq_doorbell:
            return
        if self.cluster.fast_datapath:
            if not qp._kick_pending:
                qp._kick_pending = True
                self.sim.call(0.0, self._engine_start, qp)
            return
        wqe = qp._sq_at(qp.sq_cursor)
        qp.sq_cursor += 1
        self._transmit(qp, wqe, first_attempt=True)

    def _engine_start(self, qp: QP) -> None:
        """Collect the doorbell'd burst into one segment (fast path)."""
        qp._kick_pending = False
        if qp.state is not QPState.RTS or qp._serializing > 0:
            return
        end = min(qp.sq_doorbell, qp.sq_cursor + self.cluster.max_burst)
        if qp.sq_cursor >= end:
            return
        sq, cap = qp.sq, qp.cap.max_send_wr
        wqes = [sq[i % cap] for i in range(qp.sq_cursor, end)]
        qp.sq_cursor = end
        self._send_segment(qp, wqes)

    # -- coalesced fast path --------------------------------------------
    def _send_segment(self, qp: QP, wqes: List[SendWQE]) -> None:
        """Serialize a run of WQEs as ONE scheduled transfer event.

        Used for first transmission and retransmission alike; payloads are
        zero-copy read-only views into registered memory (DMA-read at
        delivery — valid under the completion-gated slot-reuse rule)."""
        if qp.state is not QPState.RTS:
            return
        wqes = [w for w in wqes if not w.completed]
        if not wqes:
            return
        if not self.nic.up:
            self.sim.call(self.cluster.nic_error_detect_latency,
                          qp._enter_error, WCStatus.RETRY_EXC_ERR, wqes[0])
            return
        bw = self.nic.effective_bandwidth()
        ser = 0.0
        tx = 0
        next_psn = qp.next_psn
        now = self.sim.now
        for wqe in wqes:
            if wqe.psn is None and not wqe.probe:
                wqe.psn = next_psn
                next_psn += 1
            wqe.attempts += 1
            if wqe.tx_time is None:
                wqe.tx_time = now
            if wqe.length:
                ser += PER_MESSAGE_OVERHEAD + wqe.length / bw
                tx += wqe.length
            else:
                ser += PER_MESSAGE_OVERHEAD
        qp.next_psn = next_psn
        self.nic.tx_bytes += tx
        # serialization occupies the NIC (compute share before joining).
        # Payloads are NOT materialized here: the receiver DMA-reads the
        # source MR at delivery (the zero-copy handoff) — valid under the
        # completion-gated slot-reuse ownership rule.
        qp._serializing += 1
        self.nic.active_flows += 1
        self.sim.call(ser, self._segment_serialized, qp, wqes, qp.epoch)

    def _segment_serialized(self, qp: QP, wqes: List[SendWQE],
                            epoch: int) -> None:
        self.nic.active_flows = max(0, self.nic.active_flows - 1)
        if epoch != qp.epoch:
            return  # QP was reset while this segment was on the wire
        qp._serializing = max(0, qp._serializing - 1)
        # pipeline: the next burst can start serializing immediately
        self._engine_start(qp)
        if qp.state is not QPState.RTS:
            return
        live = [w for w in wqes if not w.completed]
        if not live:
            return
        # one ACK timeout for the whole segment (vs. one per WQE)
        bt = _SegmentTimeout()
        for wqe in live:
            old = wqe.batch
            if old is not None:            # re-segmented retransmission
                old.remaining -= 1
                if old.remaining <= 0 and old.ev is not None:
                    old.ev.cancel()
            wqe.batch = bt
            bt.remaining += 1
        bt.ev = self.sim.schedule(qp.timeout, self._segment_timeout, qp,
                                  live, epoch)
        dst = self.cluster.nic_by_gid.get(_gid_of(qp))
        if dst is None or not self.cluster.path_up(self.nic, dst):
            return  # segment lost on the wire
        lat = self.cluster.path_latency(self.nic, dst)
        self.sim.call(lat, self._segment_deliver, qp, live, dst, epoch)

    def _segment_deliver(self, src_qp: QP, items: List[SendWQE],
                         dst_nic: RNIC, epoch: int) -> None:
        # Receiver-side execution proceeds even if the *sender* QP was
        # reset meanwhile (Theorem 3.4's Ghost) — only sender completion
        # is epoch-guarded, exactly like the per-WQE path. Payload views
        # are taken HERE, at the RNIC-to-memory boundary: the simulated
        # DMA engine reads registered source memory at delivery time.
        if not self.cluster.path_up(src_qp.pd.ctx.nic, dst_nic):
            return  # dropped in flight
        dqp = _qp_registry.get((dst_nic.gid, src_qp.dest_qpn))
        if dqp is None or dqp.state not in (QPState.RTR, QPState.RTS):
            return  # receiver QP not ready: silent drop -> sender timeout
        src_host = src_qp.pd.ctx.nic.host.name
        acked: List[Tuple[SendWQE, Optional[object]]] = []
        rnr_wqe: Optional[SendWQE] = None
        nak_wqe: Optional[SendWQE] = None
        i, n = 0, len(items)
        while i < n:
            wqe = items[i]
            if wqe.probe:
                # sequence-transparent management probe: ACK, never
                # touches epsn or memory
                acked.append((wqe, None))
                i += 1
                continue
            if wqe.psn < dqp.epsn:
                acked.append((wqe, None))   # duplicate: drop and re-ACK
                i += 1
                continue
            if wqe.psn > dqp.epsn:
                i += 1
                continue  # gap: drop, the sender retransmits in order
            if wqe.opcode is Opcode.WRITE and wqe.length and i + 1 < n:
                # vectorized transfer: gather the PSN-ordered run of plain
                # WRITEs and execute it in one pass (adjacent writes that
                # are contiguous in source AND destination collapse into
                # a single numpy copy)
                j = i + 1
                expect = wqe.psn + 1
                while j < n:
                    w2 = items[j]
                    if (w2.probe or w2.opcode is not Opcode.WRITE
                            or not w2.length or w2.psn != expect):
                        break
                    expect += 1
                    j += 1
                if j - i >= 2:
                    run = items[i:j]
                    n_ok = self._execute_write_run(dqp, run, dst_nic,
                                                   src_host)
                    dqp.epsn += n_ok
                    for k in range(n_ok):
                        acked.append((run[k], None))
                    if n_ok < len(run):
                        nak_wqe = run[n_ok]
                        break
                    i = j
                    continue
            payload = None
            if wqe.length and wqe.opcode in _PAYLOAD_OPCODES:
                src_mr = _mr_registry_lkey.get((src_host, wqe.lkey))
                if src_mr is None:
                    nak_wqe = wqe   # source MR vanished: local protection
                    break
                payload = src_mr.ro_view(wqe.local_addr, wqe.length)
            result = self._execute_at_receiver(dqp, wqe, payload, dst_nic)
            if type(result) is str:
                if result == "rnr":
                    rnr_wqe = wqe
                else:       # "acc_err"
                    nak_wqe = wqe
                break       # later PSNs become gaps: dropped
            dqp.epsn += 1
            acked.append((wqe, result))
            i += 1
        if acked:
            # coalesced ACK: one response event for the delivered run
            self._send_segment_ack(src_qp, acked, dst_nic, epoch)
        if rnr_wqe is not None:
            self._send_ack(src_qp, rnr_wqe, dst_nic, rnr=True, epoch=epoch)
        elif nak_wqe is not None:
            self._send_nak_access(src_qp, nak_wqe, dst_nic, epoch)

    def _execute_write_run(self, dqp: QP, run: List[SendWQE],
                           dst_nic: RNIC, src_host: str) -> int:
        """Execute a PSN-ordered run of plain RDMA WRITEs against
        destination memory. Returns how many executed (stops at the first
        access error — the caller NAKs that WQE). Adjacent writes that
        are contiguous in BOTH source and destination are copied with one
        numpy operation instead of one per message."""
        host = dst_nic.host.name
        done = 0
        i, n = 0, len(run)
        while i < n:
            wqe = run[i]
            total = wqe.length
            j = i + 1
            while j < n:
                w2 = run[j]
                if not (w2.lkey == wqe.lkey
                        and w2.local_addr == wqe.local_addr + total
                        and w2.rkey == wqe.rkey
                        and w2.remote_addr == wqe.remote_addr + total):
                    break
                total += w2.length
                j += 1
            mr = _find_mr(host, wqe.rkey, wqe.remote_addr, total)
            src_mr = _mr_registry_lkey.get((src_host, wqe.lkey))
            if mr is not None and src_mr is not None:
                mr.slice(wqe.remote_addr, total)[:] = src_mr.ro_view(
                    wqe.local_addr, total)
                dst_nic.delivered_bytes += total
                done += j - i
            else:
                # merged lookup failed (or no source MR): fall back to
                # per-WQE execution so the NAK lands on the exact WQE
                for k in range(i, j):
                    wk = run[k]
                    mrk = _find_mr(host, wk.rkey, wk.remote_addr, wk.length)
                    srck = _mr_registry_lkey.get((src_host, wk.lkey))
                    if mrk is None or srck is None:
                        return done
                    mrk.slice(wk.remote_addr, wk.length)[:] = srck.ro_view(
                        wk.local_addr, wk.length)
                    dst_nic.delivered_bytes += wk.length
                    done += 1
            i = j
        return done

    def _send_segment_ack(self, src_qp: QP,
                          acked: List[Tuple[SendWQE, Optional[object]]],
                          dst_nic: RNIC, epoch: int) -> None:
        src_nic = src_qp.pd.ctx.nic
        lat = self.cluster.path_latency(dst_nic, src_nic)
        resp_bytes = sum(len(data) for wqe, data in acked
                         if data is not None and wqe.opcode is Opcode.READ)
        if resp_bytes:
            # READ responses carry data: serialize at the responder NIC
            lat += resp_bytes / max(dst_nic.effective_bandwidth(), 1.0)
        self.sim.call(lat, self._segment_ack_arrive, src_qp, acked, dst_nic,
                      epoch)

    def _segment_ack_arrive(self, qp: QP,
                            acked: List[Tuple[SendWQE, Optional[object]]],
                            dst_nic: RNIC, epoch: int) -> None:
        src_nic = qp.pd.ctx.nic
        if not self.cluster.path_up(dst_nic, src_nic):
            return  # ACK lost — Lemma 3.1 trace T2
        if epoch != qp.epoch or qp.state is not QPState.RTS:
            return
        # Batch completion: inlined success path of QP._complete_send for
        # the whole acked run; the in-order watermark advances once at the
        # end instead of once per WQE. Semantics are identical.
        ok = WCStatus.SUCCESS
        any_done = False
        for wqe, data in acked:
            if wqe.completed:
                continue
            wqe.acked = True
            if data is not None and wqe.opcode in (Opcode.READ,
                                                   *ATOMIC_OPCODES):
                n = wqe.length if wqe.opcode is Opcode.READ else 8
                mr = self._local_mr(wqe.lkey)
                if isinstance(data, (bytes, bytearray)):
                    mr.slice(wqe.local_addr, n)[:] = np.frombuffer(
                        bytes(data[:n]), dtype=np.uint8)
                else:
                    mr.slice(wqe.local_addr, n)[:] = data[:n]
            wqe.completed = True
            wqe.status = ok
            any_done = True
            if wqe.length and not wqe.probe and wqe.tx_time is not None:
                # per-rail completion telemetry (payload WQEs only)
                self.cluster.telemetry.note_completion(
                    src_nic.index, wqe.length, self.sim.now - wqe.tx_time)
            if wqe.timeout_ev is not None:
                wqe.timeout_ev.cancel()
                wqe.timeout_ev = None
            bt = wqe.batch
            if bt is not None:
                wqe.batch = None
                bt.remaining -= 1
                if bt.remaining <= 0 and bt.ev is not None:
                    bt.ev.cancel()
            if wqe.probe:
                cb = self._probe_cb.get(qp.qpn)
                if cb is not None:
                    cb(wqe, ok)
            elif wqe.signaled:
                wc = WC(wqe.wr_id, ok, _WC_OP_OF[wqe.opcode], wqe.length,
                        qp_num=qp.qpn)
                wc._wqe = wqe
                qp.send_cq.push(wc)
        if any_done:
            sq, cap = qp.sq, qp.cap.max_send_wr
            done = qp.sq_completed
            tail = qp.sq_tail
            while done < tail and sq[done % cap].completed:
                done += 1
            qp.sq_completed = done

    def _segment_timeout(self, qp: QP, wqes: List[SendWQE],
                         epoch: int) -> None:
        if epoch != qp.epoch or qp.state is not QPState.RTS:
            return
        pend = [w for w in wqes if not w.completed and not w.acked]
        if not pend:
            return
        if pend[0].attempts > qp.retry_cnt:
            qp._enter_error(WCStatus.RETRY_EXC_ERR, pend[0])
            return
        self._send_segment(qp, pend)

    # -- legacy per-WQE path (cluster.fast_datapath=False) --------------
    def _transmit(self, qp: QP, wqe: SendWQE, first_attempt: bool) -> None:
        if qp.state is not QPState.RTS or wqe.completed:
            return
        if not self.nic.up:
            self.sim.call(self.cluster.nic_error_detect_latency,
                          qp._enter_error, WCStatus.RETRY_EXC_ERR, wqe)
            return
        if first_attempt and wqe.psn is None and not wqe.probe:
            wqe.psn = qp.next_psn
            qp.next_psn += 1
        wqe.attempts += 1
        if wqe.tx_time is None:
            wqe.tx_time = self.sim.now
        # DMA-read the payload out of registered memory at transmit time
        payload = None
        if wqe.opcode in _PAYLOAD_OPCODES and wqe.length:
            mr = self._local_mr(wqe.lkey)
            payload = bytes(mr.slice(wqe.local_addr, wqe.length))
        # serialization occupies the NIC (compute share before joining)
        bw = self.nic.effective_bandwidth()
        qp._serializing += 1
        self.nic.active_flows += 1
        self.nic.tx_bytes += wqe.length
        ser = PER_MESSAGE_OVERHEAD + (wqe.length / bw if wqe.length else 0.0)
        self.sim.call(ser, self._serialized, qp, wqe, payload, qp.epoch)

    def _serialized(self, qp: QP, wqe: SendWQE, payload: Optional[bytes],
                    epoch: int) -> None:
        self.nic.active_flows = max(0, self.nic.active_flows - 1)
        if epoch != qp.epoch:
            return  # QP was reset while this WQE was on the wire
        qp._serializing = max(0, qp._serializing - 1)
        # pipeline: next WQE can start serializing immediately
        self._engine_kick(qp)
        if qp.state is not QPState.RTS:
            return
        dst = self.cluster.nic_by_gid.get(_gid_of(qp))
        # arm the ACK timeout
        if wqe.timeout_ev is not None:
            wqe.timeout_ev.cancel()
        wqe.timeout_ev = self.sim.schedule(qp.timeout, self._ack_timeout,
                                           qp, wqe, epoch)
        if dst is None or not self.cluster.path_up(self.nic, dst):
            return  # packet lost on the wire
        lat = self.cluster.path_latency(self.nic, dst)
        self.sim.call(lat, self._deliver, qp, wqe, payload, dst, epoch)

    # -- receiver side ----------------------------------------------------
    def _deliver(self, src_qp: QP, wqe: SendWQE, payload: Optional[bytes],
                 dst_nic: RNIC, epoch: int) -> None:
        # NB: receiver-side execution proceeds even if the *sender* QP was
        # reset meanwhile — the packet is physically on the wire (this is
        # exactly the 'Ghost' of Theorem 3.4). Only sender completion is
        # epoch-guarded.
        if not self.cluster.path_up(src_qp.pd.ctx.nic, dst_nic):
            return  # dropped in flight
        dqp = _qp_registry.get((dst_nic.gid, src_qp.dest_qpn))
        if dqp is None or dqp.state not in (QPState.RTR, QPState.RTS):
            return  # receiver QP not ready: silent drop -> sender timeout
        if wqe.probe:
            # Sequence-transparent management probe (see shift.py): ACK if
            # the receiver QP is alive, never touches epsn or memory.
            self._send_ack(src_qp, wqe, dst_nic, rnr=False, epoch=epoch)
            return
        if wqe.psn < dqp.epsn:
            # duplicate (ACK was lost): hardware drops and re-ACKs —
            # same-QP exactly-once. This state is what dies with the NIC.
            self._send_ack(src_qp, wqe, dst_nic, rnr=False, epoch=epoch)
            return
        if wqe.psn > dqp.epsn:
            return  # gap: drop, let the sender retransmit in order
        # psn == epsn: execute
        result = self._execute_at_receiver(dqp, wqe, payload, dst_nic)
        if result == "rnr":
            self._send_ack(src_qp, wqe, dst_nic, rnr=True, epoch=epoch)
            return
        if result == "acc_err":
            self._send_nak_access(src_qp, wqe, dst_nic, epoch)
            return
        dqp.epsn += 1
        self._send_ack(src_qp, wqe, dst_nic, rnr=False, read_data=result,
                       epoch=epoch)

    def _execute_at_receiver(self, dqp: QP, wqe: SendWQE,
                             payload, dst_nic: RNIC):
        """Execute one WQE against destination memory.

        ``payload`` is a read-only numpy view on the fast path (the single
        copy to destination memory happens here — the RNIC-to-memory
        boundary) or a ``bytes`` snapshot on the legacy path."""
        host = dst_nic.host.name
        if type(payload) is bytes:
            payload = np.frombuffer(payload, dtype=np.uint8)
        if wqe.opcode in (Opcode.WRITE, Opcode.WRITE_IMM):
            if wqe.length:
                mr = _find_mr(host, wqe.rkey, wqe.remote_addr, wqe.length)
                if mr is None:
                    return "acc_err"
                mr.slice(wqe.remote_addr, wqe.length)[:] = payload
                dst_nic.delivered_bytes += wqe.length
            if wqe.opcode is Opcode.WRITE_IMM:
                rwqe = _consume_recv(dqp)
                if rwqe is None:
                    return "rnr"
                wc = WC(rwqe.wr_id, WCStatus.SUCCESS,
                        WCOpcode.RECV_RDMA_WITH_IMM,
                        byte_len=wqe.length, imm_data=wqe.imm_data,
                        qp_num=dqp.qpn)
                wc._rwqe = rwqe
                dqp.recv_cq.push(wc)
            return None
        if wqe.opcode is Opcode.SEND:
            rwqe = _consume_recv(dqp)
            if rwqe is None:
                return "rnr"
            if wqe.length:
                if wqe.length > rwqe.length:
                    return "acc_err"
                mr = _mr_registry_lkey.get((host, rwqe.lkey))
                if mr is None:
                    return "acc_err"
                mr.slice(rwqe.addr, wqe.length)[:] = payload
                dst_nic.delivered_bytes += wqe.length
            wc = WC(rwqe.wr_id, WCStatus.SUCCESS, WCOpcode.RECV,
                    byte_len=wqe.length, imm_data=None, qp_num=dqp.qpn)
            wc._rwqe = rwqe
            dqp.recv_cq.push(wc)
            return None
        if wqe.opcode is Opcode.READ:
            mr = _find_mr(host, wqe.rkey, wqe.remote_addr, wqe.length)
            if mr is None:
                return "acc_err"
            if self.cluster.fast_datapath:
                # READ responses must snapshot at execution time: the
                # responder NIC serializes the data as it executes, so a
                # write landing during the response's flight must not be
                # visible to the requester (a live view would leak it).
                return mr.slice(wqe.remote_addr, wqe.length).copy()
            return bytes(mr.slice(wqe.remote_addr, wqe.length))
        if wqe.opcode in ATOMIC_OPCODES:
            mr = _find_mr(host, wqe.rkey, wqe.remote_addr, 8)
            if mr is None:
                return "acc_err"
            cell = mr.slice(wqe.remote_addr, 8)
            old = struct.unpack("<q", bytes(cell))[0]
            if wqe.opcode is Opcode.FETCH_ADD:
                cell[:] = np.frombuffer(
                    struct.pack("<q", old + wqe.compare_add), dtype=np.uint8)
            else:  # CMP_SWAP
                if old == wqe.compare_add:
                    cell[:] = np.frombuffer(
                        struct.pack("<q", wqe.swap), dtype=np.uint8)
            return struct.pack("<q", old)
        raise VerbsError(f"unhandled opcode {wqe.opcode}")

    # -- ACK path -----------------------------------------------------------
    def _send_ack(self, src_qp: QP, wqe: SendWQE, dst_nic: RNIC,
                  rnr: bool, read_data: Optional[bytes] = None,
                  epoch: int = 0) -> None:
        src_nic = src_qp.pd.ctx.nic
        lat = self.cluster.path_latency(dst_nic, src_nic)
        if isinstance(read_data, (bytes, bytearray)) and wqe.opcode is Opcode.READ:
            # response carries data: serialize at the responder NIC
            lat += len(read_data) / max(dst_nic.effective_bandwidth(), 1.0)
        self.sim.call(lat, self._ack_arrive, src_qp, wqe, dst_nic, rnr,
                      read_data, epoch)

    def _ack_arrive(self, qp: QP, wqe: SendWQE, dst_nic: RNIC, rnr: bool,
                    read_data, epoch: int) -> None:
        src_nic = qp.pd.ctx.nic
        if not self.cluster.path_up(dst_nic, src_nic):
            return  # ACK lost — Lemma 3.1 trace T2
        if epoch != qp.epoch:
            return  # stale: the sender QP was reset since this was sent
        if qp.state is not QPState.RTS or wqe.completed:
            return
        if rnr:
            if wqe.timeout_ev is not None:
                wqe.timeout_ev.cancel()
            if wqe.attempts > qp.rnr_retry:
                qp._enter_error(WCStatus.RNR_RETRY_EXC_ERR, wqe)
                return
            self.sim.call(self.cluster.rnr_timer, self._retransmit,
                          qp, wqe, epoch)
            return
        wqe.acked = True
        if isinstance(read_data, (bytes, bytearray)) and wqe.opcode in (
                Opcode.READ, *ATOMIC_OPCODES):
            n = wqe.length if wqe.opcode is Opcode.READ else 8
            mr = self._local_mr(wqe.lkey)
            mr.slice(wqe.local_addr, n)[:] = np.frombuffer(
                bytes(read_data[:n]), dtype=np.uint8)
        if wqe.length and not wqe.probe and wqe.tx_time is not None:
            # per-rail completion telemetry (payload WQEs only)
            self.cluster.telemetry.note_completion(
                src_nic.index, wqe.length, self.sim.now - wqe.tx_time)
        qp._complete_send(wqe, WCStatus.SUCCESS)

    def _send_nak_access(self, src_qp: QP, wqe: SendWQE, dst_nic: RNIC,
                         epoch: int) -> None:
        src_nic = src_qp.pd.ctx.nic
        lat = self.cluster.path_latency(dst_nic, src_nic)

        def _nak():
            if epoch != src_qp.epoch:
                return
            if src_qp.state is QPState.RTS and not wqe.completed:
                src_qp._enter_error(WCStatus.REM_ACCESS_ERR, wqe)
        self.sim.call(lat, _nak)

    def _ack_timeout(self, qp: QP, wqe: SendWQE, epoch: int) -> None:
        if epoch != qp.epoch:
            return
        if wqe.acked or wqe.completed or qp.state is not QPState.RTS:
            return
        if wqe.attempts > qp.retry_cnt:
            qp._enter_error(WCStatus.RETRY_EXC_ERR, wqe)
            return
        self._retransmit(qp, wqe, epoch)

    def _retransmit(self, qp: QP, wqe: SendWQE, epoch: int) -> None:
        if epoch != qp.epoch:
            return
        if qp.state is not QPState.RTS or wqe.completed:
            return
        if self.cluster.fast_datapath:
            self._send_segment(qp, [wqe])
        else:
            self._transmit(qp, wqe, first_attempt=False)


def _gid_of(qp: QP) -> str:
    return qp.dest_gid


def _consume_recv(dqp: QP) -> Optional[RecvWQE]:
    if dqp.rq_consumed >= dqp.rq_doorbell:
        return None
    rwqe = dqp._rq_at(dqp.rq_consumed)
    dqp.rq_consumed += 1
    rwqe.consumed = True
    rwqe.completed = True
    rwqe.status = WCStatus.SUCCESS
    return rwqe


def _find_mr(host: str, rkey: int, addr: int, length: int) -> Optional[MR]:
    mr = _mr_registry.get((host, rkey))
    if mr is None:
        return None
    if addr < mr.addr or addr + length > mr.addr + mr.length:
        return None
    return mr


# global registries (the 'wire' knows how to find remote QPs/MRs)
_qp_registry: Dict[Tuple[str, int], QP] = {}
_mr_registry: Dict[Tuple[str, int], MR] = {}
_mr_registry_lkey: Dict[Tuple[str, int], MR] = {}


def reset_registries() -> None:
    """Test isolation helper."""
    _qp_registry.clear()
    _mr_registry.clear()
    _mr_registry_lkey.clear()


# ---------------------------------------------------------------------------
# libibverbs-style API surface (what applications call; what SHIFT wraps)
# ---------------------------------------------------------------------------


def ibv_get_device_list(cluster: Cluster, host: str) -> List[str]:
    """Device names available on ``host``."""
    return [nic.name for nic in cluster.hosts[host].nics]


def ibv_open_device(cluster: Cluster, host: str, nic_name: str) -> Context:
    """Open a device context on ``host``'s NIC named ``nic_name``."""
    for nic in cluster.hosts[host].nics:
        if nic.name == nic_name:
            return Context(cluster, nic)
    raise VerbsError(f"no device {nic_name} on {host}")


def ibv_alloc_pd(ctx: Context) -> PD:
    """Allocate a protection domain on ``ctx``."""
    return PD(ctx)


def ibv_reg_mr(pd: PD, buf: np.ndarray, addr: Optional[int] = None) -> MR:
    """Register ``buf`` (1-D uint8) as an MR; ``addr`` pins the VA
    (SHIFT's backup registration reuses the default MR's address)."""
    return MR(pd, buf, addr=addr)


def ibv_create_comp_channel(ctx: Context) -> CompChannel:
    """Create a completion event channel."""
    return CompChannel(ctx)


def ibv_create_cq(ctx: Context, depth: int,
                  channel: Optional[CompChannel] = None) -> CQ:
    """Create a CQ of ``depth`` entries, optionally on a comp channel."""
    return CQ(ctx, depth, channel)


def ibv_req_notify_cq(cq: CQ) -> None:
    """Arm the CQ for one completion event."""
    cq.armed = True


def ibv_create_qp(pd: PD, init: QPInitAttr) -> QP:
    """Create an RC queue pair."""
    return QP(pd, init)


def ibv_modify_qp(qp: QP, attr: QPAttr) -> None:
    """Apply a state transition / attribute change to ``qp``."""
    qp.modify(attr)


def ibv_query_qp(qp: QP) -> QPAttr:
    """Snapshot ``qp``'s current attributes."""
    return qp.query()


def ibv_post_send(qp: QP, wr: SendWR) -> SendWQE:
    """Post one send WR with an immediate doorbell."""
    return qp.post_send_wqe(wr, ring=True)


def ibv_post_send_chain(qp: QP, wrs: Sequence[SendWR]) -> List[SendWQE]:
    """Post a ``wr.next``-style linked chain with a single doorbell."""
    return qp.post_send_chain(wrs, ring=True)


def ibv_post_recv(qp: QP, wr: RecvWR) -> RecvWQE:
    """Post one receive WR with an immediate doorbell."""
    return qp.post_recv_wqe(wr, ring=True)


def ibv_poll_cq(cq: CQ, n: int) -> List[WC]:
    """Poll up to ``n`` completions off ``cq``."""
    return cq.poll(n)


# ---------------------------------------------------------------------------
# convenience for tests / benchmarks
# ---------------------------------------------------------------------------


def connect_qps(qp_a: QP, qp_b: QP, psn_a: int = 0, psn_b: int = 0) -> None:
    """Perform the RESET->INIT->RTR->RTS dance on both sides."""
    for qp in (qp_a, qp_b):
        if qp.state is not QPState.RESET:
            qp.modify(QPAttr(qp_state=QPState.RESET))
        qp.modify(QPAttr(qp_state=QPState.INIT))
    qp_a.modify(QPAttr(qp_state=QPState.RTR, dest_gid=qp_b.ctx.nic.gid,
                       dest_qp_num=qp_b.qpn, rq_psn=psn_b))
    qp_b.modify(QPAttr(qp_state=QPState.RTR, dest_gid=qp_a.ctx.nic.gid,
                       dest_qp_num=qp_a.qpn, rq_psn=psn_a))
    qp_a.modify(QPAttr(qp_state=QPState.RTS, sq_psn=psn_a))
    qp_b.modify(QPAttr(qp_state=QPState.RTS, sq_psn=psn_b))
