"""SHIFT — user-space cross-NIC RDMA fault tolerance (§4 of the paper).

``ShiftLib`` mirrors the verbs API (the paper implements SHIFTLib inside
rdma-core and swaps it in via LD_LIBRARY_PATH; here applications swap
``StandardLib`` for ``ShiftLib``). It provides, per the paper:

* **Shadow control verbs** (§4.2): control verbs are recorded and replayed
  by a background actor on the backup RNIC, best-effort to break cyclic
  dependencies (App. B.1), with default->backup attribute mappings
  published through the out-of-band KV store.
* **WQE copy resubmission** (§4.1/§4.3.2): fallback recovers WQEs from the
  work-queue rings via ``SendWQE.to_wr()`` — no payload is ever buffered
  (zero-copy is preserved; tests assert SHIFT holds no payload bytes).
* **CQ-event-based 2-way handshake** (§4.3.2): NOTIFY/ACK messages carrying
  receive-WQE counters; retransmission starts from the first failed send WR
  after the last successfully completed receive WR, and sends that the
  counters prove delivered (ACK lost) are excluded and their completions
  synthesized.
* **Retransmission-safe check**: in-flight atomics ⇒ the error is
  propagated to the application (the Trilemma's non-idempotent ops).
* **WR execution fence** (§4.3.3): after the probe succeeds, traffic keeps
  flowing on the backup QP until the next *signaled* WR (the fence);
  subsequent WRs are posted to the default QP **with the doorbell
  withheld** and released only when the fence completes and the peer has
  re-armed its receive side.
* Send-queue state machine ``Default -> Fallback -> WaitSignaled ->
  WaitDrained -> Default``; receive side ``Default <-> Fallback``.

Implementation deviations from the paper (documented in DESIGN.md):

1. Control messages travel on a dedicated small control QP pair on the
   backup NICs instead of sharing the backup data QP. This keeps app
   receive rings free of control consumptions across repeated
   fallback/recovery cycles. The recovery notification therefore carries an
   explicit RECOVER_ACK instead of relying on same-QP FIFO ordering; the
   doorbell-withholding fence is unchanged.
2. Each fallback cycle re-connects the default and backup-data QPs at a
   per-cycle PSN base so that 'ghost' packets from a previous cycle are
   rejected as duplicates (the sim makes ghosts real; see verbs._deliver).
3. Probe WRs are sequence-transparent at the receiver (they validate path
   liveness without perturbing PSN state); production SHIFT achieves the
   equivalent via the QP re-connect handshake over the management network.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import verbs as V
from .fabric import Cluster
from .kvstore import KVStore
from .protocols import FailoverClass, classify_wqe_set

# ---------------------------------------------------------------------------
# Control-plane constants
# ---------------------------------------------------------------------------

CTRL_WRID_BASE = 1 << 62
IMM_TYPE_SHIFT = 28
IMM_COUNTER_MASK = (1 << 28) - 1

CTRL_NOTIFY = 0xE       # fallback notification (carries recv counter)
CTRL_ACK = 0xD          # fallback acknowledgment (carries recv counter)
CTRL_RECOVER = 0xC      # recovery notification (sender side recovered)
CTRL_RECOVER_ACK = 0xB  # receiver re-armed on default QP

_ctrl_seq = itertools.count()


def _pack_imm(msg_type: int, counter: int) -> int:
    return (msg_type << IMM_TYPE_SHIFT) | (counter & IMM_COUNTER_MASK)


def _unpack_imm(imm: int) -> Tuple[int, int]:
    return imm >> IMM_TYPE_SHIFT, imm & IMM_COUNTER_MASK


def _wrap_delta(a: int, b: int) -> int:
    """a - b on the 28-bit counter ring; negative -> 0."""
    d = (a - b) & IMM_COUNTER_MASK
    return d if d < (1 << 27) else 0


class SendState(enum.Enum):
    """Send-side SHIFT states (Fig. 4): Default -> Fallback ->
    WaitSignaled -> WaitDrained -> Default; FAILED is terminal."""

    DEFAULT = 1
    FALLBACK = 2
    WAIT_SIGNALED = 3
    WAIT_DRAINED = 4
    FAILED = 5


class RecvState(enum.Enum):
    """Receive-side SHIFT states: Default <-> Fallback."""

    DEFAULT = 1
    FALLBACK = 2


@dataclass
class ShiftConfig:
    """SHIFT tunables: probing cadence, control-plane costs, rail-aware
    backup placement (``data_rails`` / ``backup_overrides``) — see
    docs/scheduler.md for how placement interacts with the channel
    scheduler at >2-rail scale."""

    probe_interval: float = 20e-3
    ctrl_recv_depth: int = 8
    protect_atomics: bool = True
    shadow_verb_delay: float = 50e-6   # per-verb background execution cost
    actor_tick: float = 200e-6
    cycle_psn_stride: int = 1 << 16
    # Rail-aware backup placement. ``data_rails`` is how many rails carry
    # default (channelized-collective) traffic: a failing data rail
    # prefers a SPARE rail (index >= data_rails) as its backup so two
    # channels never fail over onto each other's default rail when a
    # spare exists. With no spares (data_rails == NIC count) placement
    # degrades to the historical next-rail rule — the Trilemma's
    # hardware constraint: some rail must absorb the displaced traffic.
    data_rails: int = 1
    # explicit per-rail override: default NIC index -> backup NIC index
    backup_overrides: Optional[Dict[int, int]] = None
    # Telemetry-driven probe pacing (ROADMAP item): a QP whose default
    # path has flapped repeatedly in the recent window is probed
    # CAUTIOUSLY (exponential backoff per extra recent fallback — a
    # flapping rail that passes a probe is likely to die again mid-
    # recovery, and each aborted recovery costs a handshake), while a
    # path with no recent flap history keeps the aggressive base
    # cadence. The FIRST fallback of a stable path always probes at
    # ``probe_interval`` exactly, so single-fault behaviour (and every
    # historical scenario fingerprint that only faults once) is
    # unchanged.
    probe_adaptive: bool = True
    probe_flap_window: float = 0.5     # seconds of fallback history used
    probe_backoff: float = 2.0         # interval multiplier per extra flap
    probe_backoff_max: float = 8.0     # cap on the pacing multiplier

    def paced_probe_interval(self, flap_times: Sequence[float],
                             now: float) -> float:
        """Probe interval given the QP's recent fallback history.

        ``flap_times`` are virtual timestamps of past fallback entries;
        only those within ``probe_flap_window`` of ``now`` count. One
        recent fallback (the one being probed for) keeps the base
        cadence; each additional one multiplies the interval by
        ``probe_backoff`` up to ``probe_backoff_max``.
        """
        if not self.probe_adaptive:
            return self.probe_interval
        recent = sum(1 for t in flap_times
                     if now - t <= self.probe_flap_window)
        factor = min(self.probe_backoff ** max(0, recent - 1),
                     self.probe_backoff_max)
        return self.probe_interval * factor

    def backup_index(self, i: int, n: int) -> int:
        """Backup NIC index for a default NIC at rail ``i`` of ``n``."""
        if self.backup_overrides:
            ov = self.backup_overrides.get(i)
            if ov is not None:
                return ov % n
        spares = n - max(self.data_rails, 1)
        if spares > 0 and i < self.data_rails:
            return self.data_rails + (i % spares)
        return (i + 1) % n


@dataclass
class ShiftStats:
    """Per-library counters (fallbacks, recoveries, probes, zero-copy
    audit) the scenario invariants assert on after every run."""

    fallbacks: int = 0
    recoveries: int = 0
    probes_sent: int = 0
    probe_failures: int = 0
    synthesized_wcs: int = 0
    resubmitted_sends: int = 0
    resubmitted_recvs: int = 0
    errors_propagated: int = 0
    fallback_latencies: List[float] = field(default_factory=list)
    # zero-copy audit: SHIFT must never hold payload bytes
    payload_bytes_held: int = 0

    def as_dict(self) -> Dict[str, object]:
        """Deep-copied snapshot (scenario engine determinism checks compare
        these across runs, so mutation after the fact must not alias)."""
        d = dataclasses.asdict(self)
        d["fallback_latencies"] = list(self.fallback_latencies)
        return d


# ---------------------------------------------------------------------------
# Standard (non-SHIFT) library — the baseline the paper compares against
# ---------------------------------------------------------------------------


class StandardLib:
    """Plain rdma-core semantics, object API shared with ShiftLib."""

    name = "standard"

    def __init__(self, cluster: Cluster, host: str):
        self.cluster = cluster
        self.host = host

    def open_device(self, nic: str) -> V.Context:
        """ibv_open_device on this host."""
        return V.ibv_open_device(self.cluster, self.host, nic)

    def alloc_pd(self, ctx) -> V.PD:
        """ibv_alloc_pd."""
        return V.ibv_alloc_pd(ctx)

    def reg_mr(self, pd, buf: np.ndarray) -> V.MR:
        """ibv_reg_mr."""
        return V.ibv_reg_mr(pd, buf)

    def create_cq(self, ctx, depth: int) -> V.CQ:
        """ibv_create_cq."""
        return V.ibv_create_cq(ctx, depth)

    def create_qp(self, pd, init: V.QPInitAttr) -> V.QP:
        """ibv_create_qp."""
        return V.ibv_create_qp(pd, init)

    def modify_qp(self, qp, attr: V.QPAttr) -> None:
        """ibv_modify_qp."""
        V.ibv_modify_qp(qp, attr)

    def query_qp(self, qp) -> V.QPAttr:
        """ibv_query_qp."""
        return V.ibv_query_qp(qp)

    def post_send(self, qp, wr: V.SendWR) -> None:
        """ibv_post_send."""
        V.ibv_post_send(qp, wr)

    def post_send_chain(self, qp, wrs: Sequence[V.SendWR]) -> None:
        """ibv_post_send with a wr.next chain (one doorbell)."""
        V.ibv_post_send_chain(qp, wrs)

    def post_recv(self, qp, wr: V.RecvWR) -> None:
        """ibv_post_recv."""
        V.ibv_post_recv(qp, wr)

    def poll_cq(self, cq, n: int) -> List[V.WC]:
        """ibv_poll_cq."""
        return V.ibv_poll_cq(cq, n)

    def route_of(self, qp) -> Tuple[str, int]:
        """(gid, qpn) route peers use to connect to ``qp``."""
        return qp.ctx.nic.gid, qp.qpn

    def connect(self, qp, peer_gid: str, peer_qpn: int) -> None:
        """Drive the INIT/RTR/RTS dance toward a peer route."""
        self.modify_qp(qp, V.QPAttr(qp_state=V.QPState.INIT))
        self.modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTR, dest_gid=peer_gid,
                                    dest_qp_num=peer_qpn, rq_psn=0))
        self.modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTS, sq_psn=0))

    def settle(self, duration: float = 0.1) -> None:
        """Run the virtual clock forward (control-plane settling)."""
        self.cluster.sim.run(until=self.cluster.sim.now + duration)


# ---------------------------------------------------------------------------
# SHIFT proxies
# ---------------------------------------------------------------------------


class _ControlActor:
    """Background 'control thread' per backup RNIC: executes recorded shadow
    control verbs best-effort (skip + retry on unmet dependencies)."""

    def __init__(self, lib: "ShiftLib"):
        self.lib = lib
        self.sim = lib.cluster.sim
        self.tasks: Deque[Callable[[], bool]] = deque()
        self._scheduled = False

    def submit(self, task: Callable[[], bool]) -> None:
        self.tasks.append(task)
        self._kick()

    def _kick(self) -> None:
        if not self._scheduled:
            self._scheduled = True
            self.sim.schedule(self.lib.config.shadow_verb_delay, self._run)

    def _run(self) -> None:
        self._scheduled = False
        pending: List[Callable[[], bool]] = []
        while self.tasks:
            task = self.tasks.popleft()
            try:
                done = task()
            except Exception:
                raise
            if not done:
                pending.append(task)  # unmet dependency: best-effort skip
        for t in pending:
            self.tasks.append(t)
        if self.tasks:
            self.sim.schedule(self.lib.config.actor_tick, self._run)
            self._scheduled = True


class ShiftContext:
    """App-facing device context: default NIC now, backup opened by the
    background actor (shadow ibv_open_device)."""

    def __init__(self, lib: "ShiftLib", default: V.Context):
        self.lib = lib
        self.default = default
        self.backup: Optional[V.Context] = None
        # shadow verb: open the backup device in the background
        nics = default.cluster.hosts[lib.host].nics
        bidx = lib.config.backup_index(default.nic.index, len(nics))
        backup_nic = nics[bidx].name

        def _open() -> bool:
            self.backup = V.ibv_open_device(default.cluster, lib.host,
                                            backup_nic)
            return True
        lib.actor.submit(_open)


class ShiftPD:
    """App-facing PD: default PD now, backup allocated in the background."""

    def __init__(self, lib: "ShiftLib", sctx: ShiftContext):
        self.lib = lib
        self.sctx = sctx
        self.default = V.ibv_alloc_pd(sctx.default)
        self.backup: Optional[V.PD] = None

        def _alloc() -> bool:
            if self.sctx.backup is None:
                return False
            self.backup = V.ibv_alloc_pd(self.sctx.backup)
            return True
        lib.actor.submit(_alloc)


class ShiftMR:
    """Registers the same buffer on default and backup NICs; publishes the
    rkey mapping to the KV store. NOTE: same VA, different keys — SHIFT's
    resubmission patches keys only."""

    def __init__(self, lib: "ShiftLib", spd: ShiftPD, buf: np.ndarray):
        self.lib = lib
        self.default = V.ibv_reg_mr(spd.default, buf)
        self.backup: Optional[V.MR] = None
        # app-facing attributes mirror the default MR (opacity)
        self.addr = self.default.addr
        self.lkey = self.default.lkey
        self.rkey = self.default.rkey
        self.length = self.default.length

        def _reg() -> bool:
            if spd.backup is None:
                return False
            self.backup = V.ibv_reg_mr(spd.backup, buf, addr=self.default.addr)
            lib.lkey_map[self.default.lkey] = self.backup.lkey
            lib.backup_lkeys.add(self.backup.lkey)
            lib.kv.put(f"mr:{lib.host}:{self.default.rkey}", self.backup.rkey)
            return True
        lib.actor.submit(_reg)


class ShiftCQ:
    """App-facing CQ: underlying default CQ + shadow backup CQ + the WC
    buffer of App. B.2. Physical WCs are routed (counters, control,
    synthesis) before the application sees them."""

    def __init__(self, lib: "ShiftLib", sctx: ShiftContext, depth: int):
        self.lib = lib
        self.sctx = sctx
        self.depth = depth
        self.channel = V.ibv_create_comp_channel(sctx.default)
        self.default = V.ibv_create_cq(sctx.default, depth, self.channel)
        self.channel.on_event(self._on_event)
        V.ibv_req_notify_cq(self.default)
        self.backup: Optional[V.CQ] = None
        self.backup_channel: Optional[V.CompChannel] = None
        self.app_buffer: List[V.WC] = []
        # optional push-mode consumer (used by event-driven apps like JCCL)
        self.app_listener = None

        def _create() -> bool:
            if sctx.backup is None:
                return False
            self.backup_channel = V.ibv_create_comp_channel(sctx.backup)
            self.backup = V.ibv_create_cq(sctx.backup, depth,
                                          self.backup_channel)
            self.backup_channel.on_event(self._on_event)
            V.ibv_req_notify_cq(self.backup)
            return True
        lib.actor.submit(_create)

    # background wake: an error WC (or data on the backup CQ) arrived while
    # the app was not polling
    def _on_event(self, cq: V.CQ) -> None:
        V.ibv_req_notify_cq(cq)
        self.process_physical()

    def process_physical(self) -> None:
        """Drain both physical CQs through SHIFT's WC router, then
        deliver any buffered app WCs to a push-mode consumer."""
        route = self.lib._route_wc
        for cq in (self.default, self.backup):
            if cq is None:
                continue
            while cq.entries:       # routing may push follow-on WCs
                for wc in cq.poll(64):
                    route(wc, self)
            V.ibv_req_notify_cq(cq)
        self.flush_app()

    def flush_app(self) -> None:
        """Deliver buffered app WCs to a push-mode consumer. Besides the
        physical-drain path above, SHIFT calls this whenever it emits app
        WCs with NO physical WC behind them (counter-synthesized
        completions, propagated errors): those land in ``app_buffer``
        outside any drain, and an event-driven app gated on completions
        (JCCL's FIFO slot reuse) would deadlock waiting for a wakeup that
        never comes."""
        if self.app_listener is not None and self.app_buffer:
            buf, self.app_buffer = self.app_buffer, []
            self.app_listener(buf)

    def poll(self, n: int) -> List[V.WC]:
        """App-facing ibv_poll_cq over the routed WC buffer."""
        self.process_physical()
        buf = self.app_buffer
        if not buf:
            return []
        if n >= len(buf):
            self.app_buffer = []
            return buf
        out = buf[:n]
        del buf[:n]
        return out


class _SendRec:
    """App-level bookkeeping for one posted send WR (metadata only — the
    payload stays in the registered MR; the physical WQE lives in a ring)."""

    __slots__ = ("seq", "opcode", "signaled", "two_sided", "completed",
                 "synthesized", "cur_wqe", "pending_wr")

    def __init__(self, seq: int, wr: V.SendWR):
        self.seq = seq
        self.opcode = wr.opcode
        self.signaled = bool(wr.send_flags & V.SEND_FLAG_SIGNALED)
        self.two_sided = wr.opcode in V.TWO_SIDED_OPCODES
        self.completed = False
        self.synthesized = False
        self.cur_wqe: Optional[V.SendWQE] = None
        self.pending_wr: Optional[V.SendWR] = None  # held during handshake


class _RecvRec:
    __slots__ = ("seq", "completed", "cur_rwqe")

    def __init__(self, seq: int):
        self.seq = seq
        self.completed = False
        self.cur_rwqe: Optional[V.RecvWQE] = None


class ShiftQP:
    """The per-QP SHIFT state machine (Fig. 4)."""

    def __init__(self, lib: "ShiftLib", spd: ShiftPD, init: V.QPInitAttr):
        self.lib = lib
        self.spd = spd
        self.send_scq: ShiftCQ = init.send_cq
        self.recv_scq: ShiftCQ = init.recv_cq
        self.default = V.ibv_create_qp(
            spd.default, V.QPInitAttr(send_cq=self.send_scq.default,
                                      recv_cq=self.recv_scq.default,
                                      cap=init.cap))
        self.qpn = self.default.qpn  # app-facing (opacity)
        self.cap = init.cap
        self.backup: Optional[V.QP] = None
        self.ctrl: Optional[V.QP] = None
        self.ctrl_cq: Optional[V.CQ] = None
        self.ready = False          # backup path connected
        self.peer_route: Optional[Tuple[str, int]] = None
        self.peer_backup: Optional[Tuple[str, int, int]] = None
        self.send_state = SendState.DEFAULT
        self.recv_state = RecvState.DEFAULT
        self.cycle = 0
        self._awaiting_ack = False
        self._in_handshake = False
        self._probing = False
        self._probe_outstanding = False
        # fallback-entry timestamps (bounded) — the telemetry the
        # adaptive probe pacing reads: a recently-flapping default path
        # is probed cautiously, a stable one aggressively
        self.flap_times: Deque[float] = deque(maxlen=16)
        self._fence_rec: Optional[_SendRec] = None
        self._withheld: List[_SendRec] = []
        self._recover_sent = False
        self._seq = itertools.count()
        self.send_recs: Deque[_SendRec] = deque()
        self.recv_fifo: Deque[_RecvRec] = deque()
        # O(1) hot-path bookkeeping: counters instead of deque scans for
        # the retransmission-safe check and the recovery-drain check.
        self._n_outstanding = 0     # posted, not yet completed sends
        self._n_atomics = 0         # outstanding FETCH_ADD/CMP_SWAP
        self.n_recv_completed = 0
        self.n_sent_twosided_completed = 0
        self._attr_rtr: Optional[V.QPAttr] = None
        self._attr_rts: Optional[V.QPAttr] = None
        self._error_t0: Optional[float] = None
        self._await_first_success = False
        self.fail_reason: Optional[str] = None
        lib.qpn_map[self.default.qpn] = self
        lib.shift_qps.append(self)

        # shadow verbs: backup data QP + control QP on the backup NIC
        def _create() -> bool:
            if (spd.backup is None or self.send_scq.backup is None
                    or self.recv_scq.backup is None):
                return False
            self.backup = V.ibv_create_qp(
                spd.backup, V.QPInitAttr(send_cq=self.send_scq.backup,
                                         recv_cq=self.recv_scq.backup,
                                         cap=init.cap))
            ch = V.ibv_create_comp_channel(spd.backup.ctx)
            self.ctrl_cq = V.ibv_create_cq(spd.backup.ctx, 64, ch)
            ch.on_event(self._on_ctrl_event)
            V.ibv_req_notify_cq(self.ctrl_cq)
            self.ctrl = V.ibv_create_qp(
                spd.backup, V.QPInitAttr(send_cq=self.ctrl_cq,
                                         recv_cq=self.ctrl_cq,
                                         cap=V.QPCap(64, 64)))
            lib.qpn_map[self.backup.qpn] = self
            # publish default->backup route mapping (§4.2)
            lib.kv.put(f"route:{self.default.ctx.nic.gid}:{self.default.qpn}",
                       (self.backup.ctx.nic.gid, self.backup.qpn,
                        self.ctrl.qpn))
            return True
        lib.actor.submit(_create)

    # ------------------------------------------------------------------
    # connection setup
    # ------------------------------------------------------------------
    def modify(self, attr: V.QPAttr) -> None:
        """App-facing ibv_modify_qp: drives the default QP and kicks
        the background backup/control-QP connection at RTR."""
        if attr.qp_state is V.QPState.RTR:
            # the paper measures extra ibv_query_qp cost here (Fig. 7):
            # SHIFT snapshots attributes to be able to reset after fallback
            V.ibv_query_qp(self.default)
            self._attr_rtr = attr
            self.peer_route = (attr.dest_gid, attr.dest_qp_num)
        elif attr.qp_state is V.QPState.RTS:
            V.ibv_query_qp(self.default)
            self._attr_rts = attr
        V.ibv_modify_qp(self.default, attr)
        if attr.qp_state is V.QPState.RTR:
            self._connect_backup_async()

    def _connect_backup_async(self) -> None:
        peer_gid, peer_qpn = self.peer_route
        key = f"route:{peer_gid}:{peer_qpn}"

        def _connect() -> bool:
            if self.backup is None or self.ctrl is None:
                return False
            val = self.lib.kv.get(key)
            if val is None:
                return False
            b_gid, b_qpn, c_qpn = val
            self.peer_backup = (b_gid, b_qpn, c_qpn)
            psn = self._cycle_psn()
            for qp, dq in ((self.backup, b_qpn), (self.ctrl, c_qpn)):
                V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.INIT))
                V.ibv_modify_qp(qp, V.QPAttr(
                    qp_state=V.QPState.RTR, dest_gid=b_gid,
                    dest_qp_num=dq if qp is self.backup else c_qpn,
                    rq_psn=psn if qp is self.backup else 0))
                V.ibv_modify_qp(qp, V.QPAttr(
                    qp_state=V.QPState.RTS,
                    sq_psn=psn if qp is self.backup else 0))
            for _ in range(self.lib.config.ctrl_recv_depth):
                self._post_ctrl_recv()
            self.ready = True
            return True
        self.lib.actor.submit(_connect)

    def _cycle_psn(self) -> int:
        return self.cycle * self.lib.config.cycle_psn_stride

    # ------------------------------------------------------------------
    # data-path posting
    # ------------------------------------------------------------------
    def _rec_done(self, rec: _SendRec) -> None:
        """Mark a send record completed, maintaining the O(1) counters."""
        rec.completed = True
        self._n_outstanding -= 1
        if rec.opcode in V.ATOMIC_OPCODES:
            self._n_atomics -= 1

    def post_send(self, wr: V.SendWR) -> None:
        """App-facing ibv_post_send, routed by the send-state machine
        (default QP, key-patched backup QP, or withheld doorbell)."""
        if self.send_state is SendState.FAILED:
            raise V.VerbsError("SHIFT QP failed (unmaskable error)")
        rec = _SendRec(next(self._seq), wr)
        self.send_recs.append(rec)
        self._n_outstanding += 1
        if rec.opcode in V.ATOMIC_OPCODES:
            self._n_atomics += 1
        if self._awaiting_ack or self._in_handshake:
            rec.pending_wr = wr  # metadata only; payload stays in the MR
            return
        if self.send_state is SendState.DEFAULT:
            if self.default.state is V.QPState.ERR:
                # the NIC already failed but we have not yet polled the
                # error WC: detection happens at post time (real ibverbs
                # returns an error here; SHIFT intercepts it)
                rec.pending_wr = wr
                self._drain_cqs()  # routes the error WC -> fallback
                if (self.send_state is SendState.DEFAULT
                        and not self._in_handshake and not self._awaiting_ack):
                    # QP errored without surfacing a WC (empty queues)
                    self._error_t0 = self.lib.cluster.sim.now
                    self._await_first_success = True
                    self.initiate_fallback()
                if self.send_state is SendState.FAILED:
                    raise V.VerbsError("SHIFT QP failed (unmaskable error)")
                return
            wqe = self.default.post_send_wqe(wr, ring=True)
            self._map_send(rec, wqe)
        elif self.send_state in (SendState.FALLBACK, SendState.WAIT_SIGNALED):
            bwr = self._patch_wr(wr)
            wqe = self.backup.post_send_wqe(bwr, ring=True)
            self._map_send(rec, wqe)
            if (self.send_state is SendState.WAIT_SIGNALED and rec.signaled):
                # the fence WR (§4.3.3 step 1)
                self._fence_rec = rec
                self.send_state = SendState.WAIT_DRAINED
        elif self.send_state is SendState.WAIT_DRAINED:
            # doorbell withheld: enqueued on the default QP, not executed
            wqe = self.default.post_send_wqe(wr, ring=False)
            self._map_send(rec, wqe)
            self._withheld.append(rec)
        else:  # pragma: no cover
            raise V.VerbsError(f"bad state {self.send_state}")

    def post_send_chain(self, wrs: Sequence[V.SendWR]) -> None:
        """Post a WR chain with one doorbell (steady-state fast path).
        In FALLBACK the chain is key-patched and posted to the backup QP,
        still with one doorbell; other states (handshake, recovery fence)
        degrade to per-WR posting, which handles every edge."""
        if self._awaiting_ack or self._in_handshake:
            for wr in wrs:
                self.post_send(wr)
            return
        if self.send_state is SendState.FALLBACK and \
                self.backup is not None and \
                self.backup.state is V.QPState.RTS:
            patched = [self._patch_wr(wr) for wr in wrs]
            wqes = self.backup.post_send_chain(patched, ring=False)
            for wr, wqe in zip(wrs, wqes):
                rec = _SendRec(next(self._seq), wr)
                self.send_recs.append(rec)
                self._n_outstanding += 1
                if rec.opcode in V.ATOMIC_OPCODES:
                    self._n_atomics += 1
                self._map_send(rec, wqe)
            self.backup.ring_sq_doorbell()
            return
        if (self.send_state is not SendState.DEFAULT
                or self.default.state is not V.QPState.RTS):
            for wr in wrs:
                self.post_send(wr)
            return
        wqes = self.default.post_send_chain(wrs, ring=False)
        append = self.send_recs.append
        seq = self._seq
        wqe_map = self.lib.wqe_map
        n_atomics = 0
        for wr, wqe in zip(wrs, wqes):
            rec = _SendRec(next(seq), wr)
            append(rec)
            if rec.opcode in V.ATOMIC_OPCODES:
                n_atomics += 1
            rec.cur_wqe = wqe   # fresh rec: nothing to unmap
            if rec.signaled:
                wqe_map[id(wqe)] = (rec, self)
        self._n_outstanding += len(wqes)
        self._n_atomics += n_atomics
        self.default.ring_sq_doorbell()

    def post_recv(self, wr: V.RecvWR) -> None:
        """App-facing ibv_post_recv, routed by the receive state."""
        rec = _RecvRec(next(self._seq))
        self.recv_fifo.append(rec)
        if self.recv_state is RecvState.DEFAULT:
            rwqe = self.default.post_recv_wqe(wr, ring=True)
        else:
            rwqe = self.backup.post_recv_wqe(self._patch_recv_wr(wr), ring=True)
        self._map_recv(rec, rwqe)

    def _map_send(self, rec: _SendRec, wqe: V.SendWQE) -> None:
        if rec.cur_wqe is not None:
            self.lib.wqe_map.pop(id(rec.cur_wqe), None)
        rec.cur_wqe = wqe
        rec.pending_wr = None
        # Unsignaled sends never produce a success WC, so they need no
        # wqe->rec route: their recs retire via ring-order completion
        # coalescing (on_send_wc) or counter synthesis, and their error
        # WCs route through qpn_map. Skipping the dict insert keeps the
        # post hot path O(1) with no per-message map growth.
        if rec.signaled:
            self.lib.wqe_map[id(wqe)] = (rec, self)

    def _map_recv(self, rec: _RecvRec, rwqe: V.RecvWQE) -> None:
        if rec.cur_rwqe is not None:
            self.lib.rwqe_map.pop(id(rec.cur_rwqe), None)
        rec.cur_rwqe = rwqe
        self.lib.rwqe_map[id(rwqe)] = (rec, self)

    def _patch_wr(self, wr: V.SendWR) -> V.SendWR:
        """Patch MR keys default->backup (§4.3.2 'updating their MR keys').

        Idempotent: WQEs recovered from the BACKUP ring on a later fallback
        cycle already carry backup keys and pass through unchanged."""
        sge = wr.sge
        if sge is not None and sge.length and \
                sge.lkey not in self.lib.backup_lkeys:
            blkey = self.lib.lkey_map.get(sge.lkey)
            if blkey is None:
                raise V.VerbsError("backup MR not ready for lkey patch")
            sge = V.SGE(sge.addr, sge.length, blkey)
        rkey = wr.rkey
        if wr.opcode is not V.Opcode.SEND and wr.rkey and \
                wr.rkey not in self.lib.backup_rkeys:
            rkey = self._peer_backup_rkey(wr.rkey)
        return V.SendWR(wr.wr_id, wr.opcode, sge, wr.remote_addr, rkey,
                        wr.imm_data, wr.send_flags, wr.compare_add, wr.swap)

    def _patch_recv_wr(self, wr: V.RecvWR) -> V.RecvWR:
        sge = wr.sge
        if sge is not None and sge.length and \
                sge.lkey not in self.lib.backup_lkeys:
            blkey = self.lib.lkey_map.get(sge.lkey)
            if blkey is None:
                raise V.VerbsError("backup MR not ready for lkey patch")
            sge = V.SGE(sge.addr, sge.length, blkey)
        return V.RecvWR(wr.wr_id, sge)

    def _peer_backup_rkey(self, rkey: int) -> int:
        if rkey == 0:
            return 0
        cached = self.lib.rkey_cache.get(rkey)
        if cached is not None:
            return cached
        peer_host = self.peer_route[0].split("/")[0]
        val = self.lib.kv.get(f"mr:{peer_host}:{rkey}")
        if val is None:
            raise V.VerbsError(f"no backup rkey mapping for {rkey}")
        self.lib.rkey_cache[rkey] = val
        self.lib.backup_rkeys.add(val)
        return val

    # ------------------------------------------------------------------
    # proactive failover (beyond-paper: straggler mitigation) ----------
    # ------------------------------------------------------------------
    def force_fallback(self) -> bool:
        """Administratively migrate traffic to the backup NIC while the
        default path is still alive — straggler mitigation for degraded
        links (the paper only switches on error WCs; the machinery is
        identical: same handshake, same counters). Returns False if a
        cycle is already in progress or the QP can't fall back."""
        if (self.send_state is not SendState.DEFAULT or self._in_handshake
                or self._awaiting_ack or not self.ready):
            return False
        self._error_t0 = self.lib.cluster.sim.now
        self._await_first_success = True
        self.initiate_fallback()
        return self.send_state is not SendState.FAILED

    # ------------------------------------------------------------------
    # fallback: State 1 -> State 2  (§4.3.2)
    # ------------------------------------------------------------------
    def on_default_error(self, wc: V.WC) -> None:
        """An error WC surfaced on the default path: enter fallback (or
        abort an in-progress recovery)."""
        if self.send_state in (SendState.FALLBACK, SendState.FAILED):
            return  # flush residue of an already-handled failure
        if self._awaiting_ack or self._in_handshake:
            return
        if self.send_state in (SendState.WAIT_SIGNALED, SendState.WAIT_DRAINED):
            # default path died again mid-recovery: abort recovery, move
            # withheld WRs back to the backup QP
            self._abort_recovery()
            return
        self._error_t0 = self.lib.cluster.sim.now
        self._await_first_success = True
        self.initiate_fallback()

    def _revive_ctrl(self) -> None:
        """Local repair after a BACKUP-NIC outage: an interface loss on
        the backup rail flushes the control QP (which lives there) to ERR
        even though this QP kept riding its default path. Re-arm it in
        place, PSN-continuous (sq/rq PSNs preserved across the reset), so
        a later fallback still has a control channel — production SHIFT
        re-creates backup resources through the management network when
        the NIC returns; the sim repairs lazily at the next fallback. If
        the backup rail is still down, the revived QP errors again on the
        first control send and the failure propagates (the true
        double-rail outage, which must NOT be masked)."""
        qp = self.ctrl
        if qp is None or qp.state is not V.QPState.ERR \
                or self.peer_backup is None:
            return
        sq_psn, rq_psn = qp.next_psn, qp.epsn
        b_gid, _b_qpn, c_qpn = self.peer_backup
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RESET))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.INIT))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTR, dest_gid=b_gid,
                                     dest_qp_num=c_qpn, rq_psn=rq_psn))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTS, sq_psn=sq_psn))
        for _ in range(self.lib.config.ctrl_recv_depth):
            self._post_ctrl_recv()

    def initiate_fallback(self) -> None:
        """State 1 -> 2 (§4.3.2): reset both QPs at the next cycle PSN,
        re-arm receives on the backup, send CTRL_NOTIFY with the recv
        counter. Refused (error propagated) if backup resources are not
        ready or atomics are in flight (retransmission-safe check)."""
        lib = self.lib
        if not self.ready:
            self._propagate_errors("backup resources not ready")
            return
        # retransmission-safe check: any outstanding atomics? (O(1) —
        # the counter is maintained at post/completion time)
        if lib.config.protect_atomics and self._n_atomics > 0:
            self._propagate_errors("atomic WR in flight (Trilemma §3.1)")
            return
        self._in_handshake = True
        lib.stats.fallbacks += 1
        self.flap_times.append(lib.cluster.sim.now)
        lib._emit_event("fallback", self)
        self.cycle += 1
        self._reset_default()
        self._reset_backup()
        self._revive_ctrl()
        # Drain before snapshotting counters / reposting: completed-but-
        # unpolled WCs (App. B.2's WC buffer) must count as progress.
        self._drain_cqs()
        self._repost_recvs(self.backup)
        self.recv_state = RecvState.FALLBACK
        self._awaiting_ack = True
        self._send_ctrl(CTRL_NOTIFY, self.n_recv_completed)

    def _on_peer_notify(self, counter: int) -> None:
        """Side B of the 2-way handshake (or the crossing case)."""
        if self.send_state is SendState.FAILED:
            return
        if self._awaiting_ack:
            # simultaneous fallback: the peer's NOTIFY doubles as our ACK
            self._on_peer_ack(counter)
            return
        if self.send_state in (SendState.WAIT_SIGNALED, SendState.WAIT_DRAINED):
            self._abort_recovery(reenter=False)
        if self.recv_state is RecvState.FALLBACK and self.send_state is SendState.FALLBACK:
            return  # duplicate notify
        self._error_t0 = self._error_t0 or self.lib.cluster.sim.now
        self._await_first_success = True
        self._in_handshake = True
        self.lib.stats.fallbacks += 1
        self.flap_times.append(self.lib.cluster.sim.now)
        self.lib._emit_event("fallback", self)
        self.cycle += 1
        self._reset_default()
        self._reset_backup()
        self._revive_ctrl()
        self._drain_cqs()
        self._repost_recvs(self.backup)
        self.recv_state = RecvState.FALLBACK
        self._send_ctrl(CTRL_ACK, self.n_recv_completed)
        self._resubmit_sends(counter)

    def _on_peer_ack(self, counter: int) -> None:
        if not self._awaiting_ack:
            return
        self._awaiting_ack = False
        self._resubmit_sends(counter)

    def _resubmit_sends(self, peer_recv_counter: int) -> None:
        """Exclude sends the peer's counter proves delivered (ACK-lost),
        synthesize their completions, resubmit the rest to the backup QP."""
        lib = self.lib
        self._awaiting_ack = False
        excess = _wrap_delta(peer_recv_counter, self.n_sent_twosided_completed)
        outstanding = [r for r in self.send_recs
                       if not r.completed and r.pending_wr is None]
        for rec in outstanding:
            if excess == 0:
                break
            # everything up to (and including) the next delivered two-sided
            # WR has landed in receiver memory — complete it locally
            self._rec_done(rec)
            rec.synthesized = True
            lib.stats.synthesized_wcs += 1
            if rec.two_sided:
                self.n_sent_twosided_completed += 1
                excess -= 1
            if rec.signaled:
                self._emit_app_wc(rec, V.WCStatus.SUCCESS)
        # WQE copy resubmission, in ring order
        n = 0
        for rec in self.send_recs:
            if rec.completed:
                continue
            if rec.pending_wr is not None:
                wr = rec.pending_wr
            else:
                wr = rec.cur_wqe.to_wr()
            wqe = self.backup.post_send_wqe(self._patch_wr(wr), ring=False)
            self._map_send(rec, wqe)
            n += 1
        self.backup.ring_sq_doorbell()
        lib.stats.resubmitted_sends += n
        self.send_state = SendState.FALLBACK
        self._in_handshake = False
        # synthesized completions have no physical WC to wake a push-mode
        # consumer — deliver them now (see ShiftCQ.flush_app)
        self.send_scq.flush_app()
        self._start_probing()

    def _repost_recvs(self, qp: V.QP) -> None:
        n = 0
        for rec in self.recv_fifo:
            if rec.completed:
                continue
            wr = rec.cur_rwqe.to_wr()
            if qp is self.backup:
                wr = self._patch_recv_wr(wr)
            rwqe = qp.post_recv_wqe(wr, ring=True)
            self._map_recv(rec, rwqe)
            n += 1
        self.lib.stats.resubmitted_recvs += n

    def _reset_default(self) -> None:
        psn = self._cycle_psn()
        qp = self.default
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RESET))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.INIT))
        V.ibv_modify_qp(qp, V.QPAttr(
            qp_state=V.QPState.RTR, dest_gid=self._attr_rtr.dest_gid,
            dest_qp_num=self._attr_rtr.dest_qp_num, rq_psn=psn))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTS, sq_psn=psn))

    def _reset_backup(self) -> None:
        psn = self._cycle_psn()
        qp = self.backup
        b_gid, b_qpn, _ = self.peer_backup
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RESET))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.INIT))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTR, dest_gid=b_gid,
                                     dest_qp_num=b_qpn, rq_psn=psn))
        V.ibv_modify_qp(qp, V.QPAttr(qp_state=V.QPState.RTS, sq_psn=psn))

    def _drain_cqs(self) -> None:
        self.send_scq.process_physical()
        if self.recv_scq is not self.send_scq:
            self.recv_scq.process_physical()

    # ------------------------------------------------------------------
    # recovery: State 2 -> 3 -> 4 -> 1  (§4.3.3)
    # ------------------------------------------------------------------
    def _probe_pace(self) -> float:
        """Current probe interval: base cadence scaled by the adaptive
        flap-history backoff (see ShiftConfig.paced_probe_interval)."""
        return self.lib.config.paced_probe_interval(
            self.flap_times, self.lib.cluster.sim.now)

    def _start_probing(self) -> None:
        if self._probing:
            return
        self._probing = True
        self.default.ctx._probe_cb[self.default.qpn] = self._on_probe_result
        self.lib.cluster.sim.schedule(self._probe_pace(), self._probe_tick)

    def _probe_tick(self) -> None:
        if self.send_state is not SendState.FALLBACK:
            self._probing = False
            return
        if self.default.state is not V.QPState.RTS:
            self._reset_default()
        wr = V.SendWR(wr_id=CTRL_WRID_BASE + next(_ctrl_seq),
                      opcode=V.Opcode.WRITE, sge=None, remote_addr=0, rkey=0,
                      send_flags=V.SEND_FLAG_SIGNALED)
        wqe = self.default.post_send_wqe(wr, ring=False)
        wqe.probe = True
        self._probe_outstanding = True
        self.default.ring_sq_doorbell()
        self.lib.stats.probes_sent += 1

    def _on_probe_result(self, wqe: V.SendWQE, status: V.WCStatus) -> None:
        if not self._probe_outstanding:
            return  # flush residue of an already-failed probe
        self._probe_outstanding = False
        if self.send_state is not SendState.FALLBACK:
            self._probing = False
            return
        if status is V.WCStatus.SUCCESS:
            self._probing = False
            self._begin_recovery()
        else:
            self.lib.stats.probe_failures += 1
            self._reset_default()
            self.lib.cluster.sim.schedule(self._probe_pace(),
                                          self._probe_tick)

    def _begin_recovery(self) -> None:
        self.send_state = SendState.WAIT_SIGNALED
        self._recover_sent = False
        self._fence_rec = None
        # if the backup queue is already drained there is nothing to fence
        if self._n_outstanding == 0:
            self.send_state = SendState.WAIT_DRAINED
            self._post_recover_ctrl()

    def _on_fence_complete(self) -> None:
        if self.send_state is SendState.WAIT_DRAINED and not self._recover_sent:
            self._post_recover_ctrl()

    def _post_recover_ctrl(self) -> None:
        self._recover_sent = True
        self._send_ctrl(CTRL_RECOVER, self.n_recv_completed)

    def _on_peer_recover(self, _counter: int) -> None:
        """Receive side of the switch-back: re-arm receives on the default
        QP before any post-recovery data can flow (fence semantics)."""
        if self.recv_state is RecvState.FALLBACK:
            # The peer's fence WC guarantees all its backup-path data has
            # been ACKed, i.e. our recv WCs are already in the backup CQ —
            # drain them so only truly-outstanding receives move back.
            self._drain_cqs()
            self._repost_recvs(self.default)
            self.recv_state = RecvState.DEFAULT
        self._send_ctrl(CTRL_RECOVER_ACK, self.n_recv_completed)

    def _on_peer_recover_ack(self, _counter: int) -> None:
        if self.send_state is not SendState.WAIT_DRAINED:
            return
        # release the withheld doorbell: State 4 -> State 1
        self.default.ring_sq_doorbell()
        self._withheld.clear()
        self._fence_rec = None
        self.send_state = SendState.DEFAULT
        self.lib.stats.recoveries += 1
        self.lib._emit_event("recovery", self)

    def _abort_recovery(self, reenter: bool = True) -> None:
        """Default path died again mid-recovery: withheld WRs (never
        doorbelled) move back to the backup QP; state returns to FALLBACK."""
        moved = self._withheld
        self._withheld = []
        self._fence_rec = None
        for rec in moved:
            if rec.completed:
                continue
            wr = rec.cur_wqe.to_wr()
            wqe = self.backup.post_send_wqe(self._patch_wr(wr), ring=False)
            self._map_send(rec, wqe)
        self.backup.ring_sq_doorbell()
        self.send_state = SendState.FALLBACK
        if reenter:
            self._start_probing()

    # ------------------------------------------------------------------
    # control channel
    # ------------------------------------------------------------------
    def _send_ctrl(self, msg_type: int, counter: int) -> None:
        if self.ctrl is None or self.ctrl.state is not V.QPState.RTS:
            self._propagate_errors("control QP unavailable")
            return
        wr = V.SendWR(wr_id=CTRL_WRID_BASE + next(_ctrl_seq),
                      opcode=V.Opcode.WRITE_IMM, sge=None,
                      remote_addr=0, rkey=0,
                      imm_data=_pack_imm(msg_type, counter),
                      send_flags=V.SEND_FLAG_SIGNALED)
        try:
            self.ctrl.post_send_wqe(wr, ring=True)
        except V.VerbsError:
            self._propagate_errors("control QP post failed")

    def _post_ctrl_recv(self) -> None:
        self.ctrl.post_recv_wqe(
            V.RecvWR(wr_id=CTRL_WRID_BASE + next(_ctrl_seq)), ring=True)

    def _on_ctrl_event(self, cq: V.CQ) -> None:
        V.ibv_req_notify_cq(cq)
        while True:
            wcs = cq.poll(16)
            if not wcs:
                break
            for wc in wcs:
                self._dispatch_ctrl(wc)

    def _dispatch_ctrl(self, wc: V.WC) -> None:
        if wc.is_error:
            # control path failure during fallback is unmaskable
            if self.send_state is not SendState.DEFAULT or \
                    self.recv_state is not RecvState.DEFAULT:
                self._propagate_errors("control path failure")
            return
        if wc.opcode is V.WCOpcode.RECV_RDMA_WITH_IMM:
            self._post_ctrl_recv()
            msg_type, counter = _unpack_imm(wc.imm_data)
            if msg_type == CTRL_NOTIFY:
                self._on_peer_notify(counter)
            elif msg_type == CTRL_ACK:
                self._on_peer_ack(counter)
            elif msg_type == CTRL_RECOVER:
                self._on_peer_recover(counter)
            elif msg_type == CTRL_RECOVER_ACK:
                self._on_peer_recover_ack(counter)

    # ------------------------------------------------------------------
    # WC routing hooks (called by ShiftLib._route_wc)
    # ------------------------------------------------------------------
    def on_send_wc(self, rec: _SendRec, wc: V.WC) -> None:
        """Route one physical send WC: error -> fallback/propagate;
        success -> retire the rec (and unsignaled predecessors), track
        fallback latency, emit the app WC, complete the recovery fence."""
        if wc.is_error:
            if wc.qp_num == self.default.qpn:
                self.on_default_error(wc)
            else:
                self._propagate_errors(f"backup path failure: {wc.status}")
            return
        if rec.completed:
            return
        # Ring-order completion coalescing: RC completes WQEs in order, so
        # a successful WC proves every EARLIER posted WQE on this stream
        # completed too. Retire unsignaled predecessors here (they never
        # get a WC of their own) — without this, unsignaled sends under
        # CQ moderation would pile up in send_recs/wqe_map forever and a
        # later fallback would needlessly resubmit proven-delivered work.
        # Signaled predecessors are untouched: their WCs route first
        # (CQ FIFO), so an uncompleted front here is always unsignaled.
        q = self.send_recs
        atomic_ops = V.ATOMIC_OPCODES
        while q and q[0] is not rec:
            front = q[0]
            if not front.completed:
                if front.pending_wr is not None or front.signaled:
                    break   # unposted (can't have completed) / owns a WC
                # unsignaled fronts are never in wqe_map (see _map_send),
                # so completion here is pure counter work
                front.completed = True
                self._n_outstanding -= 1
                if front.opcode in atomic_ops:
                    self._n_atomics -= 1
                if front.two_sided:
                    self.n_sent_twosided_completed += 1
            q.popleft()
        self._rec_done(rec)
        while self.send_recs and self.send_recs[0].completed:
            self.send_recs.popleft()
        if rec.two_sided:
            self.n_sent_twosided_completed += 1
        if self._await_first_success and self.send_state is SendState.FALLBACK:
            self._await_first_success = False
            if self._error_t0 is not None:
                self.lib.stats.fallback_latencies.append(
                    self.lib.cluster.sim.now - self._error_t0)
                self._error_t0 = None
        if rec.signaled:
            self._emit_app_wc(rec, V.WCStatus.SUCCESS, wc)
        if rec is self._fence_rec:
            self._on_fence_complete()

    def on_recv_wc(self, rec: _RecvRec, wc: V.WC) -> None:
        """Route one physical recv WC: bump the receive counter (the
        handshake's progress proof) and surface it app-side, renumbered
        to the app-facing QPN (opacity)."""
        if wc.is_error:
            # recv flush errors accompany a send-side error; fallback is
            # driven from the send side (footnote 3)
            return
        if rec.completed:
            return
        rec.completed = True
        self.n_recv_completed += 1
        while self.recv_fifo and self.recv_fifo[0].completed:
            self.recv_fifo.popleft()
        wc.qp_num = self.qpn  # opacity: the app sees its own QP number
        self.recv_scq.app_buffer.append(wc)

    def _emit_app_wc(self, rec: _SendRec, status: V.WCStatus,
                     wc: Optional[V.WC] = None) -> None:
        out = V.WC(wc.wr_id if wc else (rec.cur_wqe.wr_id if rec.cur_wqe
                                        else 0),
                   status, V._WC_OP_OF[rec.opcode],
                   byte_len=wc.byte_len if wc else (
                       rec.cur_wqe.length if rec.cur_wqe else 0),
                   qp_num=self.qpn)
        self.send_scq.app_buffer.append(out)

    # ------------------------------------------------------------------
    # introspection (scenario-engine invariant hooks)
    # ------------------------------------------------------------------
    def state_summary(self) -> Dict[str, object]:
        """Structured snapshot of the per-QP state machine — used by the
        campaign engine to assert quiescence invariants after a run."""
        return {
            "qpn": self.qpn,
            "send_state": self.send_state.name,
            "recv_state": self.recv_state.name,
            "cycle": self.cycle,
            "outstanding_sends": sum(1 for r in self.send_recs
                                     if not r.completed),
            "outstanding_recvs": sum(1 for r in self.recv_fifo
                                     if not r.completed),
            "withheld": len(self._withheld),
            "n_outstanding_counter": self._n_outstanding,
            "awaiting_ack": self._awaiting_ack,
            "in_handshake": self._in_handshake,
            "probing": self._probing,
            "n_recv_completed": self.n_recv_completed,
            "n_sent_twosided_completed": self.n_sent_twosided_completed,
            "fail_reason": self.fail_reason,
        }

    # ------------------------------------------------------------------
    # unmaskable failure
    # ------------------------------------------------------------------
    def _propagate_errors(self, reason: str) -> None:
        if self.send_state is SendState.FAILED:
            return
        self.send_state = SendState.FAILED
        self._in_handshake = False
        self.lib.stats.errors_propagated += 1
        self.fail_reason = reason
        self.lib._emit_event("failed", self)
        first = True
        for rec in self.send_recs:
            if rec.completed:
                continue
            self._rec_done(rec)
            self._emit_app_wc(rec, V.WCStatus.RETRY_EXC_ERR if first
                              else V.WCStatus.WR_FLUSH_ERR)
            first = False
        for rec in self.recv_fifo:
            if not rec.completed:
                rec.completed = True
                wc = V.WC(0, V.WCStatus.WR_FLUSH_ERR, V.WCOpcode.RECV,
                          qp_num=self.qpn)
                self.recv_scq.app_buffer.append(wc)
        self.send_scq.flush_app()
        if self.recv_scq is not self.send_scq:
            self.recv_scq.flush_app()


# ---------------------------------------------------------------------------
# ShiftLib — the drop-in library
# ---------------------------------------------------------------------------


class ShiftLib:
    """Drop-in replacement for StandardLib with SHIFT fault tolerance."""

    name = "shift"

    def __init__(self, cluster: Cluster, host: str,
                 kv: Optional[KVStore] = None,
                 config: Optional[ShiftConfig] = None):
        self.cluster = cluster
        self.host = host
        self.kv = kv if kv is not None else _shared_kv(cluster)
        self.config = config or ShiftConfig()
        self.stats = ShiftStats()
        self.actor = _ControlActor(self)
        self.lkey_map: Dict[int, int] = {}
        self.rkey_cache: Dict[int, int] = {}
        self.backup_lkeys: set = set()
        self.backup_rkeys: set = set()
        self.wqe_map: Dict[int, Tuple[_SendRec, ShiftQP]] = {}
        self.rwqe_map: Dict[int, Tuple[_RecvRec, ShiftQP]] = {}
        self.qpn_map: Dict[int, ShiftQP] = {}
        self.shift_qps: List[ShiftQP] = []
        # lifecycle observers: cb(event, qp) with event in
        # {"fallback", "recovery", "failed"} — scenario-engine hook
        self.event_listeners: List[Callable[[str, ShiftQP], None]] = []
        # optional fault-policy engine (repro.policy): consulted on
        # every lifecycle event, AFTER telemetry and listeners, so the
        # policy sees the same post-transition state observers do
        self.policy = None

    def add_event_listener(self,
                           cb: Callable[[str, "ShiftQP"], None]) -> None:
        """Observe lifecycle events: cb(event, qp) with event in
        {"fallback", "recovery", "failed"}."""
        self.event_listeners.append(cb)

    def attach_policy(self, engine) -> None:
        """Attach a :class:`repro.policy.FaultPolicyEngine`: its
        ``on_lifecycle(lib, event, qp)`` hook fires on every fallback /
        recovery / failed transition (the §4.4 decision point)."""
        self.policy = engine

    def _emit_event(self, event: str, qp: "ShiftQP") -> None:
        # feed the fabric's per-rail telemetry first: a fallback/recovery
        # changes which physical path the QP's traffic rides, so the
        # default rail's latency/busbw EWMAs are stale and must re-learn
        self.cluster.telemetry.note_lifecycle(event, qp.default.ctx.nic.index)
        for cb in list(self.event_listeners):
            cb(event, qp)
        if self.policy is not None:
            self.policy.on_lifecycle(self, event, qp)

    def invariant_snapshot(self) -> Dict[str, object]:
        """Library-wide state snapshot for post-run invariant checks."""
        return {
            "host": self.host,
            "stats": self.stats.as_dict(),
            "payload_bytes_held": self.stats.payload_bytes_held,
            "qps": [qp.state_summary() for qp in self.shift_qps],
        }

    # -- control verbs (recorded + shadowed) --------------------------------
    def open_device(self, nic: str) -> ShiftContext:
        """ibv_open_device + shadow open of the policy-chosen backup NIC."""
        return ShiftContext(self, V.ibv_open_device(self.cluster, self.host, nic))

    def alloc_pd(self, sctx: ShiftContext) -> ShiftPD:
        """ibv_alloc_pd + shadow backup PD."""
        return ShiftPD(self, sctx)

    def reg_mr(self, spd: ShiftPD, buf: np.ndarray) -> ShiftMR:
        """ibv_reg_mr + shadow backup registration (same VA, new keys)."""
        return ShiftMR(self, spd, buf)

    def create_cq(self, sctx: ShiftContext, depth: int) -> ShiftCQ:
        """ibv_create_cq + shadow backup CQ behind one app-facing CQ."""
        return ShiftCQ(self, sctx, depth)

    def create_qp(self, spd: ShiftPD, init: V.QPInitAttr) -> ShiftQP:
        """ibv_create_qp + shadow backup data/control QPs."""
        return ShiftQP(self, spd, init)

    def modify_qp(self, sqp: ShiftQP, attr: V.QPAttr) -> None:
        """ibv_modify_qp on the app-facing SHIFT QP."""
        sqp.modify(attr)

    def query_qp(self, sqp: ShiftQP) -> V.QPAttr:
        """ibv_query_qp of the default QP (opacity)."""
        return V.ibv_query_qp(sqp.default)

    # -- data verbs ----------------------------------------------------------
    def post_send(self, sqp: ShiftQP, wr: V.SendWR) -> None:
        """ibv_post_send through the SHIFT state machine."""
        sqp.post_send(wr)

    def post_send_chain(self, sqp: ShiftQP, wrs: Sequence[V.SendWR]) -> None:
        """Chained ibv_post_send (one doorbell) through SHIFT."""
        sqp.post_send_chain(wrs)

    def post_recv(self, sqp: ShiftQP, wr: V.RecvWR) -> None:
        """ibv_post_recv through the SHIFT receive state."""
        sqp.post_recv(wr)

    def poll_cq(self, scq: ShiftCQ, n: int) -> List[V.WC]:
        """ibv_poll_cq over the routed app-facing WC buffer."""
        return scq.poll(n)

    def route_of(self, sqp: ShiftQP) -> Tuple[str, int]:
        """(gid, qpn) of the DEFAULT path — what peers connect to."""
        return sqp.default.ctx.nic.gid, sqp.default.qpn

    def connect(self, sqp: ShiftQP, peer_gid: str, peer_qpn: int) -> None:
        """INIT/RTR/RTS toward a peer; backup wiring happens in the
        background off the KV store."""
        self.modify_qp(sqp, V.QPAttr(qp_state=V.QPState.INIT))
        self.modify_qp(sqp, V.QPAttr(qp_state=V.QPState.RTR,
                                     dest_gid=peer_gid, dest_qp_num=peer_qpn,
                                     rq_psn=0))
        self.modify_qp(sqp, V.QPAttr(qp_state=V.QPState.RTS, sq_psn=0))

    def settle(self, duration: float = 0.1) -> None:
        """Run the virtual clock so background control work completes."""
        self.cluster.sim.run(until=self.cluster.sim.now + duration)

    # -- WC routing ------------------------------------------------------
    def _route_wc(self, wc: V.WC, scq: ShiftCQ) -> None:
        rwqe = getattr(wc, "_rwqe", None)
        if rwqe is not None:
            entry = self.rwqe_map.pop(id(rwqe), None)
            if entry is None:
                return  # stale ring entry from a previous cycle
            rec, sqp = entry
            sqp.on_recv_wc(rec, wc)
            return
        wqe = getattr(wc, "_wqe", None)
        if wqe is not None:
            entry = self.wqe_map.pop(id(wqe), None)
            if entry is None:
                if wc.is_error:
                    sqp = self.qpn_map.get(wc.qp_num)
                    if sqp is not None:
                        # error on a WQE we don't track (unsignaled sends
                        # are never mapped; flushed-twice residue) still
                        # signals path failure — on either NIC
                        if wc.qp_num == sqp.default.qpn:
                            sqp.on_default_error(wc)
                        else:
                            sqp._propagate_errors(
                                f"backup path failure: {wc.status}")
                return
            rec, sqp = entry
            if wc.is_error:
                # keep the mapping: the rec is outstanding until resubmitted
                self.wqe_map[id(wqe)] = (rec, sqp)
            sqp.on_send_wc(rec, wc)
            return
        # WC without refs: synthesized/flush recv errors on an errored QP
        sqp = self.qpn_map.get(wc.qp_num)
        if sqp is not None and wc.is_error:
            if wc.qp_num == sqp.default.qpn:
                sqp.on_default_error(wc)


_cluster_kv: Dict[int, KVStore] = {}


def _shared_kv(cluster: Cluster) -> KVStore:
    """One management-network KV store per cluster (the paper's Redis)."""
    kv = _cluster_kv.get(id(cluster))
    if kv is None:
        kv = KVStore(cluster.sim)
        _cluster_kv[id(cluster)] = kv
    return kv
