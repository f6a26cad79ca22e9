"""Per-rail rank endpoint: device/PD/MRs/CQ + a QP per peer.

One :class:`RankEndpoint` is one rank's presence on ONE rail (channel):
it owns that rail's NIC context, staging/source FIFOs and completion
queue. A multi-rail world instantiates ``channels`` of these per rank
(see ``repro.collectives.channel``); the single-rail world is simply the
one-channel special case.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import verbs as V
from ..core.shift import ShiftCQ, ShiftLib

#: notify sequence numbers travel in the low 28 bits of imm_data
IMM_SEQ_MASK = 0x0FFFFFFF


class _ListenedCQ:
    """StandardLib CQ with a completion-channel push listener (the ShiftCQ
    equivalent of app_listener for the baseline library)."""

    def __init__(self, ctx: V.Context, depth: int):
        self.channel = V.ibv_create_comp_channel(ctx)
        self.cq = V.ibv_create_cq(ctx, depth, self.channel)
        self.channel.on_event(self._on_event)
        V.ibv_req_notify_cq(self.cq)
        self.app_listener: Optional[Callable[[List[V.WC]], None]] = None

    def _on_event(self, cq: V.CQ) -> None:
        V.ibv_req_notify_cq(cq)
        self.drain()

    def drain(self) -> None:
        out = []
        while True:
            wcs = self.cq.poll(64)
            if not wcs:
                break
            out.extend(wcs)
        if out and self.app_listener is not None:
            self.app_listener(out)


class RankEndpoint:
    """One collective rank on one rail: device/PD/MRs/CQ + a QP per peer."""

    def __init__(self, channel, rank: int, lib, nic: str):
        self.channel = channel
        self.world = channel.world
        self.rank = rank
        self.lib = lib
        self.nic = nic
        world = self.world
        self.ctx = lib.open_device(nic)
        self.pd = lib.alloc_pd(self.ctx)
        n = world.n_ranks
        slot = world.max_chunk_bytes
        self.K = world.src_slots
        # Inbound staging: per peer, K slots addressed by message sequence
        # (slot = seq % K). The staging depth EQUALS the sender's outbound
        # FIFO depth, so the at-most-K in-flight messages to a peer always
        # occupy distinct slots — credit-based flow control that stays
        # correct even when a coalesced segment delivers a whole burst at
        # one virtual instant (the old 2-slot parity scheme relied on
        # inter-message event spacing and broke under doorbell coalescing).
        self.staging = np.zeros(n * self.K * slot, dtype=np.uint8)
        self.staging_mr = lib.reg_mr(self.pd, self.staging)
        # Outbound FIFO: per peer, K slots. A slot may only be reused once
        # the send that references it has COMPLETED (ACKed or synthesized):
        # payloads are DMA-read at (re)transmit time, so reusing the slot
        # of an unACKed send would corrupt a post-failover retransmission.
        # This mirrors NCCL's completion-gated FIFO reuse.
        self.src = np.zeros(n * self.K * slot, dtype=np.uint8)
        self.src_mr = lib.reg_mr(self.pd, self.src)
        self.send_completed: Dict[int, int] = {}
        self.pending_sends: Dict[int, List] = {}
        if isinstance(lib, ShiftLib):
            self.cq: ShiftCQ = lib.create_cq(self.ctx, world.cq_depth)
            self._listened = None
        else:
            self._listened = _ListenedCQ(self.ctx, world.cq_depth)
            self.cq = self._listened.cq
        self.qps: Dict[int, object] = {}       # peer rank -> QP
        self.qp_of_qpn: Dict[int, int] = {}    # qpn -> peer rank
        self.send_seq: Dict[int, int] = {}     # posted to the QP
        self.enqueue_seq: Dict[int, int] = {}  # accepted by send_chunk
        self.recv_seq: Dict[int, int] = {}
        # Bounded notify bookkeeping: instead of remembering every imm
        # value ever seen (which grows linearly in message count and leaks
        # across a long campaign), track only the seqs SKIPPED past by an
        # out-of-order resync, per peer. An arrival behind the in-order
        # watermark is a late skipped notify if it is in this set, a
        # duplicate otherwise. In a clean run the sets stay empty.
        self.missing_notifies: Dict[int, set] = {}
        self.errors: List[V.WC] = []

    # -- wiring ---------------------------------------------------------
    def make_qp(self, peer: int):
        """Create (and index) this rank's QP toward ``peer`` on this rail.

        ShiftLib and StandardLib share the create_qp signature — the
        SHIFT magic is inside the returned QP object, not the call."""
        qp = self.lib.create_qp(self.pd, V.QPInitAttr(
            send_cq=self.cq, recv_cq=self.cq,
            cap=V.QPCap(self.world.qp_depth, self.world.qp_depth)))
        self.qps[peer] = qp
        self.qp_of_qpn[qp.qpn] = peer
        self.send_seq[peer] = 0
        self.enqueue_seq[peer] = 0
        self.recv_seq[peer] = 0
        self.missing_notifies[peer] = set()
        self.send_completed[peer] = 0
        self.pending_sends[peer] = []
        return qp

    def attach_listener(self, fn: Callable[[List[V.WC]], None]) -> None:
        """Register the push-mode completion consumer for this rail's CQ
        (the channel's WC router)."""
        if isinstance(self.lib, ShiftLib):
            self.cq.app_listener = fn
        else:
            self._listened.app_listener = fn

    # -- staging layout ---------------------------------------------------
    def staging_slot_addr(self, peer: int, seq: int) -> int:
        """Registered address of the inbound staging slot for message
        ``seq`` from ``peer`` (slot = seq % K, credit-aligned)."""
        slot = self.world.max_chunk_bytes
        off = (peer * self.K + seq % self.K) * slot
        return self.staging_mr.addr + off

    def staging_slot_view(self, peer: int, seq: int, nbytes: int) -> np.ndarray:
        """View of the first ``nbytes`` of that staging slot (the
        collective reads delivered chunk payloads through this)."""
        slot = self.world.max_chunk_bytes
        off = (peer * self.K + seq % self.K) * slot
        return self.staging[off:off + nbytes]

    # -- data-plane helpers -------------------------------------------------
    def post_recv_notify(self, peer: int) -> None:
        """Pre-post one notify receive on the QP toward ``peer``."""
        self.lib.post_recv(self.qps[peer], V.RecvWR(wr_id=peer))

    def send_chunk(self, peer: int, payload: np.ndarray) -> int:
        """NCCL-Simple message: bulk WRITE (unsignaled) into the peer's
        staging slot ``send_seq % K`` + WRITE_IMM notification (signaled).
        If all outbound FIFO slots for this peer are in flight, the
        payload is held until a completion frees one (completion-gated
        reuse). Returns the message's logical sequence number (the value
        the peer's matching notify will carry) — posting is FIFO, so the
        enqueue order equals the eventual post order.

        Ownership rule (zero-copy): a chunk handed to ``send_chunk`` must
        stay byte-stable until it is copied into the outbound FIFO slot at
        post time. The collectives guarantee this causally — any later
        write to the same flat range is triggered by a notify that is
        downstream of THIS chunk's delivery, so a still-pending (unposted)
        send can never be overwritten. A held view therefore suffices; no
        defensive copy."""
        seq = self.enqueue_seq[peer]
        self.enqueue_seq[peer] = seq + 1
        raw = payload.view(np.uint8).ravel()
        if self.send_seq[peer] - self.send_completed[peer] >= self.K:
            self.pending_sends[peer].append(raw)
            return seq
        self._post_chunk(peer, raw)
        return seq

    def _post_chunk(self, peer: int, raw: np.ndarray) -> None:
        nbytes = raw.nbytes
        seq = self.send_seq[peer]
        self.send_seq[peer] = seq + 1
        src_off = (peer * self.K + seq % self.K) * self.world.max_chunk_bytes
        self.src[src_off:src_off + nbytes] = raw
        remote = self.channel.endpoints[peer]
        remote_addr = remote.staging_slot_addr(self.rank, seq)
        qp = self.qps[peer]
        if nbytes:
            self.lib.post_send(qp, V.SendWR(
                wr_id=seq, opcode=V.Opcode.WRITE,
                sge=V.SGE(self.src_mr.addr + src_off, nbytes, self.src_mr.lkey),
                remote_addr=remote_addr, rkey=remote.staging_mr.rkey,
                send_flags=0))
        self.lib.post_send(qp, V.SendWR(
            wr_id=seq, opcode=V.Opcode.WRITE_IMM, sge=None,
            remote_addr=0, rkey=remote.staging_mr.rkey,
            imm_data=seq & IMM_SEQ_MASK,
            send_flags=V.SEND_FLAG_SIGNALED))

    def on_send_complete(self, peer: int) -> None:
        """One outbound chunk to ``peer`` completed: free its FIFO slot
        and post the oldest held chunk, if any (completion-gated reuse)."""
        self.send_completed[peer] += 1
        if self.pending_sends[peer] and (
                self.send_seq[peer] - self.send_completed[peer] < self.K):
            self._post_chunk(peer, self.pending_sends[peer].pop(0))
