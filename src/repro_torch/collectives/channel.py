"""Channels: one per-rail communicator mesh + the adaptive chunk scheduler.

A :class:`Channel` is a complete QP mesh over ONE rail of the cluster:
every rank opens the rail's NIC, wires a QP to every peer, and routes
that rail's completions. ``JcclWorld`` owns ``N = channels`` of these and
stripes collective traffic across them through a
:class:`ChannelScheduler`.

The scheduler is *telemetry-driven* (docs/scheduler.md has the full
policy with a worked 4-rail example):

* chunk assignment is weighted proportionally to each rail's **measured
  busbw** (per-completion ``bytes/latency`` EWMA from
  :class:`repro.core.fabric.RailTelemetry`) rather than backlog count,
  so a degraded-but-alive rail gets a proportional share instead of
  being either fully loaded or fully dark;
* a slow-but-healthy rail is **demoted** (straggler routing) when its
  completion-latency EWMA exceeds a configurable multiple of the
  leave-one-out median across rails — no health transition required;
* a rail returning from DOWN/DEGRADED is **re-admitted along a ramp**
  instead of a cliff, so a freshly recovered path is not instantly
  flooded with a backlog of home traffic.

Health is per (rank, peer) link, not per channel globally: a rail that
died for one host pair can still carry other pairs' traffic.  All
scheduler inputs are virtual-clock-driven, so same-seed runs make
identical choices (the campaign fingerprint covers them).

Latency classes (tail-latency SLO scheduling): every chunk carries a
priority class (``latency_critical`` / ``bulk`` / ``background``) and
enters a per-(rank, peer) **dispatch queue** ordered
earliest-deadline-first (deadline = enqueue time + the class's budget,
size and FIFO order as tie-breaks). Chunks are handed to the wire only
while the endpoint's outbound FIFO has free credit, so a small
latency-critical collective's chunks overtake megabytes of queued bulk
chunks — while a bulk chunk that has waited out its (finite) deadline
budget beats even fresh critical chunks, which is what makes the policy
starvation-free by construction. Reordering happens strictly ABOVE
sequence-number assignment (``RankEndpoint.send_chunk`` is FIFO and the
seq addresses the receiver's staging slot), so exactly-once delivery and
notification ordering are untouched.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from statistics import median
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import verbs as V
from ..core.shift import RecvState, SendState, ShiftQP

from .endpoint import IMM_SEQ_MASK, RankEndpoint

#: link-health vocabulary, best to worst
HEALTH_OK = "ok"
HEALTH_DEGRADED = "degraded"
HEALTH_DOWN = "down"

#: latency classes, most to least urgent. ``latency_critical`` is for
#: small blocking traffic on the serving hot path (decode-step gathers,
#: MoE all-to-alls), ``bulk`` for gradient buckets and anything unmarked,
#: ``background`` for checkpoint replication that must yield to all else.
PRIORITY_CLASSES = ("latency_critical", "bulk", "background")


def _qp_health(qp) -> str:
    """Map a QP's SHIFT/verbs state onto the link-health vocabulary."""
    if isinstance(qp, ShiftQP):
        if qp.send_state is SendState.FAILED:
            return HEALTH_DOWN
        if (qp.send_state is not SendState.DEFAULT
                or qp.recv_state is not RecvState.DEFAULT):
            return HEALTH_DEGRADED
        return HEALTH_OK
    if qp.state is V.QPState.ERR:
        return HEALTH_DOWN
    return HEALTH_OK


class Channel:
    """One rail's endpoint mesh + notify routing and per-rail counters."""

    def __init__(self, world, index: int, libs: Sequence,
                 nic_names: Sequence[str]):
        self.world = world
        self.index = index
        self.nic_names = list(nic_names)
        # rail index this channel's default path rides (telemetry key),
        # plus its tier ("rail" intra-pod / "dcn" cross-pod) and link
        # bandwidth — the scheduler's prior before telemetry exists
        nic0 = world.cluster.nic_by_gid[f"{libs[0].host}/{nic_names[0]}"]
        self.rail = nic0.index
        self.tier = nic0.tier
        self.link_bandwidth = nic0.link.bandwidth if nic0.link else 0.0
        self.endpoints: List[RankEndpoint] = [
            RankEndpoint(self, r, lib, nic_names[r])
            for r, lib in enumerate(libs)]
        n = len(self.endpoints)
        # full QP mesh + app-level OOB route exchange
        for i, j in itertools.combinations(range(n), 2):
            qi, qj = self.endpoints[i].make_qp(j), self.endpoints[j].make_qp(i)
            gi, ni = self.endpoints[i].lib.route_of(qi)
            gj, nj = self.endpoints[j].lib.route_of(qj)
            self.endpoints[i].lib.connect(qi, gj, nj)
            self.endpoints[j].lib.connect(qj, gi, ni)
        for ep in self.endpoints:
            ep.attach_listener(lambda wcs, ep=ep: self._on_wcs(ep, wcs))
            for peer in ep.qps:
                for _ in range(world.recv_prepost):
                    ep.post_recv_notify(peer)
        # per-rail counters (world-level totals are sums over channels)
        self.total_notifies = 0
        self.order_violations = 0
        self.duplicate_notifies = 0
        self.chunks_delivered = 0
        self.bytes_sent = 0
        # deadline-ordered dispatch queues, one per (rank, peer) flow:
        # entries are (deadline, nbytes, enqueue_order, payload, tag,
        # cid, class). Chunks reorder HERE, before any sequence number
        # exists; once handed to send_chunk the flow is strictly FIFO.
        self._dispatchq: Dict[Tuple[int, int], List[tuple]] = {}
        self._enq_order = 0
        #: chunks actually posted to the wire, by latency class
        self.class_dispatched: Dict[str, int] = {
            k: 0 for k in PRIORITY_CLASSES}
        #: dispatches that jumped ahead of an earlier-enqueued chunk
        #: still waiting in the same flow's queue (priority in action)
        self.priority_overtakes = 0

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def send(self, rank: int, peer: int, payload, tag,
             cid: Optional[int] = None, klass: str = "bulk") -> None:
        """Queue one tagged chunk rank -> peer on this rail. The chunk
        enters the flow's deadline-ordered dispatch queue and is posted
        the moment outbound credit allows; the ``(cid, tag)`` pair is
        returned to the owning collective when the matching notify lands
        (the world keys it by this channel + the FIFO sequence number;
        the cid routes it to the right live collective, ``None`` for raw
        streams). ``klass`` is the chunk's latency class."""
        deadline, size = self.world.scheduler.dispatch_key(
            klass, payload.nbytes)
        q = self._dispatchq.setdefault((rank, peer), [])
        self._enq_order += 1
        heapq.heappush(q, (deadline, size, self._enq_order,
                           payload, tag, cid, klass))
        self._drain(rank, peer)

    def _drain(self, rank: int, peer: int) -> None:
        """Post the flow's best queued chunks while the endpoint's
        outbound FIFO has free credit. Called at enqueue and whenever a
        send completion frees a slot — so the queue order is re-evaluated
        at every dispatch opportunity (a critical chunk enqueued after a
        pile of bulk chunks still goes out next)."""
        q = self._dispatchq.get((rank, peer))
        if not q:
            return
        ep = self.endpoints[rank]
        while q and ep.send_seq[peer] - ep.send_completed[peer] < ep.K:
            _dl, _sz, order, payload, tag, cid, klass = heapq.heappop(q)
            if q and any(e[2] < order for e in q):
                self.priority_overtakes += 1
            seq = ep.send_chunk(peer, payload)
            self.world._tags[(self.index, peer, rank, seq)] = (cid, tag)
            self.bytes_sent += payload.nbytes
            self.class_dispatched[klass] += 1

    def purge(self, cid: Optional[int]) -> int:
        """Drop a retired collective's queued (never-posted) chunks from
        every dispatch queue; returns how many were dropped. Safe against
        double-decrement by construction: purged chunks never reached the
        wire, so no tag entry exists for them and ``note_delivered`` can
        never fire — ``ChannelScheduler.retire`` already reconciled their
        in-flight accounting in one step."""
        dropped = 0
        for key, q in self._dispatchq.items():
            keep = [e for e in q if e[5] != cid]
            if len(keep) != len(q):
                dropped += len(q) - len(keep)
                heapq.heapify(keep)
                self._dispatchq[key] = keep
        return dropped

    def queued_chunks(self, cid: object = "*") -> int:
        """Number of enqueued-but-not-yet-posted chunks across this
        channel's dispatch queues (``cid`` filters to one collective;
        the default counts everything)."""
        return sum(1 for q in self._dispatchq.values() for e in q
                   if cid == "*" or e[5] == cid)

    def link_state(self, rank: int, peer: int) -> str:
        """Worst-case health of the rank<->peer link on this rail."""
        worst = HEALTH_OK
        for a, b in ((rank, peer), (peer, rank)):
            qp = self.endpoints[a].qps.get(b)
            if qp is None:
                continue
            h = _qp_health(qp)
            if h == HEALTH_DOWN:
                return HEALTH_DOWN
            if h == HEALTH_DEGRADED:
                worst = HEALTH_DEGRADED
        return worst

    # ------------------------------------------------------------------
    # completion routing
    # ------------------------------------------------------------------
    def _on_wcs(self, ep: RankEndpoint, wcs: List[V.WC]) -> None:
        world = self.world
        for wc in wcs:
            if wc.is_error:
                ep.errors.append(wc)
                world.failed = True
                world.fail_wc = wc
                continue
            if wc.opcode is V.WCOpcode.RDMA_WRITE:
                peer = ep.qp_of_qpn.get(wc.qp_num)
                if peer is not None:
                    ep.on_send_complete(peer)
                    # the completion freed one outbound credit: dispatch
                    # the flow's best queued chunk (deadline order)
                    self._drain(ep.rank, peer)
                continue
            if wc.opcode is V.WCOpcode.RECV_RDMA_WITH_IMM:
                peer = ep.qp_of_qpn.get(wc.qp_num)
                if peer is None:
                    continue
                seq = ep.recv_seq[peer]
                self.total_notifies += 1
                ep.post_recv_notify(peer)
                # notification-ordering invariant (what SHIFT preserves):
                # each fault counts once and is DROPPED — a duplicate
                # doesn't consume a sequence slot, a skip resyncs
                # expectation past the gap; the collective never sees a
                # bad notify (it stalls loudly instead of corrupting data)
                if wc.imm_data != seq & IMM_SEQ_MASK:
                    self._notify_anomaly(ep, peer, seq, wc.imm_data)
                    continue
                ep.recv_seq[peer] = seq + 1
                world._dispatch_notify(self, ep, peer, seq)

    def _notify_anomaly(self, ep: RankEndpoint, peer: int, seq: int,
                        imm: int) -> None:
        """Classify a mismatched notify with BOUNDED bookkeeping: only
        skipped-past seqs are remembered (see ``missing_notifies``), not
        every imm ever delivered."""
        delta = (imm - seq) & IMM_SEQ_MASK
        missing = ep.missing_notifies[peer]
        if delta >= 1 << 27:        # behind the in-order watermark
            if imm in missing:      # a skipped notify arriving late
                missing.discard(imm)
                self.order_violations += 1
            else:                   # already consumed once
                self.duplicate_notifies += 1
        else:                       # ahead: a gap was skipped — resync
            self.order_violations += 1
            if delta <= 4096:       # remember the gap (bounded by faults)
                for s in range(seq, seq + delta):
                    missing.add(s & IMM_SEQ_MASK)
                    # the skipped chunks will never dispatch: reclaim
                    # their tags and scheduler backlog so later picks
                    # aren't biased by phantom in-flight chunks
                    self.world._drop_tag(self, ep.rank, peer, s)
            ep.recv_seq[peer] = seq + delta + 1
        assert not self.world.strict_order, (
            f"rank {ep.rank} ch{self.index}: notify out of order "
            f"({imm} != {seq & IMM_SEQ_MASK})")

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Per-channel counters for campaign reports and invariants."""
        sched = self.world.scheduler
        return {
            "channel": self.index,
            "rail": self.rail,
            "tier": self.tier,
            "nics": sorted(set(self.nic_names)),
            "chunks_assigned": sched.assigned[self.index],
            "chunks_delivered": self.chunks_delivered,
            "chunks_queued": self.queued_chunks(),
            "bytes_sent": self.bytes_sent,
            "total_notifies": self.total_notifies,
            "order_violations": self.order_violations,
            "duplicate_notifies": self.duplicate_notifies,
            "class_dispatched": dict(self.class_dispatched),
            "priority_overtakes": self.priority_overtakes,
        }


@dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for the adaptive :class:`ChannelScheduler`.

    Pass via ``JcclWorld(..., sched=SchedulerConfig(...))`` (or
    ``build_world(sched=...)``).  Every parameter is documented in
    docs/scheduler.md with a worked 4-rail example.
    """

    #: weight of a DEGRADED channel (its SHIFT endpoints ride the backup
    #: rail, which may be shared) relative to a mean healthy channel
    degraded_weight: float = 0.25
    #: demote a healthy rail whose completion-latency EWMA exceeds this
    #: multiple of the leave-one-out median across the other rails
    straggler_factor: float = 3.0
    #: weight cap applied to a demoted straggler rail — deliberately
    #: non-zero so completions keep flowing and recovery is observable
    straggler_weight: float = 0.1
    #: minimum latency samples (per rail) before straggler judgments
    straggler_min_samples: int = 16
    #: re-admission ramp length (virtual seconds) after a channel
    #: returns to OK from DOWN/DEGRADED
    ramp_time: float = 20e-3
    #: weight multiplier at the start of the re-admission ramp
    ramp_floor: float = 0.1
    #: how many chunks past its proportional share a home channel may be
    #: before the pick resteers (home-stickiness hysteresis)
    share_slack: float = 2.0
    #: decay applied to the recent-assignment counters once per closed
    #: telemetry window (bounds the scheduler's memory of old traffic)
    decay: float = 0.5
    #: backlog-stall guard: resteer a chunk off its home channel when
    #: OTHER collectives' undrained backlog there exceeds this multiple
    #: of their mean backlog on the remaining usable channels (+1
    #: cushion). This is how a STALLED sibling's chunks stop dragging
    #: new collectives onto the same stuck rail: the backlog is
    #: per-collective attributed (the picker's own in-flight chunks are
    #: excluded from the signal) and reconciled at retire, so the
    #: penalty lifts the moment the stalled op is reaped. Deliberately
    #: conservative — healthy overlap never hits it.
    backlog_factor: float = 8.0
    #: enable latency-class dispatch ordering (earliest deadline first,
    #: size then FIFO as tie-breaks). False degrades every flow to pure
    #: FIFO — the no-priority baseline the perf suite measures against.
    classful: bool = True
    #: deadline budget (virtual seconds past enqueue) per class. A
    #: chunk's queue position is its deadline, so these encode BOTH the
    #: priority order and the starvation bound: a bulk chunk waits at
    #: most ``deadline_bulk`` behind an arbitrary stream of critical
    #: chunks before its deadline beats theirs. latency_critical = 0
    #: means "due immediately".
    deadline_critical: float = 0.0
    deadline_bulk: float = 2e-3
    deadline_background: float = 20e-3
    #: adapt per-rail wire-chunk size from telemetry: a rail whose
    #: measured busbw EWMA trails the best rail gets proportionally
    #: smaller chunks (power-of-two divisors), bounding per-chunk
    #: latency skew on degraded rails. Applies only to pure
    #: data-movement collectives (broadcast, all-to-all) — allreduce
    #: chunk bounds are pinned by the byte-identity alignment contract
    #: (``JcclWorld.aligned_bucket_bounds``).
    adapt_chunk_size: bool = True
    #: floor on the adapted chunk size as a fraction of
    #: ``max_chunk_bytes`` (divisor cap: 1/frac, power of two)
    chunk_floor_frac: float = 0.125


class ChannelScheduler:
    """Telemetry-driven weighted chunk-to-channel assignment.

    Each pick computes a weight per channel for the (rank, peer) pair —
    measured-busbw share for healthy rails, ``degraded_weight`` for
    FALLBACK rails, 0 for dead ones, scaled by straggler demotion and
    the recovery ramp — then honours the chunk's *home* channel unless
    the home is over its proportional share by more than ``share_slack``
    chunks (or unusable), in which case the chunk is resteered to the
    most-behind channel (weighted deficit).  Share accounting uses
    window-decayed counters so the policy reacts to the recent past,
    not the whole run (a recovered rail is not flooded to make up for
    its dark period).

    Deterministic: every input (QP state, telemetry EWMAs, window
    rolls) is virtual-clock-driven, so same-seed runs make identical
    choices (the campaign fingerprint covers them).
    """

    def __init__(self, world, config: Optional[SchedulerConfig] = None):
        self.world = world
        self.cfg = config or SchedulerConfig()
        self.n = len(world.channels)
        self.assigned: List[int] = [0] * self.n
        self.inflight: List[int] = [0] * self.n
        # per-collective in-flight attribution: cid -> per-channel counts
        # (None = raw streams). A stalled/aborted collective's backlog is
        # reconciled out of the global counters by retire(), so a dead
        # op on a degraded rail cannot bias sibling collectives' view of
        # that rail's backlog forever.
        self.inflight_by_cid: Dict[Optional[int], List[int]] = {}
        self.resteered = 0
        # window-decayed recent-assignment counters (share accounting)
        self.recent: List[float] = [0.0] * self.n
        # introspection: last computed weights + straggler flags
        self.last_weights: List[float] = [1.0 / self.n] * self.n
        self.demoted: List[bool] = [False] * self.n
        # policy-engine actuation state (repro.policy): forced demotion
        # ORs into the organic straggler flag; exclusion zeroes the
        # channel's weight outright (shrink-world continue). Both are
        # cleared by readmit(), which re-enters through the standard
        # recovery ramp instead of jumping back to full weight.
        self.policy_demoted: List[bool] = [False] * self.n
        self.excluded: List[bool] = [False] * self.n
        # observer for demote/readmit transitions (audit trail):
        # cb(action, channel) with action in {"demote", "readmit"}
        self.policy_hook: Optional[Callable[[str, int], None]] = None
        self._prev_demoted: List[bool] = [False] * self.n
        self._ramp_start: List[Optional[float]] = [None] * self.n
        # channel-level impairment latch: set whenever ANY pair observes
        # the channel off OK, cleared (starting ONE ramp) by the first
        # pick that sees it healthy again — so later pairs' first
        # post-recovery picks don't each restart the channel-wide ramp
        self._impaired: List[bool] = [False] * self.n
        self._win_seq = world.cluster.telemetry.window_seq
        # heterogeneous-fabric awareness: on a multi-tier cluster the
        # scheduler seeds weights/chunk sizes from link-bandwidth priors
        # (a DCN channel with no telemetry yet must NOT default to a
        # mean-rail share) and compares stragglers within a tier only.
        # Single-tier clusters keep the historical behavior exactly.
        self._multi_tier = any(ch.tier == "dcn" for ch in world.channels)
        self._rank_pods: Optional[List[int]] = None

    def _pod_of(self, rank: int) -> int:
        """Pod membership of ``rank`` (cached from the world's libs)."""
        if self._rank_pods is None:
            self._rank_pods = [
                self.world.cluster.hosts[lib.host].pod
                for lib in self.world.libs]
        return self._rank_pods[rank]

    # ------------------------------------------------------------------
    # latency classes
    # ------------------------------------------------------------------
    def dispatch_key(self, klass: str, nbytes: int) -> Tuple[float, int]:
        """(deadline, size) sort key for one chunk's dispatch-queue
        position: deadline = now + the class's budget (earliest first),
        chunk size breaks deadline ties (small chunks first — a tiny
        critical gather never waits behind an equally-due megabyte), and
        the caller's FIFO counter breaks the rest. With ``classful``
        off every chunk gets the same key — pure FIFO, the no-priority
        baseline."""
        cfg = self.cfg
        if not cfg.classful:
            return (0.0, 0)
        if klass == "latency_critical":
            budget = cfg.deadline_critical
        elif klass == "background":
            budget = cfg.deadline_background
        else:
            budget = cfg.deadline_bulk
        return (self.world.sim.now + budget, nbytes)

    def adaptive_chunk_bytes(self, home: int) -> int:
        """Wire-chunk size for a chunk homed on channel ``home``,
        adapted to that rail's measured busbw: a rail delivering a
        fraction of the best rail's busbw gets its chunks shrunk by the
        matching power-of-two divisor (floored at ``chunk_floor_frac``),
        so per-chunk service time — and therefore per-chunk completion
        latency skew across rails — stays bounded on a degraded rail.
        Deterministic (telemetry EWMAs are virtual-clock-driven) and
        consistent across ranks (telemetry is cluster-global). Returns
        ``max_chunk_bytes`` unchanged for single-channel worlds, rails
        without data, or when adaptation is off."""
        cfg = self.cfg
        full = self.world.max_chunk_bytes
        if not cfg.adapt_chunk_size or self.n <= 1:
            return full
        tel = self.world.cluster.telemetry
        bus = [tel.busbw_ewma.get(ch.rail) for ch in self.world.channels]
        if self._multi_tier:
            # link-bandwidth prior: a slow DCN channel gets small chunks
            # from the first dispatch, not only after telemetry warms up
            bus = [b if b else ch.link_bandwidth
                   for b, ch in zip(bus, self.world.channels)]
        known = [b for b in bus if b]
        if len(known) < 2:
            return full
        best = max(known)
        mine = bus[home % self.n]
        if not mine or not best or mine >= best:
            return full
        frac = max(mine / best, cfg.chunk_floor_frac)
        div = 1
        while frac <= 0.5 and div * 2 * cfg.chunk_floor_frac <= 1.0:
            div *= 2
            frac *= 2.0
        return max(1, full // div)

    # ------------------------------------------------------------------
    # policy actuation (repro.policy.FaultPolicyEngine)
    # ------------------------------------------------------------------
    def force_demote(self, channel: int, on: bool = True) -> None:
        """Policy-directed demotion: cap ``channel`` at the straggler
        weight regardless of what the latency EWMAs say (the policy
        engine reacts to a degradation FAULT instantly; the organic
        straggler test needs ``straggler_min_samples`` completions).
        Idempotent; undone by :meth:`readmit`."""
        self.policy_demoted[channel % self.n] = bool(on)

    def exclude(self, channel: int) -> bool:
        """Shrink-world continue: remove ``channel`` from every pick.
        Refused (returns False) when it would leave no usable channel —
        a shrink that empties the world is an abort, not a policy.
        Idempotent; undone by :meth:`readmit`."""
        c = channel % self.n
        if self.excluded[c]:
            return True
        if sum(1 for x in self.excluded if not x) <= 1:
            return False
        self.excluded[c] = True
        return True

    def readmit(self, channel: int) -> None:
        """Clear any policy-forced demotion/exclusion of ``channel``.
        Re-entry goes through the standard recovery ramp: the channel
        is latched impaired so the next healthy pick starts a ramp at
        ``ramp_floor`` instead of jumping straight to full weight."""
        c = channel % self.n
        if self.policy_demoted[c] or self.excluded[c]:
            self.policy_demoted[c] = False
            self.excluded[c] = False
            self._impaired[c] = True

    def _note_demotions(self) -> None:
        """Fire ``policy_hook`` on demotion-flag transitions (the audit
        trail records organic straggler demotions/readmissions exactly
        like policy-directed ones)."""
        if self.policy_hook is None:
            self._prev_demoted = list(self.demoted)
            return
        for c in range(self.n):
            if self.demoted[c] != self._prev_demoted[c]:
                self.policy_hook(
                    "demote" if self.demoted[c] else "readmit", c)
        self._prev_demoted = list(self.demoted)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def _decay_recent(self) -> None:
        """Decay recent-assignment counters once per closed telemetry
        window (virtual-time driven, so fully deterministic)."""
        tel = self.world.cluster.telemetry
        tel.roll()
        k = tel.window_seq - self._win_seq
        if k:
            self._win_seq = tel.window_seq
            f = self.cfg.decay ** min(k, 64)
            self.recent = [r * f for r in self.recent]

    def _is_straggler(self, c: int, lats: List[Optional[float]],
                      counts: List[int]) -> bool:
        """Leave-one-out straggler test: rail ``c`` is demoted when its
        latency EWMA exceeds ``straggler_factor`` x the median of the
        OTHER rails' EWMAs (excluding ``c`` keeps a 2-rail straggler
        from pulling the reference up toward itself). The comparison is
        SAME-TIER only: a DCN uplink is intrinsically orders of
        magnitude slower than an intra-pod rail, and judging it against
        rail latencies would permanently demote a perfectly healthy
        cross-pod path."""
        cfg = self.cfg
        if lats[c] is None or counts[c] < cfg.straggler_min_samples:
            return False
        channels = self.world.channels
        tier = channels[c].tier
        others = [lats[o] for o in range(self.n)
                  if o != c and lats[o] is not None
                  and counts[o] >= cfg.straggler_min_samples
                  and channels[o].tier == tier]
        if not others:
            return False
        return lats[c] > cfg.straggler_factor * median(others)

    def channel_weights(self, rank: int, peer: int
                        ) -> Tuple[List[str], List[float]]:
        """Per-channel (states, weights) for one (rank, peer) pair.

        Weights are NOT normalized here; a zero weight means the channel
        is unusable for this pair. Also advances the per-channel ramp
        bookkeeping (a transition back to OK starts a re-admission ramp).
        """
        cfg = self.cfg
        world = self.world
        tel = world.cluster.telemetry
        now = world.sim.now
        channels = world.channels
        states = [ch.link_state(rank, peer) for ch in channels]
        # ramp bookkeeping: a channel that left DOWN/DEGRADED re-admits
        # gradually instead of jumping straight back to full weight. An
        # already-running ramp is never restarted (no knock-back to the
        # floor while it climbs).
        for c, st in enumerate(states):
            if st != HEALTH_OK:
                self._impaired[c] = True
                # any running ramp is moot while impaired — clearing it
                # here guarantees a FLAPPING channel gets a fresh ramp
                # on every recovery (a stale ramp from the previous
                # recovery would otherwise read as already-expired)
                self._ramp_start[c] = None
            elif self._impaired[c]:
                self._impaired[c] = False
                self._ramp_start[c] = now
        # path feasibility: across pods only DCN channels are routable
        # (rail switches are pod-local), so cross-pod pairs must never
        # see a rail channel as usable — and vice versa an intra-pod
        # pair may use the DCN, just at its proportionally small share.
        cross_pod = (self._multi_tier
                     and self._pod_of(rank) != self._pod_of(peer))
        bus = [tel.busbw_ewma.get(channels[c].rail) for c in range(self.n)]
        known = [bus[c] for c in range(self.n)
                 if states[c] == HEALTH_OK and bus[c]]
        mean_bw = sum(known) / len(known) if known else 0.0
        link_bw = [getattr(channels[c], "link_bandwidth", 0.0)
                   for c in range(self.n)]
        mean_link_bw = (sum(link_bw) / len(link_bw)) if link_bw else 0.0
        lats = [tel.lat_ewma.get(channels[c].rail) for c in range(self.n)]
        counts = [tel.samples.get(channels[c].rail, 0)
                  for c in range(self.n)]
        weights: List[float] = []
        for c, st in enumerate(states):
            if self.excluded[c]:
                # shrunk out of the world by the fault policy: unusable
                # for every pair until readmit()
                self.demoted[c] = False
                weights.append(0.0)
                continue
            if cross_pod and channels[c].tier != "dcn":
                self.demoted[c] = False
                weights.append(0.0)
                continue
            if st == HEALTH_DOWN:
                self.demoted[c] = False
                weights.append(0.0)
                continue
            if st == HEALTH_DEGRADED:
                self.demoted[c] = False
                weights.append(cfg.degraded_weight)
                continue
            # healthy: proportional to measured busbw; before telemetry
            # exists a multi-tier cluster falls back to the
            # link-bandwidth PRIOR (a cold DCN channel gets its
            # proportionally small share, not a mean-rail share) while
            # single-tier clusters keep the historical no-data -> mean
            # behavior
            if bus[c] and mean_bw:
                base = bus[c] / mean_bw
            elif self._multi_tier and mean_link_bw:
                base = link_bw[c] / mean_link_bw
            else:
                base = 1.0
            self.demoted[c] = (self._is_straggler(c, lats, counts)
                               or self.policy_demoted[c])
            if self.demoted[c]:
                base = min(base, cfg.straggler_weight)
            t0 = self._ramp_start[c]
            if t0 is not None:
                dt = now - t0
                if dt < cfg.ramp_time:
                    base *= (cfg.ramp_floor
                             + (1.0 - cfg.ramp_floor) * dt / cfg.ramp_time)
                else:
                    self._ramp_start[c] = None
            weights.append(base)
        self.last_weights = weights
        self._note_demotions()
        return states, weights

    # ------------------------------------------------------------------
    # assignment
    # ------------------------------------------------------------------
    def pick(self, rank: int, peer: int, home: int,
             cid: Optional[int] = None) -> int:
        """Assign one chunk: the home channel while it is within its
        proportional share, otherwise the most-behind usable channel.
        ``cid`` attributes the in-flight accounting to one live
        collective (None for raw streams)."""
        home %= self.n
        if self.n == 1:
            self.assigned[0] += 1
            self._note_assigned(0, cid)
            return 0
        self._decay_recent()
        _states, w = self.channel_weights(rank, peer)
        pool = [c for c in range(self.n) if w[c] > 0.0]
        if not pool:
            # every channel is down: post on the home anyway so the
            # failure surfaces as an error instead of a silent stall
            choice = home
        else:
            stalled = home in pool and self._home_stalled(home, pool, cid)
            if stalled and len(pool) > 1:
                # backlog-stall guard: chunks are piling up undrained on
                # the home (typically behind a stalled collective) — new
                # chunks must not join the pile, so the home is not a
                # candidate until retire()/deliveries drain it
                pool = [c for c in pool if c != home]
            wsum = sum(w[c] for c in pool)
            total = sum(self.recent[c] for c in pool) + 1.0
            if (home in pool and not stalled and self.recent[home]
                    <= (w[home] / wsum) * total + self.cfg.share_slack):
                choice = home
            else:
                # weighted deficit: most behind its target share wins;
                # ties resolve to the nearest channel after home
                choice = min(pool, key=lambda c: (
                    self.recent[c] - (w[c] / wsum) * total,
                    (c - home) % self.n))
                if choice != home:
                    self.resteered += 1
        self.assigned[choice] += 1
        self._note_assigned(choice, cid)
        self.recent[choice] += 1.0
        return choice

    def _home_stalled(self, home: int, pool: List[int],
                      cid: Optional[int]) -> bool:
        """True when OTHER collectives' outstanding backlog on the home
        channel dwarfs their backlog on its peers (``backlog_factor`` x
        the mean, +1 cushion): chunks are piling up undrained there
        behind a stalled sibling, and this collective's new chunks must
        not join the pile. The picking collective's OWN in-flight chunks
        are excluded from the signal — a healthy pipeline naturally
        keeps its own chunks in flight on its home rail, and that must
        never read as a stall (nor perturb single-collective runs)."""
        own = self.inflight_by_cid.get(cid)

        def foreign(c: int) -> int:
            return self.inflight[c] - (own[c] if own else 0)
        others = [foreign(c) for c in pool if c != home]
        if not others:
            return False
        mean = sum(others) / len(others)
        return foreign(home) > self.cfg.backlog_factor * (mean + 1)

    def _note_assigned(self, channel: int, cid: Optional[int]) -> None:
        """Count one assignment in the global + per-cid backlog."""
        self.inflight[channel] += 1
        by_cid = self.inflight_by_cid.get(cid)
        if by_cid is None:
            by_cid = self.inflight_by_cid[cid] = [0] * self.n
        by_cid[channel] += 1

    def note_delivered(self, channel: int,
                       cid: Optional[int] = None) -> None:
        """One chunk assigned to ``channel`` was delivered (frees the
        backlog slot of the owning collective). A chunk whose collective
        already retired is a no-op: retire() reconciled it out of the
        global counters, so decrementing again would double-count (the
        late skip-resync / post-abort delivery path)."""
        by_cid = self.inflight_by_cid.get(cid)
        if by_cid is None:
            return
        self.inflight[channel] -= 1
        by_cid[channel] -= 1

    def retire(self, cid: Optional[int]) -> None:
        """A collective finished or failed: drop its per-cid accounting
        and reconcile any chunks it never saw delivered OUT of the
        global backlog — a stalled op on a degraded rail must not bias
        resteering decisions for its sibling collectives forever."""
        by_cid = self.inflight_by_cid.pop(cid, None)
        if by_cid is not None:
            for c, k in enumerate(by_cid):
                if k:
                    self.inflight[c] -= k

    def snapshot(self) -> Dict[str, object]:
        """Structured scheduler state for campaign reports. ``weights``
        and ``demoted`` reflect the most recent pick's (rank, peer)
        evaluation — health is per pair, so they are a sample, not a
        channel-global truth. ``inflight_by_collective`` lists only the
        collectives with outstanding chunks."""
        return {"assigned": list(self.assigned),
                "inflight": list(self.inflight),
                "inflight_by_collective": {
                    str(cid): list(v)
                    for cid, v in self.inflight_by_cid.items() if any(v)},
                "resteered": self.resteered,
                "recent": [round(r, 3) for r in self.recent],
                "weights": [round(x, 4) for x in self.last_weights],
                "demoted": list(self.demoted),
                "excluded": list(self.excluded),
                "tiers": [ch.tier for ch in self.world.channels]}
