"""Discrete-event simulated RDMA fabric.

This module provides the deterministic substrate under ``repro.core.verbs``:
hosts, RNICs, rail-optimized switches, links with bandwidth/latency models,
PCIe contention, and failure injection (NIC down/up, switch-port down/up,
link flapping).

Design notes (see DESIGN.md §2):

* Virtual clock + event heap keyed ``(time, seq)`` -> fully deterministic.
* "Threads" in the paper (SHIFT background control / CQ-event threads) are
  actors: callbacks scheduled on this loop.
* Failure timing naturally produces both *packet-lost* and *ACK-lost*
  traces — the two indistinguishable traces of the paper's Lemma 3.1 —
  because data delivery and ACK delivery are separate events.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Simulator core
# ---------------------------------------------------------------------------


class Event:
    """A cancellable scheduled callback (the handle ``schedule`` returns).

    Heap records themselves are plain tuples ``(time, seq, handle, fn,
    args)`` so heap ordering compares floats/ints in C; an ``Event`` is
    only allocated when the caller needs the ability to cancel.  Handles
    are deliberately NOT pooled: they escape to callers (``wqe.timeout_ev``
    and friends) and a recycled handle would make a stale ``cancel()``
    kill an unrelated event.
    """

    __slots__ = ("time", "seq", "fn", "args", "cancelled", "fired", "_sim")

    def __init__(self, time: float, seq: int, fn: Callable, args: tuple,
                 sim: Optional["Simulator"] = None):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False
        self.fired = False
        self._sim = sim

    def cancel(self) -> None:
        """Mark this event dead; it will be skipped (lazy deletion)."""
        # cancelling an already-executed event is a no-op — it left the
        # heap when it fired, so it must not count toward _dead (phantom
        # counts would trigger compactions that remove nothing)
        if not self.cancelled and not self.fired:
            self.cancelled = True
            if self._sim is not None:
                self._sim._dead += 1

    def __lt__(self, other: "Event") -> bool:  # legacy ordering helper
        return (self.time, self.seq) < (other.time, other.seq)


class Simulator:
    """Deterministic discrete-event loop with a virtual clock (seconds).

    Two scheduling entry points:

    * :meth:`schedule` returns a cancellable :class:`Event` handle.
    * :meth:`call` is the allocation-light fast path for events that are
      never cancelled (the bulk of the datapath: serialize-done, deliver,
      ACK-arrive). No handle object is created.

    Cancelled events are removed lazily: ``Event.cancel`` only marks the
    handle and bumps ``_dead``; when dead events exceed half the heap the
    heap is compacted in one pass (the cancel-leak fix — a long run that
    cancels most of its timeouts no longer grows the heap without bound).
    """

    #: compaction only kicks in above this heap size (small heaps drain
    #: dead entries through normal pops faster than a rebuild would)
    COMPACT_MIN = 64

    def __init__(self) -> None:
        self.now: float = 0.0
        # heap records: (time, seq, Event-or-None, fn, args)
        self._heap: List[tuple] = []
        self._seq = 0
        self._executed: int = 0
        self._dead: int = 0          # cancelled events still in the heap
        self._compactions: int = 0

    def schedule(self, delay: float, fn: Callable, *args) -> Event:
        """Schedule ``fn(*args)`` after ``delay``; returns a cancellable
        handle."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        t = self.now + delay
        seq = self._seq
        self._seq = seq + 1
        ev = Event(t, seq, fn, args, self)
        heapq.heappush(self._heap, (t, seq, ev, fn, args))
        if self._dead > self.COMPACT_MIN and self._dead * 2 > len(self._heap):
            self._compact()
        return ev

    def call(self, delay: float, fn: Callable, *args) -> None:
        """Hot-path schedule with no cancellation handle (no allocation
        beyond the heap record itself)."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        t = self.now + delay
        seq = self._seq
        self._seq = seq + 1
        heapq.heappush(self._heap, (t, seq, None, fn, args))

    def at(self, time: float, fn: Callable, *args) -> Event:
        """Schedule ``fn(*args)`` at absolute virtual ``time``."""
        return self.schedule(max(0.0, time - self.now), fn, *args)

    def _compact(self) -> None:
        """Drop cancelled records and re-heapify (lazy deletion).

        In place: ``run`` holds a reference to the heap list across
        events, so the list object must never be rebound."""
        self._heap[:] = [rec for rec in self._heap
                         if rec[2] is None or not rec[2].cancelled]
        heapq.heapify(self._heap)
        self._dead = 0
        self._compactions += 1

    def peek_time(self) -> Optional[float]:
        """Virtual time of the next live event (None if the heap is empty)."""
        heap = self._heap
        while heap and heap[0][2] is not None and heap[0][2].cancelled:
            heapq.heappop(heap)
            self._dead -= 1
        return heap[0][0] if heap else None

    def step(self) -> bool:
        """Execute the next pending event. Returns False if none left."""
        heap = self._heap
        while heap:
            t, _seq, ev, fn, args = heapq.heappop(heap)
            if ev is not None:
                if ev.cancelled:
                    self._dead -= 1
                    continue
                ev.fired = True
            self.now = t
            self._executed += 1
            fn(*args)
            return True
        return False

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> None:
        """Run events until the heap drains or virtual time passes ``until``."""
        heap = self._heap
        pop = heapq.heappop
        n = 0
        while heap:
            if until is not None and heap[0][0] > until:
                self.now = until
                return
            t, _seq, ev, fn, args = pop(heap)
            if ev is not None:
                if ev.cancelled:
                    self._dead -= 1
                    continue
                ev.fired = True
            self.now = t
            self._executed += 1
            fn(*args)
            n += 1
            if n > max_events:
                raise RuntimeError("simulator exceeded max_events — livelock?")
        if until is not None and self.now < until:
            self.now = until

    def run_until_idle(self, max_events: int = 50_000_000) -> None:
        """Run until the event heap drains completely."""
        self.run(until=None, max_events=max_events)


# ---------------------------------------------------------------------------
# Network components
# ---------------------------------------------------------------------------

GBPS = 1e9 / 8.0  # bytes/sec per Gbit/s


@dataclass
class Link:
    """Point-to-point cable NIC <-> switch port."""

    name: str
    bandwidth: float = 100 * GBPS  # bytes/sec
    latency: float = 2e-6  # seconds, one-way propagation
    up: bool = True
    # Declared loss character of the medium (fraction of time the link
    # drops traffic). Loss is injected DETERMINISTICALLY as scheduled
    # link-down pulses (:func:`loss_windows`) rather than per-packet
    # randomness — an in-flight segment whose delivery lands inside a
    # pulse is dropped by the existing path_up-at-delivery check and
    # ridden out by RC segment retransmission, with no RNG in the fabric.
    loss: float = 0.0
    # pre-degradation values, remembered by the first bw_degrade /
    # lat_inflate fault so the matching restore puts them back exactly
    base_bandwidth: Optional[float] = None
    base_latency: Optional[float] = None


@dataclass
class SwitchPort:
    """One switch port: link + peer NIC + independent up/down state."""

    index: int
    up: bool = True
    link: Optional[Link] = None
    peer_nic: Optional["RNIC"] = None


class Switch:
    """A ToR/rail switch. Ports connect NICs; the switching core is assumed
    loss-free (in-network rerouting covers fabric-internal failures, per the
    paper's Figure 1 layering)."""

    def __init__(self, name: str, n_ports: int = 64):
        self.name = name
        self.up = True
        self.ports: List[SwitchPort] = [SwitchPort(i) for i in range(n_ports)]
        self._next_port = 0

    def attach(self, nic: "RNIC", link: Link) -> SwitchPort:
        """Wire ``nic`` to the next free port via ``link``."""
        port = self.ports[self._next_port]
        self._next_port += 1
        port.link = link
        port.peer_nic = nic
        nic.switch = self
        nic.switch_port = port
        nic.link = link
        return port


class RNIC:
    """A simulated RDMA NIC endpoint.

    Transport logic (QPs, WQE scheduling, ACK/timeout) lives in
    ``repro.core.verbs``; this class models physical state + bandwidth share.
    """

    def __init__(self, name: str, host: "Host", index: int,
                 pcie_bandwidth: float = 14 * GBPS * 8,  # ~14 GB/s x16 gen3
                 tier: str = "rail"):
        self.name = name
        self.host = host
        self.index = index  # rail index
        self.tier = tier    # "rail" (intra-pod) or "dcn" (cross-pod)
        self.gid = f"{host.name}/{name}"
        self.up = True
        self.switch: Optional[Switch] = None
        self.switch_port: Optional[SwitchPort] = None
        self.link: Optional[Link] = None
        self.pcie_bandwidth = pcie_bandwidth
        # Flows currently serializing through this NIC (for fair share).
        self.active_flows: int = 0
        # Persistent background traffic (the paper's "busy backup RNIC").
        self.background_flows: int = 0
        # Per-rail traffic accounting (verbs layer increments): payload
        # bytes this NIC serialized onto the wire / DMA'd into host
        # memory. Multi-rail busbw benchmarks and the channel scheduler's
        # reports read these through Cluster.rail_bytes().
        self.tx_bytes: int = 0
        self.delivered_bytes: int = 0
        # Callbacks fired on state change (verbs layer hooks in for
        # fast local error detection).
        self.state_listeners: List[Callable[[bool], None]] = []

    # -- failure injection ---------------------------------------------------
    def set_up(self, up: bool) -> None:
        """Change interface state, notifying registered state listeners."""
        if self.up == up:
            return
        self.up = up
        for cb in list(self.state_listeners):
            cb(up)

    # -- bandwidth model -----------------------------------------------------
    def effective_bandwidth(self) -> float:
        """Fair-share bandwidth snapshot for a new flow starting now."""
        base = self.link.bandwidth if self.link else 0.0
        base = min(base, self.pcie_bandwidth)
        nflows = 1 + self.active_flows + self.background_flows
        return base / nflows

    def path_up(self) -> bool:
        """True if NIC, cable, switch and port are all up."""
        return (
            self.up
            and self.link is not None
            and self.link.up
            and self.switch is not None
            and self.switch.up
            and self.switch_port is not None
            and self.switch_port.up
        )

    def __repr__(self) -> str:
        return f"RNIC({self.gid}, up={self.up})"


class Host:
    """A GPU server with multiple RNICs and a flat registered-memory space."""

    def __init__(self, name: str, cluster: "Cluster", pod: int = 0):
        self.name = name
        self.cluster = cluster
        self.pod = pod  # pod membership (0 in single-pod clusters)
        self.nics: List[RNIC] = []
        # Bump allocator for MR base addresses (per-host address space).
        self._next_addr = 0x1000

    def add_nic(self, nic: RNIC) -> None:
        """Attach one more RNIC (rail index = position)."""
        self.nics.append(nic)

    def alloc_addr(self, nbytes: int) -> int:
        """Allocate a page-aligned MR base address in this host's space."""
        addr = self._next_addr
        self._next_addr += ((nbytes + 0xFFF) // 0x1000 + 1) * 0x1000
        return addr


# ---------------------------------------------------------------------------
# Per-rail telemetry (feeds the adaptive channel scheduler)
# ---------------------------------------------------------------------------


class RailTelemetry:
    """Continuous per-rail traffic telemetry on the virtual clock.

    Three signals per rail (= NIC index), all deterministic because they
    are driven purely by virtual time and payload byte counts:

    * **Delivered-byte-rate windows** — ``rates[rail]`` is the payload
      bytes/second delivered over the last *measurement span* (at least
      one ``window``, exact length = whenever the lazy roll happened),
      computed from :meth:`Cluster.rail_bytes` deltas. Spans roll
      lazily on access, so no periodic actor is needed and idle
      periods cost nothing; because sampling is lazy there is no
      boundary-aligned sample, and dividing by the true span is what
      keeps the rate honest (no traffic time-shifted across windows).
    * **Completion-latency EWMA** — ``lat_ewma[rail]`` tracks post-to-ACK
      latency of payload-carrying send WQEs, fed by the verbs engine at
      ACK arrival (both datapaths). The channel scheduler's straggler
      demotion compares a rail's EWMA against the leave-one-out median
      of its peers.
    * **Per-completion busbw EWMA** — ``busbw_ewma[rail]`` tracks
      ``bytes / latency`` per completion: a load-independent estimate of
      the rail's service capacity (a saturated AND an underloaded rail
      both report their true per-chunk service rate). The scheduler
      weights chunk assignment proportionally to this signal.

    SHIFT lifecycle hooks (:meth:`note_lifecycle`) reset a rail's EWMAs
    on fallback/recovery so pre-fault readings don't linger as stale
    truth while the rail's physical path has changed.
    """

    def __init__(self, cluster: "Cluster", window: float = 250e-6,
                 alpha: float = 0.2):
        self.cluster = cluster
        self.window = window
        self.alpha = alpha
        self.lat_ewma: Dict[int, float] = {}
        self.busbw_ewma: Dict[int, float] = {}
        self.samples: Dict[int, int] = {}
        self.rates: Dict[int, float] = {}
        #: monotone counter of closed windows (the scheduler decays its
        #: recent-assignment counters once per closed window)
        self.window_seq = 0
        self._win_start = cluster.sim.now
        self._win_base: Dict[int, int] = {}

    # -- completion feed (verbs layer) ----------------------------------
    def note_completion(self, rail: int, nbytes: int,
                        latency: float) -> None:
        """Record one payload send completion on ``rail``.

        Called by the verbs engine at ACK arrival for payload-carrying
        WQEs (``nbytes > 0``); notifies/probes are header-sized and
        excluded so the busbw EWMA is not diluted."""
        if latency <= 0.0 or nbytes <= 0:
            return
        self.roll()
        a = self.alpha
        bw = nbytes / latency
        prev_lat = self.lat_ewma.get(rail)
        self.lat_ewma[rail] = (latency if prev_lat is None
                               else (1 - a) * prev_lat + a * latency)
        prev_bw = self.busbw_ewma.get(rail)
        self.busbw_ewma[rail] = (bw if prev_bw is None
                                 else (1 - a) * prev_bw + a * bw)
        self.samples[rail] = self.samples.get(rail, 0) + 1

    # -- lifecycle feed (SHIFT layer) -----------------------------------
    def note_lifecycle(self, event: str, rail: int) -> None:
        """SHIFT fallback/recovery on a QP whose default NIC sits on
        ``rail``: the rail's physical path just changed, so its EWMAs are
        reset and re-learned from post-transition completions."""
        if event in ("fallback", "recovery", "failed"):
            self.lat_ewma.pop(rail, None)
            self.busbw_ewma.pop(rail, None)
            self.samples[rail] = 0

    # -- windowed delivered-byte rates ----------------------------------
    def roll(self) -> None:
        """Close the measurement span once >= one window has elapsed
        (lazy, idempotent). The rate divides the byte delta by the TRUE
        span (boundary to now) — the delta is sampled now, so dividing
        by a window-aligned span would attribute open-window traffic to
        the closed window (time-shifted rates)."""
        now = self.cluster.sim.now
        elapsed = now - self._win_start
        if elapsed < self.window:
            return
        cur = {rail: d["delivered_bytes"]
               for rail, d in self.cluster.rail_bytes().items()}
        for rail, v in cur.items():
            self.rates[rail] = (v - self._win_base.get(rail, 0)) / elapsed
        self._win_base = cur
        self._win_start = now
        self.window_seq += int(elapsed / self.window)

    def rate(self, rail: int) -> float:
        """Delivered bytes/second of ``rail`` over the last closed
        measurement span (>= one window)."""
        self.roll()
        return self.rates.get(rail, 0.0)

    def snapshot(self) -> Dict[str, object]:
        """Structured copy of every signal (campaign/benchmark reports)."""
        self.roll()
        return {
            "window_s": self.window,
            "window_seq": self.window_seq,
            "rates_bytes_per_s": dict(self.rates),
            "lat_ewma_s": dict(self.lat_ewma),
            "busbw_ewma_bytes_per_s": dict(self.busbw_ewma),
            "samples": dict(self.samples),
        }


# ---------------------------------------------------------------------------
# Cluster: topology + failure injection helpers
# ---------------------------------------------------------------------------


class Cluster:
    """Owns the simulator, hosts, switches and the GID registry."""

    def __init__(self, sim: Optional[Simulator] = None):
        self.sim = sim or Simulator()
        self.hosts: Dict[str, Host] = {}
        self.switches: Dict[str, Switch] = {}
        self.nic_by_gid: Dict[str, RNIC] = {}
        # transport params (verbs layer reads these)
        self.ack_timeout: float = 400e-6
        self.retry_cnt: int = 7
        self.rnr_timer: float = 100e-6
        self.rnr_retry: int = 7
        self.nic_error_detect_latency: float = 20e-6
        # --- datapath fast path (DESIGN.md §5) ---
        # fast_datapath=True: the verbs engine coalesces every burst of
        # doorbell'd WQEs into ONE scheduled segment (one serialize-done,
        # one delivery, one coalesced ACK, one batch timeout) and hands
        # payloads around as read-only numpy views (single copy at the
        # RNIC-to-memory boundary). False restores the legacy per-WQE
        # event chain with bytes() payload snapshots.
        self.fast_datapath: bool = True
        self.max_burst: int = 64     # WQEs per coalesced segment
        # applied-fault audit trail: (virtual time, kind, nic gid)
        self.fault_log: List[Tuple[float, str, str]] = []
        self.fault_listeners: List[Callable[[float, str, str], None]] = []
        # per-rail telemetry (byte-rate windows + latency/busbw EWMAs);
        # the verbs engine and SHIFT feed it, the channel scheduler and
        # benchmarks read it
        self.telemetry = RailTelemetry(self)
        # heterogeneous-topology metadata (build_cluster fills these in
        # for multi-pod clusters; single-pod clusters keep the defaults)
        self.n_pods: int = 1
        #: NIC indices that sit on the cross-pod DCN tier (empty when the
        #: cluster is single-pod — every index is then an intra-pod rail)
        self.dcn_rail_indices: Tuple[int, ...] = ()

    # -- construction ---------------------------------------------------------
    def add_host(self, name: str, pod: int = 0) -> Host:
        """Create and register a host (``pod`` assigns its pod in
        multi-pod clusters; single-pod callers leave the default)."""
        h = Host(name, self, pod=pod)
        self.hosts[name] = h
        return h

    def add_switch(self, name: str, n_ports: int = 64) -> Switch:
        """Create and register a rail/ToR switch."""
        s = Switch(name, n_ports)
        self.switches[name] = s
        return s

    def add_nic(self, host: Host, name: str, switch: Switch,
                bandwidth: float = 100 * GBPS, latency: float = 2e-6,
                pcie_bandwidth: Optional[float] = None,
                loss: float = 0.0, tier: str = "rail") -> RNIC:
        """Create a NIC on ``host``, cable it to ``switch``, register it.
        ``tier`` marks intra-pod rails vs cross-pod DCN uplinks; ``loss``
        declares the link's loss character (see :class:`Link`)."""
        nic = RNIC(name, host, index=len(host.nics),
                   pcie_bandwidth=pcie_bandwidth or 14 * GBPS * 8,
                   tier=tier)
        host.add_nic(nic)
        link = Link(f"{host.name}.{name}<->{switch.name}",
                    bandwidth=bandwidth, latency=latency, loss=loss)
        switch.attach(nic, link)
        self.nic_by_gid[nic.gid] = nic
        return nic

    # -- path model -----------------------------------------------------------
    def path_up(self, src: RNIC, dst: RNIC) -> bool:
        """End-to-end availability src NIC -> (rail/spine) -> dst NIC.

        Inter-switch (spine) connectivity is assumed always available
        WITHIN a pod: fabric-internal failures are masked by in-network
        rerouting (paper Fig. 1 — the layer below the one SHIFT adds).
        ACROSS pods only the DCN tier is physically routable: a
        cross-pod pair of rail NICs has no path, so cross-pod traffic is
        forced onto the DCN uplinks.
        """
        if src.host.pod != dst.host.pod and (
                src.tier != "dcn" or dst.tier != "dcn"):
            return False
        return src.path_up() and dst.path_up()

    def path_latency(self, src: RNIC, dst: RNIC) -> float:
        """One-way propagation latency src -> dst (links + hops)."""
        lat = (src.link.latency if src.link else 0.0) + (
            dst.link.latency if dst.link else 0.0)
        if src.switch is not dst.switch:
            lat += 1e-6  # spine hop
        # switch forwarding delay
        return lat + 0.5e-6

    # -- per-rail traffic accounting ------------------------------------------
    def rail_bytes(self) -> Dict[int, Dict[str, int]]:
        """Aggregate traffic per rail: rail index -> tx/delivered payload
        bytes summed over every host's NIC on that rail. WRITE-class
        payloads only (notifies and ACKs are header-sized and excluded),
        so this is the busbw numerator."""
        out: Dict[int, Dict[str, int]] = {}
        for host in self.hosts.values():
            for nic in host.nics:
                d = out.setdefault(nic.index,
                                   {"tx_bytes": 0, "delivered_bytes": 0})
                d["tx_bytes"] += nic.tx_bytes
                d["delivered_bytes"] += nic.delivered_bytes
        return out

    def tier_bytes(self) -> Dict[str, Dict[str, int]]:
        """Aggregate traffic per TIER ("rail" vs "dcn"): the DCN row is
        the cross-pod bytes-moved numerator the hierarchical-allreduce
        benchmark gates on (compression must shrink it)."""
        out = {"rail": {"tx_bytes": 0, "delivered_bytes": 0},
               "dcn": {"tx_bytes": 0, "delivered_bytes": 0}}
        for host in self.hosts.values():
            for nic in host.nics:
                d = out[nic.tier]
                d["tx_bytes"] += nic.tx_bytes
                d["delivered_bytes"] += nic.delivered_bytes
        return out

    # -- failure injection ----------------------------------------------------
    def fail_nic(self, gid: str) -> None:
        """Take the NIC at ``gid`` down (interface loss)."""
        self._record_fault("nic_down", gid)
        self.nic_by_gid[gid].set_up(False)

    def recover_nic(self, gid: str) -> None:
        """Bring the NIC at ``gid`` back up."""
        self._record_fault("nic_up", gid)
        self.nic_by_gid[gid].set_up(True)

    def fail_switch_port(self, gid: str) -> None:
        """Take down the switch port the NIC at ``gid`` connects to."""
        nic = self.nic_by_gid[gid]
        if nic.switch_port:
            self._record_fault("port_down", gid)
            nic.switch_port.up = False

    def recover_switch_port(self, gid: str) -> None:
        """Bring that switch port back up."""
        nic = self.nic_by_gid[gid]
        if nic.switch_port:
            self._record_fault("port_up", gid)
            nic.switch_port.up = True

    def fail_link(self, gid: str) -> None:
        """Pull the cable of the NIC at ``gid``."""
        nic = self.nic_by_gid[gid]
        if nic.link:
            self._record_fault("link_down", gid)
            nic.link.up = False

    def recover_link(self, gid: str) -> None:
        """Re-seat that cable."""
        nic = self.nic_by_gid[gid]
        if nic.link:
            self._record_fault("link_up", gid)
            nic.link.up = True

    def flap_nic(self, gid: str, down_at: float, up_at: float) -> None:
        """Schedule an interface flap (down then up) in virtual time."""
        self.sim.at(down_at, self.fail_nic, gid)
        self.sim.at(up_at, self.recover_nic, gid)

    # -- partial degradation (the rail stays UP, just slower) ----------------
    def degrade_link_bw(self, gid: str, factor: float = 0.25) -> None:
        """Cut a link's bandwidth to ``factor`` of its original value.

        The interface stays up and error-free — no QP sees a failure —
        so only *telemetry* (measured busbw) can reveal the degradation.
        This is the `degraded-but-alive rail` the adaptive scheduler
        must load proportionally instead of all-or-nothing."""
        nic = self.nic_by_gid[gid]
        if nic.link:
            self._record_fault(f"bw_degrade:{factor:g}", gid)
            link = nic.link
            if link.base_bandwidth is None:
                link.base_bandwidth = link.bandwidth
            link.bandwidth = link.base_bandwidth * factor

    def restore_link_bw(self, gid: str) -> None:
        """Undo :meth:`degrade_link_bw` (restores the original bandwidth)."""
        nic = self.nic_by_gid[gid]
        if nic.link and nic.link.base_bandwidth is not None:
            self._record_fault("bw_restore", gid)
            nic.link.bandwidth = nic.link.base_bandwidth

    def inflate_link_latency(self, gid: str, factor: float = 25.0) -> None:
        """Multiply a link's propagation latency by ``factor``.

        Models a congested/misrouted path: completions still succeed
        (keep the factor small enough that the RC ack timeout is not
        exceeded) but per-completion latency rises — the straggler
        signal the scheduler demotes on, with NO health transition."""
        nic = self.nic_by_gid[gid]
        if nic.link:
            self._record_fault(f"lat_inflate:{factor:g}", gid)
            link = nic.link
            if link.base_latency is None:
                link.base_latency = link.latency
            link.latency = link.base_latency * factor

    def restore_link_latency(self, gid: str) -> None:
        """Undo :meth:`inflate_link_latency` (restores the original)."""
        nic = self.nic_by_gid[gid]
        if nic.link and nic.link.base_latency is not None:
            self._record_fault("lat_restore", gid)
            nic.link.latency = nic.link.base_latency

    # -- composable fault-injection hooks (scenario engine entry points) -----
    # Uniform fault vocabulary: every injectable event is a (kind, target)
    # pair — target is a NIC GID ("host0/mlx5_0") or a rail selector
    # ("rail:0" = NIC index 0 of every host — correlated rail failure) —
    # plus an optional magnitude ``arg`` for the degradation kinds
    # (bw_degrade: bandwidth fraction, lat_inflate: latency multiplier).
    FAULT_KINDS = ("nic_down", "nic_up", "port_down", "port_up",
                   "link_down", "link_up",
                   "bw_degrade", "bw_restore", "lat_inflate", "lat_restore")

    def _record_fault(self, kind: str, gid: str) -> None:
        """Append to the audit trail and fire the fault listeners.
        Parametric faults arrive with their magnitude baked into the
        kind (``bw_degrade:0.05``, ``lat_inflate:25``) so the trail —
        and every fingerprint built from it — distinguishes injections
        that differ only in magnitude."""
        self.fault_log.append((self.sim.now, kind, gid))
        for cb in list(self.fault_listeners):
            cb(self.sim.now, kind, gid)

    def add_fault_listener(
            self, cb: Callable[[float, str, str], None]) -> None:
        """Register an observer fired on every applied fault (the scenario
        engine uses this to cross-check injected vs. applied timelines)."""
        self.fault_listeners.append(cb)

    def resolve_targets(self, target: str) -> List[str]:
        """Expand a target selector to concrete NIC GIDs.

        ``rail:k`` selects NIC index k of every host (correlated rail
        failure); ``dcn`` selects every cross-pod uplink NIC, and
        ``dcn:k`` the k-th DCN uplink of every host (``dcn:0`` = the
        primary uplink, ``dcn:1`` = its SHIFT backup)."""
        if target.startswith("rail:"):
            k = int(target.split(":", 1)[1])
            return [nic.gid for host in self.hosts.values()
                    for nic in host.nics if nic.index == k]
        if target == "dcn" or target.startswith("dcn:"):
            dcn = [nic for host in self.hosts.values()
                   for nic in host.nics if nic.tier == "dcn"]
            if ":" in target:
                k = int(target.split(":", 1)[1])
                dcn = [nic for nic in dcn
                       if nic.index - min(self.dcn_rail_indices or (0,)) == k]
            return [nic.gid for nic in dcn]
        if (target not in self.nic_by_gid and "/" in target
                and target.split("/", 1)[1].startswith("dcn")):
            # a concrete DCN-uplink GID on a single-pod cluster: no-op,
            # so the dcn_* scenarios stay runnable under flat workloads
            # (same contract as a rail selector that matches nothing)
            return []
        return [target]

    def apply_fault(self, kind: str, target: str,
                    arg: Optional[float] = None) -> None:
        """Apply one fault action now. Rail selectors expand to every
        matching NIC (same virtual instant -> correlated failure).
        ``arg`` parameterizes the degradation kinds (``bw_degrade``:
        bandwidth fraction, ``lat_inflate``: latency multiplier) and is
        ignored by the binary up/down kinds."""
        fn = {
            "nic_down": self.fail_nic, "nic_up": self.recover_nic,
            "port_down": self.fail_switch_port,
            "port_up": self.recover_switch_port,
            "link_down": self.fail_link, "link_up": self.recover_link,
            "bw_restore": self.restore_link_bw,
            "lat_restore": self.restore_link_latency,
        }.get(kind)
        parametric = {"bw_degrade": self.degrade_link_bw,
                      "lat_inflate": self.inflate_link_latency}.get(kind)
        if fn is None and parametric is None:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected one of {self.FAULT_KINDS})")
        for gid in self.resolve_targets(target):
            if parametric is not None:
                parametric(gid) if arg is None else parametric(gid, arg)
            else:
                fn(gid)

    def schedule_fault(self, at: float, kind: str, target: str,
                       arg: Optional[float] = None) -> None:
        """Schedule :meth:`apply_fault` at virtual time ``at``."""
        self.sim.at(at, self.apply_fault, kind, target, arg)


# ---------------------------------------------------------------------------
# Fault-timeline generators — produce (time, kind, target) triples that
# compose by concatenation; the scenario DSL (repro.scenarios.spec) wraps
# them into FaultActions. Times are relative to an arbitrary origin.
# ---------------------------------------------------------------------------


FaultTriple = Tuple[float, str, str]


def flap_train(target: str, start: float, count: int, down_time: float,
               period: float, kind: str = "nic") -> List[FaultTriple]:
    """A train of ``count`` down/up flaps: down at start + i*period, back
    up ``down_time`` later. ``kind`` is "nic", "port" or "link"."""
    if down_time >= period:
        raise ValueError("down_time must be < period (interface must "
                         "come back up before the next flap)")
    out: List[FaultTriple] = []
    for i in range(count):
        t = start + i * period
        out.append((t, f"{kind}_down", target))
        out.append((t + down_time, f"{kind}_up", target))
    return out


def correlated_failure(targets: Sequence[str], at: float,
                       kind: str = "nic_down") -> List[FaultTriple]:
    """The same fault on every target at the same virtual instant (e.g.
    a rail switch power loss taking out one NIC of every host)."""
    return [(at, kind, t) for t in targets]


def loss_windows(target: str, start: float, span: float, loss: float,
                 period: float = 2e-3) -> List[FaultTriple]:
    """Deterministic loss model: turn a loss FRACTION into link-down
    pulses with duty cycle ``loss`` over ``[start, start+span)``.

    Segments whose delivery lands inside a pulse are dropped in flight
    (the delivery-time ``path_up`` check) and recovered by RC segment
    retransmission — the same machinery per-packet random loss would
    exercise, with zero RNG in the fabric. Keep each pulse
    (``loss * period``) well under the RC retry budget
    (``retry_cnt x ack_timeout`` ~ 3.2ms) so the loss is transient, not
    an outage."""
    if not 0.0 < loss < 1.0:
        raise ValueError(f"loss fraction must be in (0, 1), got {loss}")
    down_time = loss * period
    count = max(1, int(span / period))
    return flap_train(target, start, count, down_time, period, kind="link")


def build_cluster(n_hosts: int = 2, nics_per_host: int = 2,
                  topology: str = "rail",
                  bandwidth: float = 100 * GBPS,
                  latency: float = 2e-6,
                  n_pods: int = 1,
                  dcn_bandwidth: float = 10 * GBPS,
                  dcn_latency: float = 50e-6,
                  dcn_loss: float = 0.0) -> Cluster:
    """Standard testbed: rail-optimized — NIC index k of every host connects
    to rail switch k (the paper's assumed deployment, §4.4), or a single
    shared ToR (``topology="single"``, SPOF — used by tests that demonstrate
    the hardware constraint).

    ``n_pods > 1`` builds the heterogeneous two-tier topology: hosts are
    block-partitioned into pods (``pod = i // (n_hosts // n_pods)``),
    rail switches become POD-LOCAL (cross-pod rail traffic is physically
    impossible — see :meth:`Cluster.path_up`), and every host gains two
    cross-pod DCN uplinks ``dcn0``/``dcn1`` (NIC indices
    ``nics_per_host`` and ``nics_per_host + 1``) on a shared DCN switch
    with the slow/lossy per-tier parameters ``dcn_bandwidth`` /
    ``dcn_latency`` / ``dcn_loss``. dcn1 exists as the SHIFT backup for
    dcn0 so cross-pod fault masking mirrors the intra-pod rail pairs.
    ``n_pods=1`` is byte-identical to the historical single-pod layout.
    """
    c = Cluster()
    if n_pods <= 1:
        if topology == "rail":
            switches = [c.add_switch(f"rail{k}")
                        for k in range(nics_per_host)]
        else:
            switches = [c.add_switch("tor0")] * nics_per_host
        for i in range(n_hosts):
            h = c.add_host(f"host{i}")
            for k in range(nics_per_host):
                c.add_nic(h, f"mlx5_{k}", switches[k],
                          bandwidth=bandwidth, latency=latency)
        return c
    if n_hosts % n_pods != 0:
        raise ValueError(f"n_hosts={n_hosts} not divisible by "
                         f"n_pods={n_pods}")
    if topology != "rail":
        raise ValueError("multi-pod clusters require the rail topology")
    per_pod = n_hosts // n_pods
    c.n_pods = n_pods
    c.dcn_rail_indices = (nics_per_host, nics_per_host + 1)
    pod_switches = [[c.add_switch(f"pod{p}.rail{k}")
                     for k in range(nics_per_host)] for p in range(n_pods)]
    dcn_switch = c.add_switch("dcn", n_ports=max(64, 2 * n_hosts))
    for i in range(n_hosts):
        pod = i // per_pod
        h = c.add_host(f"host{i}", pod=pod)
        for k in range(nics_per_host):
            c.add_nic(h, f"mlx5_{k}", pod_switches[pod][k],
                      bandwidth=bandwidth, latency=latency)
        for k in range(2):
            c.add_nic(h, f"dcn{k}", dcn_switch,
                      bandwidth=dcn_bandwidth, latency=dcn_latency,
                      loss=dcn_loss, tier="dcn")
    return c
