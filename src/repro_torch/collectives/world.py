"""JCCL communicator world: an async multi-collective engine over N rails.

``JcclWorld`` owns ``channels`` :class:`~repro.collectives.channel.Channel`
meshes (one per host rail) plus a
:class:`~repro.collectives.channel.ChannelScheduler` that stripes
collective chunks across them. Everything runs as actors on the cluster's
deterministic event loop, so failures can be injected at ANY point inside
a collective and the result is still reproducible. With ``ShiftLib``
endpoints, NIC/link failures are masked (the collective completes,
possibly slower, with the scheduler resteering chunks off the degraded
rail); with ``StandardLib`` endpoints the collective aborts with
``CollectiveError`` — the paper's crash-stop baseline.

The engine is **non-blocking at its core**: any number of collectives can
be live at once. ``allreduce_async`` / ``all_gather_async`` /
``broadcast_async`` / ``all_to_all_async`` / ``reduce_scatter_async``
register the collective in a registry keyed by a *collective id* (cid)
and return a :class:`Work` handle (``done()`` / ``wait(timeout)`` /
``exception()`` / ``result()``). Chunk tags are namespaced by cid —
``JcclWorld._tags`` maps an in-flight ``(channel, receiver, sender,
seq)`` to ``(cid, tag)`` — so concurrent collectives' notifies always
dispatch to the right actor and an overlapped bucketed all-reduce is
byte-identical to the sequential path. The historical blocking calls
(``allreduce`` et al.) are ``*_async().wait()`` one-liners, so every
existing caller keeps working unchanged. See DESIGN.md §8 and
docs/collectives.md for the work-handle lifecycle.

Layout: per-rail endpoints live in ``endpoint.py``, channel mesh +
scheduler in ``channel.py``, the collective algorithms (chunk schedulers)
in ``algorithms.py``. This module is the public API.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.fabric import Cluster
from ..core.shift import ShiftLib, StandardLib

from .algorithms import (_AllToAll, _Collective, _HierarchicalAllReduce,
                         _PipelineBroadcast, _RingAllGather, _RingAllReduce)
from .channel import (PRIORITY_CLASSES, Channel, ChannelScheduler,
                      SchedulerConfig)
from .endpoint import RankEndpoint, _ListenedCQ  # noqa: F401 (re-export)

#: Single source of truth for the engine chunk / staging-slot size.
#: ``JcclWorld`` and ``build_world`` used to default to 1<<22 and 1<<16
#: respectively — a silent 64x divergence, since the chunk size sets the
#: allreduce bucket granularity (and so the byte-identity alignment) AND
#: the per-endpoint staging footprint (n_ranks * src_slots * chunk
#: bytes). 64 KiB is the harness value every test, scenario and
#: benchmark actually ran with; callers wanting bigger wire chunks pass
#: ``max_chunk_bytes=`` explicitly (fig8 and the DDP example use 1<<20).
DEFAULT_MAX_CHUNK_BYTES = 1 << 16


class CollectiveError(RuntimeError):
    """A collective could not complete (crash-stop abort or timeout)."""


def aligned_bucket_bounds(total_elems: int, itemsize: int,
                          target_bytes: int, *, max_chunk_bytes: int,
                          n_ranks: int) -> List[Tuple[int, int]]:
    """Element ranges of size-targeted buckets whose boundaries are
    ALIGNED to the engine's allreduce bucket granularity
    (``max_chunk_bytes * n_ranks`` worth of elements).

    Standalone (no :class:`JcclWorld` needed) so the launch dry-runs can
    compute leaf->bucket schedules for trillion-parameter pytrees from
    shapes alone; :meth:`JcclWorld.aligned_bucket_bounds` delegates here
    and remains the in-world entry point. ``target_bytes=0`` means one
    flat bucket.
    """
    if not target_bytes:
        return [(0, total_elems)]
    align = max(1, max_chunk_bytes // itemsize) * n_ranks
    target = max(1, target_bytes // itemsize)
    step = max(align, (target // align) * align)
    return [(i, min(i + step, total_elems))
            for i in range(0, total_elems, step)] or [(0, 0)]


def _describe_works(works: Sequence["Work"], limit: int = 6) -> str:
    """Attribution string for error messages: which collectives (cid,
    kind, latency class) were still pending when the batch died."""
    body = ", ".join(f"cid={w.cid}:{w.kind}:{w.priority}"
                     for w in works[:limit])
    if len(works) > limit:
        body += f", +{len(works) - limit} more"
    return body


class Work:
    """Handle for one in-flight collective (the non-blocking API).

    Mirrors ``torch.distributed``'s work-handle contract: the launching
    call returns immediately, the caller overlaps other work (more
    collectives, compute), and later synchronizes through the handle.
    Progress happens whenever the simulator is pumped — by this handle's
    :meth:`wait`, by ``JcclWorld.wait_all``, or by any other live
    handle's wait (the event loop is shared, so sibling collectives
    advance together).

    Lifecycle: a handle retires its collective from the world registry
    the first time :meth:`done` observes completion (or on failure), at
    which point the scheduler reconciles the collective's per-cid
    accounting. A handle that is never polled simply keeps its registry
    entry until it is — entries hold no payload bytes.
    """

    def __init__(self, world: "JcclWorld", cid: int, coll: _Collective,
                 result_fn: Optional[Callable[[], object]] = None):
        self.world = world
        self.cid = cid
        self._coll = coll
        self._result_fn = result_fn
        self._result: object = None
        self._exc: Optional[CollectiveError] = None
        self._finished = False
        #: latency class every chunk of this collective dispatches under
        self.priority: str = getattr(coll, "priority", "bulk")
        self._t_launch = world.sim.now
        #: virtual time this work was launched (the backward-hook
        #: overlap metrics read it to place the first bucket issue
        #: relative to the modeled backward compute window)
        self.issue_time: float = self._t_launch
        #: virtual seconds from launch to the first completion
        #: observation (``wait_all`` polls per event, so for waited
        #: works this is the actual completion latency)
        self.completion_latency: Optional[float] = None

    @property
    def kind(self) -> str:
        """The collective's kind (``allreduce``, ``broadcast``, ...)."""
        return getattr(self._coll, "kind", "collective")

    # -- state ----------------------------------------------------------
    def done(self) -> bool:
        """True once the collective completed or failed. Polling a
        freshly completed collective finalizes it (registry retire +
        result materialization) — this never pumps the simulator."""
        if not self._finished and self._exc is None and self._coll.done():
            self._finished = True
            self.completion_latency = self.world.sim.now - self._t_launch
            self.world._note_class_latency(self.priority,
                                           self.completion_latency)
            self._result = (self._result_fn()
                            if self._result_fn is not None else None)
            self.world._retire(self.cid)
        return self._finished or self._exc is not None

    def exception(self) -> Optional[CollectiveError]:
        """The failure that killed this collective, or None."""
        return self._exc

    def result(self):
        """The collective's output (raises if failed or still live)."""
        if self._exc is not None:
            raise self._exc
        if not self._finished:
            raise CollectiveError("collective still in flight — "
                                  "wait() on the handle first")
        return self._result

    # -- synchronization ------------------------------------------------
    def wait(self, timeout: Optional[float] = None):
        """Pump the simulator until this collective completes; returns
        its result. Sibling live collectives advance too (shared event
        loop). ``timeout=None`` uses the world-level default
        (``JcclWorld.wait_timeout``). Raises :class:`CollectiveError`
        on abort/timeout."""
        self.world.wait_all([self], timeout=timeout)
        return self.result()

    def _fail(self, exc: CollectiveError) -> None:
        """Mark the work failed and retire its registry entry."""
        if not self._finished and self._exc is None:
            self._exc = exc
            self.world._retire(self.cid)


class JcclWorld:
    """All ranks of one communicator + the async collective engine."""

    def __init__(self, cluster: Cluster, libs: Sequence, nic: str = "mlx5_0",
                 max_chunk_bytes: int = DEFAULT_MAX_CHUNK_BYTES,
                 qp_depth: int = 8192,
                 cq_depth: int = 1 << 17, recv_prepost: int = 64,
                 src_slots: int = 4, strict_order: bool = True,
                 channels: int = 1,
                 sched: Optional[SchedulerConfig] = None,
                 wait_timeout: float = 120.0):
        self.cluster = cluster
        self.sim = cluster.sim
        self.libs = list(libs)
        self.n_ranks = len(libs)
        #: default virtual-seconds budget for ``Work.wait`` /
        #: ``wait_all`` when the caller passes no timeout
        self.wait_timeout = wait_timeout
        # notification invariants (what SHIFT preserves across failover):
        # violations are always counted; strict_order additionally makes
        # an out-of-order notify fatal (the historical behaviour). The
        # scenario engine runs non-strict and asserts the counters post-run.
        self.strict_order = strict_order
        self.max_chunk_bytes = max_chunk_bytes
        self.qp_depth = qp_depth
        self.cq_depth = cq_depth
        self.recv_prepost = recv_prepost
        self.src_slots = src_slots
        self.n_channels = max(1, channels)
        self.channels: List[Channel] = [
            Channel(self, c, self.libs,
                    [self._nic_name(lib, c, nic) for lib in self.libs])
            for c in range(self.n_channels)]
        #: pod count of the underlying cluster (1 = flat single-pod)
        self.n_pods: int = getattr(cluster, "n_pods", 1)
        #: channel indices riding DCN uplinks (cross-pod tier) — the
        #: hierarchical allreduce homes its exchange chunks here
        self.dcn_channels: Tuple[int, ...] = tuple(
            c for c, ch in enumerate(self.channels) if ch.tier == "dcn")
        self.scheduler = ChannelScheduler(self, config=sched)
        # (channel, receiver, sender, seq) -> (cid, tag) of the in-flight
        # chunk: the cid routes the eventual notify to the right live
        # collective, the tag identifies the chunk within it
        self._tags: Dict[Tuple[int, int, int, int],
                         Tuple[Optional[int], object]] = {}
        # settle shadow control verbs (no-op for StandardLib worlds)
        self.sim.run(until=self.sim.now + 0.05)
        # live-collective registry: cid -> collective actor
        self._live: Dict[int, _Collective] = {}
        self._next_cid = 0
        #: peak number of simultaneously live collectives (introspection;
        #: the overlap workloads assert a floor on it)
        self.peak_live = 0
        self.failed = False
        self.fail_wc = None
        #: per-class completion latencies (virtual seconds) of finished
        #: works — the raw data behind the p50/p99 SLO histograms
        self.class_latencies: Dict[str, List[float]] = {
            k: [] for k in PRIORITY_CLASSES}

    def _nic_name(self, lib, channel: int, nic: str) -> str:
        """Channel c rides NIC index c of each host; the single-channel
        world keeps the historical explicit ``nic`` parameter."""
        if self.n_channels == 1:
            return nic
        nics = self.cluster.hosts[lib.host].nics
        if channel >= len(nics):
            raise ValueError(
                f"channels={self.n_channels} but host {lib.host} has only "
                f"{len(nics)} NICs")
        return nics[channel].name

    # -- single-channel compatibility aliases ---------------------------
    @property
    def endpoints(self) -> List[RankEndpoint]:
        """Channel 0's endpoint mesh (the historical single-rail view)."""
        return self.channels[0].endpoints

    @property
    def total_notifies(self) -> int:
        """Notify count summed over every channel."""
        return sum(ch.total_notifies for ch in self.channels)

    @property
    def order_violations(self) -> int:
        """Out-of-order notify count summed over every channel."""
        return sum(ch.order_violations for ch in self.channels)

    @property
    def duplicate_notifies(self) -> int:
        """Duplicate notify count summed over every channel."""
        return sum(ch.duplicate_notifies for ch in self.channels)

    # ------------------------------------------------------------------
    # striped data plane
    # ------------------------------------------------------------------
    def send(self, rank: int, peer: int, payload: np.ndarray, tag,
             home: Optional[int] = None, cid: Optional[int] = None,
             priority: Optional[str] = None) -> int:
        """Send one tagged chunk, striping across channels: ``home``
        (default: the tag) names the chunk's preferred channel; the
        scheduler resteers it if that channel's link is degraded or
        down. ``cid`` namespaces the tag to one live collective (None
        for raw streams — benchmarks drive the scheduler directly).
        ``priority`` overrides the chunk's latency class (default: the
        owning collective's class, ``bulk`` for raw streams). Returns
        the channel the chunk actually took."""
        if home is None:
            home = tag if isinstance(tag, int) else 0
        if priority is None:
            coll = self._live.get(cid)
            priority = coll.priority if coll is not None else "bulk"
        c = self.scheduler.pick(rank, peer, home, cid)
        self.channels[c].send(rank, peer, payload, tag, cid,
                              klass=priority)
        return c

    def _drop_tag(self, channel: Channel, rank: int, peer: int,
                  seq: int) -> None:
        """Forget a chunk whose notify was dropped by the anomaly path:
        it will never dispatch, so its tag entry and the scheduler's
        in-flight count must not linger (a leak here would bias every
        later resteer decision against the channel)."""
        entry = self._tags.pop((channel.index, rank, peer, seq), None)
        if entry is not None:
            self.scheduler.note_delivered(channel.index, entry[0])

    def _dispatch_notify(self, channel: Channel, ep: RankEndpoint,
                         peer: int, seq: int) -> None:
        """Route one in-order notify to its collective: the tag entry
        names the owning cid, so concurrent collectives never see each
        other's chunks (tag namespacing)."""
        entry = self._tags.pop((channel.index, ep.rank, peer, seq), None)
        if entry is None:
            return
        cid, tag = entry
        self.scheduler.note_delivered(channel.index, cid)
        channel.chunks_delivered += 1
        if cid is None:
            return  # raw stream chunk (no collective to notify)
        coll = self._live.get(cid)
        if coll is not None:
            coll.on_notify(ep.rank, peer, tag, ep, seq)

    # ------------------------------------------------------------------
    # async collective driver
    # ------------------------------------------------------------------
    def _launch(self, coll: _Collective,
                result_fn: Optional[Callable[[], object]] = None,
                priority: str = "bulk") -> Work:
        """Register + start one collective; returns its work handle.
        ``priority`` stamps every chunk's latency class. Degenerate
        collectives (1 rank, empty payload) complete — and retire —
        synchronously inside this call."""
        if priority not in PRIORITY_CLASSES:
            raise ValueError(f"priority {priority!r} not one of "
                             f"{PRIORITY_CLASSES}")
        cid = self._next_cid
        self._next_cid += 1
        coll.cid = cid
        coll.priority = priority
        self._live[cid] = coll
        self.peak_live = max(self.peak_live, len(self._live))
        work = Work(self, cid, coll, result_fn)
        coll.start()
        work.done()  # finalize immediately-complete collectives
        return work

    def _retire(self, cid: int) -> None:
        """Remove a finished/failed collective from the registry,
        reconcile the scheduler's per-collective accounting, and purge
        its queued (never-posted) chunks from every channel's dispatch
        queue — a stalled high-priority collective's backlog must
        neither dispatch posthumously nor double-decrement anything
        (purged chunks never got a seq, so no tag/delivery exists)."""
        self._live.pop(cid, None)
        self.scheduler.retire(cid)
        for ch in self.channels:
            ch.purge(cid)

    def _note_class_latency(self, klass: str, latency: float) -> None:
        """Record one finished work's completion latency (virtual
        seconds) under its latency class."""
        self.class_latencies.setdefault(klass, []).append(latency)

    def class_latency_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-class completion-latency histogram summary: count, p50
        and p99 in virtual milliseconds (deterministic — same seed,
        same histogram). Classes with no finished works are omitted."""
        out: Dict[str, Dict[str, float]] = {}
        for klass, lats in self.class_latencies.items():
            if not lats:
                continue
            arr = np.asarray(lats)
            out[klass] = {
                "count": len(lats),
                "p50_virtual_ms": round(float(np.percentile(arr, 50))
                                        * 1e3, 6),
                "p99_virtual_ms": round(float(np.percentile(arr, 99))
                                        * 1e3, 6),
            }
        return out

    def wait_all(self, works: Sequence[Work],
                 timeout: Optional[float] = None) -> Sequence[Work]:
        """Pump the simulator until every handle in ``works`` completes.

        The deadline covers the whole batch (virtual seconds from now;
        ``None`` uses the world-level ``wait_timeout`` default). On an
        unmaskable failure the non-tolerant pending works are failed
        and the error raised; on timeout every pending work is failed.
        Error messages name the pending works (cid, kind, latency
        class) so mixed-load timeouts are attributable. Returns
        ``works`` for chaining.
        """
        if timeout is None:
            timeout = self.wait_timeout
        deadline = self.sim.now + timeout
        pending = [w for w in works if not w.done()]
        while pending:
            if self.failed:
                doomed = [w for w in pending
                          if not w._coll.tolerates_failure]
                if doomed:
                    exc = CollectiveError(
                        f"collective aborted: {self.fail_wc} "
                        f"[{_describe_works(doomed)}]")
                    for w in doomed:
                        w._fail(exc)
                    raise exc
            t = self.sim.peek_time()
            if t is None or t > deadline:
                exc = CollectiveError(
                    (f"collective dead after failure: {self.fail_wc}"
                     if self.failed else
                     f"collective timed out after {timeout}s") +
                    f" [pending: {_describe_works(pending)}]")
                for w in pending:
                    w._fail(exc)
                raise exc
            self.sim.step()
            pending = [w for w in pending if not w.done()]
        return works

    @property
    def any_shift(self) -> bool:
        """True if any rank runs ShiftLib (collectives tolerate faults)."""
        return any(isinstance(lib, ShiftLib) for lib in self.libs)

    def aligned_bucket_bounds(self, total_elems: int, itemsize: int,
                              target_bytes: int) -> List[Tuple[int, int]]:
        """Element ranges of size-targeted buckets whose boundaries are
        ALIGNED to this world's allreduce bucket granularity
        (``max_chunk_bytes * n_ranks`` worth of elements).

        Aligned buckets give every engine-level chunk the same bounds —
        and therefore the same ring-reduction order per element — as the
        flat-vector all-reduce of the whole range, which is what makes a
        bucketed (and overlapped) collective BYTE-IDENTICAL to the
        sequential flat path for every dtype, floats included. This is
        the single source of truth for that alignment: the DDP trainer,
        the overlap campaign workload and the byte-identity tests all
        derive their bucket bounds here (the launch dry-runs use the
        module-level :func:`aligned_bucket_bounds`, which this method
        delegates to). ``target_bytes=0`` means one flat bucket.
        """
        return aligned_bucket_bounds(total_elems, itemsize, target_bytes,
                                     max_chunk_bytes=self.max_chunk_bytes,
                                     n_ranks=self.n_ranks)

    # -- async public API -----------------------------------------------
    # every launcher takes ``priority`` — the latency class
    # (``latency_critical`` / ``bulk`` / ``background``) stamped on the
    # work handle and on every chunk the collective dispatches
    def allreduce_async(self, arrays: List[np.ndarray],
                        op: str = "sum",
                        priority: str = "bulk") -> Work:
        """Launch a ring all-reduce of ``arrays`` in place (one array per
        rank); returns a :class:`Work` whose result is ``arrays``."""
        coll = _RingAllReduce(self, arrays, op)
        return self._launch(coll, lambda: arrays, priority=priority)

    def hierarchical_allreduce_async(self, arrays: List[np.ndarray],
                                     compress: bool = True,
                                     feedback: Optional[Dict] = None,
                                     priority: str = "bulk") -> Work:
        """Launch the two-tier allreduce (intra-pod reduce-scatter,
        cross-pod shard exchange over the DCN — int8-compressed with
        error feedback unless ``compress=False`` — intra-pod
        all-gather). Requires a multi-pod world (``n_pods >= 2``) with
        at least one DCN channel; float32 sum only. ``feedback`` is the
        caller-owned error-feedback dict keyed ``(pod, bucket, shard)``
        — pass the SAME dict every step so quantization residue carries
        across steps (see ``repro.optim.compress``). The work's result
        is ``arrays``, reduced in place."""
        if self.n_pods >= 2 and not self.dcn_channels:
            raise ValueError(
                "hierarchical allreduce needs a DCN channel: build the "
                "world with channels > nics_per_host so the uplinks are "
                "striped (e.g. channels=nics_per_host+1)")
        coll = _HierarchicalAllReduce(self, arrays, compress=compress,
                                      feedback=feedback)
        return self._launch(coll, lambda: arrays, priority=priority)

    def reduce_scatter_async(self, arrays: List[np.ndarray],
                             op: str = "sum",
                             priority: str = "bulk") -> Work:
        """Launch a ring reduce-scatter; the work's result is each rank's
        owned (fully reduced) elements — rank r owns chunk (r+1) % n."""
        coll = _RingAllReduce(self, arrays, op, phases=("rs",))
        coll.kind = "reduce_scatter"

        def _owned() -> List[np.ndarray]:
            n = self.n_ranks
            out = []
            for r in range(n):
                own = (r + 1) % n
                flat = arrays[r].reshape(-1)
                parts = [flat[c0:c1] for c0, c1 in
                         (coll._chunk_bounds(b, own)
                          for b in range(coll.n_buckets))]
                out.append(np.concatenate(parts) if parts else flat[:0])
            return out
        return self._launch(coll, _owned, priority=priority)

    def all_gather_async(self, shards: List[np.ndarray],
                         priority: str = "bulk") -> Work:
        """Launch a ring all-gather of variable-size ``shards``; the
        work's result is one concatenated array per rank."""
        full = [np.concatenate([np.zeros_like(s) for s in shards])
                for _ in range(self.n_ranks)]
        for r, s in enumerate(shards):
            off = sum(x.size for x in shards[:r])
            full[r][off:off + s.size] = s
        coll = _RingAllGather(self, full, [s.size for s in shards])
        return self._launch(coll, lambda: full, priority=priority)

    def shard_bounds(self, total: int) -> List[Tuple[int, int]]:
        """Per-rank contiguous slice bounds of a ``total``-element vector
        (balanced: the first ``total % n_ranks`` ranks get one extra
        element). The serving engine's tensor-parallel contract derives
        every activation/logits shard from these bounds, so all ranks
        agree on who owns which slice without any metadata exchange."""
        base, rem = divmod(total, self.n_ranks)
        bounds = []
        off = 0
        for r in range(self.n_ranks):
            size = base + (1 if r < rem else 0)
            bounds.append((off, off + size))
            off += size
        return bounds

    def gather_replicated_async(self, array: np.ndarray,
                                priority: str = "bulk") -> Work:
        """Serving-shaped all-gather: every rank holds the same
        replicated 1-D ``array`` (e.g. a tensor-parallel layer's
        activations or logits recomputed on each rank); rank r
        contributes ITS slice (``shard_bounds``) and the work's result
        is each rank's fabric-reconstructed copy of the full vector.

        The reconstruction is pure data movement — no reduction — so on
        a healthy or SHIFT-masked fabric it is byte-identical to the
        input; the serving engine samples from the reconstructed bytes,
        making any corruption observable as a wrong token."""
        if array.ndim != 1:
            raise ValueError("gather_replicated_async takes a 1-D array")
        shards = [array[lo:hi].copy()
                  for lo, hi in self.shard_bounds(array.size)]
        return self.all_gather_async(shards, priority=priority)

    def broadcast_async(self, array: np.ndarray, root: int = 0,
                        priority: str = "bulk") -> Work:
        """Launch a pipelined chain broadcast from ``root``; the work's
        result is one output per rank (the root's is a read-only alias)."""
        # Ownership rule: the root's entry is a READ-ONLY view of the
        # caller's array — the pipeline only ever reads the root slot
        # (non-roots get fresh writable buffers), so aliasing the input
        # is safe and saves a full-size copy. Callers that need an
        # independent root buffer copy it themselves.
        root_view = array.view()
        root_view.flags.writeable = False
        outs = [root_view if r == root else np.zeros_like(array)
                for r in range(self.n_ranks)]
        coll = _PipelineBroadcast(self, outs, root)
        return self._launch(coll, lambda: outs, priority=priority)

    def all_to_all_async(self, mats: List[np.ndarray],
                         priority: str = "bulk") -> Work:
        """Launch a chunk-striped all-to-all (``mats[r]`` row j goes to
        rank j); the work's result is one received matrix per rank."""
        outs = [np.zeros_like(m) for m in mats]
        coll = _AllToAll(self, mats, outs)
        return self._launch(coll, lambda: outs, priority=priority)

    # -- blocking public API (async + wait) -------------------------------
    def allreduce(self, arrays: List[np.ndarray], op: str = "sum",
                  timeout: Optional[float] = None,
                  priority: str = "bulk") -> List[np.ndarray]:
        """Ring all-reduce ``arrays`` in place (one array per rank)."""
        return self.allreduce_async(arrays, op,
                                    priority=priority).wait(timeout)

    def hierarchical_allreduce(self, arrays: List[np.ndarray],
                               compress: bool = True,
                               feedback: Optional[Dict] = None,
                               timeout: Optional[float] = None,
                               priority: str = "bulk") -> List[np.ndarray]:
        """Two-tier (pod-hierarchical) allreduce of ``arrays`` in place;
        see :meth:`hierarchical_allreduce_async`."""
        return self.hierarchical_allreduce_async(
            arrays, compress=compress, feedback=feedback,
            priority=priority).wait(timeout)

    def reduce_scatter(self, arrays: List[np.ndarray], op: str = "sum",
                       timeout: Optional[float] = None,
                       priority: str = "bulk") -> List[np.ndarray]:
        """After ring reduce-scatter, rank r owns chunk (r+1) % n of each
        bucket; returns each rank's owned (fully reduced) elements."""
        return self.reduce_scatter_async(arrays, op,
                                         priority=priority).wait(timeout)

    def all_gather(self, shards: List[np.ndarray],
                   timeout: Optional[float] = None,
                   priority: str = "bulk") -> List[np.ndarray]:
        """Ring all-gather: every rank ends with the concatenation of
        all ranks' (variable-size) shards."""
        return self.all_gather_async(shards,
                                     priority=priority).wait(timeout)

    def broadcast(self, array: np.ndarray, root: int = 0,
                  timeout: Optional[float] = None,
                  priority: str = "bulk") -> List[np.ndarray]:
        """Pipelined chain broadcast of ``array`` from ``root``; returns
        one output per rank (the root's is a read-only alias)."""
        return self.broadcast_async(array, root,
                                    priority=priority).wait(timeout)

    def all_to_all(self, mats: List[np.ndarray],
                   timeout: Optional[float] = None,
                   priority: str = "bulk") -> List[np.ndarray]:
        """mats[r] has shape (n_ranks, k): row j goes to rank j."""
        return self.all_to_all_async(mats,
                                     priority=priority).wait(timeout)

    def barrier(self, timeout: float = 60.0) -> None:
        """Block (in virtual time) until every rank reaches the barrier."""
        self.allreduce([np.zeros(self.n_ranks, dtype=np.float32)
                        for _ in range(self.n_ranks)], timeout=timeout)

    def stats_snapshot(self) -> Dict[str, object]:
        """Aggregate SHIFT + notification + per-channel stats for
        campaign reports."""
        shift_libs = [lib for lib in self.libs if isinstance(lib, ShiftLib)]
        return {
            "fallbacks": sum(l.stats.fallbacks for l in shift_libs),
            "recoveries": sum(l.stats.recoveries for l in shift_libs),
            "errors_propagated": sum(l.stats.errors_propagated
                                     for l in shift_libs),
            "payload_bytes_held": sum(l.stats.payload_bytes_held
                                      for l in shift_libs),
            "fallback_latencies": [lat for l in shift_libs
                                   for lat in l.stats.fallback_latencies],
            "total_notifies": self.total_notifies,
            "order_violations": self.order_violations,
            "duplicate_notifies": self.duplicate_notifies,
            "rank_errors": [sum(len(ch.endpoints[r].errors)
                                for ch in self.channels)
                            for r in range(self.n_ranks)],
            "channels": [ch.stats() for ch in self.channels],
            "scheduler": self.scheduler.snapshot(),
            "telemetry": self.cluster.telemetry.snapshot(),
            "peak_live_collectives": self.peak_live,
            "live_collectives": len(self._live),
            "inflight_tags": len(self._tags),
            "class_dispatched": {
                k: sum(ch.class_dispatched[k] for ch in self.channels)
                for k in PRIORITY_CLASSES},
            "priority_overtakes": sum(ch.priority_overtakes
                                      for ch in self.channels),
            "class_latency": self.class_latency_stats(),
        }


def build_world(n_ranks: int = 2, lib_kind: str = "shift",
                nics_per_host: int = 2, probe_interval: float = 5e-3,
                max_chunk_bytes: int = DEFAULT_MAX_CHUNK_BYTES,
                strict_order: bool = True,
                fast: bool = True, channels: int = 1,
                n_pods: int = 1,
                dcn_bandwidth: Optional[float] = None,
                dcn_latency: Optional[float] = None,
                dcn_loss: float = 0.0,
                **world_kw) -> Tuple[Cluster, List, JcclWorld]:
    """Scenario-harness entry point: a fresh cluster + per-rank libs + a
    fully wired JcclWorld. Consolidates the setup previously copy-pasted
    across tests and benchmarks; the campaign engine drives it directly.
    ``fast`` selects the coalescing zero-copy datapath (default); pass
    False to run on the legacy per-WQE event chain. ``channels`` stripes
    collectives across that many rails (requires ``nics_per_host >=
    channels``); SHIFT backup placement is made rail-aware via
    ``ShiftConfig.data_rails`` so channels prefer spare rails over each
    other's default rails.

    ``n_pods > 1`` builds the heterogeneous two-tier fabric: rail
    switches become pod-local and every host gains two DCN uplinks
    (``dcn0``/``dcn1`` at NIC indices ``nics_per_host`` and
    ``nics_per_host + 1``, with ``dcn_*`` link parameters — defaults in
    ``repro.core.fabric.build_cluster``). Pass ``channels =
    nics_per_host + 1`` to stripe a DCN channel alongside the rails
    (the hierarchical allreduce requires one). SHIFT backup placement
    is tier-pinned: rail i falls back to rail ``(i+1) % nics_per_host``
    and ``dcn0`` to ``dcn1`` — a rail never falls back onto the
    thousand-times-thinner DCN, and the DCN uplink pair covers each
    other (the ``dcn_partition_transient`` scenario's failover)."""
    from ..core import verbs as V
    from ..core.fabric import build_cluster
    from ..core.shift import ShiftConfig

    host_nics = nics_per_host + (2 if n_pods > 1 else 0)
    if channels > host_nics:
        raise ValueError(f"channels={channels} > NICs per host="
                         f"{host_nics}")
    V.reset_registries()
    cluster_kw = {}
    if n_pods > 1:
        cluster_kw["n_pods"] = n_pods
        if dcn_bandwidth is not None:
            cluster_kw["dcn_bandwidth"] = dcn_bandwidth
        if dcn_latency is not None:
            cluster_kw["dcn_latency"] = dcn_latency
        if dcn_loss:
            cluster_kw["dcn_loss"] = dcn_loss
    cluster = build_cluster(n_hosts=n_ranks, nics_per_host=nics_per_host,
                            **cluster_kw)
    cluster.fast_datapath = fast
    backup_overrides = None
    if n_pods > 1:
        backup_overrides = {i: (i + 1) % nics_per_host
                            for i in range(nics_per_host)}
        backup_overrides[nics_per_host] = nics_per_host + 1
        backup_overrides[nics_per_host + 1] = nics_per_host
    libs: List = []
    if lib_kind == "shift":
        kv = None
        for r in range(n_ranks):
            lib = ShiftLib(cluster, f"host{r}", kv=kv,
                           config=ShiftConfig(probe_interval=probe_interval,
                                              data_rails=max(1, channels),
                                              backup_overrides=(
                                                  backup_overrides)))
            kv = lib.kv
            libs.append(lib)
    else:
        libs = [StandardLib(cluster, f"host{r}") for r in range(n_ranks)]
    world = JcclWorld(cluster, libs, max_chunk_bytes=max_chunk_bytes,
                      strict_order=strict_order, channels=channels,
                      **world_kw)
    return cluster, libs, world
