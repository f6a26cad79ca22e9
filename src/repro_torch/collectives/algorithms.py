"""Collective algorithms as channel-striping chunk schedulers.

Every algorithm is an event-driven actor: ``start()`` launches the first
wave of chunks, ``on_notify`` consumes one delivered chunk and launches
its successors, ``done()`` reports completion. Chunks go out through
``_Collective._send(rank, peer, payload, tag, home)``, which forwards to
``JcclWorld.send`` with this collective's id (cid): the *tag* identifies
the chunk to the algorithm when the matching notify lands (so arrival
order across channels does not matter), *home* is the chunk's preferred
channel — the scheduler honours it while the channel is healthy and
resteers it otherwise — and the *cid* namespaces the tag so any number of
collectives can be live at once without their notifies cross-dispatching.

Defense in depth: the world only routes a notify to the collective whose
cid stamped the chunk, AND every ``on_notify`` rejects foreign input
(wrong ring predecessor, out-of-range or missing tag). A stray notify is
dropped — the collective stalls loudly (timeout) instead of corrupting
its output buffers.

Striping units (each unit's chunk chain is ordered; units are
independent, so they ride different rails concurrently):

* all-reduce / reduce-scatter — **buckets**: each bucket runs the full
  ring pipeline on its home channel.
* all-gather — **shards**: each shard's trip around the ring is a chain.
* broadcast — **chunks**: each pipeline chunk travels the root chain.
* all-to-all — **row chunks**: each (src, dst) row is split into
  ``max_chunk_bytes`` chunks with per-chunk tags/home channels, so one
  large MoE row stripes across rails like the ring collectives do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _reduce(dst: np.ndarray, src: np.ndarray, op: str) -> None:
    if op == "sum":
        np.add(dst, src, out=dst)
    elif op == "max":
        np.maximum(dst, src, out=dst)
    else:
        raise ValueError(op)


class _Collective:
    tolerates_failure = False
    #: collective kind for error attribution (overridden per subclass)
    kind = "collective"

    def __init__(self, world):
        self.world = world
        #: collective id — assigned by ``JcclWorld._launch`` before
        #: ``start()``; namespaces every chunk tag this actor sends
        self.cid: Optional[int] = None
        #: latency class — stamped by ``JcclWorld._launch`` before
        #: ``start()``; every chunk dispatches under it
        self.priority: str = "bulk"
        self.tolerates_failure = world.any_shift

    def _send(self, rank: int, peer: int, payload: np.ndarray, tag,
              home: int) -> None:
        """Send one chunk stamped with this collective's cid."""
        self.world.send(rank, peer, payload, tag, home=home, cid=self.cid)

    def start(self) -> None:
        raise NotImplementedError

    def on_notify(self, rank: int, peer: int, tag, ep, seq: int) -> None:
        raise NotImplementedError

    def done(self) -> bool:
        raise NotImplementedError


class _RingAllReduce(_Collective):
    """Chunked, bucketed ring all-reduce (reduce-scatter + all-gather).

    Buckets are independent ring pipelines striped across channels:
    bucket b's home channel is ``b % channels``, so with two healthy
    rails half the buckets flow on each. Within a bucket each rank has
    at most one chunk in flight (recv step t gates send step t+1), so
    per-bucket notifies always arrive in step order.

    Chunk bounds are deliberately NOT telemetry-adapted: the reduction
    chunking fixes the per-element reduction order, and the
    byte-identity contract (``JcclWorld.aligned_bucket_bounds``) pins it
    to ``max_chunk_bytes``. Size adaptation applies only to the pure
    data-movement collectives (broadcast, all-to-all)."""

    kind = "allreduce"

    def __init__(self, world, arrays: List[np.ndarray],
                 op: str = "sum", phases: Tuple[str, ...] = ("rs", "ag")):
        super().__init__(world)
        n = world.n_ranks
        assert len(arrays) == n
        self.op = op
        self.phases = phases
        self.arrays = arrays
        self.flat = [a.reshape(-1) for a in arrays]
        self.dtype = self.flat[0].dtype
        self.itemsize = self.dtype.itemsize
        total = self.flat[0].size
        # bucket so one chunk fits the staging slot
        max_chunk_elems = world.max_chunk_bytes // self.itemsize
        if total and max_chunk_elems == 0:
            raise ValueError(
                f"max_chunk_bytes={world.max_chunk_bytes} cannot hold one "
                f"{self.dtype} element")
        self.bucket_elems = min(total, max_chunk_elems * n)
        self.n_buckets = ((total + self.bucket_elems - 1) // self.bucket_elems
                          if self.bucket_elems else 0)
        self.steps_per_bucket = len(phases) * max(n - 1, 0)
        self.buckets_done = [0] * n
        self.done_ranks = 0

    # -- index helpers ------------------------------------------------------
    def _chunk_bounds(self, bucket: int, chunk: int) -> Tuple[int, int]:
        n = self.world.n_ranks
        b0 = bucket * self.bucket_elems
        b1 = min(b0 + self.bucket_elems, self.flat[0].size)
        size = b1 - b0
        per = (size + n - 1) // n
        c0 = b0 + chunk * per
        c1 = min(b0 + (chunk + 1) * per, b1)
        return c0, max(c0, c1)

    def _decode(self, step: int) -> Tuple[str, int]:
        n1 = max(self.world.n_ranks - 1, 1)
        return self.phases[step // n1], step % n1

    def _send_for_step(self, rank: int, bucket: int, step: int) -> None:
        if step >= self.steps_per_bucket:
            self.buckets_done[rank] += 1
            if self.buckets_done[rank] == self.n_buckets:
                self.done_ranks += 1
            return
        n = self.world.n_ranks
        phase, s = self._decode(step)
        chunk = (rank - s) % n if phase == "rs" else (rank + 1 - s) % n
        c0, c1 = self._chunk_bounds(bucket, chunk)
        self._send(rank, (rank + 1) % n, self.flat[rank][c0:c1],
                   tag=bucket * self.steps_per_bucket + step,
                   home=bucket)

    def start(self) -> None:
        n = self.world.n_ranks
        if n == 1 or self.steps_per_bucket == 0 or self.n_buckets == 0:
            self.done_ranks = n
            return
        for r in range(n):
            for b in range(self.n_buckets):
                self._send_for_step(r, b, 0)

    def on_notify(self, rank: int, peer: int, tag, ep, seq: int) -> None:
        n = self.world.n_ranks
        if peer != (rank - 1) % n or not isinstance(tag, int):
            return
        if not 0 <= tag < self.n_buckets * self.steps_per_bucket:
            return  # foreign tag: not one of this collective's chunks
        bucket, step = divmod(tag, self.steps_per_bucket)
        phase, s = self._decode(step)
        chunk = (rank - s - 1) % n if phase == "rs" else (rank - s) % n
        c0, c1 = self._chunk_bounds(bucket, chunk)
        stage = ep.staging_slot_view(
            peer, seq, (c1 - c0) * self.itemsize).view(self.dtype)
        if phase == "rs":
            _reduce(self.flat[rank][c0:c1], stage, self.op)
        else:
            self.flat[rank][c0:c1] = stage
        self._send_for_step(rank, bucket, step + 1)

    def done(self) -> bool:
        return self.done_ranks == self.world.n_ranks


class _RingAllGather(_Collective):
    """Ring all-gather over variable-size shards. Each shard's trip
    around the ring is an independent chain (tag = shard index), so the
    n shards stripe across channels and pipeline concurrently."""

    kind = "all_gather"

    def __init__(self, world, full: List[np.ndarray], sizes: List[int]):
        super().__init__(world)
        self.full = [f.reshape(-1) for f in full]
        self.sizes = sizes
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.dtype = self.full[0].dtype
        self.itemsize = self.dtype.itemsize
        n = world.n_ranks
        self.remaining = [n - 1] * n    # shards each rank still awaits
        self.done_ranks = 0

    def _forward(self, rank: int, shard: int) -> None:
        n = self.world.n_ranks
        nxt = (rank + 1) % n
        if nxt == shard:
            return  # the shard is back at its origin: chain complete
        o0, o1 = self.offsets[shard], self.offsets[shard + 1]
        self._send(rank, nxt, self.full[rank][o0:o1],
                   tag=shard, home=shard)

    def start(self) -> None:
        n = self.world.n_ranks
        if n == 1:
            self.done_ranks = 1
            return
        for r in range(n):
            self._forward(r, r)     # launch this rank's own shard


    def on_notify(self, rank: int, peer: int, tag, ep, seq: int) -> None:
        n = self.world.n_ranks
        if peer != (rank - 1) % n or not isinstance(tag, int):
            return
        if not 0 <= tag < n:
            return  # foreign tag: no such shard
        shard = tag
        o0, o1 = self.offsets[shard], self.offsets[shard + 1]
        stage = ep.staging_slot_view(
            peer, seq, (o1 - o0) * self.itemsize).view(self.dtype)
        self.full[rank][o0:o1] = stage
        self.remaining[rank] -= 1
        if self.remaining[rank] == 0:
            self.done_ranks += 1
        self._forward(rank, shard)

    def done(self) -> bool:
        return self.done_ranks == self.world.n_ranks


class _PipelineBroadcast(_Collective):
    """Chain broadcast root -> root+1 -> ... in pipelined chunks. Each
    chunk travels the chain independently (tag = chunk index); the
    per-peer send FIFO provides the flow control that used to be the
    explicit pipeline-depth ratchet.

    Pure data movement, so wire-chunk sizes are telemetry-adapted:
    chunk ci homes on channel ``ci % channels`` and its size comes from
    ``ChannelScheduler.adaptive_chunk_bytes(ci)`` — a degraded rail's
    chunks shrink to bound per-chunk latency skew. The chunking is
    fixed at construction (deterministic, all ranks share this actor),
    and any chunk the scheduler later resteers just rides the healthy
    rail at its smaller size."""

    kind = "broadcast"

    def __init__(self, world, outs: List[np.ndarray], root: int):
        super().__init__(world)
        self.outs = [o.reshape(-1) for o in outs]
        self.root = root
        self.dtype = self.outs[0].dtype
        self.itemsize = self.dtype.itemsize
        total = self.outs[0].size
        sched = world.scheduler
        chunks = []
        i = 0
        while i < total:
            per = max(1, sched.adaptive_chunk_bytes(len(chunks))
                      // self.itemsize)
            chunks.append((i, min(i + per, total)))
            i += per
        self.chunks = chunks or [(0, 0)]
        n = world.n_ranks
        self.remaining = [len(self.chunks)] * n
        self.remaining[root] = 0
        self.done_ranks = 1  # root is trivially done receiving

    def start(self) -> None:
        n = self.world.n_ranks
        if n == 1:
            return
        nxt = (self.root + 1) % n
        for ci, (c0, c1) in enumerate(self.chunks):
            self._send(self.root, nxt, self.outs[self.root][c0:c1],
                       tag=ci, home=ci)

    def on_notify(self, rank: int, peer: int, tag, ep, seq: int) -> None:
        n = self.world.n_ranks
        if peer != (rank - 1) % n or not isinstance(tag, int):
            return
        if not 0 <= tag < len(self.chunks):
            return  # foreign tag: no such pipeline chunk
        c0, c1 = self.chunks[tag]
        stage = ep.staging_slot_view(
            peer, seq, (c1 - c0) * self.itemsize).view(self.dtype)
        self.outs[rank][c0:c1] = stage
        self.remaining[rank] -= 1
        if self.remaining[rank] == 0:
            self.done_ranks += 1
        nxt = (rank + 1) % n
        if nxt != self.root:
            self._send(rank, nxt, self.outs[rank][c0:c1],
                       tag=tag, home=tag)

    def done(self) -> bool:
        return self.done_ranks == self.world.n_ranks


class _HierarchicalAllReduce(_Collective):
    """Two-tier allreduce for multi-pod clusters (DESIGN.md §11):
    intra-pod ring reduce-scatter, cross-pod exchange of each owned
    shard between the pods' counterpart owners (optionally
    int8-compressed with error feedback), intra-pod ring all-gather.

    Rank layout follows the fabric's block partition: rank r sits in
    pod ``r // R`` with local index ``j = r % R`` (R ranks per pod).
    After the pod-local reduce-scatter, local rank j owns shard
    ``(j + 1) % R`` of each bucket fully pod-reduced — the same
    ownership convention as the flat ring. The owner then exchanges
    that shard DIRECTLY with its counterparts (same local index) in
    every other pod over the DCN tier, and each owner computes the
    final shard as the sum of every pod's contribution **in pod-index
    order, its own contribution passed through the same
    compress/decompress round-trip** — so the result is byte-identical
    across pods regardless of arrival order or which side compressed.
    Compression error (what int8 dropped of THIS pod's partial sum) is
    carried in the caller's ``feedback`` dict keyed ``(pod, bucket,
    shard)`` and fed into the next step's compression — no gradient
    mass is lost, only deferred (see ``repro.optim.compress``).

    All three stages dispatch through the ordinary cid-keyed send path:
    SHIFT fallback, EDF latency classes and the campaign invariants
    apply unchanged on both tiers. Cross-pod chunks home on the DCN
    channels (the scheduler's path-feasibility filter would route them
    there anyway); intra-pod chunks stripe over the rails by bucket.
    """

    kind = "hier_allreduce"

    def __init__(self, world, arrays: List[np.ndarray], op: str = "sum",
                 compress: bool = True,
                 feedback: Optional[Dict] = None):
        super().__init__(world)
        n = world.n_ranks
        pods = world.n_pods
        if pods < 2:
            raise ValueError("hierarchical allreduce needs n_pods >= 2")
        if n % pods != 0:
            raise ValueError(f"n_ranks={n} not divisible by n_pods={pods}")
        if op != "sum":
            raise ValueError("hierarchical allreduce supports op='sum' "
                             "only (compression commutes with sums)")
        assert len(arrays) == n
        self.op = op
        self.compress = compress
        self.feedback = feedback if feedback is not None else {}
        self.pods = pods
        self.R = n // pods
        self.arrays = arrays
        self.flat = [a.reshape(-1) for a in arrays]
        self.dtype = self.flat[0].dtype
        if self.dtype != np.float32:
            raise ValueError("hierarchical allreduce is float32-only "
                             "(the int8 wire format is fixed)")
        self.itemsize = self.dtype.itemsize
        total = self.flat[0].size
        max_chunk_elems = world.max_chunk_bytes // self.itemsize
        if total and max_chunk_elems == 0:
            raise ValueError(
                f"max_chunk_bytes={world.max_chunk_bytes} cannot hold one "
                f"{self.dtype} element")
        # bucket so one per-pod shard chunk fits the staging slot (the
        # compressed X payload is 4 + elems bytes <= elems * 4, so it
        # fits wherever the raw shard does)
        self.bucket_elems = min(total, max_chunk_elems * self.R)
        self.n_buckets = ((total + self.bucket_elems - 1)
                          // self.bucket_elems if self.bucket_elems else 0)
        self.rs_steps = self.R - 1
        # tag layout: [0, X0) intra-pod RS steps, [X0, A0) cross-pod
        # exchange, [A0, end) intra-pod all-gather
        self.X0 = self.n_buckets * max(self.rs_steps, 0)
        self.A0 = self.X0 + self.n_buckets * self.R
        self.tag_end = self.A0 + self.n_buckets * self.R
        # per-rank finalize countdown: every rank finalizes R chunks per
        # bucket (1 own X combine + R-1 all-gather receives)
        self.remaining = [self.n_buckets * self.R] * n
        # cross-pod receive buffers: (rank, bucket, shard) -> {src_pod:
        # packed payload copy}; own packed contribution kept alongside
        # so the combine sums ALL pods' bytes in pod-index order
        self._xrecv: Dict[Tuple[int, int, int], Dict[int, np.ndarray]] = {}
        self._xown: Dict[Tuple[int, int, int], np.ndarray] = {}

    # -- index helpers ------------------------------------------------------
    def _pod(self, rank: int) -> int:
        return rank // self.R

    def _local(self, rank: int) -> int:
        return rank % self.R

    def _lnext(self, rank: int) -> int:
        return self._pod(rank) * self.R + (self._local(rank) + 1) % self.R

    def _lprev(self, rank: int) -> int:
        return self._pod(rank) * self.R + (self._local(rank) - 1) % self.R

    def _chunk_bounds(self, bucket: int, chunk: int) -> Tuple[int, int]:
        b0 = bucket * self.bucket_elems
        b1 = min(b0 + self.bucket_elems, self.flat[0].size)
        size = b1 - b0
        per = (size + self.R - 1) // self.R
        c0 = b0 + chunk * per
        c1 = min(b0 + (chunk + 1) * per, b1)
        return c0, max(c0, c1)

    def _dcn_home(self, bucket: int) -> int:
        dcn = self.world.dcn_channels
        return dcn[bucket % len(dcn)] if dcn else bucket

    # -- stage 1: intra-pod ring reduce-scatter -----------------------------
    def _send_rs(self, rank: int, bucket: int, step: int) -> None:
        if step >= self.rs_steps:
            # pod-local reduction complete: this rank owns shard
            # (local + 1) % R of the bucket — start the cross exchange
            self._start_x(rank, bucket)
            return
        j = self._local(rank)
        chunk = (j - step) % self.R
        c0, c1 = self._chunk_bounds(bucket, chunk)
        self._send(rank, self._lnext(rank), self.flat[rank][c0:c1],
                   tag=bucket * self.rs_steps + step, home=bucket)

    # -- stage 2: cross-pod compressed exchange -----------------------------
    def _pack(self, rank: int, bucket: int, shard: int) -> np.ndarray:
        """Pack this pod's reduced shard for the wire: raw float32
        bytes, or ``scale || q`` with the quantization residual written
        back into the feedback dict."""
        from ..optim.compress import int8_compress

        c0, c1 = self._chunk_bounds(bucket, shard)
        vec = self.flat[rank][c0:c1]
        if not self.compress:
            return np.ascontiguousarray(vec).view(np.uint8).copy()
        key = (self._pod(rank), bucket, shard)
        err = self.feedback.get(key)
        if err is not None and err.shape != vec.shape:
            err = None      # bucket layout changed: stale feedback
        q, scale, new_err = int8_compress(vec, err)
        self.feedback[key] = new_err
        buf = np.empty(4 + q.size, dtype=np.uint8)
        buf[:4].view(np.float32)[0] = scale
        buf[4:] = q.view(np.uint8)
        return buf

    def _unpack(self, raw: np.ndarray, elems: int) -> np.ndarray:
        """Decode one packed contribution back to float32."""
        from ..optim.compress import int8_decompress

        if not self.compress:
            return raw.view(np.float32)
        scale = raw[:4].view(np.float32)[0]
        return int8_decompress(raw[4:].view(np.int8), scale)

    def _start_x(self, rank: int, bucket: int) -> None:
        shard = (self._local(rank) + 1) % self.R
        packed = self._pack(rank, bucket, shard)
        self._xown[(rank, bucket, shard)] = packed
        tag = self.X0 + bucket * self.R + shard
        for p in range(self.pods):
            if p == self._pod(rank):
                continue
            peer = p * self.R + self._local(rank)
            self._send(rank, peer, packed, tag=tag,
                       home=self._dcn_home(bucket))
        # counterpart payloads may already be buffered: under
        # concurrent collectives (or a fast DCN) another pod's X chunk
        # can land BEFORE this rank's own reduce-scatter finishes
        self._maybe_combine(rank, bucket, shard)

    def _maybe_combine(self, rank: int, bucket: int, shard: int) -> None:
        """Combine once BOTH sides are ready: this rank's own packed
        contribution exists (reduce-scatter done) and every other pod's
        payload has been buffered — whichever happens last triggers."""
        key = (rank, bucket, shard)
        if key not in self._xown:
            return      # own RS not done yet (or already combined)
        if len(self._xrecv.get(key, ())) >= self.pods - 1:
            self._combine(rank, bucket, shard)

    def _combine(self, rank: int, bucket: int, shard: int) -> None:
        """All pods' contributions arrived: sum them in POD-INDEX order
        (own pod included, through the same pack/unpack round-trip) so
        every pod's owner materializes byte-identical final bytes."""
        c0, c1 = self._chunk_bounds(bucket, shard)
        got = self._xrecv.pop((rank, bucket, shard), {})
        own = self._xown.pop((rank, bucket, shard))
        acc = np.zeros(c1 - c0, dtype=np.float32)
        for p in range(self.pods):
            raw = own if p == self._pod(rank) else got[p]
            acc += self._unpack(raw, c1 - c0)
        self.flat[rank][c0:c1] = acc
        self._finalize(rank)
        self._forward_ag(rank, bucket, shard)

    # -- stage 3: intra-pod ring all-gather ---------------------------------
    def _forward_ag(self, rank: int, bucket: int, shard: int) -> None:
        nxt = self._lnext(rank)
        if self.R == 1 or self._local(nxt) == (shard - 1) % self.R:
            return      # next hop is the shard's owner: chain complete
        c0, c1 = self._chunk_bounds(bucket, shard)
        self._send(rank, nxt, self.flat[rank][c0:c1],
                   tag=self.A0 + bucket * self.R + shard, home=bucket)

    def _finalize(self, rank: int) -> None:
        self.remaining[rank] -= 1

    # -- actor interface ----------------------------------------------------
    def start(self) -> None:
        if self.n_buckets == 0:
            return
        for r in range(self.world.n_ranks):
            for b in range(self.n_buckets):
                self._send_rs(r, b, 0)

    def on_notify(self, rank: int, peer: int, tag, ep, seq: int) -> None:
        if not isinstance(tag, int) or not 0 <= tag < self.tag_end:
            return      # foreign tag
        if tag < self.X0:
            self._on_rs(rank, peer, tag, ep, seq)
        elif tag < self.A0:
            self._on_x(rank, peer, tag, ep, seq)
        else:
            self._on_ag(rank, peer, tag, ep, seq)

    def _on_rs(self, rank: int, peer: int, tag: int, ep, seq: int) -> None:
        if peer != self._lprev(rank) or peer == rank:
            return
        bucket, step = divmod(tag, self.rs_steps)
        chunk = (self._local(rank) - step - 1) % self.R
        c0, c1 = self._chunk_bounds(bucket, chunk)
        stage = ep.staging_slot_view(
            peer, seq, (c1 - c0) * self.itemsize).view(self.dtype)
        _reduce(self.flat[rank][c0:c1], stage, self.op)
        self._send_rs(rank, bucket, step + 1)

    def _on_x(self, rank: int, peer: int, tag: int, ep, seq: int) -> None:
        bucket, shard = divmod(tag - self.X0, self.R)
        if (self._local(peer) != self._local(rank)
                or self._pod(peer) == self._pod(rank)):
            return      # foreign: not a counterpart owner
        if (shard - 1) % self.R != self._local(rank):
            return      # not a shard this rank owns
        c0, c1 = self._chunk_bounds(bucket, shard)
        nbytes = (4 + (c1 - c0)) if self.compress \
            else (c1 - c0) * self.itemsize
        stage = ep.staging_slot_view(peer, seq, nbytes)
        # buffer unconditionally: this payload may arrive before the
        # local reduce-scatter registers its own contribution, and a
        # stray post-combine duplicate just parks here harmlessly
        got = self._xrecv.setdefault((rank, bucket, shard), {})
        got[self._pod(peer)] = np.asarray(stage, dtype=np.uint8).copy()
        self._maybe_combine(rank, bucket, shard)

    def _on_ag(self, rank: int, peer: int, tag: int, ep, seq: int) -> None:
        if peer != self._lprev(rank) or peer == rank:
            return
        bucket, shard = divmod(tag - self.A0, self.R)
        c0, c1 = self._chunk_bounds(bucket, shard)
        stage = ep.staging_slot_view(
            peer, seq, (c1 - c0) * self.itemsize).view(self.dtype)
        self.flat[rank][c0:c1] = stage
        self._finalize(rank)
        self._forward_ag(rank, bucket, shard)

    def done(self) -> bool:
        return all(r <= 0 for r in self.remaining)


class _AllToAll(_Collective):
    """Chunk-striped direct-write all-to-all (MoE dispatch pattern).

    Each (src, dst) row is split into ``max_chunk_bytes`` chunks; each
    chunk is an independent message with tag = chunk index within the
    row (the sender is identified by the QP the notify arrives on) and
    home channel ``src + dst + chunk`` — so one large row stripes across
    every healthy rail instead of riding a single ``(src + dst) %
    channels`` channel as one monolithic message. ``on_notify`` rejects
    foreign notifies (self-loop peer, missing or out-of-range tag):
    load-bearing once collectives run concurrently, where a stray
    notify used to silently corrupt ``outs``.

    Pure data movement, so wire-chunk sizes are telemetry-adapted per
    row: chunk ci of row (src, dst) homes on channel ``src + dst + ci``
    and its size comes from ``ChannelScheduler.adaptive_chunk_bytes`` —
    rows whose chunks home on a degraded rail are cut finer to bound
    per-chunk latency skew. Every rank shares this actor, so the
    per-row bounds are consistent between sender and receiver by
    construction."""

    kind = "all_to_all"

    def __init__(self, world, mats: List[np.ndarray],
                 outs: List[np.ndarray]):
        super().__init__(world)
        self.mats = mats
        self.outs = outs
        n = world.n_ranks
        self.dtype = mats[0].dtype
        self.itemsize = self.dtype.itemsize
        row_elems = mats[0][0].size
        sched = world.scheduler
        self.row_bounds = {}
        for r in range(n):
            for peer in range(n):
                if peer == r:
                    continue
                bounds = []
                i = 0
                while i < row_elems:
                    per = max(1, sched.adaptive_chunk_bytes(
                        r + peer + len(bounds)) // self.itemsize)
                    bounds.append((i, min(i + per, row_elems)))
                    i += per
                self.row_bounds[(r, peer)] = bounds or [(0, 0)]
        self.expected = [sum(len(self.row_bounds[(p, r)])
                             for p in range(n) if p != r)
                         for r in range(n)]
        self.received = [0] * n

    def start(self) -> None:
        n = self.world.n_ranks
        for r in range(n):
            self.outs[r][r] = self.mats[r][r]  # local row
            for peer in range(n):
                if peer == r:
                    continue
                row = np.ascontiguousarray(self.mats[r][peer]).reshape(-1)
                for ci, (c0, c1) in enumerate(self.row_bounds[(r, peer)]):
                    self._send(r, peer, row[c0:c1], tag=ci,
                               home=r + peer + ci)

    def on_notify(self, rank: int, peer: int, tag, ep, seq: int) -> None:
        if peer == rank or not isinstance(tag, int):
            return
        bounds = self.row_bounds.get((peer, rank))
        if bounds is None or not 0 <= tag < len(bounds):
            return  # foreign tag: no such row chunk
        c0, c1 = bounds[tag]
        stage = ep.staging_slot_view(
            peer, seq, (c1 - c0) * self.itemsize).view(self.dtype)
        self.outs[rank][peer].reshape(-1)[c0:c1] = stage
        self.received[rank] += 1

    def done(self) -> bool:
        return all(r >= e for r, e in zip(self.received, self.expected))
