"""Campaign engine: execute fault scenarios against ShiftLib workloads.

Workloads, in increasing weight:

* ``pingpong`` — a paced one-directional NCCL-Simple stream (bulk WRITE +
  WRITE_IMM notify) between two hosts, with per-message payload
  verification. Source-slot reuse is completion-gated (mirroring
  ``collectives.endpoint.RankEndpoint``) so a post-failover retransmission
  can never DMA-read a recycled slot.
* ``allreduce`` — repeated ring all-reduces through ``JcclWorld`` until
  the scenario window closes, verifying the numeric result of every
  round (payload-level exactly-once). ``channels=N`` runs it striped
  across N rails (per-channel stats land in ``RunResult.channel_stats``).
* ``broadcast`` / ``all_to_all`` — the remaining collective shapes under
  the same fault matrix, each with byte-exact payload verification per
  round; both accept ``channels`` too.
* ``overlap_allreduce`` — CONCURRENT collectives: every round splits the
  vector into aligned parts and issues one ``allreduce_async`` work per
  part, so scenario faults land while several collectives are in flight;
  each part's numeric result is verified and the run must actually
  overlap (``RunResult.peak_concurrency`` floor).
* ``hierarchical_allreduce`` — the two-tier multi-pod all-reduce on the
  heterogeneous fabric (intra-pod rails + int8-compressed cross-pod DCN
  exchange with error feedback carried across rounds); every round's
  outputs must be byte-identical across ranks and within the
  quantization bound of the true sum. The DCN fault scenarios target
  this workload's uplinks.
* ``ddp`` — a short data-parallel training run (``build_smoke_trainer``);
  scenario times are rebased onto the measured per-step collective time
  so faults land mid-all-reduce regardless of model size.
* ``ddp_bucketed`` — the same trainer with ``bucket_bytes`` forced small
  enough that every step issues >= 4 concurrent gradient-bucket works
  (the overlapped-DDP smoke; a run that never overlaps is a violation).
* ``serving`` — continuous-batching tensor-parallel inference
  (``repro_torch.serving.tp`` + ``repro_torch.serving.scheduler``) on the
  fabric: per-step logits/activation all-gathers and MoE all-to-alls under
  the fault timeline, with request-level invariants (no dropped requests,
  no duplicated/truncated/corrupted tokens — byte-exact against the
  single-host reference run).
* ``mixed`` — all three latency classes live at once (DESIGN.md §10):
  every round issues bulk gradient-bucket allreduces, then a small
  latency-critical serving-style gather that must overtake them at the
  dispatch queues, while a real ``CheckpointStore`` replicates
  checkpoints over the fabric as background broadcasts. Verifies that
  priority never breaks byte-identity or exactly-once, and the
  invariants assert no class starves (``RunResult.class_latency``).

Every run returns a :class:`RunResult` whose :meth:`RunResult.fingerprint`
is a pure function of the virtual-clock execution — same seed implies an
identical fingerprint (the determinism contract tests assert this).
Invariants (exactly-once, zero-copy, notification order, bounded fallback
latency) are checked by ``repro_torch.scenarios.invariants`` after every
run.

This is the port's own copy of the reference's campaign engine, with its
imports pointed at the port. The fabric stays numpy on the host, so the
fabric-only workloads never touch a device and their fingerprints equal
the reference's. The DDP and serving workloads take ``device``
(``"cuda"`` by default) and run there the smoke trainer's forward and
backward, or the smoke MoE model's prefill and decode; the fingerprint
reads the virtual clock only, so a card run and a CPU run of one cell give
the same fingerprint.
"""

from __future__ import annotations

import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import shift as S
from ..core import verbs as V
from ..core.fabric import Cluster, build_cluster

from .spec import Scenario

# ---------------------------------------------------------------------------
# run result
# ---------------------------------------------------------------------------


@dataclass
class RunResult:
    """Everything one (scenario, workload) cell observed: progress,
    SHIFT's fallbacks and recoveries, the fault and lifecycle logs, the
    payload checks and the workload's own accounting."""

    scenario: str
    workload: str
    seed: int
    completed: bool = False         # workload reached its goal
    aborted: bool = False           # app-visible failure (crash-stop)
    event_count: int = 0            # simulator events executed
    sim_elapsed: float = 0.0        # virtual seconds consumed
    fallbacks: int = 0
    recoveries: int = 0
    errors_propagated: int = 0
    payload_bytes_held: int = 0
    fallback_latencies: List[float] = field(default_factory=list)
    app_errors: int = 0             # error WCs surfaced to the application
    delivered: Optional[List[int]] = None   # notify seqs in arrival order
    n_expected: Optional[int] = None
    payload_mismatches: int = 0
    order_violations: int = 0
    duplicate_notifies: int = 0
    rounds: int = 0                 # allreduce rounds / train steps done
    fault_log: List[Tuple[float, str, str]] = field(default_factory=list)
    lifecycle: List[Tuple[float, str, str]] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)
    # multi-rail channel accounting (None for channel-less workloads)
    channel_stats: Optional[List[Dict[str, object]]] = None
    resteered_chunks: int = 0
    # concurrent-collective accounting: peak simultaneously live
    # collectives observed, and the workload-declared floor (0 = no
    # overlap requirement; a completed run below the floor is a
    # violation — the overlap claim would otherwise be vacuous)
    peak_concurrency: int = 0
    min_concurrency: int = 0
    # cross-collective tag hygiene: in-flight tag entries left in
    # JcclWorld._tags after the workload finished (must be 0 on a
    # completed run — a leak means a chunk was assigned but its notify
    # neither dispatched nor was reclaimed)
    leaked_tags: int = 0
    # serving workload request-level accounting: a maskable fault must
    # drop NO requests and corrupt NO tokens (token_mismatches counts
    # completed requests whose token stream diverged from the
    # single-host reference — wrong, duplicated or truncated tokens)
    requests_total: int = 0
    requests_done: int = 0
    requests_failed: int = 0
    token_mismatches: int = 0
    # per-latency-class completion stats (mixed workload only): class ->
    # {count, p50_virtual_ms, p99_virtual_ms} from
    # JcclWorld.class_latency_stats. The invariants require every class
    # to have completed work on a completed run (no starvation).
    class_latency: Optional[Dict[str, Dict[str, float]]] = None
    # fault-policy audit trail (policy-mode runs only): the name of the
    # policy the run executed under and every decision the engine took,
    # as (at, trigger, response, detail, signals) tuples — folded into
    # the fingerprint, so policy behavior rides the same determinism
    # contract as the fabric
    policy: Optional[str] = None
    decision_log: List[Tuple] = field(default_factory=list)
    # virtual seconds the round loop itself consumed (excludes the
    # settle window sim_elapsed includes): the recovered-throughput
    # denominator of the policy comparison — rounds/work_elapsed stays
    # meaningful whether a run was deadline- or round-capped
    work_elapsed: float = 0.0
    # DDP workload extras: the unrounded per-step loss trajectory (the
    # ddp_hooked workload compares it byte-for-byte against a clean
    # post-backward reference), the mean comm/compute overlap fraction
    # (issue-as-produced mode only), and the per-step peak of
    # concurrently in-flight gradient works — surfaced in the campaign
    # matrix markdown so overlap regressions show up in CI summaries
    loss_trace: Optional[List[float]] = None
    overlap_fraction: float = 0.0
    step_peak_works: List[int] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        """True when the run violated no invariant."""
        return not self.violations

    def fingerprint(self) -> Tuple:
        """Virtual-clock-only digest; identical across same-seed runs."""
        return (
            self.event_count,
            round(self.sim_elapsed, 9),
            self.fallbacks, self.recoveries, self.errors_propagated,
            self.completed, self.aborted, self.rounds,
            tuple(self.delivered) if self.delivered is not None else None,
            tuple((round(t, 9), k, g) for t, k, g in self.fault_log),
            tuple((round(t, 9), e, h) for t, e, h in self.lifecycle),
            tuple(round(l, 9) for l in self.fallback_latencies),
            self.resteered_chunks,
            self.peak_concurrency,
            (self.requests_total, self.requests_done,
             self.requests_failed, self.token_mismatches),
            tuple((c["chunks_assigned"], c["chunks_delivered"])
                  for c in self.channel_stats)
            if self.channel_stats is not None else None,
            tuple((k, s["count"], s["p50_virtual_ms"], s["p99_virtual_ms"])
                  for k, s in sorted(self.class_latency.items()))
            if self.class_latency is not None else None,
            self.policy,
            tuple(self.decision_log),
            round(self.work_elapsed, 9),
            round(self.overlap_fraction, 9),
            tuple(self.step_peak_works),
        )


def _observe(cluster: Cluster, libs: Sequence, result: RunResult) -> None:
    """Wire fault + SHIFT lifecycle observers into a result."""
    cluster.add_fault_listener(
        lambda t, kind, gid: result.fault_log.append((t, kind, gid)))
    for lib in libs:
        if isinstance(lib, S.ShiftLib):
            lib.add_event_listener(
                lambda ev, qp, host=lib.host: result.lifecycle.append(
                    (cluster.sim.now, ev, host)))


def _harvest(libs: Sequence, result: RunResult) -> None:
    shift_libs = [l for l in libs if isinstance(l, S.ShiftLib)]
    result.fallbacks = sum(l.stats.fallbacks for l in shift_libs)
    result.recoveries = sum(l.stats.recoveries for l in shift_libs)
    result.errors_propagated = sum(l.stats.errors_propagated
                                   for l in shift_libs)
    result.payload_bytes_held = sum(l.stats.payload_bytes_held
                                    for l in shift_libs)
    result.fallback_latencies = [lat for l in shift_libs
                                 for lat in l.stats.fallback_latencies]


def _from_snapshot(snap: Dict[str, object], result: RunResult) -> None:
    """Populate a RunResult from JcclWorld.stats_snapshot — the single
    source of aggregation for world-based workloads."""
    result.fallbacks = snap["fallbacks"]
    result.recoveries = snap["recoveries"]
    result.errors_propagated = snap["errors_propagated"]
    result.payload_bytes_held = snap["payload_bytes_held"]
    result.fallback_latencies = snap["fallback_latencies"]
    result.order_violations = snap["order_violations"]
    result.duplicate_notifies = snap["duplicate_notifies"]
    result.app_errors = sum(snap["rank_errors"])
    result.peak_concurrency = snap.get("peak_live_collectives", 0)
    result.leaked_tags = snap.get("inflight_tags", 0)
    if len(snap.get("channels", ())) > 1:
        result.channel_stats = snap["channels"]
        result.resteered_chunks = snap["scheduler"]["resteered"]


# ---------------------------------------------------------------------------
# pingpong workload
# ---------------------------------------------------------------------------


class PairEndpoint:
    """One application endpoint (mirrors the tests'/benchmarks' harness)."""

    def __init__(self, lib, nic: str = "mlx5_0", buf_size: int = 1 << 20,
                 cq_depth: int = 1 << 16):
        self.lib = lib
        self.ctx = lib.open_device(nic)
        self.pd = lib.alloc_pd(self.ctx)
        self.buf = np.zeros(buf_size, dtype=np.uint8)
        self.mr = lib.reg_mr(self.pd, self.buf)
        self.cq = lib.create_cq(self.ctx, cq_depth)
        self.qp = lib.create_qp(self.pd, V.QPInitAttr(
            send_cq=self.cq, recv_cq=self.cq,
            cap=V.QPCap(max_send_wr=8192, max_recv_wr=8192)))

    def poll(self, n: int = 4096):
        """Up to ``n`` completions from the endpoint's CQ."""
        return self.lib.poll_cq(self.cq, n)


def make_pair(lib_kind: str = "shift", probe_interval: float = 5e-3,
              nics_per_host: int = 2, endpoint_kw: Optional[dict] = None,
              fast: bool = True, **cluster_kw):
    """Fresh 2-host cluster + connected endpoint pair (also the harness
    behind ``benchmarks.common.make_pair``). ``fast`` selects the
    coalescing zero-copy datapath (default); False restores the legacy
    per-WQE event chain."""
    V.reset_registries()
    c = build_cluster(n_hosts=2, nics_per_host=nics_per_host, **cluster_kw)
    c.fast_datapath = fast
    if lib_kind == "shift":
        cfg = S.ShiftConfig(probe_interval=probe_interval)
        lib_a = S.ShiftLib(c, "host0", config=cfg)
        lib_b = S.ShiftLib(c, "host1", kv=lib_a.kv, config=cfg)
    else:
        lib_a, lib_b = S.StandardLib(c, "host0"), S.StandardLib(c, "host1")
    endpoint_kw = endpoint_kw or {}
    a, b = PairEndpoint(lib_a, **endpoint_kw), PairEndpoint(lib_b, **endpoint_kw)
    lib_a.connect(a.qp, *lib_b.route_of(b.qp))
    lib_b.connect(b.qp, *lib_a.route_of(a.qp))
    lib_a.settle(0.05)
    return c, a, b


class _PingPongPump:
    """Paced Simple-protocol stream a -> b with payload verification.

    ``SLOTS`` source/staging slots are reused round-robin; a new message
    only posts while fewer than ``WINDOW`` notifies are uncompleted, so a
    slot is never rewritten before its prior message is ACKed (or its
    completion synthesized) — the completion-gated reuse rule.

    ``burst`` > 1 posts B messages per tick with the tick period scaled
    by B: the same average message rate, fills, and delivery trace, but
    the posts land in one doorbell-coalescing window so the fast datapath
    serializes them as a single segment. ``burst=1`` reproduces the
    legacy one-message-per-tick pacing exactly.
    """

    SLOTS = 16
    WINDOW = 4

    def __init__(self, c: Cluster, a: PairEndpoint, b: PairEndpoint,
                 n_msgs: int, size: int, interval: float, seed: int,
                 deadline: float, result: RunResult, burst: int = 1):
        self.c, self.a, self.b = c, a, b
        self.n_msgs, self.size, self.interval = n_msgs, size, interval
        self.burst = max(1, burst)
        # completion-gated reuse needs slots >= window (a slot is never
        # rewritten while its previous message could still be in flight)
        self.slots = max(self.SLOTS, 2 * self.burst)
        if self.slots * size > min(a.buf.nbytes, b.buf.nbytes):
            raise ValueError("pingpong burst*size exceeds endpoint buffers")
        self.window = max(self.WINDOW, 2 * self.burst)
        self.deadline = deadline
        self.r = result
        self.fills = [(seed * 31 + s) % 251 + 1 for s in range(n_msgs)]
        self.posted = 0
        self.completed_sends = 0
        self.dead = False
        result.delivered = []
        result.n_expected = n_msgs

    # -- helpers -----------------------------------------------------------
    def _off(self, seq: int) -> int:
        return (seq % self.slots) * self.size

    def drain(self) -> None:
        for wc in self.a.poll():
            if wc.is_error:
                self.r.app_errors += 1
                self.dead = True
                continue
            if wc.opcode is V.WCOpcode.RDMA_WRITE:
                self.completed_sends += 1   # only the imm send is signaled
        for wc in self.b.poll():
            if wc.is_error:
                self.r.app_errors += 1
                continue
            if wc.opcode is V.WCOpcode.RECV_RDMA_WITH_IMM:
                seq = wc.imm_data
                self.r.delivered.append(seq)
                off = self._off(seq)
                got = self.b.buf[off:off + self.size]
                if not (got == self.fills[seq]).all():
                    self.r.payload_mismatches += 1

    def _post_batch(self, count: int) -> None:
        """Fill payload slots and post ``count`` messages. With count > 1
        the bulk WRITE + WRITE_IMM pairs go out as ONE posted chain (one
        doorbell -> one coalesced segment on the fast datapath); count=1
        reproduces the legacy two-post sequence exactly."""
        start = self.posted
        wrs = []
        for k in range(count):
            seq = start + k
            off = self._off(seq)
            self.a.buf[off:off + self.size] = self.fills[seq]
            wrs.append(V.SendWR(
                wr_id=seq, opcode=V.Opcode.WRITE,
                sge=V.SGE(self.a.mr.addr + off, self.size, self.a.mr.lkey),
                remote_addr=self.b.mr.addr + off, rkey=self.b.mr.rkey,
                send_flags=0))
            wrs.append(V.SendWR(
                wr_id=seq, opcode=V.Opcode.WRITE_IMM, sge=None,
                remote_addr=0, rkey=self.b.mr.rkey, imm_data=seq,
                send_flags=V.SEND_FLAG_SIGNALED))
        try:
            for k in range(count):
                self.b.lib.post_recv(self.b.qp,
                                     V.RecvWR(wr_id=50_000 + start + k))
            if count == 1:
                self.a.lib.post_send(self.a.qp, wrs[0])
                self.a.lib.post_send(self.a.qp, wrs[1])
            else:
                self.a.lib.post_send_chain(self.a.qp, wrs)
        except V.VerbsError:
            self.dead = True
            return
        self.posted = start + count

    @property
    def finished(self) -> bool:
        if self.dead:
            return True
        return (len(self.r.delivered) >= self.n_msgs
                and self.completed_sends >= self.n_msgs)

    def _tick(self) -> None:
        self.drain()
        if not self.dead:
            count = min(self.burst, self.n_msgs - self.posted,
                        self.window - (self.posted - self.completed_sends))
            if count > 0:
                self._post_batch(count)
        if not self.finished and self.c.sim.now <= self.deadline:
            self.c.sim.call(self.interval * self.burst, self._tick)

    def start(self) -> None:
        self._tick()


def rebase_fault_times(actions, scale: float):
    """Rebase authored fault times onto a measured span by scaling the
    ANCHOR (earliest action time) only, preserving every inter-action
    delta verbatim.

    Uniform scaling (``at * scale``) compresses flap-train outages: with
    a short measured span the authored 6ms down-time shrinks below the
    RC retry budget (retry_cnt x ack_timeout ~ 3.2ms) and the transport
    rides the flap out, so the scenario's ``min_fallbacks`` expectation
    becomes unmeetable — the old documented reason ddp workloads had to
    avoid flap scenarios. Anchor-only rebasing moves the timeline's
    START into the measured window but keeps each flap's outage duration
    and inter-flap gap exactly as authored; actions whose preserved
    offsets fall past the workload's end simply never fire.

    Returns ``(new_time, kind, target, arg)`` tuples ready for
    ``Cluster.schedule_fault``.
    """
    acts = list(actions)
    if not acts:
        return []
    anchor = min(a.at for a in acts)
    return [(anchor * scale + (a.at - anchor), a.kind, a.target, a.arg)
            for a in acts]


def _traffic_horizon(scenario: Scenario, probe_interval: float) -> float:
    """How long the workload must keep posting *signaled* traffic: past the
    last fault action plus a few probe cycles. Recovery's WR-execution
    fence is the next signaled WR after the probe succeeds, so a stream
    that drains before the default path returns can never switch back."""
    last_act = max((a.at for a in scenario.actions), default=0.0)
    return last_act + 3 * probe_interval


def run_pingpong(scenario: Scenario, seed: int = 0, n_msgs: int = 60,
                 size: int = 8192, interval: float = 200e-6,
                 probe_interval: float = 5e-3, fast: bool = True,
                 burst: Optional[int] = None) -> RunResult:
    """A paced, payload-verified NCCL-Simple stream between two hosts
    under the scenario's fault timeline (``_PingPongPump``); the stream
    is lengthened to span the timeline plus a few probe cycles."""
    result = RunResult(scenario=scenario.name, workload="pingpong",
                       seed=seed)
    n_msgs = max(n_msgs,
                 int(_traffic_horizon(scenario, probe_interval) / interval))
    c, a, b = make_pair(probe_interval=probe_interval, fast=fast)
    _observe(c, [a.lib, b.lib], result)
    t0 = c.sim.now
    scenario.schedule(c, t0)
    deadline = t0 + scenario.duration
    if burst is None:
        burst = 8 if fast else 1   # fast mode feeds the doorbell coalescer
    pump = _PingPongPump(c, a, b, n_msgs, size, interval, seed,
                         deadline, result, burst=burst)
    pump.start()
    c.sim.run(until=deadline + 0.05)
    pump.drain()
    result.completed = (not pump.dead
                        and len(result.delivered) >= n_msgs)
    result.aborted = pump.dead
    result.event_count = c.sim._executed
    result.sim_elapsed = c.sim.now - t0
    _harvest([a.lib, b.lib], result)
    return result


# ---------------------------------------------------------------------------
# world-based round workloads (allreduce / broadcast / all_to_all)
# ---------------------------------------------------------------------------


def _attach_policy(policy: Optional[str], cluster, libs, world,
                   result: RunResult, with_store: bool = True):
    """Stand up a :class:`repro_torch.policy.FaultPolicyEngine` for a policy-
    mode run: engine + (optionally) a throwaway CheckpointStore attached
    to the world, so "checkpoint" decisions put real background-class
    replication traffic on the fabric (the cost the policy comparison
    measures). Returns ``(engine, ckpt_dir)`` — ``(None, None)`` when
    the run is policy-less."""
    if policy is None:
        return None, None
    from ..checkpoint import CheckpointStore
    from ..policy import FaultPolicyEngine

    ckpt_dir = None
    store = None
    if with_store:
        ckpt_dir = tempfile.mkdtemp(prefix="repro-policy-ckpt-")
        store = CheckpointStore(ckpt_dir, keep=2)
        store.attach_world(world)
    engine = FaultPolicyEngine(policy)
    engine.attach(cluster, libs, world=world, store=store)
    result.policy = policy
    return engine, ckpt_dir


def _harvest_policy(engine, ckpt_dir, result: RunResult) -> None:
    """Fold the engine's decision log into the result and drop the
    throwaway checkpoint directory."""
    if engine is not None:
        result.decision_log = engine.audit()
        if engine.store is not None:
            engine.store.drain_stream(timeout=0.0)
    if ckpt_dir is not None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _run_rounds(workload: str, scenario: Scenario, seed: int,
                n_ranks: int, max_rounds: int, probe_interval: float,
                fast: bool, channels: int, max_chunk_bytes: int,
                round_fn, nics_per_host: Optional[int] = None,
                min_concurrency: int = 0,
                build_kw: Optional[dict] = None,
                policy: Optional[str] = None) -> RunResult:
    """Shared driver for JcclWorld round workloads: build the world,
    schedule the fault timeline, run ``round_fn(world, rng, timeout) ->
    payload mismatches`` until the traffic horizon/deadline, settle, and
    harvest the world snapshot. Rounds are capped for wall time, but
    traffic MUST span the fault timeline (+ probe margin) or recovery
    could never fence (see ``_traffic_horizon``) and min_fallbacks
    expectations would be vacuous. ``build_kw`` forwards extra
    ``build_world`` parameters (the hierarchical workload's multi-pod
    topology). ``policy`` attaches a fault-policy engine
    (repro_torch.policy); its decisions land in ``RunResult.decision_log``."""
    from ..collectives import CollectiveError, build_world

    result = RunResult(scenario=scenario.name, workload=workload,
                       seed=seed, min_concurrency=min_concurrency)
    cluster, libs, world = build_world(
        n_ranks=n_ranks, probe_interval=probe_interval,
        max_chunk_bytes=max_chunk_bytes, strict_order=False, fast=fast,
        channels=channels,
        nics_per_host=nics_per_host or max(2, channels),
        **(build_kw or {}))
    _observe(cluster, libs, result)
    engine, ckpt_dir = _attach_policy(policy, cluster, libs, world, result)
    t0 = cluster.sim.now
    scenario.schedule(cluster, t0)
    deadline = t0 + scenario.duration
    rng = np.random.RandomState(seed)
    mismatched = 0
    horizon = t0 + min(scenario.duration,
                       _traffic_horizon(scenario, probe_interval))
    try:
        while cluster.sim.now < horizon or (
                cluster.sim.now < deadline and result.rounds < max_rounds):
            mismatched += round_fn(world, rng, scenario.duration + 1.0)
            result.rounds += 1
        result.completed = result.rounds > 0
    except CollectiveError:
        result.aborted = True
    result.work_elapsed = cluster.sim.now - t0
    # let probes / recovery handshakes settle inside the window
    cluster.sim.run(until=deadline + 0.05)
    result.payload_mismatches = mismatched
    result.event_count = cluster.sim._executed
    result.sim_elapsed = cluster.sim.now - t0
    _from_snapshot(world.stats_snapshot(), result)
    _harvest_policy(engine, ckpt_dir, result)
    return result


def run_allreduce(scenario: Scenario, seed: int = 0, n_ranks: int = 2,
                  elems: int = 1 << 14, max_rounds: int = 4000,
                  probe_interval: float = 5e-3, fast: bool = True,
                  channels: int = 1,
                  nics_per_host: Optional[int] = None,
                  policy: Optional[str] = None) -> RunResult:
    """Repeated ring all-reduces; every round's numeric result must equal
    the true sum (payload-level exactly-once: a lost or doubled
    contribution changes it). ``policy`` runs the cell under a fault-
    policy engine (repro_torch.policy) — the policy-comparison campaign's
    workload of record."""
    def one_round(world, rng, timeout):
        arrays = [rng.randn(elems).astype(np.float32)
                  for _ in range(n_ranks)]
        expect = np.sum(arrays, axis=0)
        world.allreduce(arrays, timeout=timeout)
        return sum(1 for arr in arrays
                   if not np.allclose(arr, expect, atol=1e-4))

    return _run_rounds("allreduce", scenario, seed, n_ranks, max_rounds,
                       probe_interval, fast, channels, 1 << 14, one_round,
                       nics_per_host=nics_per_host, policy=policy)


def run_overlap_allreduce(scenario: Scenario, seed: int = 0,
                          n_ranks: int = 2, elems: int = 1 << 14,
                          parts: int = 4, max_rounds: int = 4000,
                          probe_interval: float = 5e-3, fast: bool = True,
                          channels: int = 1,
                          nics_per_host: Optional[int] = None) -> RunResult:
    """Concurrent collectives under faults: every round splits the
    vector into ``parts`` engine-aligned slices and issues one
    ``allreduce_async`` work per slice, waiting on all handles — so the
    scenario's faults land while several collectives are in flight.
    Each slice's numeric result must equal the true sum, and the run
    must actually overlap (``min_concurrency=2`` floor, checked by the
    invariants; the parts themselves give >= ``parts`` live works)."""
    max_chunk_bytes = 1 << 12

    def one_round(world, rng, timeout):
        arrays = [rng.randn(elems).astype(np.float32)
                  for _ in range(n_ranks)]
        expect = np.sum(arrays, axis=0)
        # engine-aligned slice bounds: byte-identical to the flat path
        bounds = world.aligned_bucket_bounds(elems, 4,
                                             elems * 4 // parts)
        works = [world.allreduce_async([a[lo:hi] for a in arrays])
                 for lo, hi in bounds]
        world.wait_all(works, timeout=timeout)
        return sum(1 for arr in arrays
                   if not np.allclose(arr, expect, atol=1e-4))

    return _run_rounds("overlap_allreduce", scenario, seed, n_ranks,
                       max_rounds, probe_interval, fast, channels,
                       max_chunk_bytes, one_round,
                       nics_per_host=nics_per_host, min_concurrency=2)


def run_hierarchical_allreduce(scenario: Scenario, seed: int = 0,
                               n_ranks: int = 4, n_pods: int = 2,
                               elems: int = 1 << 14,
                               max_rounds: int = 4000,
                               probe_interval: float = 5e-3,
                               fast: bool = True,
                               nics_per_host: int = 2,
                               compress: bool = True,
                               dcn_loss: float = 0.0) -> RunResult:
    """Repeated two-tier (pod-hierarchical) all-reduces on the
    heterogeneous multi-pod fabric, under the scenario's fault timeline
    — the DCN scenarios (``dcn_degrade``, ``dcn_partition_transient``)
    aim their faults at the uplinks this workload depends on.

    Verified every round:

    * **byte identity across ranks** — all ``n_ranks`` outputs must be
      bit-equal (the pod-index-order combine makes the cross-pod sum
      deterministic regardless of arrival order or compression);
    * **quantization-bounded accuracy** — each output must match the
      true float sum within the int8 error-feedback bound (the per-pod
      residue is at most half a quantization bucket per element, summed
      over pods, plus the carried feedback of the previous step);
      uncompressed runs use the exact float tolerance.

    The error-feedback dict is carried ACROSS rounds — exactly how the
    trainer uses it — so a mid-round fault that forces a retransmit
    must not double-apply or drop residue (it would break byte identity
    or blow the accuracy bound)."""
    feedback: Dict = {}

    def one_round(world, rng, timeout):
        arrays = [rng.randn(elems).astype(np.float32)
                  for _ in range(n_ranks)]
        expect = np.sum(arrays, axis=0)
        world.hierarchical_allreduce(arrays, compress=compress,
                                     feedback=feedback, timeout=timeout)
        bad = 0
        ref = arrays[0].tobytes()
        bad += sum(1 for a in arrays[1:] if a.tobytes() != ref)
        if compress:
            # per element: n_pods residues of <= scale/2 each, plus the
            # previous round's carried feedback of the same magnitude
            scale = float(np.max(np.abs(expect))) / 127.0
            atol = 2.0 * n_pods * max(scale, 1e-6) + 1e-4
        else:
            atol = 1e-4
        bad += sum(1 for a in arrays
                   if not np.allclose(a, expect, atol=atol))
        return bad

    return _run_rounds(
        "hierarchical_allreduce", scenario, seed, n_ranks, max_rounds,
        probe_interval, fast, nics_per_host + 1, 1 << 14, one_round,
        nics_per_host=nics_per_host,
        build_kw={"n_pods": n_pods, "dcn_loss": dcn_loss})


def run_broadcast(scenario: Scenario, seed: int = 0, n_ranks: int = 2,
                  elems: int = 1 << 14, max_rounds: int = 4000,
                  probe_interval: float = 5e-3, fast: bool = True,
                  channels: int = 1, root: int = 0,
                  nics_per_host: Optional[int] = None) -> RunResult:
    """Repeated pipelined broadcasts; every round's outputs are compared
    byte-for-byte against the root payload — a lost, duplicated or
    misordered chunk shows up as a payload mismatch."""
    def one_round(world, rng, timeout):
        msg = rng.randn(elems).astype(np.float32)
        outs = world.broadcast(msg, root=root, timeout=timeout)
        return sum(1 for out in outs if not np.array_equal(out, msg))

    return _run_rounds("broadcast", scenario, seed, n_ranks, max_rounds,
                       probe_interval, fast, channels, 1 << 14, one_round,
                       nics_per_host=nics_per_host)


def run_alltoall(scenario: Scenario, seed: int = 0, n_ranks: int = 2,
                 row_elems: int = 1 << 12, max_rounds: int = 4000,
                 probe_interval: float = 5e-3, fast: bool = True,
                 channels: int = 1,
                 nics_per_host: Optional[int] = None) -> RunResult:
    """Repeated direct-write all-to-alls; the received matrix must be the
    exact transpose of the sent rows every round (payload-level
    exactly-once: a dropped or doubled row changes a cell)."""
    def one_round(world, rng, timeout):
        mats = [rng.randn(n_ranks, row_elems).astype(np.float32)
                for _ in range(n_ranks)]
        outs = world.all_to_all(mats, timeout=timeout)
        return sum(1 for j in range(n_ranks) for i in range(n_ranks)
                   if not np.array_equal(outs[j][i], mats[i][j]))

    return _run_rounds("all_to_all", scenario, seed, n_ranks, max_rounds,
                       probe_interval, fast, channels,
                       max(1 << 14, row_elems * 4), one_round,
                       nics_per_host=nics_per_host)


# ---------------------------------------------------------------------------
# ddp training workload
# ---------------------------------------------------------------------------


def run_ddp(scenario: Scenario, seed: int = 0, steps: int = 6,
            n_ranks: int = 2, fast: bool = True, channels: int = 1,
            max_chunk_bytes: int = 1 << 18,
            bucket_bytes: Optional[int] = None,
            min_concurrency: int = 0,
            workload_name: str = "ddp",
            policy: Optional[str] = None,
            issue_as_produced: bool = False,
            layer_compute_s: float = 0.0,
            device="cuda", model_cfg=None) -> RunResult:
    """Short DDP training run under the scenario's fault timeline.
    ``bucket_bytes`` overrides the trainer's gradient bucketing (None
    keeps the default); ``min_concurrency`` declares an overlap floor
    the invariants enforce (the ``ddp_bucketed`` workload uses both to
    force >= 4 concurrent gradient-bucket works per step). ``policy``
    attaches a fault-policy engine that drives the trainer's §4.4
    post-fallback checkpointing (the trainer saves its REAL state when
    the engine decides "checkpoint" — no second store).
    ``issue_as_produced`` / ``layer_compute_s`` enable the
    backward-hook overlap path (the ``ddp_hooked`` workload). Each
    rank's forward and backward run on ``device``; ``model_cfg`` None is
    the smoke trainer's model (see ``build_smoke_trainer``)."""
    from ..collectives import build_world
    from ..train.trainer import RestartNeeded, build_smoke_trainer

    result = RunResult(scenario=scenario.name, workload=workload_name,
                       seed=seed, min_concurrency=min_concurrency)
    cluster, libs, world = build_world(
        n_ranks=n_ranks, probe_interval=5e-4,
        max_chunk_bytes=max_chunk_bytes, strict_order=False, fast=fast,
        channels=channels)
    _observe(cluster, libs, result)
    engine, _ = _attach_policy(policy, cluster, libs, world, result,
                               with_store=False)
    ckpt_dir = tempfile.mkdtemp(prefix="repro-campaign-ckpt-")
    trainer = build_smoke_trainer(cluster, libs, steps=steps,
                                  ckpt_dir=ckpt_dir, seed=seed,
                                  bucket_bytes=bucket_bytes,
                                  issue_as_produced=issue_as_produced,
                                  layer_compute_s=layer_compute_s,
                                  device=device, model_cfg=model_cfg)
    trainer.policy = engine
    t0 = cluster.sim.now
    scheduled = [False]

    def on_step(step: int, t: float, loss: float) -> None:
        # Rebase the scenario timeline onto the measured collective time:
        # after step 1 we know the per-step virtual cost, so the
        # timeline's ANCHOR (authored against `scenario.duration`) is
        # scaled to land inside the remaining steps — mid-all-reduce,
        # not between steps — while every authored outage duration and
        # inter-action gap is preserved verbatim (see
        # ``rebase_fault_times``: uniform scaling would compress
        # flap-train outages below the RC retry budget and no fallback
        # would ever fire).
        if step == 1 and not scheduled[0]:
            scheduled[0] = True
            per_step = cluster.sim.now - t0
            span = max(per_step * (steps - 1), per_step)
            scale = span / scenario.duration
            for lib in libs:
                lib.config.probe_interval = max(per_step / 4, 1e-5)
            for at, kind, target, arg in rebase_fault_times(
                    scenario.actions, scale):
                cluster.schedule_fault(cluster.sim.now + at, kind, target,
                                       arg)
        result.rounds = step

    try:
        run = trainer.train(world, on_step=on_step)
        result.completed = run.final_step == steps
        losses = [l for _, _, l in run.timeline]
        if not all(np.isfinite(losses)):
            result.payload_mismatches += 1
        result.loss_trace = losses
        result.overlap_fraction = run.overlap_fraction
        result.step_peak_works = list(run.step_peak_works)
    except RestartNeeded:
        result.aborted = True
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    result.event_count = cluster.sim._executed
    result.sim_elapsed = cluster.sim.now - t0
    _from_snapshot(world.stats_snapshot(), result)
    _harvest_policy(engine, None, result)
    return result


# ---------------------------------------------------------------------------
# tensor-parallel serving workload
# ---------------------------------------------------------------------------


# Build-once serving fixture (model, params, shared engine, prompts,
# single-host reference generations): every cell shares one ServeEngine
# (its params on the device) and one reference run per parameter set. The
# key holds the device: one device's reference run never serves another's.
_SERVING_FIXTURE: Dict[Tuple, Tuple] = {}


def _serving_fixture(seed: int, n_requests: int, n_tokens: int,
                     n_slots: int, prefill_len: int, max_len: int,
                     device="cuda"):
    """Smoke MoE serving fixture: the llama4-maverick smoke config, a
    ragged prompt set, and the single-host reference run — the SAME
    scheduler/engine classes with ``world=None``, so the reference
    executes the identical admission/decode schedule and the comparison
    is byte-level, not approximate. The params are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to ``device``, so a
    seed gives the same params on the card and the CPU."""
    import torch

    from .. import resolve_device
    from ..configs import llama4_maverick
    from ..models import build_model
    from ..serving import RequestScheduler, ServeEngine, TPServeEngine

    device = resolve_device(device)
    key = (seed, n_requests, n_tokens, n_slots, prefill_len, max_len,
           str(device))
    hit = _SERVING_FIXTURE.get(key)
    if hit is not None:
        return hit
    cfg = llama4_maverick.smoke_config()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    model = build_model(cfg, device=device)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab,
                           size=int(rng.randint(3, prefill_len + 1)))
               .astype(np.int32) for _ in range(n_requests)]
    local = ServeEngine(model, params, max_len=max_len, device=device)
    ref_engine = TPServeEngine(model, params, world=None, max_len=max_len,
                               local=local, device=device)
    sched = RequestScheduler(ref_engine, n_slots=n_slots,
                             prefill_len=prefill_len)
    for p in prompts:
        sched.submit(p, n_tokens)
    sched.run()
    ref = [list(r.tokens) for r in sched.requests]
    fx = (model, params, local, prompts, ref)
    _SERVING_FIXTURE[key] = fx
    return fx


def run_serving(scenario: Scenario, seed: int = 0, n_requests: int = 4,
                n_tokens: int = 6, n_slots: int = 2, prefill_len: int = 12,
                max_len: int = 32, n_ranks: int = 2, fast: bool = True,
                channels: int = 1, max_chunk_bytes: int = 1 << 12,
                max_steps: int = 4000, device="cuda") -> RunResult:
    """Fault-tolerant TP serving under the scenario's fault timeline.

    A continuous-batching ``RequestScheduler`` drives a sharded
    ``TPServeEngine`` over a JcclWorld while the scenario's faults fire;
    the model runs on ``device``.
    Like ``run_ddp``, the timeline is rebased after the first scheduler
    tick (anchor scaled onto the measured per-step time, authored
    outage durations preserved — ``rebase_fault_times``) so the first
    fault lands mid-decode, with in-flight per-layer gathers. Filler
    request waves (the same prompts resubmitted) keep decode traffic
    flowing across the fault window, so multi-action scenarios (flap
    trains, the unmaskable second rail kill) hit live collectives.

    Request-level contract, checked by the invariants: a maskable fault
    drops no requests and corrupts no tokens — the first wave's tokens
    must be byte-identical to the single-host reference (sampling runs
    on fabric-reconstructed logits, so corruption IS observable as a
    wrong token). Filler waves must complete but are not token-compared:
    MoE expert-capacity contention couples rows within a batch, so only
    the wave that replays the reference's exact schedule is
    byte-comparable.
    """
    from ..collectives import CollectiveError, build_world
    from ..serving import RequestScheduler, TPServeEngine

    model, params, local, prompts, ref = _serving_fixture(
        seed, n_requests, n_tokens, n_slots, prefill_len, max_len, device)
    result = RunResult(scenario=scenario.name, workload="serving",
                       seed=seed, min_concurrency=2)
    cluster, libs, world = build_world(
        n_ranks=n_ranks, probe_interval=5e-4,
        max_chunk_bytes=max_chunk_bytes, strict_order=False, fast=fast,
        channels=channels)
    _observe(cluster, libs, result)
    engine = TPServeEngine(model, params, world=world, max_len=max_len,
                           timeout=scenario.duration + 1.0, local=local,
                           device=local.device)
    sched = RequestScheduler(engine, n_slots=n_slots,
                             prefill_len=prefill_len)
    for p in prompts:
        sched.submit(p, n_tokens)
    t0 = cluster.sim.now
    horizon = None
    steps = 0
    # expected remaining first-wave ticks: admission waves x tokens
    est_steps = max(1, -(-n_requests // n_slots) * n_tokens)
    try:
        while steps < max_steps:
            if (horizon is not None and cluster.sim.now >= horizon
                    and not sched.pending):
                break
            if not sched.pending:
                for p in prompts:       # filler wave: keep faults biting
                    sched.submit(p, n_tokens)
            sched.step()
            steps += 1
            if steps == 1:
                # Rebase the timeline onto the measured tick time (see
                # run_ddp); cap the traffic horizon at anchor + 10ms —
                # enough virtual time for the RC retry budget (~3.2ms),
                # a staggered second fault (+4ms) and probe cycles, but
                # not the authored 30ms recovery gaps (serving, like
                # ddp, is exempt from the recovery invariant).
                per_step = max(cluster.sim.now - t0, 1e-7)
                scale = per_step * est_steps / scenario.duration
                probe = max(per_step / 2, 1e-5)
                for lib in libs:
                    lib.config.probe_interval = probe
                rebased = rebase_fault_times(scenario.actions, scale)
                for at, kind, target, arg in rebased:
                    cluster.schedule_fault(cluster.sim.now + at, kind,
                                           target, arg)
                anchor = min((at for at, *_ in rebased), default=0.0)
                last = max((at for at, *_ in rebased), default=0.0)
                horizon = (cluster.sim.now + min(last, anchor + 10e-3)
                           + 3 * probe)
    except CollectiveError:
        sched.fail_outstanding()
        result.aborted = True
    # let scheduled fault actions + probes settle inside the window
    cluster.sim.run(until=t0 + scenario.duration + 0.05)
    result.requests_total = len(sched.requests)
    result.requests_done = sum(r.state == "done" for r in sched.requests)
    result.requests_failed = sum(r.state == "failed"
                                 for r in sched.requests)
    mismatches = 0
    for r in sched.requests:
        if r.state != "done":
            continue
        if len(r.tokens) != r.n_tokens:
            mismatches += 1          # truncated or duplicated tokens
        elif r.rid < len(ref) and list(r.tokens) != ref[r.rid]:
            mismatches += 1          # diverged from single-host reference
    result.token_mismatches = mismatches
    result.payload_mismatches = engine.reconstruction_mismatches
    result.rounds = sched.decode_steps
    result.completed = (not result.aborted and result.requests_total > 0
                        and result.requests_failed == 0
                        and result.requests_done == result.requests_total)
    result.event_count = cluster.sim._executed
    result.sim_elapsed = cluster.sim.now - t0
    _from_snapshot(world.stats_snapshot(), result)
    return result


# ---------------------------------------------------------------------------
# mixed latency-class workload
# ---------------------------------------------------------------------------


def run_mixed(scenario: Scenario, seed: int = 0, n_ranks: int = 2,
              elems: int = 1 << 14, buckets: int = 3,
              max_rounds: int = 400, probe_interval: float = 5e-3,
              fast: bool = True, channels: int = 2, ckpt_every: int = 4,
              nics_per_host: Optional[int] = None) -> RunResult:
    """All three latency classes concurrently under the fault timeline
    (DESIGN.md §10) — the scheduling twin of ``overlap_allreduce``.

    Every round issues ``buckets`` BULK gradient-bucket allreduces and
    then a small LATENCY-CRITICAL serving-style gather; because the
    gather is issued last, it only finishes early if the classful
    dispatch queues actually reorder its chunks past the queued bulk
    backlog. Every ``ckpt_every`` rounds a real
    :class:`~repro_torch.checkpoint.CheckpointStore` saves a small state tree,
    whose fabric replication rides as BACKGROUND broadcasts that yield
    to everything and are only drained at the end.

    Verified per round: the gather's reconstruction is byte-identical
    to its input and every bucket's sum is exact — priority reordering
    must never break byte-identity or exactly-once. The harvested
    ``RunResult.class_latency`` lets the invariants assert that no
    class starved (every class completed > 0 works).
    """
    from ..checkpoint import CheckpointStore
    from ..collectives import CollectiveError, build_world

    result = RunResult(scenario=scenario.name, workload="mixed",
                       seed=seed, min_concurrency=2)
    cluster, libs, world = build_world(
        n_ranks=n_ranks, probe_interval=probe_interval,
        max_chunk_bytes=1 << 12, strict_order=False, fast=fast,
        channels=channels,
        nics_per_host=nics_per_host or max(2, channels))
    _observe(cluster, libs, result)
    ckpt_dir = tempfile.mkdtemp(prefix="repro-mixed-ckpt-")
    store = CheckpointStore(ckpt_dir, keep=2)
    store.attach_world(world)
    t0 = cluster.sim.now
    scenario.schedule(cluster, t0)
    deadline = t0 + scenario.duration
    rng = np.random.RandomState(seed)
    mismatched = 0
    timeout = scenario.duration + 1.0
    horizon = t0 + min(scenario.duration,
                       _traffic_horizon(scenario, probe_interval))
    try:
        while cluster.sim.now < horizon or (
                cluster.sim.now < deadline and result.rounds < max_rounds):
            if result.rounds % ckpt_every == 0:
                store.save(result.rounds,
                           {"w": rng.randn(256).astype(np.float32)},
                           {"reason": "mixed-workload"})
            arrays = [rng.randn(elems).astype(np.float32)
                      for _ in range(n_ranks)]
            expect = np.sum(arrays, axis=0)
            bounds = world.aligned_bucket_bounds(elems, 4,
                                                 elems * 4 // buckets)
            works = [world.allreduce_async([a[lo:hi] for a in arrays],
                                           priority="bulk")
                     for lo, hi in bounds]
            small = rng.randn(256).astype(np.float32)
            crit = world.gather_replicated_async(
                small, priority="latency_critical")
            world.wait_all(works + [crit], timeout=timeout)
            for rec in crit.result():
                if not np.array_equal(rec, small):
                    mismatched += 1
            for arr in arrays:
                if not np.allclose(arr, expect, atol=1e-4):
                    mismatched += 1
            result.rounds += 1
        store.drain_stream(timeout)
        result.completed = result.rounds > 0
    except CollectiveError:
        result.aborted = True
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cluster.sim.run(until=deadline + 0.05)
    result.payload_mismatches = mismatched
    result.event_count = cluster.sim._executed
    result.sim_elapsed = cluster.sim.now - t0
    snap = world.stats_snapshot()
    _from_snapshot(snap, result)
    result.class_latency = snap["class_latency"]
    return result


# ---------------------------------------------------------------------------
# campaign runner
# ---------------------------------------------------------------------------


def run_ddp_bucketed(scenario: Scenario, seed: int = 0, steps: int = 4,
                     n_ranks: int = 2, fast: bool = True,
                     channels: int = 1,
                     bucket_bytes: int = 1 << 16,
                     device="cuda") -> RunResult:
    """Overlapped bucketed DDP: the smoke trainer with ``bucket_bytes``
    small enough (vs the ~2.4MB smoke-model gradient) that every step
    issues >= 4 concurrent gradient-bucket works — the invariants fail
    the run if it never actually overlapped."""
    return run_ddp(scenario, seed=seed, steps=steps, n_ranks=n_ranks,
                   fast=fast, channels=channels,
                   max_chunk_bytes=1 << 14, bucket_bytes=bucket_bytes,
                   min_concurrency=4, workload_name="ddp_bucketed",
                   device=device)


# Clean post-backward reference loss trajectories for the ddp_hooked
# byte-identity check, keyed by every knob that can change the numbers
# (build once: one reference run per configuration, shared across
# campaign cells).
_HOOKED_REFERENCE: Dict[Tuple, List[float]] = {}


def _hooked_reference(seed: int, steps: int, n_ranks: int,
                      bucket_bytes: int, device) -> List[float]:
    """Unrounded loss trajectory of a CLEAN post-backward bucketed run
    with the same world geometry as ``run_ddp_hooked`` — the reference
    the hooked (and faulted) trajectories must match byte-for-byte. The
    cache is keyed on the device too: one device's trajectory never
    serves as another's reference."""
    from .. import resolve_device
    from ..collectives import build_world
    from ..train.trainer import build_smoke_trainer

    device = resolve_device(device)
    key = (seed, steps, n_ranks, bucket_bytes, str(device))
    hit = _HOOKED_REFERENCE.get(key)
    if hit is not None:
        return hit
    cluster, libs, _world = build_world(
        n_ranks=n_ranks, probe_interval=5e-4, max_chunk_bytes=1 << 14,
        strict_order=False, fast=True, channels=2)
    ckpt_dir = tempfile.mkdtemp(prefix="repro-hooked-ref-")
    try:
        trainer = build_smoke_trainer(cluster, libs, steps=steps,
                                      ckpt_dir=ckpt_dir, seed=seed,
                                      bucket_bytes=bucket_bytes,
                                      device=device)
        run = trainer.train(_world)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref = [l for _, _, l in run.timeline]
    _HOOKED_REFERENCE[key] = ref
    return ref


def run_ddp_hooked(scenario: Scenario, seed: int = 0, steps: int = 4,
                   n_ranks: int = 2, fast: bool = True,
                   channels: int = 2, bucket_bytes: int = 1 << 16,
                   layer_compute_s: float = 2e-4,
                   device="cuda") -> RunResult:
    """Issue-as-produced DDP (DESIGN.md §13): the smoke trainer fires
    each gradient bucket's allreduce the moment the modeled backward
    produces its last leaf, while later segments still compute. The
    run's unrounded loss trajectory is compared byte-for-byte against a
    CLEAN post-backward reference — any divergence (including under a
    mid-backward rail kill, which must only DELAY the bucket it hit)
    counts as a payload mismatch and fails the invariants. Defaults to
    2 channels so single-rail scenarios stay maskable mid-backward."""
    result = run_ddp(scenario, seed=seed, steps=steps, n_ranks=n_ranks,
                     fast=fast, channels=channels,
                     max_chunk_bytes=1 << 14, bucket_bytes=bucket_bytes,
                     min_concurrency=4, workload_name="ddp_hooked",
                     issue_as_produced=True,
                     layer_compute_s=layer_compute_s, device=device)
    if result.completed and result.loss_trace is not None:
        ref = _hooked_reference(seed, steps, n_ranks, bucket_bytes, device)
        if (len(result.loss_trace) != len(ref)
                or any(a != b for a, b in zip(result.loss_trace, ref))):
            result.payload_mismatches += 1
    return result


WORKLOADS: Dict[str, Callable[..., RunResult]] = {
    "pingpong": run_pingpong,
    "allreduce": run_allreduce,
    "overlap_allreduce": run_overlap_allreduce,
    "hierarchical_allreduce": run_hierarchical_allreduce,
    "broadcast": run_broadcast,
    "all_to_all": run_alltoall,
    "ddp": run_ddp,
    "ddp_bucketed": run_ddp_bucketed,
    "ddp_hooked": run_ddp_hooked,
    "serving": run_serving,
    "mixed": run_mixed,
}


def run_scenario(scenario: Scenario, workload: str = "pingpong",
                 seed: int = 0, **kw) -> RunResult:
    """Execute one (scenario, workload) cell and check invariants."""
    from .invariants import check_invariants

    hints = (scenario.workload_hints or {}).get(workload, {})
    result = WORKLOADS[workload](scenario, seed=seed, **{**hints, **kw})
    result.violations = check_invariants(result, scenario)
    return result


class Campaign:
    """A scenario x workload matrix executed on the deterministic fabric."""

    def __init__(self, scenarios: Sequence[Scenario],
                 workloads: Sequence[str] = ("pingpong",),
                 seed: int = 0,
                 workload_kw: Optional[Dict[str, dict]] = None):
        unknown = [w for w in workloads if w not in WORKLOADS]
        if unknown:
            raise ValueError(f"unknown workloads {unknown}")
        self.scenarios = list(scenarios)
        self.workloads = list(workloads)
        self.seed = seed
        self.workload_kw = workload_kw or {}

    def run(self) -> List[RunResult]:
        """Every scenario x workload cell, in order."""
        results = []
        for sc in self.scenarios:
            for w in self.workloads:
                results.append(run_scenario(
                    sc, workload=w, seed=self.seed,
                    **self.workload_kw.get(w, {})))
        return results

    @staticmethod
    def report(results: Sequence[RunResult]) -> str:
        """One line a cell (status, fallbacks, recoveries, the largest
        fallback latency), each violation under its cell."""
        lines = []
        for r in results:
            lat = max(r.fallback_latencies) * 1e3 \
                if r.fallback_latencies else float("nan")
            status = "ok" if r.ok else "VIOLATED"
            lines.append(
                f"{r.scenario:32s} {r.workload:9s} {status:8s} "
                f"fb={r.fallbacks} rec={r.recoveries} "
                f"err={r.errors_propagated} lat_max={lat:.2f}ms "
                f"events={r.event_count}")
            for v in r.violations:
                lines.append(f"    ! {v}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# policy-comparison campaign mode
# ---------------------------------------------------------------------------

#: The scenarios the policy comparison sweeps: a control, the headline
#: binary faults (transient + permanent + flapping), and the two pure
#: degradations — together they cover every branch of the adaptive
#: decision table, and each fixed policy is optimal somewhere-ish and
#: pathological somewhere else.
POLICY_SCENARIOS = ("baseline_clean", "sender_nic_down",
                    "nic_down_permanent", "link_flap_train",
                    "slow_rail_straggler",
                    "degraded_rail_proportional_share")


def run_policy_matrix(policies: Optional[Sequence[str]] = None,
                      scenario_names: Sequence[str] = POLICY_SCENARIOS,
                      seed: int = 0, channels: int = 2,
                      max_rounds: int = 800, elems: int = 1 << 15,
                      fast: bool = True) -> Dict[str, Dict[str, dict]]:
    """Run the same scenario set under every policy (the four fixed
    baselines + adaptive by default) on the 2-channel allreduce
    workload and return ``matrix[policy][scenario]`` cells.

    Each cell records the **recovered throughput** — completed rounds
    per virtual second over the scenario window — plus the invariant
    verdict and the decision count. A cell that VIOLATES the standing
    invariants scores zero throughput: a policy that breaks
    exactly-once/share/recovery contracts earns no credit for any speed
    it got in exchange (fixed ``shrink`` breaking the proportional-
    share contract is the canonical case). Fully deterministic: same
    seed ⇒ byte-identical matrix including every decision log."""
    from ..policy import POLICIES

    from .library import get

    policies = list(policies) if policies is not None else list(POLICIES)
    matrix: Dict[str, Dict[str, dict]] = {}
    for p in policies:
        row: Dict[str, dict] = {}
        for name in scenario_names:
            r = run_scenario(get(name), workload="allreduce", seed=seed,
                             policy=p, channels=channels,
                             max_rounds=max_rounds, elems=elems,
                             fast=fast)
            span = r.work_elapsed or r.sim_elapsed
            tput = (0.0 if r.violations or not span
                    else r.rounds / span)
            row[name] = {
                "tput": round(tput, 3),
                "rounds": r.rounds,
                "work_elapsed": round(r.work_elapsed, 9),
                "ok": not r.violations,
                "violations": list(r.violations),
                "decisions": len(r.decision_log),
                "fallbacks": r.fallbacks,
                "fingerprint": r.fingerprint(),
            }
        matrix[p] = row
    return matrix


def policy_dominance(matrix: Dict[str, Dict[str, dict]]) -> Dict[str, object]:
    """Score a :func:`run_policy_matrix` result for the
    ``policy_adaptive_dominance`` gate.

    Aggregate recovered throughput per policy is the mean of its
    per-scenario cells, each normalized by the best throughput ANY
    policy achieved on that scenario (so every scenario contributes
    equally regardless of its absolute round rate). Returns the
    aggregates, the best fixed policy, ``adaptive_aggregate_ratio``
    (adaptive / best fixed — the gate requires >= 1.0) and
    ``min_cell_ratio`` (worst per-scenario adaptive vs the best FIXED
    policy in that cell — the gate requires >= 0.9)."""
    from ..policy import FIXED_POLICIES

    scenarios = list(next(iter(matrix.values())).keys())
    best_cell = {s: max(matrix[p][s]["tput"] for p in matrix)
                 for s in scenarios}
    agg = {p: sum((matrix[p][s]["tput"] / best_cell[s])
                  if best_cell[s] else 1.0 for s in scenarios)
           / max(len(scenarios), 1)
           for p in matrix}
    fixed = [p for p in matrix if p in FIXED_POLICIES]
    best_fixed = max(fixed, key=lambda p: agg[p]) if fixed else None
    out: Dict[str, object] = {"aggregate": {p: round(a, 6)
                                            for p, a in agg.items()},
                              "best_fixed": best_fixed}
    if best_fixed is not None and "adaptive" in matrix:
        out["adaptive_aggregate_ratio"] = round(
            agg["adaptive"] / agg[best_fixed], 6) if agg[best_fixed] else 1.0
        cell_ratios = {}
        for s in scenarios:
            best_fixed_cell = max(matrix[p][s]["tput"] for p in fixed)
            cell_ratios[s] = (matrix["adaptive"][s]["tput"]
                              / best_fixed_cell if best_fixed_cell else 1.0)
        worst = min(cell_ratios, key=cell_ratios.get)
        out["cell_ratios"] = {s: round(v, 6)
                              for s, v in cell_ratios.items()}
        out["min_cell_ratio"] = round(cell_ratios[worst], 6)
        out["worst_cell"] = worst
    return out
