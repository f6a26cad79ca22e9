"""Fault-tolerant data-parallel trainer over SHIFT-protected RDMA.

This is the paper's §5.2 experiment on PyTorch: N data-parallel
workers (one per simulated host), gradient all-reduce through JCCL's
NCCL-Simple protocol over either StandardLib (baseline: a NIC failure
aborts the job -> checkpoint-restart with rescheduling + retrain loss) or
ShiftLib (failures masked; training continues until the next checkpoint or
indefinitely). Per §4.4, the trainer checkpoints promptly after a fallback
("failure-aware checkpointing").

Gradient communication is **bucketed and overlapped** (DESIGN.md §8): the
flat gradient vector is split into ``TrainerConfig.bucket_bytes``-sized
buckets whose boundaries align with the collective engine's chunk
granularity, each bucket goes out as an ``allreduce_async`` work handle,
and the optimizer step waits on all handles — so bucket rings pipeline
across each other and across rails, and a mid-step fallback only delays
the bucket it hit. The bucketed result is byte-identical to the
sequential flat-vector path (same chunk bounds, same reduction order).

The returned ``TrainRun.timeline`` is (time, step, loss) where time
combines measured compute wall-time (divided by world size — workers run
sequentially here but execute in parallel on a real cluster) and the
simulated network time of the collectives.

The port's own copy of the reference's trainer. Each rank's forward and
backward run on the trainer's device (``"cuda"`` by default: the flash
attention kernels B1, B2a and B2b on a card) through
:func:`repro_torch.launch.value_and_grad`; the gradient leaves are
joined in :func:`repro_torch.models.lm.flatten` order (the reference's
order) into one float32 vector, copied to the host, and the fabric,
which is numpy on the host as in the reference, all-reduces it. The mean
goes back to the device, where AdamW runs. Initial params are drawn on
the CPU from ``torch.Generator().manual_seed(seed)`` and moved to the
device, so the same seed gives the same params on every device.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointStore
from ..collectives import CollectiveError, JcclWorld
from ..configs import smoke_config
from ..convert import param_shapes
from ..core.shift import ShiftLib
from ..data import SyntheticDataset
from ..launch import value_and_grad
from ..models import build_model
from ..models.lm import flatten, unflatten
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.compress import int8_compress, int8_decompress

from .backward import BackwardScheduler


def _tmp_dir(name: str) -> str:
    """``name`` under the process's temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), name)


@dataclasses.dataclass
class TrainerConfig:
    """Run-length, checkpoint, optimizer and DDP-overlap knobs for
    :class:`DDPTrainer`."""

    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: _tmp_dir("repro-ckpt"))
    reschedule_time: float = 63.0      # paper Fig. 8(d) baseline value
    reschedule_time_shift: float = 37.0
    lr: float = 1e-3
    grad_compress: bool = False        # int8 + error feedback (cross-pod)
    stop_at_next_ckpt_after_fallback: bool = False  # scenario (3)
    seed: int = 0
    # Gradient bucketing (DDP overlap): the flat gradient vector is split
    # into size-targeted buckets, each all-reduced as its own collective.
    # ``overlap=True`` issues every bucket as an async work handle and
    # waits on all of them before the optimizer step, so bucket rings
    # pipeline across each other (and across rails) instead of running
    # back-to-back; a mid-step fallback only delays the bucket it hit.
    # 0 disables bucketing (one flat all-reduce, the historical path).
    # Bucket boundaries are ALIGNED to the collective engine's bucket
    # granularity, so the bucketed result is byte-identical to the flat
    # path — see DDPTrainer._grad_buckets.
    bucket_bytes: int = 1 << 18
    overlap: bool = True
    # Two-tier gradient sync (DESIGN.md §11): on a multi-pod world,
    # all-reduce each bucket hierarchically — intra-pod ring
    # reduce-scatter, cross-pod shard exchange over the DCN uplinks,
    # intra-pod all-gather. ``compress_dcn`` int8-compresses only the
    # cross-pod exchange (4x fewer bytes on the ~10x-thinner tier) with
    # per-shard error feedback carried across steps beside the
    # optimizer state, so quantization residue is deferred, not lost.
    hierarchical: bool = False
    compress_dcn: bool = True
    # Gradient-work wait budget (virtual seconds). A bucket that is
    # still pending past this deadline fails with a CollectiveError
    # naming the stuck bucket indices and cids.
    comm_timeout_s: float = 300.0
    # Backward-hook overlap (DESIGN.md §13, docs/overlap.md): issue
    # each gradient bucket's allreduce the moment its last leaf is
    # produced by the (modeled) backward pass, instead of after the
    # whole backward. ``layer_compute_s`` is the virtual cost of ONE
    # backward segment (head / per-layer row / embed — see
    # BackwardScheduler); the trainer pumps the simulator by that much
    # between segments, so in-flight buckets make progress UNDER the
    # remaining backward and the overlap is measurable in virtual
    # seconds. With ``layer_compute_s > 0`` the non-hooked paths charge
    # the same total backward cost up front, so end-to-end virtual step
    # times are comparable across modes. Defaults (False / 0.0) keep
    # every existing path and timing unchanged.
    issue_as_produced: bool = False
    layer_compute_s: float = 0.0


@dataclasses.dataclass
class TrainRun:
    """Outcome of one training run: the (time, step, loss) timeline plus
    fault/recovery counters and communication-time accounting."""

    timeline: List[Tuple[float, int, float]]
    restarts: int = 0
    fallbacks: int = 0
    recoveries: int = 0
    slowdown_reschedule: float = 0.0
    slowdown_retrain: float = 0.0
    final_step: int = 0
    # virtual seconds spent in gradient collectives across the run (the
    # ddp_overlap_speedup benchmark compares this across modes)
    comm_time: float = 0.0
    # peak number of concurrently in-flight gradient works in any step
    peak_works: int = 0
    # fault-policy accounting (repro.policy): policy-directed
    # post-fallback saves and shrink-world events this run consumed
    policy_ckpts: int = 0
    policy_shrinks: int = 0
    # backward-hook overlap accounting (issue-as-produced mode): mean
    # fraction of the gradient-comm window that ran UNDER the modeled
    # backward compute, the per-step fraction/first-issue series, the
    # per-step virtual grad-phase duration (modeled compute + exposed
    # comm — what the ddp_hook_overlap benchmark compares end-to-end),
    # and the per-step peak of concurrently in-flight gradient works
    # (surfaced in the campaign matrix markdown)
    overlap_fraction: float = 0.0
    step_overlap_fractions: List[float] = dataclasses.field(
        default_factory=list)
    first_issue_offsets: List[float] = dataclasses.field(
        default_factory=list)
    step_grad_times: List[float] = dataclasses.field(default_factory=list)
    step_peak_works: List[int] = dataclasses.field(default_factory=list)


class DDPTrainer:
    """Data-parallel trainer over a JcclWorld: per-rank forward/backward,
    bucketed+overlapped bulk-class gradient all-reduce, periodic
    checkpointing with background-class replication, and SHIFT-aware
    fault accounting."""

    def __init__(self, cluster, libs, model_cfg, tcfg: TrainerConfig,
                 batch_per_rank: int = 4, seq_len: int = 128,
                 device="cuda"):
        """Build the model (on ``device``), per-rank datasets and
        checkpoint store."""
        self.cluster = cluster
        self.libs = libs
        self.n = len(libs)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build_model(model_cfg, device=self.device)
        self.opt_cfg = AdamWConfig(lr=tcfg.lr, warmup_steps=10,
                                   total_steps=tcfg.steps)
        self.data = [SyntheticDataset(model_cfg.vocab, seq_len,
                                      batch_per_rank, rank=r, world=self.n,
                                      seed=tcfg.seed)
                     for r in range(self.n)]
        self.store = CheckpointStore(tcfg.ckpt_dir, keep=2)
        # optional fault-policy engine (repro.policy): when attached,
        # the §4.4 post-fallback checkpoint fires when (and only when)
        # the policy decided "checkpoint" — the raw fallback-delta
        # trigger below stays authoritative otherwise
        self.policy = None
        self._grad_fn = functools.partial(value_and_grad, self.model)
        self._err_fb = [None] * self.n  # int8 error feedback per rank
        # DCN error feedback, one dict per gradient bucket (the
        # hierarchical collective keys residue by (pod, bucket, shard)
        # WITHIN one launch, so distinct gradient buckets must not
        # share a dict). Lives beside the optimizer state for the whole
        # run — quantization residue carries across steps.
        self._dcn_fb: Dict[int, Dict] = {}
        # cached leaf->bucket readiness schedule (issue-as-produced /
        # modeled-compute modes); rebuilt when the world geometry or
        # bucketing changes (e.g. across a restart)
        self._bw_sched: Optional[BackwardScheduler] = None
        self._bw_key: Optional[Tuple] = None

    # ------------------------------------------------------------------
    def _init_state(self):
        # drawn on the CPU, so a seed gives the same params on any device
        cpu = build_model(self.model_cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(self.tcfg.seed))
        params = unflatten((path, p.to(self.device))
                           for path, p in flatten(params))
        opt = adamw_init(params, self.opt_cfg)
        return {"params": params, "opt": opt}

    def _batch(self, r: int, step: int) -> Dict[str, torch.Tensor]:
        """Rank ``r``'s batch at ``step``: int32 tokens on the device."""
        return {"tokens": torch.as_tensor(self.data[r].batch_at(step),
                                          device=self.device)}

    def _flatten_grads(self, grads) -> Tuple[np.ndarray, Callable]:
        """One host float32 vector of the gradient leaves in
        :func:`flatten` order, and the function that puts such a vector
        back on the device as a tree of views of one tensor."""
        items = flatten(grads)
        shapes = [g.shape for _, g in items]
        sizes = [g.numel() for _, g in items]
        # the copy to the host waits for the backward to finish on the
        # card, so the caller's wall clock covers the device work
        vec = torch.cat([g.detach().reshape(-1).float()
                         for _, g in items]).cpu().numpy()

        def unflatten_(v):
            flat = torch.from_numpy(
                np.ascontiguousarray(v, np.float32)).to(self.device)
            return unflatten((path, part.view(s)) for (path, _), part, s
                             in zip(items, flat.split(sizes), shapes))
        return vec, unflatten_

    def _grad_buckets(self, world: JcclWorld,
                      total_elems: int) -> List[Tuple[int, int]]:
        """Element ranges of the size-targeted gradient buckets — the
        engine's aligned bounds (see JcclWorld.aligned_bucket_bounds:
        alignment is what makes the bucketed/overlapped result
        byte-identical to the flat path). Gradients travel as float32."""
        return world.aligned_bucket_bounds(total_elems, 4,
                                           self.tcfg.bucket_bytes)

    def _backward_schedule(self, world: JcclWorld,
                           total_elems: int) -> BackwardScheduler:
        """Cached leaf->aligned-bucket readiness schedule, built from
        the parameter tree's SHAPES (meta tensors from
        :func:`param_shapes` — no gradient materialization) and this
        world's aligned bucket bounds."""
        key = (world.n_ranks, world.max_chunk_bytes,
               self.tcfg.bucket_bytes, total_elems)
        if self._bw_key != key:
            meta = unflatten((path, torch.empty(shape, device="meta"))
                             for path, shape in
                             param_shapes(self.model_cfg).items())
            sched = BackwardScheduler(
                meta, self._grad_buckets(world, total_elems))
            if sched.total_elems != total_elems:
                raise ValueError(
                    f"backward schedule covers {sched.total_elems} elems "
                    f"but the flat gradient has {total_elems}")
            self._bw_sched, self._bw_key = sched, key
        return self._bw_sched

    def _wait_grad_works(self, world: JcclWorld, works, idxs,
                         bounds) -> None:
        """Wait on gradient works with the ``comm_timeout_s`` budget;
        on failure re-raise naming the stuck buckets (index, element
        range, cid) so a wedged bucket is attributable at a glance."""
        try:
            world.wait_all(works, timeout=self.tcfg.comm_timeout_s)
        except CollectiveError as e:
            stuck = [f"bucket {i} [{bounds[i][0]}:{bounds[i][1]}) "
                     f"cid={w.cid}"
                     for i, w in zip(idxs, works)
                     if w.exception() is not None]
            raise CollectiveError(
                f"gradient all-reduce did not complete within "
                f"comm_timeout_s={self.tcfg.comm_timeout_s}s: "
                + ("; ".join(stuck) if stuck else str(e))) from e

    def _allreduce_grads(self, world: JcclWorld, run: TrainRun,
                         grad_vecs: List[np.ndarray]) -> None:
        """All-reduce the per-rank gradient vectors, bucketed and (by
        default) overlapped: one async work per bucket, all waited
        before the optimizer step. Sequential mode (``overlap=False``)
        waits each bucket before issuing the next — the baseline the
        ``ddp_overlap_speedup`` benchmark gates against. With
        ``issue_as_produced`` the buckets are instead launched
        incrementally as the modeled backward produces them (see
        :meth:`_allreduce_grads_hooked`); with ``layer_compute_s > 0``
        but hooks off, the same total backward cost is charged up front
        so virtual step times stay comparable across modes."""
        tcfg = self.tcfg
        bounds = self._grad_buckets(world, grad_vecs[0].size)
        if tcfg.hierarchical:
            # two-tier path: one hierarchical collective per bucket,
            # each with its own persistent DCN feedback dict
            launch = [
                (lambda vecs, i=i: world.hierarchical_allreduce_async(
                    vecs, compress=self.tcfg.compress_dcn,
                    feedback=self._dcn_fb.setdefault(i, {}),
                    priority="bulk"))
                for i in range(len(bounds))]
        else:
            launch = [
                (lambda vecs: world.allreduce_async(vecs, priority="bulk"))
                for _ in bounds]
        if tcfg.issue_as_produced and tcfg.overlap:
            sched = self._backward_schedule(world, grad_vecs[0].size)
            self._allreduce_grads_hooked(world, run, grad_vecs, bounds,
                                         launch, sched)
            return
        if tcfg.layer_compute_s > 0:
            # post-backward baseline under the same compute model: the
            # WHOLE backward is charged before the first bucket issues
            sched = self._backward_schedule(world, grad_vecs[0].size)
            world.sim.run(until=world.sim.now
                          + sched.n_segments * tcfg.layer_compute_s)
        if tcfg.overlap:
            # gradient buckets are explicitly BULK class: they should
            # pipeline at full busbw but yield the head of the dispatch
            # queues to latency-critical serving works (DESIGN.md §10)
            works = [go([v[lo:hi] for v in grad_vecs])
                     for go, (lo, hi) in zip(launch, bounds)]
            run.peak_works = max(run.peak_works, len(works))
            run.step_peak_works.append(len(works))
            self._wait_grad_works(world, works,
                                  list(range(len(bounds))), bounds)
        else:
            run.peak_works = max(run.peak_works, 1)
            run.step_peak_works.append(1)
            for i, (go, (lo, hi)) in enumerate(zip(launch, bounds)):
                self._wait_grad_works(
                    world, [go([v[lo:hi] for v in grad_vecs])], [i],
                    bounds)

    def _allreduce_grads_hooked(self, world: JcclWorld, run: TrainRun,
                                grad_vecs: List[np.ndarray], bounds,
                                launch, sched: BackwardScheduler) -> None:
        """Issue-as-produced gradient sync: walk the backward segments
        in production order (head, layers in reverse, embed), pump the
        simulator by ``layer_compute_s`` of modeled compute per
        segment — in-flight buckets progress DURING that compute — and
        fire each bucket's allreduce the moment its last leaf lands.
        Byte-identity with the flat/post-backward paths is structural:
        the gradients are computed once by the unchanged
        backward, the bucket bounds are the same engine-aligned bounds,
        and hooks only change WHEN each bucket's work is issued, never
        its chunk bounds or ring order."""
        tcfg = self.tcfg
        sim = world.sim
        t0 = sim.now
        works, idxs = [], []
        peak = 0
        for seg in range(sched.n_segments):
            if tcfg.layer_compute_s > 0:
                sim.run(until=sim.now + tcfg.layer_compute_s)
            for i in sched.ready_after(seg):
                lo, hi = bounds[i]
                works.append(launch[i]([v[lo:hi] for v in grad_vecs]))
                idxs.append(i)
            live = sum(1 for w in works if not w.done())
            peak = max(peak, live)
        t_bw_end = sim.now  # the modeled backward is fully charged here
        run.peak_works = max(run.peak_works, peak)
        run.step_peak_works.append(peak)
        t_first = min((w.issue_time for w in works), default=t0)
        self._wait_grad_works(world, works, idxs, bounds)
        t_done = sim.now
        # overlap fraction: share of the comm window [first issue ..
        # all buckets done] that ran under the backward. A comm window
        # fully hidden by compute (t_done <= t_bw_end) scores 1.0.
        denom = t_done - t_first
        frac = 1.0 if denom <= 0 else max(
            0.0, min(1.0, (min(t_bw_end, t_done) - t_first) / denom))
        run.step_overlap_fractions.append(frac)
        run.first_issue_offsets.append(t_first - t0)
        run.overlap_fraction = float(
            np.mean(run.step_overlap_fractions))

    # ------------------------------------------------------------------
    def train(self, world: JcclWorld,
              on_step: Optional[Callable] = None) -> TrainRun:
        """Run the configured number of steps on ``world``; returns the
        :class:`TrainRun` (timeline + fault/comm accounting). Faults on
        the fabric surface as fallbacks/restarts, not training errors."""
        tcfg = self.tcfg
        run = TrainRun(timeline=[])
        state = self._init_state()
        step = 0
        t = 0.0  # combined (compute + simulated-network) clock
        # checkpoint saves replicate over the fabric as background-class
        # traffic that yields to the gradient buckets (and to any
        # co-located serving works); drained best-effort at run end
        self.store.attach_world(world)
        shift_libs = [l for l in self.libs if isinstance(l, ShiftLib)]
        last_fallbacks = sum(l.stats.fallbacks for l in shift_libs)
        ckpt_after_fallback_pending = False

        while step < tcfg.steps:
            try:
                wall0 = time.time()
                losses, grad_vecs, unflatten_ = [], [], None
                for r in range(self.n):
                    loss, grads = self._grad_fn(state["params"],
                                                self._batch(r, step))
                    losses.append(float(loss))
                    vec, unflatten_ = self._flatten_grads(grads)
                    del grads  # this rank's device gradients are freed
                    if tcfg.grad_compress:
                        q, scale, self._err_fb[r] = int8_compress(
                            vec, self._err_fb[r])
                        vec = int8_decompress(q, scale)
                    grad_vecs.append(vec)
                # host wall time around finished device work: each
                # rank's loss and gradient copy to the host wait for it
                compute_t = (time.time() - wall0) / self.n

                sim0 = self.cluster.sim.now
                self._allreduce_grads(world, run, grad_vecs)
                comm_t = self.cluster.sim.now - sim0
                run.comm_time += comm_t
                run.step_grad_times.append(comm_t)

                mean_grads = unflatten_(grad_vecs[0] / self.n)
                state["params"], state["opt"], _ = adamw_update(
                    state["params"], mean_grads, state["opt"], self.opt_cfg)
                step += 1
                t += compute_t + comm_t
                run.timeline.append((t, step, float(np.mean(losses))))
                if on_step is not None:
                    on_step(step, t, float(np.mean(losses)))

                # failure-aware checkpointing (§4.4)
                now_fallbacks = sum(l.stats.fallbacks for l in shift_libs)
                if now_fallbacks > last_fallbacks:
                    last_fallbacks = now_fallbacks
                    if self.policy is None:
                        ckpt_after_fallback_pending = True
                if self.policy is not None:
                    # policy-directed: the engine already decided (and
                    # rate-limited) at the fallback events themselves —
                    # the trainer saves its REAL state exactly when a
                    # "checkpoint" decision is pending, and counts
                    # shrink-world actuations (the engine excluded the
                    # channels at the scheduler already)
                    acts = self.policy.consume_trainer_actions()
                    if acts["checkpoint"]:
                        ckpt_after_fallback_pending = True
                        run.policy_ckpts += 1
                    if acts["shrink"]:
                        run.policy_shrinks += 1
                if step % tcfg.ckpt_every == 0 or ckpt_after_fallback_pending:
                    self.store.save(step, state,
                                    {"reason": "post-fallback"
                                     if ckpt_after_fallback_pending
                                     else "scheduled"})
                    if (ckpt_after_fallback_pending
                            and tcfg.stop_at_next_ckpt_after_fallback):
                        # scenario (3): stop gracefully at the checkpoint,
                        # reschedule, and resume on healthy hardware
                        run.restarts += 1
                        run.slowdown_reschedule += tcfg.reschedule_time_shift
                        t += tcfg.reschedule_time_shift
                        ckpt_after_fallback_pending = False
                    else:
                        ckpt_after_fallback_pending = False

            except CollectiveError:
                # crash-stop: the job dies; checkpoint-restart baseline
                run.restarts += 1
                restart_step = self.store.latest_step() or 0
                lost_steps = step - restart_step
                # retrain cost estimated from the measured per-step time
                per_step = (t / step) if step else 1.0
                run.slowdown_reschedule += tcfg.reschedule_time
                run.slowdown_retrain += lost_steps * per_step
                t += tcfg.reschedule_time
                if restart_step:
                    state, _ = self.store.restore(state)
                else:
                    state = self._init_state()
                step = restart_step
                # the failed NIC is recovered by the harness before restart;
                # rebuild the communicator world on fresh QPs
                raise RestartNeeded(run, state, step, t)

        self.store.drain_stream()
        run.final_step = step
        run.fallbacks = sum(l.stats.fallbacks for l in shift_libs)
        run.recoveries = sum(l.stats.recoveries for l in shift_libs)
        return run


def build_smoke_trainer(cluster, libs, steps: int = 6,
                        ckpt_dir: Optional[str] = None, seed: int = 0,
                        lr: float = 3e-3, bucket_bytes: Optional[int] = None,
                        overlap: bool = True, hierarchical: bool = False,
                        compress_dcn: bool = True,
                        issue_as_produced: bool = False,
                        layer_compute_s: float = 0.0,
                        comm_timeout_s: Optional[float] = None,
                        device="cuda", model_cfg=None) -> DDPTrainer:
    """Campaign-engine / CI-smoke entry point: a DDP trainer over a tiny
    model that finishes a handful of steps in seconds. The fault-scenario
    campaign (repro.scenarios) drives this as its heaviest workload.
    ``bucket_bytes`` / ``overlap`` override the gradient-bucketing knobs
    (None keeps the TrainerConfig default); ``hierarchical`` /
    ``compress_dcn`` select the two-tier gradient sync on multi-pod
    worlds; ``issue_as_produced`` / ``layer_compute_s`` enable the
    backward-hook overlap path under the modeled per-segment compute
    cost (DESIGN.md §13). ``ckpt_dir`` None is ``repro-ckpt-smoke`` under
    the temporary directory; the model runs on ``device``. ``model_cfg``
    None is the reference's smoke model (gpt2-124m cut to 2 layers at
    d=128); another config trains that model on the same 2 x 32 tokens a
    rank."""
    if model_cfg is None:
        model_cfg = smoke_config("gpt2-124m", n_layers=2, d_model=128,
                                 n_heads=4, n_kv_heads=4, d_ff=512,
                                 vocab=512)
    if ckpt_dir is None:
        ckpt_dir = _tmp_dir("repro-ckpt-smoke")
    kw = {} if bucket_bytes is None else {"bucket_bytes": bucket_bytes}
    if comm_timeout_s is not None:
        kw["comm_timeout_s"] = comm_timeout_s
    tcfg = TrainerConfig(steps=steps, ckpt_every=max(2, steps // 2),
                         lr=lr, ckpt_dir=ckpt_dir, seed=seed,
                         overlap=overlap, hierarchical=hierarchical,
                         compress_dcn=compress_dcn,
                         issue_as_produced=issue_as_produced,
                         layer_compute_s=layer_compute_s, **kw)
    return DDPTrainer(cluster, libs, model_cfg, tcfg,
                      batch_per_rank=2, seq_len=32, device=device)


class RestartNeeded(Exception):
    """Signals the driver to rebuild the communicator and resume.

    Carries (run, state, step, t) so progress accounting continues across
    the restart — mirrors a real gang-scheduler rescheduling the job."""

    def __init__(self, run, state, step, t):
        super().__init__("job crashed; restart from checkpoint")
        self.run = run
        self.state = state
        self.step = step
        self.t = t


def resume_training(trainer: DDPTrainer, world: JcclWorld, rn: RestartNeeded,
                    on_step: Optional[Callable] = None) -> TrainRun:
    """Continue a crashed run with a fresh world (baseline restart path)."""
    tcfg = trainer.tcfg
    run, state, step, t = rn.run, rn.state, rn.step, rn.t
    # re-attach replication to the FRESH world; stream works issued
    # against the crashed world are dropped, not waited
    trainer.store.attach_world(world)
    while step < tcfg.steps:
        wall0 = time.time()
        losses, grad_vecs, unflatten_ = [], [], None
        for r in range(trainer.n):
            loss, grads = trainer._grad_fn(state["params"],
                                           trainer._batch(r, step))
            losses.append(float(loss))
            vec, unflatten_ = trainer._flatten_grads(grads)
            del grads
            grad_vecs.append(vec)
        compute_t = (time.time() - wall0) / trainer.n
        sim0 = trainer.cluster.sim.now
        trainer._allreduce_grads(world, run, grad_vecs)
        comm_t = trainer.cluster.sim.now - sim0
        run.comm_time += comm_t
        run.step_grad_times.append(comm_t)
        mean_grads = unflatten_(grad_vecs[0] / trainer.n)
        state["params"], state["opt"], _ = adamw_update(
            state["params"], mean_grads, state["opt"], trainer.opt_cfg)
        step += 1
        t += compute_t + comm_t
        run.timeline.append((t, step, float(np.mean(losses))))
        if on_step is not None:
            on_step(step, t, float(np.mean(losses)))
        if step % tcfg.ckpt_every == 0:
            trainer.store.save(step, state, {"reason": "scheduled"})
    trainer.store.drain_stream()
    run.final_step = step
    return run
