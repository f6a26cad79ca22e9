"""Real-time fault-policy engine: pick a per-fault response, live.

SHIFT (PAPER.md §4.4) prescribes ONE response to every fault — mask it
in place with a cross-NIC fallback, then checkpoint promptly.  The
fabric grown around it now has four distinct recovery mechanisms:

* ``shift_fallback`` — in-place SHIFT masking (the paper's default; the
  fault is absorbed by the QP-level failover and nothing else moves);
* ``demote``         — telemetry straggler demotion: cap the affected
  rail's scheduler weight immediately instead of waiting for the
  latency EWMA to cross the straggler threshold organically;
* ``checkpoint``     — §4.4's post-fallback checkpoint, issued through
  :class:`repro_torch.checkpoint.CheckpointStore` with
  ``reason="post-fallback"``;
* ``shrink``         — shrink-world continue: exclude the affected
  channel from the chunk scheduler and finish the job on the surviving
  rails (never wait for a recovery that may not come).

Chameleon (PAPERS.md) argues that *adaptive* selection among such
mechanisms — driven by live failure signals — dominates any single
fixed policy.  :class:`FaultPolicyEngine` is that selector: it watches
every applied fault (``Cluster.add_fault_listener``), every SHIFT
lifecycle event (``ShiftLib.attach_policy`` → fallback / recovery /
failed), the per-rail
:class:`~repro_torch.core.fabric.RailTelemetry` EWMAs, and the SHIFT flap
history (``ShiftQP.flap_times``), and decides one response per event.
Every decision is recorded with the full input
signal snapshot (:class:`PolicyDecision`) and lands in the scenario
audit trail — ``RunResult.decision_log`` folds into the campaign
fingerprint, so policy behavior is covered by the same determinism
contract as the fabric itself.

The four fixed policies (one per response, applied unconditionally to
every disruptive event) exist as explicit baselines for the
policy-comparison campaign (``scenarios.engine.run_policy_matrix``):
the ``adaptive`` policy must beat their best aggregate recovered
throughput and never fall below 0.9x of the best fixed policy in any
scenario cell (the ``policy_adaptive_dominance`` perf gate).

Decision table of the adaptive policy (docs/policies.md has the prose):

==========================  ===========================================
trigger                     response
==========================  ===========================================
heavy degradation fault     ``shrink`` (a rail this slow is worth less
(``bw_degrade`` below       than nothing at ANY share: exclude it now
``shrink_bw_frac``, or      — unlike fixed shrink, the restore signal
``lat_inflate`` above       readmits it later)
``shrink_lat_mult``)
moderate degradation        ``demote`` the affected rail now (the
fault                       organic straggler EWMA needs
                            ``straggler_min_samples`` completions to
                            react; the fault listener fires instantly)
restore fault / recovery    ``readmit`` (bookkeeping: clear any forced
lifecycle                   demotion/exclusion; the scheduler's ramp
                            machinery re-admits gradually)
binary down fault           ``shift_fallback`` (SHIFT will mask it;
                            the interesting decision happens at the
                            fallback lifecycle event that follows)
fallback lifecycle,         ``checkpoint`` (§4.4: bound progress loss
calm (first flap in the     while running degraded; further fallbacks
window, no recent save)     inside ``min_ckpt_interval`` ride in place
                            — one save per burst, never a save storm)
fallback lifecycle,         ``shrink`` (a flapping rail is worse than
storm (``storm_flaps``+     a dead one: every flap re-breaks the QPs —
flaps in ``flap_window``)   excise it; the storm's own link_up signals
                            readmit it once the flapping stops)
``failed`` lifecycle        ``shrink`` (both rails dead for that QP:
(unmaskable)                exclude the channel, continue on the rest)
==========================  ===========================================
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

#: The per-fault response vocabulary (also the fixed-policy names).
RESPONSES = ("shift_fallback", "demote", "checkpoint", "shrink")

#: Fixed baseline policies — one per response, applied unconditionally.
FIXED_POLICIES = RESPONSES

#: Everything ``run_policy_matrix`` compares.
POLICIES = FIXED_POLICIES + ("adaptive",)

# fault-kind classes (magnitude suffixes like "bw_degrade:0.05" are
# stripped before classification)
_DOWN_KINDS = frozenset({"nic_down", "port_down", "link_down"})
_DEGRADE_KINDS = frozenset({"bw_degrade", "lat_inflate"})
_RESTORE_KINDS = frozenset({"nic_up", "port_up", "link_up",
                            "bw_restore", "lat_restore"})


@dataclass(frozen=True)
class PolicyConfig:
    """Knobs of the adaptive decision table.

    ``flap_window``      — lookback over ``ShiftQP.flap_times`` when
                           counting recent fallbacks (storm detection).
    ``storm_flaps``      — this many fallbacks inside the window makes
                           a storm: stop checkpointing per flap.
    ``min_ckpt_interval``— rate limit between post-fallback saves (the
                           "exactly one save per fallback burst"
                           contract: a flap train triggers ONE save).
    ``ckpt_bytes``       — size of the synthetic state the engine
                           checkpoints when it owns the store (campaign
                           runs without a trainer); the trainer saves
                           its real state instead.
    ``shrink_bw_frac``   — a ``bw_degrade`` at or below this fraction
                           is HEAVY: the rail is excluded outright
                           (shrink) instead of demoted to a floor share.
    ``shrink_lat_mult``  — a ``lat_inflate`` at or above this multiple
                           is HEAVY, same consequence.
    """

    flap_window: float = 30e-3
    storm_flaps: int = 3
    min_ckpt_interval: float = 25e-3
    ckpt_bytes: int = 1 << 14
    shrink_bw_frac: float = 0.25
    shrink_lat_mult: float = 4.0


@dataclass(frozen=True)
class PolicySignals:
    """Frozen snapshot of every input the decision saw.

    Recorded verbatim on each :class:`PolicyDecision` so the audit
    trail answers not just *what* the policy chose but *why* — and so
    the campaign determinism test can assert the signals themselves are
    reproducible."""

    now: float
    trigger: str                 # "fault:<kind>" | "shift:<event>"
    target: str                  # NIC gid or "ch<k>"
    rail: Optional[int]          # NIC/rail index the event resolved to
    recent_flaps: int            # fallbacks within flap_window, all QPs
    fallbacks: int               # cumulative SHIFT fallbacks, all libs
    lat_ewma: Optional[float]    # telemetry EWMAs for ``rail`` at
    busbw_ewma: Optional[float]  # decision time (None = no data yet)
    demoted: Tuple[bool, ...]    # scheduler demotion flags (per channel)
    excluded: Tuple[bool, ...]   # scheduler exclusion flags
    n_channels: int

    def as_tuple(self) -> Tuple:
        """Hashable, rounded form for fingerprints/audit trails."""
        return (round(self.now, 9), self.trigger, self.target, self.rail,
                self.recent_flaps, self.fallbacks,
                None if self.lat_ewma is None else round(self.lat_ewma, 9),
                None if self.busbw_ewma is None
                else round(self.busbw_ewma, 3),
                self.demoted, self.excluded, self.n_channels)


@dataclass(frozen=True)
class PolicyDecision:
    """One recorded decision: when, on what, what was chosen, and the
    full signal snapshot it was chosen from."""

    at: float
    trigger: str
    response: str   # one of RESPONSES, or "readmit" (bookkeeping)
    detail: str
    signals: PolicySignals

    def as_tuple(self) -> Tuple:
        """Hashable, rounded form for fingerprints/audit trails."""
        return (round(self.at, 9), self.trigger, self.response,
                self.detail, self.signals.as_tuple())


class FaultPolicyEngine:
    """Live per-fault response selection over an attached world.

    ``policy`` is one of :data:`POLICIES`: the four fixed baselines
    apply their namesake response to every disruptive event;
    ``adaptive`` follows the decision table in the module docstring.

    Usage::

        engine = FaultPolicyEngine("adaptive")
        engine.attach(cluster, libs, world=world, store=store)
        ...   # run traffic; decisions accumulate
        trail = engine.audit()

    Actuation paths:

    * demote/readmit — ``world.scheduler.force_demote`` / ``readmit``
      on the channels riding the affected rail;
    * shrink — ``world.scheduler.exclude`` (refused when it would leave
      no usable channel) and, when a trainer polls the engine,
      ``consume_trainer_actions()["shrink"]``;
    * checkpoint — when the engine owns a store, a deferred
      ``store.save(..., reason="post-fallback")`` scheduled as a
      zero-delay sim event (never from inside the WC callback that
      reported the fallback); when a trainer polls, the pending flag is
      handed over instead and the trainer saves its real state.

    Deterministic by construction: every input is virtual-clock-driven
    and every actuation lands on the virtual clock, so same-seed runs
    produce byte-identical decision logs.
    """

    def __init__(self, policy: str = "adaptive",
                 config: Optional[PolicyConfig] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r} "
                             f"(expected one of {POLICIES})")
        self.policy = policy
        self.cfg = config or PolicyConfig()
        self.decisions: List[PolicyDecision] = []
        self.cluster = None
        self.libs: Sequence = ()
        self.world = None
        self.store = None
        self.saves = 0               # post-fallback saves actuated
        self._ckpt_seq = 0
        self._last_ckpt_at: Optional[float] = None
        self._pending_ckpt = False   # handed to a polling trainer
        self._pending_shrink = False
        self._state = None           # synthetic ckpt payload (lazy)

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def attach(self, cluster, libs: Sequence, world=None,
               store=None) -> None:
        """Subscribe to ``cluster`` fault events and every lib's SHIFT
        lifecycle events; remember the world (scheduler actuation) and
        the store (checkpoint actuation)."""
        self.cluster = cluster
        self.libs = list(libs)
        self.world = world
        self.store = store
        if store is not None:
            # never overwrite a committed step: rewriting in place is
            # not crash-atomic (the marker predates the new payload)
            self._ckpt_seq = max(store.list_steps(), default=self._ckpt_seq)
        cluster.add_fault_listener(self._on_fault)
        for lib in self.libs:
            lib.attach_policy(self)
        sched = getattr(world, "scheduler", None)
        if sched is not None:
            # organic straggler demotions/readmissions land in the same
            # audit trail as policy-directed ones
            sched.policy_hook = self.on_scheduler_event

    # ------------------------------------------------------------------
    # signal collection
    # ------------------------------------------------------------------
    def _recent_flaps(self, now: float) -> int:
        """Fallback entries within ``flap_window`` across every QP of
        every attached lib (``ShiftQP.flap_times`` keeps the last 16)."""
        lo = now - self.cfg.flap_window
        return sum(1 for lib in self.libs for qp in lib.shift_qps
                   for t in qp.flap_times if t >= lo)

    def _signals(self, trigger: str, target: str,
                 rail: Optional[int]) -> PolicySignals:
        """Snapshot every decision input at the current virtual time."""
        now = self.cluster.sim.now
        tel = self.cluster.telemetry
        sched = getattr(self.world, "scheduler", None)
        demoted = tuple(sched.demoted) if sched is not None else ()
        excluded = (tuple(sched.excluded)
                    if sched is not None and hasattr(sched, "excluded")
                    else ())
        return PolicySignals(
            now=now, trigger=trigger, target=target, rail=rail,
            recent_flaps=self._recent_flaps(now),
            fallbacks=sum(lib.stats.fallbacks for lib in self.libs),
            lat_ewma=None if rail is None else tel.lat_ewma.get(rail),
            busbw_ewma=None if rail is None else tel.busbw_ewma.get(rail),
            demoted=demoted, excluded=excluded,
            n_channels=len(getattr(self.world, "channels", ()) or ()))

    def _record(self, sig: PolicySignals, response: str,
                detail: str) -> None:
        self.decisions.append(PolicyDecision(
            at=sig.now, trigger=sig.trigger, response=response,
            detail=detail, signals=sig))

    # ------------------------------------------------------------------
    # event entry points
    # ------------------------------------------------------------------
    def _on_fault(self, t: float, kind: str, gid: str) -> None:
        """Cluster fault listener: every applied fault action, including
        the degradations SHIFT itself never sees (no WC ever errors)."""
        parts = kind.split(":", 1)
        base = parts[0]
        try:
            magnitude = float(parts[1]) if len(parts) > 1 else None
        except ValueError:
            magnitude = None
        nic = self.cluster.nic_by_gid.get(gid)
        rail = nic.index if nic is not None else None
        sig = self._signals(f"fault:{base}", gid, rail)
        if base in _RESTORE_KINDS:
            self._decide_restore(sig, rail)
        elif base in _DEGRADE_KINDS:
            self._decide_degrade(sig, rail, base, magnitude)
        elif base in _DOWN_KINDS:
            self._decide_disruption(sig, rail)

    def on_lifecycle(self, lib, event: str, qp) -> None:
        """SHIFT lifecycle hook (wired via ``ShiftLib.attach_policy``):
        fallback / recovery / failed, with the QP that transitioned."""
        rail = qp.default.ctx.nic.index
        sig = self._signals(f"shift:{event}", qp.default.ctx.nic.gid, rail)
        if event == "fallback":
            self._decide_fallback(sig, rail)
        elif event == "recovery":
            self._decide_restore(sig, rail)
        elif event == "failed":
            self._decide_failed(sig, rail)

    def on_scheduler_event(self, action: str, channel: int) -> None:
        """Organic scheduler transitions (straggler demotion /
        readmission the scheduler performed on its own) — recorded for
        the audit trail, never re-actuated."""
        sig = self._signals(f"sched:{action}", f"ch{channel}", channel)
        self._record(sig, "demote" if action == "demote" else "readmit",
                     "scheduler-organic")

    # ------------------------------------------------------------------
    # decision core
    # ------------------------------------------------------------------
    def _decide_degrade(self, sig: PolicySignals, rail: Optional[int],
                        base: str, magnitude: Optional[float]) -> None:
        """A parametric degradation landed (no WC will ever error —
        SHIFT is blind to it; only this listener and telemetry see it)."""
        if self.policy != "adaptive":
            self._apply_fixed(sig, rail)
            return
        cfg = self.cfg
        heavy = ((base == "bw_degrade" and magnitude is not None
                  and magnitude <= cfg.shrink_bw_frac)
                 or (base == "lat_inflate" and magnitude is not None
                     and magnitude >= cfg.shrink_lat_mult))
        if heavy:
            # a rail this slow drags every chunk routed to it: worth
            # less than nothing at ANY share. Exclude it — the restore
            # signal will readmit it (fixed shrink never would).
            self._record(sig, "shrink",
                         f"heavy degradation ({sig.trigger.split(':')[1]}"
                         f" {magnitude}): exclude rail")
            self._act_shrink(rail)
        else:
            # beat the organic straggler EWMA to the punch: the fault
            # listener knows NOW what telemetry would need
            # straggler_min_samples completions to infer
            self._record(sig, "demote", "moderate degradation: cap rail")
            self._act_demote(rail)

    def _decide_disruption(self, sig: PolicySignals,
                           rail: Optional[int]) -> None:
        """A binary down fault was applied."""
        if self.policy == "adaptive":
            self._record(sig, "shift_fallback",
                         "binary fault: SHIFT masks in place")
            return
        self._apply_fixed(sig, rail)

    def _decide_fallback(self, sig: PolicySignals,
                         rail: Optional[int]) -> None:
        """A SHIFT QP entered Fallback (the §4.4 decision point)."""
        if self.policy == "adaptive":
            cfg = self.cfg
            if sig.recent_flaps >= cfg.storm_flaps:
                # a flapping rail is worse than a dead one: every flap
                # re-breaks its QPs mid-chunk. Excise it; the storm's
                # own link_up/port_up signals readmit it once it stops.
                self._record(sig, "shrink",
                             f"flap storm ({sig.recent_flaps} in "
                             f"window): exclude flapping rail")
                self._act_shrink(rail)
            elif (self._last_ckpt_at is not None
                    and sig.now - self._last_ckpt_at
                    < cfg.min_ckpt_interval):
                self._record(sig, "shift_fallback",
                             "ckpt rate-limited: save already on disk")
            else:
                self._record(sig, "checkpoint",
                             "post-fallback checkpoint (§4.4)")
                self._act_checkpoint(sig.now)
            return
        self._apply_fixed(sig, rail)

    def _decide_failed(self, sig: PolicySignals,
                       rail: Optional[int]) -> None:
        """A QP exhausted both rails (unmaskable for that path)."""
        if self.policy == "adaptive":
            self._record(sig, "shrink",
                         "both rails dead: continue on survivors")
            self._act_shrink(rail)
            return
        self._apply_fixed(sig, rail)

    def _decide_restore(self, sig: PolicySignals,
                        rail: Optional[int]) -> None:
        """A restore fault landed or a QP recovered to its default."""
        if self.policy == "adaptive":
            self._record(sig, "readmit", "restore: clear forced demotion")
            self._act_readmit(rail)
        # the fixed baselines are memoryless single-response policies:
        # nothing is ever undone (fixed demote keeps the rail capped
        # after it recovers, fixed shrink never re-grows the world) —
        # UNDOING on the restore signal is precisely what the adaptive
        # loop adds, and what the dominance gate measures

    def _apply_fixed(self, sig: PolicySignals,
                     rail: Optional[int]) -> None:
        """Fixed baselines: the namesake response, unconditionally."""
        p = self.policy
        if p == "shift_fallback":
            self._record(sig, p, "fixed: always mask in place")
        elif p == "demote":
            self._record(sig, p, "fixed: always demote the rail")
            self._act_demote(rail)
        elif p == "checkpoint":
            # deliberately NOT rate-limited: this baseline exists to
            # show the save-storm cost under flap trains
            self._record(sig, p, "fixed: always checkpoint")
            self._act_checkpoint(sig.now)
        elif p == "shrink":
            self._record(sig, p, "fixed: always shrink the world")
            self._act_shrink(rail)

    # ------------------------------------------------------------------
    # actuators
    # ------------------------------------------------------------------
    def _channels_on_rail(self, rail: Optional[int]) -> List[int]:
        if self.world is None or rail is None:
            return []
        return [c for c, ch in enumerate(self.world.channels)
                if ch.rail == rail]

    def _act_demote(self, rail: Optional[int]) -> None:
        sched = getattr(self.world, "scheduler", None)
        if sched is None:
            return
        for c in self._channels_on_rail(rail):
            sched.force_demote(c)

    def _act_readmit(self, rail: Optional[int]) -> None:
        sched = getattr(self.world, "scheduler", None)
        if sched is None:
            return
        for c in self._channels_on_rail(rail):
            sched.readmit(c)

    def _act_shrink(self, rail: Optional[int]) -> None:
        self._pending_shrink = True
        sched = getattr(self.world, "scheduler", None)
        if sched is None:
            return
        for c in self._channels_on_rail(rail):
            sched.exclude(c)   # refused if it would empty the world

    def _act_checkpoint(self, now: float) -> None:
        """Issue one post-fallback save.  With an owned store the write
        is deferred one zero-delay sim event (the lifecycle hook fires
        inside WC processing; the fabric broadcast the save issues must
        not re-enter that); with a polling trainer the pending flag is
        handed over instead and the trainer saves its real state."""
        self._last_ckpt_at = now
        self._pending_ckpt = True
        if self.store is None or self.cluster is None:
            return
        self._ckpt_seq += 1
        self.cluster.sim.at(now, self._do_save, self._ckpt_seq)

    def _do_save(self, seq: int) -> None:
        if self._state is None:
            self._state = {"policy_state": np.zeros(
                max(1, self.cfg.ckpt_bytes // 4), np.float32)}
        self.store.save(seq, self._state, {"reason": "post-fallback"})
        self.saves += 1

    # ------------------------------------------------------------------
    # consumers
    # ------------------------------------------------------------------
    def consume_trainer_actions(self) -> dict:
        """Poll-and-clear the trainer-directed actions accumulated since
        the last call: ``{"checkpoint": bool, "shrink": bool}``."""
        out = {"checkpoint": self._pending_ckpt,
               "shrink": self._pending_shrink}
        self._pending_ckpt = self._pending_shrink = False
        return out

    def audit(self) -> List[Tuple]:
        """The decision log as rounded, hashable tuples — what
        ``RunResult.decision_log`` carries into the fingerprint."""
        return [d.as_tuple() for d in self.decisions]
