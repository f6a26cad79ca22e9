"""Post-run invariant checks for campaign results.

The four headline invariants (checked after EVERY run):

1. **Exactly-once delivery** — every notification is delivered once:
   no duplicates in the pingpong delivery trace, no duplicate notifies in
   a JcclWorld, and every all-reduce round's numeric result equals the
   true sum (a payload-level exactly-once proof: a lost or doubled
   contribution changes the sum).
2. **Zero-copy** — SHIFT never buffers payload bytes
   (``ShiftStats.payload_bytes_held == 0``; WQE-copy resubmission reads
   payloads from the registered MRs at retransmit time).
3. **Notification-order preservation** — the delivery trace is the posted
   order (strictly increasing seqs) across any number of failovers.
4. **Bounded fallback latency** — every observed first-failed-WC to
   first-success interval is within the scenario's ``latency_bound``.

Channelized (multi-rail) runs add per-channel checks: every channel's
notify counters must be clean, chunk accounting must balance (every
chunk the scheduler assigned was delivered), scenarios that fault a
rail under striped traffic assert the scheduler actually resteered
chunks off it (``Scenario.min_resteers``), and proportional-share
scenarios bound each channel's final share of assigned chunks
(``Scenario.share_bounds``) — a degraded/straggler rail must be neither
fully loaded nor fully dark. ``Scenario.max_fallbacks`` caps health
transitions: degradation faults must be absorbed by the scheduler
alone.

Concurrent-collective runs add two checks: a workload that declares an
overlap floor (``RunResult.min_concurrency``) must have actually run
that many collectives simultaneously (``peak_concurrency`` — the
overlap claim is vacuous otherwise), and after a completed run no
in-flight tag entries may remain in ``JcclWorld._tags``
(``leaked_tags`` — cross-collective tag hygiene). Runs that drive every
latency class (``RunResult.class_latency``, the mixed workload) must
complete work in EVERY class — classful dispatch may reorder, never
starve (DESIGN.md §10).

Scenario expectations (masked vs. propagated, minimum fallback count,
recovery) are checked alongside: a fault-tolerance claim is vacuous if
the fault never actually bit.
"""

from __future__ import annotations

from typing import List

from .engine import RunResult
from .spec import Scenario


def check_invariants(result: RunResult, scenario: Scenario) -> List[str]:
    """Every invariant ``result`` breaks under ``scenario``'s
    expectations, one message each (empty when the run is clean)."""
    v: List[str] = []

    # -- zero-copy ----------------------------------------------------------
    if result.payload_bytes_held:
        v.append(f"zero-copy violated: SHIFT held "
                 f"{result.payload_bytes_held} payload bytes")

    # -- exactly-once + ordering (pingpong delivery trace) -------------------
    if result.delivered is not None:
        seen = set()
        dups = [s for s in result.delivered
                if s in seen or seen.add(s)]
        if dups:
            v.append(f"exactly-once violated: duplicate deliveries {dups[:8]}")
        if result.delivered != sorted(set(result.delivered)):
            v.append("notification order violated in delivery trace")
        if (scenario.expect_masked and result.n_expected is not None
                and result.delivered != list(range(result.n_expected))):
            v.append(f"incomplete delivery: {len(result.delivered)}/"
                     f"{result.n_expected} messages")
    if result.payload_mismatches:
        v.append(f"payload corruption: {result.payload_mismatches} "
                 f"mismatched messages/rounds")

    # -- concurrent-collective accounting ------------------------------------
    # A workload that CLAIMS overlap must actually overlap: a completed
    # run whose peak live-collective count is below the declared floor
    # would make the concurrency claim vacuous.
    if (result.min_concurrency and result.completed and not result.aborted
            and result.peak_concurrency < result.min_concurrency):
        v.append(f"overlap never happened: peak {result.peak_concurrency} "
                 f"concurrent collectives < required "
                 f"{result.min_concurrency}")
    # Tag hygiene: after a completed (non-aborted) run every in-flight
    # chunk tag must have been consumed or reclaimed — a leftover entry
    # is a cross-collective leak in JcclWorld._tags.
    if result.leaked_tags and result.completed and not result.aborted:
        v.append(f"tag leak: {result.leaked_tags} in-flight tag entries "
                 f"left in JcclWorld._tags after completion")
    # Latency-class starvation: a workload that drives every priority
    # class (the mixed workload harvests RunResult.class_latency) must
    # see every class actually complete work — latency-critical
    # preference that starves bulk or background would otherwise pass
    # unnoticed as long as the favored class stayed fast.
    if (result.class_latency is not None and result.completed
            and not result.aborted):
        starved = sorted(k for k, s in result.class_latency.items()
                         if not s.get("count"))
        if starved:
            v.append(f"class starvation: {starved} completed zero works "
                     f"under mixed-class load")

    # -- world-level notify counters ----------------------------------------
    if result.duplicate_notifies:
        v.append(f"exactly-once violated: {result.duplicate_notifies} "
                 f"duplicate notifies")
    if result.order_violations:
        v.append(f"notification order violated: {result.order_violations} "
                 f"out-of-order notifies")

    # -- per-channel accounting (multi-rail runs only) -----------------------
    if result.channel_stats:
        for c in result.channel_stats:
            if c["order_violations"] or c["duplicate_notifies"]:
                v.append(f"channel {c['channel']} notify invariants "
                         f"violated: {c['order_violations']} ooo / "
                         f"{c['duplicate_notifies']} dup")
        if scenario.expect_masked and not result.aborted:
            assigned = sum(c["chunks_assigned"] for c in result.channel_stats)
            delivered = sum(c["chunks_delivered"]
                            for c in result.channel_stats)
            if assigned != delivered:
                v.append(f"channel accounting broken: {assigned} chunks "
                         f"assigned vs {delivered} delivered")
        if (scenario.min_resteers
                and result.resteered_chunks < scenario.min_resteers):
            v.append(f"scheduler never resteered off the faulted rail: "
                     f"{result.resteered_chunks} resteers < expected "
                     f"{scenario.min_resteers}")
        # proportional-share bounds (the adaptive scheduler's contract:
        # a degraded/straggler rail keeps a bounded, non-zero share
        # instead of being fully loaded or fully dark)
        if scenario.share_bounds:
            total = sum(c["chunks_assigned"] for c in result.channel_stats)
            for ch, (lo, hi) in scenario.share_bounds.items():
                if ch >= len(result.channel_stats):
                    # the run used fewer channels than the scenario's
                    # widest configuration (e.g. a 2-rail workload of a
                    # 4-rail scenario): the bound is vacuous, like a
                    # rail selector that matches nothing
                    continue
                share = (result.channel_stats[ch]["chunks_assigned"]
                         / max(total, 1))
                if not lo <= share <= hi:
                    v.append(f"channel {ch} share {share:.3f} outside "
                             f"proportional bounds [{lo}, {hi}]")

    # -- bounded fallback latency -------------------------------------------
    late = [l for l in result.fallback_latencies
            if l > scenario.latency_bound]
    if late:
        v.append(f"fallback latency unbounded: max {max(late) * 1e3:.2f}ms "
                 f"> {scenario.latency_bound * 1e3:.2f}ms")

    # -- serving request-level invariants ------------------------------------
    # A maskable fault must degrade throughput, never correctness: no
    # request dropped, and every completed request's token stream
    # byte-identical to the single-host reference (wrong, duplicated or
    # truncated tokens all count as mismatches).
    if result.requests_total:
        if scenario.expect_masked and result.requests_failed:
            v.append(f"requests dropped: {result.requests_failed}/"
                     f"{result.requests_total} failed under a maskable "
                     f"fault")
        if result.token_mismatches:
            v.append(f"token corruption: {result.token_mismatches} "
                     f"requests diverged from the single-host reference")

    # -- scenario expectations ----------------------------------------------
    if scenario.expect_masked:
        if result.aborted:
            v.append("maskable failure aborted the workload")
        if result.app_errors:
            v.append(f"maskable failure surfaced {result.app_errors} "
                     f"error WCs to the application")
        if not result.completed:
            v.append("workload did not complete inside the scenario window")
        # an empty fault log means every action resolved to nothing on
        # this topology (e.g. the dcn_* scenarios on a single-pod
        # cluster, whose DCN selectors are documented no-ops): there was
        # no fault to bite, so the expectation is waived, not violated
        if result.fallbacks < scenario.min_fallbacks and result.fault_log:
            v.append(f"fault did not bite: {result.fallbacks} fallbacks "
                     f"< expected {scenario.min_fallbacks}")
        if (scenario.max_fallbacks is not None
                and result.fallbacks > scenario.max_fallbacks):
            v.append(f"degradation caused a health transition: "
                     f"{result.fallbacks} fallbacks > allowed "
                     f"{scenario.max_fallbacks}")
        # recovery needs probe cycles the short ddp/serving windows
        # don't have (their timelines are rebased onto measured step
        # time; the authored 30ms recovery gaps fall past the traffic)
        if (scenario.expect_recovery
                and result.workload not in ("ddp", "ddp_bucketed",
                                            "ddp_hooked", "serving")
                and result.recoveries < 1):
            v.append("traffic never returned to the default NIC")
    else:
        if not (result.errors_propagated or result.aborted
                or result.app_errors):
            v.append("unmaskable failure was silently swallowed")

    return v
