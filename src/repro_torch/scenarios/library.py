"""The named fault-scenario library (>= 10 scenarios).

All scenarios assume the standard rail-optimized testbed
(``build_cluster(n_hosts>=2, nics_per_host=2)``): NIC ``mlx5_0`` of every
host on rail 0 (the default data rail), ``mlx5_1`` on rail 1 (SHIFT's
backup). Multi-rail scenarios request wider hosts via
``workload_hints`` (e.g. ``{"allreduce": {"channels": 4,
"nics_per_host": 4}}``); rail selectors that match nothing on a
narrower workload are no-ops, so every scenario stays runnable under
every workload. The ``dcn_*`` scenarios target the multi-pod
heterogeneous fabric (``hierarchical_allreduce`` workload; hosts gain
``dcn0``/``dcn1`` uplinks and the ``dcn`` selector) — on single-pod
clusters their targets resolve to nothing, keeping them no-op under
the flat workloads. Times are virtual seconds after workload start; the
pingpong workload paces one message per 200us, so the 2ms-40ms window
is dense mid-stream traffic.

Naming convention: what fails, then how. ``expect_masked=False`` marks
the boundary of fault tolerance — scenarios SHIFT must *propagate*, not
mask (the Trilemma: no healthy path left). Degradation scenarios
(``max_fallbacks=0``) mark the opposite boundary: faults the adaptive
scheduler must absorb with NO health transition at all (see
docs/scheduler.md and docs/scenarios.md).
"""

from __future__ import annotations

from typing import Dict, List

from .spec import FaultAction, Scenario, correlated, flap_train

A = FaultAction


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        name="baseline_clean",
        description="Control: no faults; zero fallbacks expected.",
        actions=(),
        tags=("control",),
    ),
    Scenario(
        name="sender_nic_down",
        description="Initiator default NIC fails mid-stream, recovers.",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),
                 A(30e-3, "nic_up", "host0/mlx5_0")),
        min_fallbacks=1, expect_recovery=True,
        tags=("nic", "single"),
    ),
    Scenario(
        name="receiver_nic_down",
        description="Responder default NIC fails mid-stream, recovers.",
        actions=(A(2e-3, "nic_down", "host1/mlx5_0"),
                 A(30e-3, "nic_up", "host1/mlx5_0")),
        min_fallbacks=1, expect_recovery=True,
        tags=("nic", "single"),
    ),
    Scenario(
        name="switch_port_down",
        description="ToR port of the initiator's rail goes down, recovers.",
        actions=(A(2e-3, "port_down", "host0/mlx5_0"),
                 A(30e-3, "port_up", "host0/mlx5_0")),
        min_fallbacks=1, expect_recovery=True,
        tags=("switch", "single"),
    ),
    Scenario(
        name="cable_pull",
        description="Initiator's rail-0 cable pulled, re-seated later.",
        actions=(A(2e-3, "link_down", "host0/mlx5_0"),
                 A(40e-3, "link_up", "host0/mlx5_0")),
        min_fallbacks=1, expect_recovery=True,
        tags=("link", "single"),
    ),
    Scenario(
        name="nic_down_permanent",
        description="Fatal NIC loss, never recovers: traffic must finish "
                    "on the backup rail (the paper's headline case).",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),),
        min_fallbacks=1, expect_recovery=False,
        tags=("nic", "permanent"),
    ),
    Scenario(
        name="link_flap_train",
        description="4 link flaps (6ms down / 9ms period) on the sender "
                    "rail: each outage exceeds the RC retry budget "
                    "(retry_cnt x ack_timeout ~ 3.2ms), so every flap "
                    "forces an error WC and a fallback regardless of "
                    "traffic pacing; probes keep failing until the train "
                    "ends.",
        actions=flap_train("host0/mlx5_0", start=2e-3, count=4,
                           down_time=6e-3, period=9e-3, kind="link"),
        min_fallbacks=1, expect_recovery=True,
        tags=("link", "flap"),
    ),
    Scenario(
        name="port_flap_train",
        description="3 switch-port flaps on the receiver rail, each "
                    "outage longer than the RC retry budget (the "
                    "transport alone cannot ride it out).",
        actions=flap_train("host1/mlx5_0", start=2e-3, count=3,
                           down_time=6e-3, period=9e-3, kind="port"),
        min_fallbacks=1, expect_recovery=True,
        tags=("switch", "flap"),
    ),
    Scenario(
        name="correlated_rail_failure",
        description="Rail-0 switch power loss: NIC 0 of EVERY host goes "
                    "down at the same instant, recovers together.",
        actions=correlated(["rail:0"], at=2e-3, kind="nic_down")
        + correlated(["rail:0"], at=40e-3, kind="nic_up"),
        min_fallbacks=2, expect_recovery=True,
        tags=("rail", "correlated"),
    ),
    Scenario(
        name="simultaneous_bidirectional",
        description="Both peers' default NICs die at the same virtual "
                    "instant: the crossing-NOTIFY handshake case (each "
                    "side's NOTIFY doubles as the other's ACK).",
        actions=correlated(["host0/mlx5_0", "host1/mlx5_0"], at=2e-3)
        + correlated(["host0/mlx5_0", "host1/mlx5_0"], at=40e-3,
                     kind="nic_up"),
        min_fallbacks=2, expect_recovery=True,
        tags=("nic", "correlated", "handshake"),
    ),
    Scenario(
        name="failure_during_recovery",
        description="Default NIC recovers just long enough for the probe "
                    "to succeed, then dies again: exercises recovery "
                    "abort (withheld WRs move back to the backup QP).",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),
                 A(8e-3, "nic_up", "host0/mlx5_0"),
                 A(16e-3, "nic_down", "host0/mlx5_0"),
                 A(40e-3, "nic_up", "host0/mlx5_0")),
        min_fallbacks=1, expect_recovery=True,
        tags=("nic", "compound"),
    ),
    Scenario(
        name="repeated_fallback_cycles",
        description="Two well-separated full fail/recover cycles: state "
                    "machine must complete Default->Fallback->Default "
                    "twice (per-cycle PSN bases reject ghosts).",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),
                 A(20e-3, "nic_up", "host0/mlx5_0"),
                 A(35e-3, "nic_down", "host0/mlx5_0"),
                 A(50e-3, "nic_up", "host0/mlx5_0")),
        duration=0.3,
        min_fallbacks=3, expect_recovery=True,
        tags=("nic", "compound"),
        workload_hints={"pingpong": {"n_msgs": 240}},
    ),
    Scenario(
        name="backup_rail_blip",
        description="The UNUSED backup NIC blips while traffic rides the "
                    "default rail: the application must see nothing.",
        actions=(A(2e-3, "nic_down", "host0/mlx5_1"),
                 A(10e-3, "nic_up", "host0/mlx5_1")),
        min_fallbacks=0, expect_recovery=False,
        tags=("nic", "control"),
    ),
    Scenario(
        name="rail_kill_striped",
        description="Rail-0 NIC of host0 dies permanently under "
                    "channelized (2-rail striped) traffic: SHIFT masks "
                    "the loss per-QP while the channel scheduler "
                    "resteers chunks onto the healthy rail — per-channel "
                    "stats must show the surviving channel carried them.",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),),
        min_fallbacks=1, expect_recovery=False, min_resteers=1,
        tags=("rail", "multirail", "permanent"),
        workload_hints={"allreduce": {"channels": 2},
                        "broadcast": {"channels": 2},
                        "serving": {"channels": 2}},
    ),
    Scenario(
        name="staggered_dual_rail_faults",
        description="Rail 0 fails and recovers, then rail 1 fails and "
                    "recovers — never overlapping, so every fault is "
                    "maskable; a channelized world must resteer each "
                    "channel in turn and re-balance after recovery.",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),
                 A(20e-3, "nic_up", "host0/mlx5_0"),
                 A(35e-3, "nic_down", "host0/mlx5_1"),
                 A(50e-3, "nic_up", "host0/mlx5_1")),
        duration=0.3,
        min_fallbacks=1, expect_recovery=True, min_resteers=1,
        tags=("rail", "multirail", "compound"),
        workload_hints={"pingpong": {"n_msgs": 240},
                        "allreduce": {"channels": 2}},
    ),
    Scenario(
        name="rail_recovery_rebalance",
        description="Rail 0 goes down mid-striped traffic and comes "
                    "back: SHIFT recovers the channel's QPs onto the "
                    "default rail and the scheduler re-balances chunks "
                    "across both rails (recovery + resteer counters).",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),
                 A(25e-3, "nic_up", "host0/mlx5_0")),
        min_fallbacks=1, expect_recovery=True, min_resteers=1,
        tags=("rail", "multirail"),
        workload_hints={"allreduce": {"channels": 2}},
    ),
    Scenario(
        name="quad_rail_staggered_kill",
        description="4-rail striped traffic; rails 0 and 2 die 18ms "
                    "apart (their SHIFT backups land on the surviving "
                    "rails 1/3). Each loss is masked per-QP while the "
                    "adaptive scheduler re-weights: the dead channels' "
                    "cumulative share must collapse to a bounded "
                    "minority while the survivors carry the bulk — the "
                    "2/4-proportional-degradation contract.",
        actions=(A(2e-3, "nic_down", "rail:0"),
                 A(20e-3, "nic_down", "rail:2")),
        min_fallbacks=2, expect_recovery=False, min_resteers=1,
        share_bounds={0: (0.005, 0.20), 2: (0.005, 0.30),
                      1: (0.25, 0.60), 3: (0.25, 0.60)},
        tags=("rail", "multirail", "quad", "permanent"),
        workload_hints={"allreduce": {"channels": 4, "nics_per_host": 4,
                                      "elems": 1 << 15}},
    ),
    Scenario(
        name="slow_rail_straggler",
        description="Rail 0's links get 25x propagation latency — "
                    "alive, error-free, just slow (a congested or "
                    "misrouted path). The scheduler's latency-EWMA "
                    "straggler demotion must cut the rail's share to "
                    "the configured floor with ZERO health transitions "
                    "(no fallback, no probe, no error WC).",
        actions=(A(2e-3, "lat_inflate", "rail:0", 25.0),),
        min_fallbacks=0, max_fallbacks=0, expect_recovery=False,
        min_resteers=1,
        share_bounds={0: (0.01, 0.30), 1: (0.70, 0.99)},
        tags=("rail", "multirail", "degradation", "straggler"),
        workload_hints={"allreduce": {"channels": 2}},
    ),
    Scenario(
        name="degraded_rail_proportional_share",
        description="Rail 0's links drop to 1/20 bandwidth with NO "
                    "errors: only measured busbw reveals it. The "
                    "scheduler must give the degraded-but-alive rail a "
                    "proportional minority share — neither fully "
                    "loaded nor fully dark — again with zero health "
                    "transitions.",
        actions=(A(2e-3, "bw_degrade", "rail:0", 0.05),),
        min_fallbacks=0, max_fallbacks=0, expect_recovery=False,
        min_resteers=1,
        share_bounds={0: (0.02, 0.45), 1: (0.55, 0.98)},
        tags=("rail", "multirail", "degradation"),
        workload_hints={"allreduce": {"channels": 2}},
    ),
    Scenario(
        name="dcn_degrade",
        description="Every DCN uplink drops to 1/4 bandwidth with NO "
                    "errors (cross-pod congestion), then restores: the "
                    "tier-aware scheduler must absorb it — cross-pod "
                    "chunks keep flowing at the thinner share with "
                    "smaller adapted chunks, and NO health transition "
                    "fires (the hierarchical allreduce stays "
                    "byte-identical across ranks throughout).",
        actions=(A(2e-3, "bw_degrade", "dcn", 0.25),
                 A(30e-3, "bw_restore", "dcn")),
        min_fallbacks=0, max_fallbacks=0, expect_recovery=False,
        tags=("dcn", "multipod", "degradation"),
        workload_hints={"hierarchical_allreduce": {}},
    ),
    Scenario(
        name="dcn_partition_transient",
        description="Cross-pod boundary events: first a 2ms DCN link "
                    "blip (shorter than the RC retry budget of "
                    "retry_cnt x ack_timeout ~ 3.2ms) that the "
                    "transport must ride out by retransmission alone — "
                    "segments in flight are dropped on the wire and "
                    "recovered with no fallback; then host0's dcn0 NIC "
                    "dies for good and SHIFT must fail the cross-pod "
                    "QPs over to the paired dcn1 uplink (tier-pinned "
                    "backup placement), masking the loss. Exactly-once "
                    "and cross-rank byte identity must hold through "
                    "both.",
        actions=(A(2e-3, "link_down", "host0/dcn0"),
                 A(4e-3, "link_up", "host0/dcn0"),
                 A(20e-3, "nic_down", "host0/dcn0")),
        min_fallbacks=1, expect_recovery=False,
        tags=("dcn", "multipod", "compound"),
        workload_hints={"hierarchical_allreduce": {}},
    ),
    Scenario(
        name="double_rail_outage",
        description="Default dies, then the backup dies during fallback: "
                    "no healthy path remains, so the error MUST be "
                    "propagated to the application (Trilemma boundary).",
        actions=(A(2e-3, "nic_down", "host0/mlx5_0"),
                 A(6e-3, "nic_down", "host0/mlx5_1")),
        expect_masked=False, min_fallbacks=1,
        tags=("nic", "unmaskable"),
    ),
]}

# Fuzz-promoted regression scenarios land here: when the randomized
# fault-schedule fuzzer (tests/test_fault_fuzz.py) finds an
# invariant-violating schedule, its seed replays deterministically and
# the schedule is added above as a named Scenario (tag it "fuzz").
# As of the policy-engine PR a 60-example-per-workload heavy pass
# (benchmarks/run.py --fuzz-heavy 60) surfaced no violations — there
# is nothing to promote yet.


def get(name: str) -> Scenario:
    """The named scenario (``KeyError`` for an unknown name)."""
    return SCENARIOS[name]


def names(*tags: str) -> List[str]:
    """Scenario names, optionally filtered to those carrying all tags."""
    return [n for n, s in SCENARIOS.items()
            if all(t in s.tags for t in tags)]
