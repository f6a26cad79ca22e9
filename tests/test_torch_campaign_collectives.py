"""The port's other fabric-only campaign workloads against the JAX
package's, on the CPU: one fault cell each of ``hierarchical_allreduce``
(a DCN uplink degraded on the two-pod fabric), ``broadcast``,
``all_to_all`` and ``mixed`` (bulk, latency-critical and background
classes at once, with a checkpoint store replicating over the fabric).
Both packages run the same scenario, seed and keywords through their own
``run_scenario``; the cells must give the same ``fingerprint()`` (the
virtual clock only) and the same invariant violations."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_campaign_common import same_cell  # noqa: E402


def test_hierarchical_allreduce_dcn_degrade_equals_reference():
    r, _ = same_cell("dcn_degrade", "hierarchical_allreduce")
    assert r.ok and r.completed and r.payload_mismatches == 0


def test_broadcast_striped_rail_kill_equals_reference():
    r, _ = same_cell("rail_kill_striped", "broadcast")
    assert r.ok and r.completed and r.fallbacks >= 1


def test_all_to_all_sender_nic_down_equals_reference():
    r, _ = same_cell("sender_nic_down", "all_to_all")
    assert r.ok and r.completed and r.fallbacks >= 1


def test_mixed_striped_rail_kill_equals_reference():
    r, _ = same_cell("rail_kill_striped", "mixed")
    assert r.ok and r.completed and r.fallbacks >= 1
    assert set(r.class_latency) == {"latency_critical", "bulk",
                                    "background"}
