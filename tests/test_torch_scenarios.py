"""The port's campaign engine (``repro_torch.scenarios``) against the JAX
package's, on the CPU.

A campaign cell is one scenario run under one workload; its
``RunResult.fingerprint()`` digests the virtual clock only (events,
faults, SHIFT's lifecycle, fallback latencies, rounds, the policy's
decisions). Each cell here runs through both packages' ``run_scenario``
on the same scenario, workload, seed and keywords, and must give the
same fingerprint and the same invariant violations. Every scenario of
the library runs on ``pingpong``; the DDP workloads run the port's smoke
trainer on the CPU (``device="cpu"``). The port's trainer draws other
initial params than the reference's for one seed (ROADMAP C9), which
moves the losses but not the fingerprint. The library itself is held
equal field by field. The fabric-only round workloads and the policy
matrix are in ``test_torch_campaign_*.py`` and ``test_torch_policy.py``.
"""

import dataclasses
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as J  # noqa: E402
from repro.scenarios import engine as j_engine  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.scenarios import engine as t_engine  # noqa: E402

from test_torch_campaign_common import same_cell  # noqa: E402

NAMES = sorted(J.SCENARIOS)


# ---------------------------------------------------------------------------
# the library, field by field
# ---------------------------------------------------------------------------


def test_library_names_the_same_scenarios_in_the_same_order():
    assert list(T.SCENARIOS) == list(J.SCENARIOS)
    assert len(T.SCENARIOS) == 22
    assert T.POLICY_SCENARIOS == J.POLICY_SCENARIOS


@pytest.mark.parametrize("name", NAMES)
def test_scenario_equals_reference_field_by_field(name):
    port, ref = T.SCENARIOS[name], J.SCENARIOS[name]
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.actions == tuple(
        T.FaultAction(a.at, a.kind, a.target, a.arg) for a in ref.actions)


def test_tag_selection_equals_reference():
    tags = sorted({t for sc in J.SCENARIOS.values() for t in sc.tags})
    assert tags
    for tag in tags:
        assert T.names(tag) == J.names(tag)


def test_rebase_fault_times_equals_reference():
    for name in NAMES:
        for scale in (0.05, 0.5, 1.0):
            assert t_engine.rebase_fault_times(
                T.SCENARIOS[name].actions, scale) == \
                j_engine.rebase_fault_times(J.SCENARIOS[name].actions, scale)
    assert t_engine.rebase_fault_times((), 0.5) == []


def test_spec_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        T.FaultAction(1e-3, "nuke_datacenter", "host0/mlx5_0")
    with pytest.raises(ValueError):
        T.FaultAction(-1.0, "nic_down", "host0/mlx5_0")
    assert T.flap_train("rail:0", 1e-3, 2, 1e-3, 3e-3) == tuple(
        T.FaultAction(a.at, a.kind, a.target, a.arg)
        for a in J.flap_train("rail:0", 1e-3, 2, 1e-3, 3e-3))
    assert T.correlated(["rail:0", "host1/mlx5_1"], 2e-3) == tuple(
        T.FaultAction(a.at, a.kind, a.target, a.arg)
        for a in J.correlated(["rail:0", "host1/mlx5_1"], 2e-3))


def test_campaign_refuses_an_unknown_workload():
    with pytest.raises(ValueError, match="unknown workloads"):
        T.Campaign([T.SCENARIOS["baseline_clean"]], workloads=("tpu_pod",))
    assert set(T.WORKLOADS) == set(J.WORKLOADS)


def test_serving_workload_names_what_is_missing():
    """The serving workload runs: the smoke MoE model over a 2-rank world
    on the CPU serves every request of a clean cell, token for token as
    its single-host run (``test_torch_campaign_serving.py`` holds the
    cells to the reference's)."""
    assert "serving" in T.WORKLOADS
    r = T.run_scenario(T.SCENARIOS["baseline_clean"], workload="serving",
                       device="cpu")
    assert r.ok and r.completed and not r.violations
    assert r.requests_done == r.requests_total >= 4
    assert r.token_mismatches == r.payload_mismatches == 0


def test_campaign_report_equals_reference():
    scs = ("baseline_clean", "sender_nic_down")
    port = T.Campaign([T.SCENARIOS[n] for n in scs]).run()
    ref = J.Campaign([J.SCENARIOS[n] for n in scs]).run()
    assert T.Campaign.report(port) == J.Campaign.report(ref)


# ---------------------------------------------------------------------------
# every scenario on pingpong
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_pingpong_cell_equals_reference(name):
    port, ref = same_cell(name, "pingpong")
    assert port.delivered == ref.delivered
    assert port.payload_mismatches == ref.payload_mismatches


# ---------------------------------------------------------------------------
# the DDP workloads, the port's trainer on the CPU
# ---------------------------------------------------------------------------


def test_ddp_policy_cell_equals_reference():
    port, ref = same_cell("sender_nic_down", "ddp",
                          port_kw={"device": "cpu"}, policy="adaptive")
    assert port.ok and port.completed and port.fallbacks >= 1
    assert port.policy == "adaptive"
    assert port.decision_log == ref.decision_log
    assert any(d[2] == "checkpoint" for d in port.decision_log)


def test_ddp_bucketed_cell_equals_reference():
    port, _ = same_cell("link_flap_train", "ddp_bucketed",
                        port_kw={"device": "cpu"})
    assert port.ok and port.completed and port.fallbacks >= 1
    assert port.peak_concurrency >= 4


def test_ddp_hooked_fault_cell_equals_reference():
    """``BENCH_core.json``'s ``ddp_hook_overlap.fault_cell``: a striped
    rail kill mid-backward, 2 steps; the hooked losses must equal the
    clean post-backward reference's bit for bit (payload mismatches 0)."""
    port, ref = same_cell("rail_kill_striped", "ddp_hooked",
                          port_kw={"device": "cpu"}, steps=2)
    assert port.decision_log == ref.decision_log
    assert port.completed and port.ok
    assert port.fallbacks == 2
    assert port.payload_mismatches == 0
    assert round(port.overlap_fraction, 6) == 0.880795


def test_hooked_reference_is_kept_per_device(monkeypatch):
    """A trajectory computed on one device never serves as another's
    reference: the cache key holds the device."""
    monkeypatch.setattr(t_engine, "_HOOKED_REFERENCE", {})
    ref = t_engine._hooked_reference(0, 1, 2, 1 << 16, "cpu")
    assert len(ref) == 1
    (key,) = t_engine._HOOKED_REFERENCE
    assert "cpu" in key
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_engine._hooked_reference(0, 1, 2, 1 << 16, "cuda")


def test_ddp_workloads_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for workload in ("ddp", "ddp_bucketed", "ddp_hooked"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_scenario(T.SCENARIOS["baseline_clean"], workload=workload,
                           steps=1)
