"""Deterministic fault-scenario campaign engine (see DESIGN.md §3), the
port's own copy.

Turns the repo's headline claim — SHIFT masks fatal NIC/link failures so
training continues — into a repeatable test artifact: a declarative
scenario DSL (``spec``), a named >=10-scenario library (``library``), a
campaign runner executing scenario x workload matrices (``engine``), and
post-run invariant checks (``invariants``).

Quick start::

    from repro_torch.scenarios import SCENARIOS, Campaign
    results = Campaign([SCENARIOS["sender_nic_down"]],
                       workloads=("pingpong", "allreduce")).run()
    assert all(r.ok for r in results)
"""

from .spec import FaultAction, Scenario, correlated, flap_train  # noqa: F401
from .library import SCENARIOS, get, names  # noqa: F401
from .engine import (Campaign, POLICY_SCENARIOS, RunResult,  # noqa: F401
                     WORKLOADS, make_pair, policy_dominance,
                     run_policy_matrix, run_scenario)
from .invariants import check_invariants  # noqa: F401
