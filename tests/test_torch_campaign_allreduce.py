"""The port's all-reduce campaign workloads against the JAX package's,
on the CPU: one fault cell each of ``allreduce`` (striped over the two
channels its scenario's hints give) and ``overlap_allreduce`` (parts of
every round in flight at once). Both packages run the same scenario,
seed and keywords through their own ``run_scenario``; the cells must
give the same ``fingerprint()`` (the virtual clock only) and the same
invariant violations. The fabric is numpy on the host in both, so no
device takes part."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_campaign_common import same_cell  # noqa: E402


def test_allreduce_striped_rail_kill_equals_reference():
    r, _ = same_cell("rail_kill_striped", "allreduce")
    assert r.ok and r.completed and r.fallbacks >= 1
    assert len(r.channel_stats) == 2 and r.resteered_chunks > 0


def test_overlap_allreduce_sender_nic_down_equals_reference():
    r, _ = same_cell("sender_nic_down", "overlap_allreduce")
    assert r.ok and r.completed and r.fallbacks >= 1
    assert r.peak_concurrency >= 2 and r.leaked_tags == 0
