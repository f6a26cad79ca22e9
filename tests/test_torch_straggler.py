"""The port's straggler monitor (``repro_torch.train.straggler``) against
the JAX package's, on the CPU: the three scripted cases of
``tests/test_straggler.py``, each run through both packages over their
own fabrics, with the same outcomes (what was delivered, fallbacks,
recoveries, the migrations and the ranks acted on)."""

import pytest

torch = pytest.importorskip("torch")

from repro.train import straggler as JS  # noqa: E402
from repro_torch.train import straggler as TS  # noqa: E402

from test_torch_campaign_common import (PACKAGES, shift_pair,  # noqa: E402
                                        simple_step)

STRAGGLER = {"ref": JS, "port": TS}


def forced_fallback(pkg: str) -> dict:
    """Traffic moves to the backup NIC with no failure, keeps its order,
    and returns to the default once probing succeeds."""
    S, V = PACKAGES[pkg][1], PACKAGES[pkg][2]
    c, a, b = shift_pair(pkg, probe_interval=2e-3)
    recv_wcs = []
    n_msgs = 60
    next_seq = [0]

    def pump():
        if next_seq[0] < n_msgs:
            simple_step(V, a, b, next_seq[0], 4096)
            next_seq[0] += 1
            c.sim.schedule(300e-6, pump)
        recv_wcs.extend(b.poll())
        a.poll()

    pump()
    c.sim.run(until=c.sim.now + 3e-3)
    forced = a.qp.force_fallback()
    c.sim.run(until=c.sim.now + 1.0)
    recv_wcs.extend(b.poll())
    a.poll()
    return {"forced": forced,
            "imms": [w.imm_data for w in recv_wcs
                     if w.opcode is V.WCOpcode.RECV_RDMA_WITH_IMM
                     and not w.is_error],
            "fallbacks": a.lib.stats.fallbacks,
            "recoveries": a.lib.stats.recoveries,
            "default": a.qp.send_state is S.SendState.DEFAULT,
            "now": c.sim.now}


def monitored(pkg: str, cfg: dict, times: dict, steps: int) -> dict:
    """``steps`` observations of per-rank comm ``times`` by ``pkg``'s
    StragglerMonitor over a fresh SHIFT pair."""
    mod = STRAGGLER[pkg]
    c, a, b = shift_pair(pkg)
    mon = mod.StragglerMonitor([a.lib, b.lib], mod.StragglerConfig(**cfg))
    acted = [mon.observe(times) for _ in range(steps)]
    return {"acted": acted, "migrations": mon.migrations,
            "fallbacks": [a.lib.stats.fallbacks, b.lib.stats.fallbacks],
            "ewma": mon.ewma}


def test_force_fallback_migrates_healthy_path_as_reference():
    port = forced_fallback("port")
    assert port["forced"] and port["imms"] == list(range(60))
    assert port["fallbacks"] >= 1 and port["recoveries"] >= 1
    assert port["default"]
    assert port == forced_fallback("ref")


def test_monitor_triggers_on_persistent_straggler_as_reference():
    args = (dict(patience=2, cooldown_steps=3, threshold=1.5),
            {0: 4.0e-3, 1: 1.0e-3}, 6)
    port = monitored("port", *args)
    acted = [r for step in port["acted"] for r in step]
    assert 0 in acted and 1 not in acted
    assert port["fallbacks"][0] >= 1
    assert port == monitored("ref", *args)


def test_monitor_respects_cooldown_as_reference():
    args = (dict(patience=1, cooldown_steps=100, threshold=1.5),
            {0: 9.0e-3, 1: 1.0e-3}, 10)
    port = monitored("port", *args)
    assert sum(len(step) for step in port["acted"]) <= 1
    assert port == monitored("ref", *args)
