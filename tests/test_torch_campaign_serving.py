"""The ``serving`` campaign workload in the port against the reference's,
on the CPU: tensor-parallel serving of the llama4-maverick smoke MoE model
over a ``JcclWorld`` while a scenario's faults fire.

Each cell runs through both packages' ``run_scenario`` and must give the
same ``fingerprint()`` (the virtual clock only: the same bytes on the wire
give the same timings) and the same violations. The port's smoke params
are drawn from a torch.Generator (ROADMAP C9), so its tokens are not the
reference's; each package's tokens are compared with its own single-host
run. The perf suite's ``serving_tp`` loop, written once here, gives the
same virtual time, tokens, fallbacks and resteered chunks through both
packages, healthy and with a rail killed mid-decode.
"""

import pytest

torch = pytest.importorskip("torch")

from repro import collectives as j_collectives  # noqa: E402
from repro import serving as j_serving  # noqa: E402
from repro.scenarios import engine as j_engine  # noqa: E402
from repro_torch import collectives as t_collectives  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch import serving as t_serving  # noqa: E402
from repro_torch.scenarios import engine as t_engine  # noqa: E402

from test_torch_campaign_common import same_cell  # noqa: E402

GATE = ("baseline_clean", "sender_nic_down", "rail_kill_striped",
        "link_flap_train", "double_rail_outage")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' tensors are tiny: one intra-op thread runs them
    faster than a pool, which the test workers would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", GATE)
def test_serving_cell_equals_reference(name):
    port, ref = same_cell(name, "serving", port_kw={"device": "cpu"})
    assert (port.rounds, port.requests_total, port.requests_done,
            port.requests_failed, port.fallbacks, port.aborted) == \
        (ref.rounds, ref.requests_total, ref.requests_done,
         ref.requests_failed, ref.fallbacks, ref.aborted)
    assert port.token_mismatches == ref.token_mismatches == 0
    if name == "double_rail_outage":       # unmaskable: a loud abort
        assert port.aborted and port.requests_failed >= 1
    else:
        assert port.ok and port.completed


def test_serving_workload_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_scenario(T.SCENARIOS["baseline_clean"], workload="serving")


PACKAGES = {
    "reference": (j_collectives, j_serving, j_engine, {}),
    "port": (t_collectives, t_serving, t_engine, {"device": "cpu"}),
}


def serving_tp(pkg: str, kill: bool, n_requests: int = 4,
               n_tokens: int = 6) -> dict:
    """``benchmarks/perf_suite.py``'s ``bench_serving_tp`` run: the
    campaign's scheduler over a TPServeEngine on a 2-rank, 2-channel world;
    ``kill`` takes host0's first NIC down half a step into decode."""
    collectives, serving, engine, kw = PACKAGES[pkg]
    n_slots, prefill_len, max_len = 2, 12, 32
    model, params, local, prompts, ref = engine._serving_fixture(
        0, n_requests, n_tokens, n_slots, prefill_len, max_len, **kw)
    cluster, libs, world = collectives.build_world(
        n_ranks=2, channels=2, probe_interval=5e-4,
        max_chunk_bytes=1 << 12, strict_order=False)
    tp = serving.TPServeEngine(model, params, world=world, max_len=max_len,
                               timeout=10.0, local=local, **kw)
    sched = serving.RequestScheduler(tp, n_slots=n_slots,
                                     prefill_len=prefill_len)
    for p in prompts:
        sched.submit(p, n_tokens)
    t0 = cluster.sim.now
    steps = 0
    while sched.pending:
        sched.step()
        steps += 1
        if steps == 1 and kill:
            per_step = cluster.sim.now - t0
            for lib in libs:
                lib.config.probe_interval = max(per_step / 2, 1e-5)
            cluster.schedule_fault(cluster.sim.now + per_step / 2,
                                   "nic_down", "host0/mlx5_0")
    elapsed = cluster.sim.now - t0
    tokens = sum(len(r.tokens) for r in sched.requests
                 if r.state == "done")
    return {"tokens": tokens, "virtual_ms": elapsed * 1e3,
            "tokens_per_virtual_s": tokens / elapsed,
            "tokens_identical": [list(r.tokens) for r in sched.requests]
            == ref,
            "fallbacks": sum(lib.stats.fallbacks for lib in libs),
            "resteered": world.scheduler.resteered,
            "reconstruction_mismatches": tp.reconstruction_mismatches}


@pytest.mark.parametrize("kill", [False, True], ids=["healthy", "rail kill"])
def test_serving_tp_loop_equals_reference(kill):
    port, ref = serving_tp("port", kill), serving_tp("reference", kill)
    assert port == ref
    assert port["tokens_identical"] and port["tokens"] == 24
    assert port["reconstruction_mismatches"] == 0
    assert port["fallbacks"] == (2 if kill else 0)
    assert port["resteered"] >= (1 if kill else 0)
