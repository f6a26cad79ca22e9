"""``correct`` on runs of the cells cut small on the CPU: the harness's
look for a chip is skipped and the rest of a run driven, with a fault
planted underneath the timed path; the control (the reference in e4m3)
read against the float32 reference; and, on the card, the control at the
cells' own size held to their limits."""

import itertools
import json

import pytest

from bench import correct, faults, harness, measure, program
from bench.tests.cells import CELLS, small

FAULTS = [("gpt2-124m.train_b64", "train.half_batch"),
          ("gpt2-124m.train_b64", "train.unchanged"),
          ("yi-6b.doc_qa", "serve.token_altered"),
          ("yi-6b.doc_qa", "serve.half_batch"),
          ("yi-6b.doc_qa", "serve.unchanged")]
SEPARATES = {"gpt2-124m.train_b64": "grad_gap", "yi-6b.doc_qa": "served_gap"}


# the windows in ticks of a clock that advances 10 ms a reading, so that
# what a run does is the same however busy the machine is
TICK = 0.01
SECONDS = {"gpt2-124m.train_b64": 0.05, "yi-6b.doc_qa": 0.6}


@pytest.fixture
def steady_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(program, "clock", lambda: next(ticks) * TICK)


def _run(cell, seed=5, control=False):
    kind = harness.load_kind(cell.traffic["kind"])
    import torch
    return kind.run(cell, seed, SECONDS[cell.name], False,
                    torch.device("cpu"), 0.0, control=control)


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_makes_correct_false(name, fault, steady_clock):
    cell = small(name)
    with faults.FAULTS[fault]():
        out = measure.measure(cell, 5, SECONDS[name], False, "cpu", 0.0)
    assert out["correct"] is False
    assert not correct.passed(out["checked"])


@pytest.fixture(scope="module")
def sound():
    """Each small cell's readings, the control's beside them."""
    ticks = itertools.count()
    clock, program.clock = program.clock, lambda: next(ticks) * TICK
    try:
        return {name: _run(small(name), control=True).readings
                for name in CELLS}
    finally:
        program.clock = clock


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_reads_far_above_a_sound_run(name, fault, sound,
                                             steady_clock):
    with faults.FAULTS[fault]():
        bad = _run(small(name)).readings
    ok = sound[name]
    assert max(bad[k] / max(ok[k], 1e-9) for k in bad) > 10


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_above_the_program(name, sound):
    key = SEPARATES[name]
    assert sound[name][f"{key}.control"] > 3 * sound[name][key]


def test_the_result_line_puts_the_checks_last():
    checked = correct.verdict({"gap": 0.1}, {"gap": 0.2})
    line = json.loads(harness.result_line(True, 3, 0, {}, {"count": 1},
                                          checked, {"device_ops": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checked"]
    assert harness.checked_lines(checked) == [
        "check gap: 0.1 (limit 0.2) ok"]
    assert not correct.passed(correct.verdict({"gap": 0.1}, {}))
    assert not correct.passed(correct.verdict({"gap": float("nan")},
                                              {"gap": 1.0}))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name, card):
    """The e4m3 reference in the program's place, on three seeds, fails
    one of the cell's limits (minutes on an H100)."""
    cell = harness.resolve(harness.load_manifest(), name)
    kind = harness.load_kind(cell.traffic["kind"])
    for seed in (3100000001, 3100000002, 3100000003):
        out = kind.run(cell, seed, 10.0, False, card, 0.0, control=True)
        control = {k[:-len(".control")]: v for k, v in out.readings.items()
                   if k.endswith(".control")}
        assert not correct.passed(correct.verdict(control, cell.limits))
