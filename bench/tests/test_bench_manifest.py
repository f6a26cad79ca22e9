"""BENCHMARK.json and the files it names: the naming rules, every cell's
files found by name, and the contract's limits on the manifest."""

import re

import pytest

from bench import harness
from bench.record import Record

MAN = harness.load_manifest()
NAMES = [c["name"] for c in MAN["configs"]] \
    + [w["name"] for w in MAN["workloads"]] \
    + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def test_manifest_is_sound():
    assert harness.manifest_errors(MAN) == []


@pytest.mark.parametrize("name", NAMES)
def test_names_follow_the_rules(name):
    assert harness.NAME.match(name)


@pytest.mark.parametrize("unit", sorted({m["unit"] for m in METRICS}))
def test_units_follow_the_rules(unit):
    assert harness.UNIT.match(unit)


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "µs", "",
                                 ".x" * 40, "-lead"])
def test_bad_names_are_refused(bad):
    assert not harness.NAME.match(bad)


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True),
                                     ("ms", True), ("GB.s-1", True),
                                     ("tokens per s", False),
                                     ("µs", False), ("", False)])
def test_units(unit, ok):
    assert bool(harness.UNIT.match(unit)) is ok


def test_a_manifest_that_breaks_a_rule_is_reported():
    import copy
    bad = copy.deepcopy(MAN)
    bad["per_layer"][0]["moves"] = "nothing"
    bad["end_to_end"][0]["unit"] = "tokens per s"
    errs = harness.manifest_errors(bad)
    assert any("moves 'nothing'" in e for e in errs)
    assert any("bad unit" in e for e in errs)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.resolve(MAN, workload)
    for path in cell.files():
        assert path.is_file(), path
    kind = harness.load_kind(cell.traffic["kind"])
    assert callable(kind.run)
    ref = harness.load_reference(cell.config["reference"])
    assert callable(ref.make_params)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert "setup_s" in cell.e2e and len(cell.e2e) >= 2 and cell.per_layer


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_config_file_holds_what_runs(workload):
    cell = harness.resolve(MAN, workload)
    entry = {c["name"]: c for c in MAN["configs"]}[
        {w["name"]: w for w in MAN["workloads"]}[workload]["config"]]
    assert entry["reduced"] == cell.config["reduced"]
    from bench import program
    cfg = program.model_config(cell.config["model"])
    assert cfg.name == cell.config["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_a_metric_with_nothing_to_read_is_left_out(metric):
    reader = harness.load_file(harness.metric_file(metric), "m")
    rec = Record(model={}, traffic={})
    if metric == "setup_s":
        assert reader.read(rec) == 0.0
    else:
        assert reader.read(rec) is None


def test_the_contract_on_the_manifest():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert isinstance(MAN["run_seconds"], int) \
        and 1 <= MAN["run_seconds"] <= 51
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert re.match(r"^bench/", c["file"])
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
            assert re.match(r"^[A-Za-z0-9]+_roofline(\.|$)", m["name"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_an_entry_missing_a_key_or_with_one_more_is_refused(group):
    import copy
    for change in ("drop", "add"):
        man = copy.deepcopy(MAN)
        entry = man[group][0]
        if change == "drop":
            entry.pop("why" if group in ("configs", "workloads")
                      else "unit")
        else:
            entry["note"] = "x"
        assert any(e.startswith(group) for e in
                   harness.manifest_errors(man)), (group, change)
