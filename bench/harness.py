"""The benchmark's manifest, the files it names, and the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

- a configuration: ``bench/configs/<config>.json`` (its sizes as run,
  its source, ``reduced`` and ``assumed``, and the name of its plain
  reference under ``bench/reference/``);
- a traffic mix: ``bench/traffic/<traffic>.json`` (parameters only; its
  ``kind`` names the driver, ``bench/kinds/<kind>.py``, that generates
  the traffic from them and runs the window);
- a metric: ``bench/metrics/<name>.py``, whose ``read(record)`` returns
  the number or None when the run has nothing to read;
- a cell's limits: ``bench/limits/<workload>.json``, the numbers that
  decide ``correct``;
- a kernel of the program: ``bench/kernels/<kernel>.json``, the wrappers
  whose launch counters count its calls (``module:function``, each
  counter under its own name), the pattern of its device kernels' names
  in the profiler's trace, and, where the wrapper launches more than
  those, the function to hold in a ``bench.<kernel>`` range in a traced
  run (``span``). Every file there is read, so a new kernel is a new
  file.

This module imports neither ``torch`` nor the program.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")
# one line of 1 to 200 characters, no tab: a why, a layer, a source
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
# the keys each entry of a group has ("workloads" may join a metric's)
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}

# top-level module names no run may load: JAX and the JAX package. A name
# is compared whole, so ``repro_torch`` is not ``repro``.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def load_manifest(path: Path = MANIFEST) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest_errors(man: Dict[str, Any]) -> List[str]:
    """What in ``man`` breaks the keys or the naming rules, or names a file
    or a cell that does not exist. Empty when the manifest is sound."""
    errs = []
    for group, required in KEYS.items():
        allowed = required | ({"workloads"} if group in (
            "end_to_end", "per_layer") else set())
        for e in man[group]:
            if not required <= set(e) <= allowed:
                errs.append(f"{group} {e.get('name')!r}: keys "
                            f"{sorted(e)}, not {sorted(required)}")
            for key in ("why", "layer", "source"):
                if isinstance(e.get(key), str) and not TEXT.match(e[key]):
                    errs.append(f"{group} {e.get('name')!r}: bad {key}")
    if errs:        # the checks below read those keys
        return errs
    configs = {c["name"]: c for c in man["configs"]}
    names = [c["name"] for c in man["configs"]] \
        + [w["name"] for w in man["workloads"]] \
        + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in man[group]]
        if len(seen) != len(set(seen)):
            errs.append(f"{group}: a name is used twice")
    for name in names:
        if not NAME.match(name):
            errs.append(f"bad name {name!r}")
    for c in man["configs"]:
        if not (ROOT / c["file"]).is_file():
            errs.append(f"config {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                errs.append(f"config {c['name']}: bad key {key!r}")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        if w["config"] not in configs:
            errs.append(f"workload {w['name']}: no config {w['config']}")
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                errs.append(f"workload {w['name']}: bad {key} {w[key]!r}")
        cell = resolve(man, w["name"])
        for path in cell.files():
            if not path.is_file():
                errs.append(f"workload {w['name']}: no file {path}")
        if len(cell.e2e) < 2 or "setup_s" not in cell.e2e:
            errs.append(f"workload {w['name']}: needs setup_s and one "
                        f"more end-to-end metric")
        if not cell.per_layer:
            errs.append(f"workload {w['name']}: no per-layer metric")
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            errs.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better={m['better']!r}")
        if m["source"] not in SOURCES:
            errs.append(f"metric {m['name']}: source {m['source']!r}")
    for m in man["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            errs.append(f"metric {m['name']}: an end-to-end metric "
                        f"cannot come from {m['source']}")
    for m in man["per_layer"]:
        if m["moves"] not in e2e:
            errs.append(f"metric {m['name']}: moves {m['moves']!r}, "
                        f"not an end-to-end metric")
        for w in m.get("workloads", []):
            cell = resolve(man, w)
            if m["moves"] not in cell.e2e:
                errs.append(f"metric {m['name']}: cell {w} does not "
                            f"report {m['moves']}")
    return errs


@dataclass
class Cell:
    """One workload of the manifest, with its files read."""

    name: str
    config: Dict[str, Any]          # bench/configs/<config>.json
    traffic: Dict[str, Any]         # bench/traffic/<traffic>.json
    limits: Dict[str, float]        # bench/limits/<name>.json
    chips: int
    e2e: List[str]                  # its end-to-end metrics, in order
    per_layer: List[str]            # its per-layer metrics, in order
    units: Dict[str, str]
    config_file: Path
    traffic_file: Path
    limits_file: Path

    def files(self) -> List[Path]:
        return [self.config_file, self.traffic_file, self.limits_file,
                kind_file(self.traffic["kind"]),
                reference_file(self.config["reference"])] \
            + [metric_file(m) for m in self.e2e + self.per_layer]


def kind_file(kind: str) -> Path:
    return BENCH / "kinds" / f"{kind}.py"


def reference_file(name: str) -> Path:
    return BENCH / "reference" / f"{name}.py"


def metric_file(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def kernels() -> Dict[str, Dict[str, Any]]:
    """Every ``bench/kernels/<kernel>.json``, by its name."""
    return {p.stem: _read_json(p)
            for p in sorted((BENCH / "kernels").glob("*.json"))}


def resolve(man: Dict[str, Any], workload: str) -> Cell:
    """The cell named ``workload``, its configuration, traffic and limits
    read, and its metrics: every end-to-end metric with no ``workloads``
    key or one that lists the cell, and the same for per-layer ones."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m["name"] for m in man["end_to_end"] if applies(m)]
    per_layer = [m["name"] for m in man["per_layer"]
                 if applies(m) and ("workloads" in m or m["moves"] in e2e)]
    units = {m["name"]: m["unit"]
             for m in man["end_to_end"] + man["per_layer"]}
    config_file = ROOT / conf["file"]
    traffic_file = BENCH / "traffic" / f"{w['traffic']}.json"
    limits_file = BENCH / "limits" / f"{workload}.json"
    return Cell(name=workload, config=_read_json(config_file),
                traffic=_read_json(traffic_file),
                limits=_read_json(limits_file) if limits_file.is_file()
                else {},
                chips=w["chips"], e2e=e2e, per_layer=per_layer, units=units,
                config_file=config_file, traffic_file=traffic_file,
                limits_file=limits_file)


def load_file(path: Path, name: str):
    """Import the module at ``path`` (names with dots are fine)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str):
    return load_file(kind_file(kind), f"bench_kind_{kind}")


def load_reference(name: str):
    return load_file(reference_file(name), f"bench_reference_{name}")


def read_metrics(names: List[str], units: Dict[str, str],
                 record) -> Dict[str, Dict[str, Any]]:
    """Each metric's ``read(record)``; a metric that finds nothing to read
    returns None and is left out."""
    out = {}
    for name in names:
        value = load_file(metric_file(name), "bench_metric_"
                          + name.replace(".", "_").replace("-", "_")
                          ).read(record)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def checked_lines(checked: Dict[str, Dict[str, float]]) -> List[str]:
    """One line a compared number: its name, value, limit and verdict."""
    def ok(c):
        return c["limit"] is not None and c["value"] <= c["limit"]
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if ok(c) else 'FAILED'}" for name, c in checked.items()]


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Any], device: Dict[str, Any],
                checked: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The run's last line on standard output; ``checked`` comes last."""
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    return json.dumps(out)
