"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix:

  - the configuration is the file its `configs` entry gives (by
    convention `portbench/configs/<config>.json`): the program's knobs as
    they are run (`synth`), the checks' limits (`correct`) and the
    deployment it stands for;
  - the mix is `portbench/mixes/<traffic>.json`: the parameters of the
    load, and the `driver` (a module of `portbench/drivers/`) that
    generates it;
  - every metric, end-to-end or per-layer, is `portbench/metrics/<name>.py`,
    whose `read(ctx)` takes the number from the run's context (the
    window's record, the traced pass's spans and trace; `run.run_cell`
    lists the keys), or returns None when there is nothing to read.

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(path: Path = BENCHMARK) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[Dict[str, Any]], name: str, what: str):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell resolved: its entry, configuration, mix and metrics."""

    def __init__(self, bench: Dict[str, Any], name: str, root: Path = ROOT,
                 pkg: Path = PKG):
        self.bench = bench
        self.pkg = pkg
        self.entry = _by_name(bench["workloads"], name, "workload")
        self.name = name
        self.config_entry = _by_name(bench["configs"], self.entry["config"],
                                     "configuration")
        self.config = load_json(root / self.config_entry["file"])
        self.mix = load_json(pkg / "mixes" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])

    def end_to_end(self) -> List[Dict[str, Any]]:
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[Dict[str, Any]]:
        return [m for m in self.bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: Dict[str, Any]) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells


def metric_reader(name: str, pkg: Path = PKG):
    """The `read(ctx)` of `metrics/<name>.py`."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(name: str, pkg: Path = PKG):
    """The `portbench.drivers.<name>` module a mix names: its file in
    `pkg`'s `drivers/` (a copy of the benchmark's files, in tests), loaded
    once a process."""
    if not re.fullmatch(r"[a-z_][a-z0-9_]*", name):
        raise ValueError(f"bad driver name {name!r}")
    full = f"portbench.drivers.{name}"
    if full in sys.modules:
        return sys.modules[full]
    importlib.import_module("portbench.drivers")
    spec = importlib.util.spec_from_file_location(
        full, pkg / "drivers" / f"{name}.py")
    if spec is None or spec.loader is None:
        raise FileNotFoundError(pkg / "drivers" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def problems(bench: Dict[str, Any], root: Path = ROOT,
             pkg: Path = PKG) -> List[str]:
    """What in `bench` breaks the naming rules or names a missing file."""
    out: List[str] = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += list(c["reduced"])
    out += [f"bad name {n!r}" for n in names if not NAME_RE.match(n)]
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in bench[group]]
        out += [f"duplicate {group} name {n!r}" for n in set(seen)
                if seen.count(n) > 1]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    out += [f"duplicate metric {n!r}" for n in set(metrics)
            if metrics.count(n) > 1]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
    for c in bench["configs"]:
        if not (root / c["file"]).is_file():
            out.append(f"missing configuration file {c['file']}")
    for w in bench["workloads"]:
        mix = pkg / "mixes" / f"{w['traffic']}.json"
        if not mix.is_file():
            out.append(f"missing mix {mix.name}")
            continue
        driver = load_json(mix).get("driver", "")
        if not (pkg / "drivers" / f"{driver}.py").is_file():
            out.append(f"missing driver {driver!r} of {mix.name}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not (pkg / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"missing metric reader {m['name']}.py")
    return out

