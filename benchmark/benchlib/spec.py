"""Finding a cell's files by name.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`),
the configurations and the metrics. Everything that belongs to one of
them sits in a file of its own under `benchmark/`, found by its name:

- a configuration: the `file` that its `configs` entry names;
- a traffic mix: `traffic/<traffic>.json`, whose `job` names the job kind;
- a job kind: `jobs/<job>.py` (set-up, one job, the check);
- a cell's limits and check sizes: `cells/<cell>.json`;
- a metric, end-to-end or per layer: `metrics/<metric>.py`, whose
  `read(rec)` returns the value or None.

A later change adds a cell, a configuration, a traffic mix or a metric
by adding such files and their entries in `BENCHMARK.json`; no file here
names one of them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root=ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(Path(root) / c["file"])
    raise ValueError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, bench=BENCH) -> dict:
    return load_json(Path(bench) / "traffic" / f"{name}.json")


def cell_file(name: str, bench=BENCH) -> dict:
    return load_json(Path(bench) / "cells" / f"{name}.json")


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric entry is reported in this cell: listed there, or
    without a `workloads` key."""
    return cell_name in metric.get("workloads", [cell_name])


def metrics_for(spec: dict, cell_name: str, trace: bool) -> list:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key] if applies(m, cell_name)]


def load_module(kind: str, name: str, bench=BENCH):
    """benchmark/<kind>/<name>.py, imported once under a name of its own."""
    mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = Path(bench) / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no file {path.relative_to(Path(bench).parent)}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
