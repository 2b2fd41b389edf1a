"""Configurations, traffic mixes, cells and metrics are found by name;
one added as new files runs without an edit to any file already there."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from benchlib import spec as specs

from conftest import SMALL


def test_every_entry_has_its_files():
    spec = specs.benchmark()
    for c in spec["configs"]:
        assert (specs.ROOT / c["file"]).is_file()
        assert specs.config(spec, c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        tr = specs.traffic(w["traffic"])
        assert (specs.BENCH / "jobs" / f"{tr['job']}.py").is_file()
        assert set(specs.cell_file(w["name"])["limits"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(specs.load_module("metrics", m["name"]).read)


def test_metrics_for_a_cell():
    spec = specs.benchmark()
    e2e = [m["name"] for m in specs.metrics_for(spec, "ldpred2_hm3.grid",
                                                False)]
    assert e2e == ["setup_s", "job_s", "peak_mem_gib"]
    layer = [m["name"] for m in specs.metrics_for(spec, "ldpred2_hm3.grid",
                                                  True)]
    assert layer == ["sweep_roofline_pct", "sweep_host_ms",
                     "device_idle_pct"]


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    import torch

    from benchlib import harness

    shutil.copytree(specs.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(specs.ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    (b / "traffic" / "randomsvd_k4.json").write_text(json.dumps(
        {"job": "randomsvd", "k": 4, "oversample": 4, "tol": 1e-4}))
    (b / "cells" / "pca_ukbb.randomsvd_k4.json").write_text(json.dumps(
        {"checked_jobs": 1, "trace_jobs": 1,
         "limits": specs.cell_file("pca_ukbb.randomsvd")["limits"]}))
    (b / "metrics" / "job_ms.py").write_text(
        "def read(rec):\n"
        "    return 1e3 * rec['window_s'] / rec['jobs']\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "pca_ukbb.randomsvd_k4",
                              "config": "pca_ukbb", "traffic": "randomsvd_k4",
                              "chips": 1, "why": "k = 4"})
    spec["end_to_end"].append({"name": "job_ms", "unit": "ms",
                               "better": "lower", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["pca_ukbb.randomsvd_k4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before

    cfg, _ = SMALL["pca_ukbb.randomsvd"]
    line, _ = harness.run_cell("pca_ukbb.randomsvd_k4", 5, 0.1, 0,
                               torch.device("cpu"), time.perf_counter(),
                               cfg_override=cfg, root=tmp_path)
    assert line["correct"]
    assert line["metrics"]["job_ms"]["value"] > 0
    assert set(line["metrics"]) == {"setup_s", "job_s", "job_ms"}


def test_an_unknown_name_is_refused():
    spec = specs.benchmark()
    with pytest.raises(ValueError):
        specs.cell(spec, "no_such.cell")
    with pytest.raises(ValueError):
        specs.load_module("metrics", "no_such_metric")
    assert Path(specs.BENCH / "run.py").is_file()
