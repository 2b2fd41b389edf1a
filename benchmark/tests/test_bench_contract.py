"""The result line's format, at the cells' small sizes on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchlib import spec as specs

from conftest import SMALL

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line(cell, small_run):
    line, checks = small_run(cell)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert json.loads(json.dumps(line)) == line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # no card: the peak and the device metrics are left out, not 0
    want = {m["name"] for m in specs.metrics_for(specs.benchmark(), cell,
                                                 False)}
    assert set(line["metrics"]) == want - {"peak_mem_gib"}
    assert all(line["metrics"][k]["unit"] == "s" for k in line["metrics"])
    assert line["device"]["platform"] == "cpu"
    limits = specs.cell_file(cell)["limits"]
    assert [c[0] for c in checks] == list(line["checks"]) == list(limits)
    for name, v, lim in checks:
        assert line["checks"][name] == {"value": v, "limit": lim}
        assert v <= lim


def test_traced_line(small_run):
    line, _ = small_run("ldpred2_hm3.grid", trace=1)
    assert line["correct"] is True
    assert line["attempted"] == specs.cell_file("ldpred2_hm3.grid")[
        "trace_jobs"]
    dev = line["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] == 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # per-layer readers find no device time on the CPU and report nothing
    assert line["metrics"] == {}
    assert list(line)[-1] == "checks"


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output; so it does in a directory that holds only
    BENCHMARK.json and the benchmark's files."""
    shutil.copytree(specs.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(specs.ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (specs.ROOT, tmp_path):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "ldpred2_hm3.grid", "--seed", "3000000000",
                            "--seconds", "1", "--trace", "0"], cwd=cwd,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0 and r.stdout == ""


def test_job_seeds():
    from benchlib.harness import job_seed

    big = 2**31 + 12345
    seeds = [job_seed(big, i) for i in range(-1, 50)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 < s < 2**31 for s in seeds)
    assert seeds == [job_seed(big, i) for i in range(-1, 50)]
