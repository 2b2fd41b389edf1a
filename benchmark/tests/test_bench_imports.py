"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program under test."""

import ast
import os
import subprocess
import sys
import types

import pytest

from benchlib import harness
from benchlib import spec as specs

FORBIDDEN = {"jax", "jaxlib", "flax", "bigsnpr_tpu"}
REFERENCE_MAY = {"__future__", "numpy", "torch", "scipy", "benchref", "math"}


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(specs.BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = _imports(f) & FORBIDDEN
        assert not bad, f"{f} imports {bad}"


def test_references_import_nothing_of_the_program():
    files = sorted((specs.BENCH / "benchref").glob("*.py"))
    assert files
    for f in files:
        tops = _imports(f)
        assert tops <= REFERENCE_MAY, f"{f} imports {tops - REFERENCE_MAY}"


def test_names_are_compared_whole():
    mods = {"bigsnpr_tpu_torch": 1, "bigsnpr_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "bigsnpr_tpu.ops": 1})
    assert harness.forbidden_modules(mods) == ["bigsnpr_tpu", "jax"]


BLOCKED_RUN = r"""
import sys, time, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "bigsnpr_tpu"}:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
from benchlib import harness
from conftest import SMALL
cfg, tr = SMALL["ldpred2_hm3.grid"]
line, _ = harness.run_cell("ldpred2_hm3.grid", 11, 0.1, 0,
                           torch.device("cpu"), time.perf_counter(),
                           cfg_override=cfg, traffic_override=tr)
assert line["correct"], line
assert harness.forbidden_modules() == []
print("ok")
"""


def test_a_run_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(specs.BENCH),
                        str(specs.ROOT)], cwd=specs.BENCH / "tests",
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(specs.BENCH /
                                                           "tests")))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_a_reference_that_loads_jax_gives_no_result(small_run, monkeypatch):
    """The harness looks at sys.modules again once the references have
    judged the jobs: a check that loads a module named jax ends the run
    before a result line exists."""
    job = specs.load_module("jobs", "ldpred2_grid")
    orig = job.check

    def check(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(*a, **kw)

    monkeypatch.setattr(job, "check", check)
    with pytest.raises(harness.ForbiddenModules, match="jax"):
        small_run("ldpred2_hm3.grid")


def test_forbidden_modules_print_nothing(monkeypatch, capsys):
    """`main` turns ForbiddenModules into exit code 3 and no result line."""
    import torch

    from bigsnpr_tpu_torch import config

    def refused(*a, **kw):
        raise harness.ForbiddenModules(["jax"])

    monkeypatch.setattr(harness, "set_caches", lambda root: "unused")
    monkeypatch.setattr(config, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", refused)
    rc = harness.main(["--workload", "ldpred2_hm3.grid", "--seed", "5",
                       "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc == 3 and out.out == ""
    assert "jax" in out.err
