"""On the card (marker `cuda`; skips without one): each cell at its small
size through the kernels, correct, with the per-layer metrics read from
the device trace, and the control failing. Run on the card with
`python -m pytest -m cuda benchmark/tests/test_bench_cuda.py`."""

import time

import pytest

from benchlib import harness
from benchlib import spec as specs

from conftest import SMALL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(cell, cuda_device):
    cfg, tr = SMALL[cell]
    line, _ = harness.run_cell(cell, 77, 0.5, 1, cuda_device,
                               time.perf_counter(), cfg_override=cfg,
                               traffic_override=tr)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    want = {m["name"] for m in specs.metrics_for(specs.benchmark(), cell,
                                                 True)}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        if name.endswith("_pct"):
            assert 0 < m["value"] <= 100
