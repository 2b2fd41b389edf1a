"""Puts the benchmark's packages and the checkout's root on sys.path, and
gives the tests the small sizes at which the cells run on the CPU."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# each cell at a size a CPU test run holds: (configuration, traffic)
SMALL = {
    "pca_ukbb.randomsvd": (
        {"n_samples": 4000, "n_variants": 2500,
         "groups": {"a": [300, 0.15], "b": [200, 0.2]},
         "uk_regions": {"count": 2, "ratio": 0.8, "fst": 0.05}},
        {"k": 5, "oversample": 5}),
    "ldpred2_hm3.grid": (
        {"n_samples": 2000, "n_gwas": 1500, "n_variants": 3000,
         "block_min": 100, "block_max": 300, "n_causal": 100,
         "ld_window": 100},
        {"burn_in": 3, "num_iter": 5}),
}


@pytest.fixture
def small_run():
    """run(cell, trace=0, seed=...) -> (line, checks) on the CPU at the
    cell's small size."""
    import time

    import torch

    from benchlib import harness

    torch.set_num_threads(min(4, torch.get_num_threads()))

    def run(cell, trace=0, seed=987654321012):
        cfg, tr = SMALL[cell]
        return harness.run_cell(cell, seed, 0.5, trace, torch.device("cpu"),
                                time.perf_counter(), cfg_override=cfg,
                                traffic_override=tr)

    return run


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
