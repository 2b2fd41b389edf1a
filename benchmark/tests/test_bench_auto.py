"""The `ldpred2_hm3.auto` cell at a small size of its own: 3,000 variants
in LD blocks of 100-300 (latent lag-1 correlation 0.97, at which no chain
diverges), 6 chains, 30 + 20 sweeps, states kept every 10 sweeps. On the
CPU through `harness.run_cell` it is correct; with the timed path broken
underneath, `correct` comes out false: the averages taken over the
burn-in too, one chain's state corrupted past the first segment, the
MLE's sigma2 left unclipped, p drawn without mean_ld, the chain QC at
the 0.5 quantile of the ranges in place of 0.95. On the card (marker
`cuda`) the cell is correct through the kernels and prints its three
per-layer metrics, and the control fails."""

import time

import numpy as np
import pytest
import torch

from benchlib import harness
from benchlib import spec as specs

CELL = "ldpred2_hm3.auto"
CFG = {"n_samples": 2000, "n_gwas": 1500, "n_variants": 3000,
       "block_min": 100, "block_max": 300, "n_causal": 100,
       "ld_window": 100, "rho": 0.97}
TRAFFIC = {"burn_in": 30, "num_iter": 20,
           "p_init": {"from": 1e-3, "to": 0.2, "n": 6}}
SEGMENT = 10


@pytest.fixture
def run_small(monkeypatch):
    """run(trace=0, dev=cpu) -> (line, checks) at the small size, the
    cell file's segment cut to 10 sweeps."""
    cellf = dict(specs.cell_file(CELL), segment=SEGMENT)
    orig = specs.cell_file
    monkeypatch.setattr(specs, "cell_file",
                        lambda name, *a: cellf if name == CELL
                        else orig(name, *a))
    torch.set_num_threads(min(4, torch.get_num_threads()))

    def run(trace=0, dev=torch.device("cpu"), seed=987654321012):
        return harness.run_cell(CELL, seed, 0.5, trace, dev,
                                time.perf_counter(), cfg_override=CFG,
                                traffic_override=TRAFFIC)

    return run


def test_the_cell_is_correct(run_small):
    line, checks = run_small()
    assert line["correct"] is True, line["checks"]
    assert [c[0] for c in checks] == list(specs.cell_file(CELL)["limits"])
    assert set(line["metrics"]) == {"setup_s", "job_s"}


def _burn_in_averaged(mp):
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb

    orig = gb._AutoRun.sweep

    def sweep(self, k):
        kw = self.kw
        self.kw = dict(kw, burn_in=0)
        try:
            return orig(self, k)
        finally:
            self.kw = kw

    mp.setattr(gb._AutoRun, "sweep", sweep)


def _state_corrupted(mp):
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb

    orig = gb._AutoRun.update

    def update(self, k):
        orig(self, k)
        if k == SEGMENT + 3:
            for part in self.parts:
                part.curr = part.curr.clone()
                part.curr[0] *= 1.5

    mp.setattr(gb._AutoRun, "update", update)


def _sigma2_unclipped(mp):
    from bigsnpr_tpu_torch.pgs import gibbs

    orig = gibbs._profile

    def profile(a, sum_a, nb, wb, log_var, s_lo, s_hi, rows=None):
        return orig(a, sum_a, nb, wb, log_var, torch.zeros_like(s_lo),
                    torch.full_like(s_hi, torch.inf), rows)

    mp.setattr(gibbs, "_profile", profile)


def _p_without_mean_ld(mp):
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb

    orig = gb._AutoRun.update

    def update(self, k):
        kw = self.kw
        self.kw = dict(kw, mean_ld=1.0)
        try:
            return orig(self, k)
        finally:
            self.kw = kw

    mp.setattr(gb._AutoRun, "update", update)


def _qc_quantile_wrong(mp):
    import bigsnpr_tpu_torch as bp

    orig = bp.ldpred2_auto_chain_qc
    mp.setattr(bp, "ldpred2_auto_chain_qc",
               lambda multi, quantile=0.95: orig(multi, quantile=0.5))


FAULTS = [_burn_in_averaged, _state_corrupted, _sigma2_unclipped,
          _p_without_mean_ld, _qc_quantile_wrong]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_makes_the_run_incorrect(fault, run_small, monkeypatch):
    fault(monkeypatch)
    line, checks = run_small()
    assert line["correct"] is False
    assert any(not v <= lim for _, v, lim in checks)
    if fault is _qc_quantile_wrong:
        assert [k for k, v, lim in checks if not v <= lim] == ["qc_mismatch"]


def test_the_parent_program_fails_at_once(run_small, monkeypatch):
    """A program without `state_sweeps` (the parent's) fails in set-up,
    before any job is timed."""
    import bigsnpr_tpu_torch as bp

    orig = bp.snp_ldpred2_auto

    def old(*a, state_sweeps=None, **kw):
        if state_sweeps is not None:
            raise TypeError("unexpected keyword argument 'state_sweeps'")
        return orig(*a, **kw)

    monkeypatch.setattr(bp, "snp_ldpred2_auto", old)
    with pytest.raises(TypeError):
        run_small()


@pytest.mark.cuda
def test_the_cell_on_the_card(run_small, cuda_device):
    line, _ = run_small(trace=1, dev=cuda_device)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
    want = {m["name"] for m in specs.metrics_for(specs.benchmark(), CELL,
                                                 True)}
    assert want == {"auto_sweep_roofline_pct", "auto_driver_device_ms",
                    "mle_exps_per_sweep"}
    assert set(line["metrics"]) == want
    assert 0 < line["metrics"]["auto_sweep_roofline_pct"]["value"] <= 100
    # 6 chains x (3 x 64 + 1) profile points x 3,000 variants a sweep
    assert line["metrics"]["mle_exps_per_sweep"]["value"] == 6 * 193 * 3000


@pytest.mark.cuda
def test_the_control_fails_on_the_card(run_small, cuda_device):
    from benchlib import ldpred2_setup as common

    job = specs.load_module("jobs", "ldpred2_auto")
    cw = specs.cell(specs.benchmark(), CELL)
    cfg = dict(specs.config(specs.benchmark(), cw["config"]), **CFG)
    tr = dict(specs.traffic(cw["traffic"]), **TRAFFIC)
    ctx = harness.Ctx(CELL, cfg, tr, specs.cell_file(CELL), 5, cuda_device)
    st = job.setup(ctx)
    sample = [(0, harness.job_seed(5, 0), job.run(st, ctx, 0,
                                                 harness.job_seed(5, 0)))]
    common.release(st)
    got = job.control(st, ctx, sample)
    limits = ctx.cellf["limits"]
    assert any(not got[k] <= limits[k] for k in limits)
    assert np.isfinite(got["p_gap"])
