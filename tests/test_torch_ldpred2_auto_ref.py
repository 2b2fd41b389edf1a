"""The port's LDpred2-auto held against the benchmark's plain reference
(`benchmark/benchref/ldpred2_auto.py`, float64), on the CPU at a small
size: a seeded cohort of 3,000 variants in LD blocks of 100-300, 6
chains, 30 + 20 sweeps, the benchmark's own set-up (`benchlib.
ldpred2_setup`) for the program and the reference's own from the bytes.

The reference replays every sweep of every chain on the program's draws
with the program's p, sigma2 and alpha fed in, from the program's kept
states (`state_sweeps`): the chain-wide update of every sweep from the
program's exact states before and after it, the states at each segment's
end, the averages' window and the chain QC. Then, on the port's side
alone: the sigma2 path without the MLE, the keyword leaving every other
output bit-equal, and the kept states under `shard_chains` and
`shard_blocks`."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import bigsnpr_tpu_torch as bp                                  # noqa: E402
from benchlib import ldpred2_setup as common                     # noqa: E402
from benchlib import spec as specs                               # noqa: E402
from benchref import ldpred2_auto as ref                         # noqa: E402

torch.set_num_threads(2)

SEED = 20261019
BURN_IN, NUM_ITER = 30, 20
T = BURN_IN + NUM_ITER
P_INIT = bp.seq_log(1e-3, 0.2, 6)
SETTINGS = dict(burn_in=BURN_IN, num_iter=NUM_ITER, shrink=0.95,
                no_jump=True, p_bounds=(1e-5, 1.0), alpha_bounds=(-1.5, 0.5))
AUTO_KW = dict(burn_in=BURN_IN, num_iter=NUM_ITER, allow_jump_sign=False,
               shrink_corr=0.95, use_MLE=True, p_bounds=(1e-5, 1.0),
               alpha_bounds=(-1.5, 0.5))
PATHS = ("path_p_est", "path_h2_est", "path_alpha_est", "path_sigma2_est")
STATES = ("state_beta", "state_sum_beta", "state_sum_postp",
          "state_sum_corr", "state_h2")
OUTPUTS = ("beta_est", "postp_est", "corr_est")
# the float32 program's readings at this size are ~5e-7 (p), ~3e-7 (h2)
# and ~4e-3 (alpha and sigma2: the MLE's float32 profile is flat near its
# minimum); no block parts in 50 sweeps
LIMITS = dict(p_gap=1e-5, h2_gap=1e-5, alpha_gap=2e-2, sigma2_gap=2e-2,
              lane_mismatch=0.1, window_mismatch=0.1, qc_mismatch=0)


@pytest.fixture(scope="module")
def cohort():
    cfg = dict(specs.config(specs.benchmark(), "ldpred2_hm3"))
    cfg.update(n_samples=2000, n_gwas=1500, n_variants=3000, block_min=100,
               block_max=300, n_causal=100, ld_window=100, rho=0.97)
    ctx = types.SimpleNamespace(cfg=cfg, seed=SEED, dev=torch.device("cpu"),
                                log=lambda *a: None, sync=lambda: None)
    with bp.config.options(device="cpu"):
        st = common.setup(ctx)
    st["R"] = common.derive_reference(st, ctx)
    return st


def auto(st, **kw):
    kw = {**AUTO_KW, "device": "cpu", **kw}
    return bp.snp_ldpred2_auto(st["corr"], st["df_beta"], h2_init=st["h2"],
                               vec_p_init=P_INIT, blocks=st["bb"], seed=SEED,
                               **kw)


def arrays(multi, kept):
    out = {k: np.stack([c[k] for c in multi])
           for k in PATHS + STATES + OUTPUTS}
    out["p_init"] = np.array([c["p_init"] for c in multi])
    out["h2_init"] = float(multi[0]["h2_init"])
    out["kept"] = list(kept)
    out["keep"] = bp.ldpred2_auto_chain_qc(multi)[0]
    return out


def judged(st, prog):
    return ref.judge(st["R"], prog, SEED, lane_tol=1e-3, **SETTINGS)


@pytest.fixture(scope="module")
def every_sweep(cohort):
    return auto(cohort, state_sweeps=range(T))


def test_every_sweep_matches_the_reference(cohort, every_sweep):
    """States kept after every sweep: each sweep's chain-wide update is
    checked from the program's exact states, and each one-sweep segment's
    end; the chain QC and the mean of the kept chains."""
    prog = arrays(every_sweep, range(T))
    assert np.isfinite(prog["beta_est"]).all()      # no chain diverged
    vals = judged(cohort, prog)
    for k, lim in LIMITS.items():
        assert vals[k] <= lim, (k, vals[k])
    keep, beta_auto = bp.ldpred2_auto_chain_qc(every_sweep)
    assert keep.any() and not keep.all()
    np.testing.assert_array_equal(keep, prog["keep"])
    np.testing.assert_allclose(beta_auto, prog["beta_est"][keep].mean(0),
                               rtol=1e-12, atol=0)


def test_segments_match_the_reference(cohort):
    """The benchmark's layout: states at 0, 9, 10, 19, 20, ... 49; the
    replay restarts from them and holds the segments' ends and sums."""
    kept = ref.kept_sweeps(T, 10)
    assert kept == [0, 9, 10, 19, 20, 29, 30, 39, 40, 49]
    assert ref.segments(kept, T) == [(0, 0), (1, 9), (10, 10), (11, 19),
                                     (20, 20), (21, 29), (30, 30), (31, 39),
                                     (40, 40), (41, 49)]
    vals = judged(cohort, arrays(auto(cohort, state_sweeps=kept), kept))
    for k, lim in LIMITS.items():
        assert vals[k] <= lim, (k, vals[k])


def test_the_reference_follows_itself_and_the_control_parts(cohort):
    """The reference's own float64 run, judged, reads rounding; its
    bfloat16 run (the benchmark's control) reads far above every limit
    of the chain-wide update."""
    kept = ref.kept_sweeps(T, 10)
    kw = {k: SETTINGS[k] for k in ("shrink", "no_jump", "p_bounds",
                                   "alpha_bounds")}
    runs = {}
    for dt in (torch.float64, torch.bfloat16):
        run = ref.run_auto(cohort["R"], P_INIT, cohort["h2"], SEED, BURN_IN,
                           NUM_ITER, kept=kept, dtype=dt, **kw)
        run["keep"] = ref.chain_qc(run["corr_est"])
        runs[dt] = judged(cohort, run)
    own, ctl = runs[torch.float64], runs[torch.bfloat16]
    for k in ("p_gap", "h2_gap", "alpha_gap", "sigma2_gap"):
        assert own[k] < 1e-8, (k, own[k])
        assert ctl[k] > LIMITS[k], (k, ctl[k])
    assert own["lane_mismatch"] == own["window_mismatch"] == 0
    assert own["qc_mismatch"] == 0


def test_sigma2_path_without_the_mle(cohort):
    """use_MLE=False: the sigma2 each sweep sets is h2 / (m p)."""
    multi = auto(cohort, use_MLE=False, state_sweeps=[])
    m = cohort["m"]
    for c in multi:
        assert not any(k.startswith("state_") for k in c)
        p, h2, s = c["path_p_est"], c["path_h2_est"], c["path_sigma2_est"]
        assert np.isfinite(s).all() and len(s) == T
        want = np.float32(h2) / (np.float32(m) * np.float32(p))
        np.testing.assert_allclose(s, want, rtol=2e-7)


def test_the_keyword_leaves_every_output_bit_equal(cohort, every_sweep):
    """With the keyword off the keys are those without it, and every
    output is bit-equal to the run that keeps states; with it, the kept
    state of the last sweep holds the averages' sums."""
    off = auto(cohort)
    for a, b in zip(off, every_sweep):
        assert set(b) - set(a) == {"path_sigma2_est", *STATES}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["state_beta"].shape == (T, cohort["m"])
        assert b["state_beta"].dtype == np.float32
        sd = 1 / cohort["R"]["scale"]
        np.testing.assert_allclose(b["state_sum_beta"][-1] / NUM_ITER,
                                   a["beta_est"] * sd, rtol=1e-4, atol=1e-9)
        np.testing.assert_array_equal(
            b["state_sum_corr"][-1] / np.float32(NUM_ITER), a["corr_est"])


@pytest.mark.parametrize("mode,shards", [("shard_chains", 2),
                                         ("shard_blocks", 2),
                                         ("shard_blocks", 3)])
def test_kept_states_under_the_shard_modes(cohort, mode, shards):
    """The states, the sigma2 path and every other output under
    shard_chains and shard_blocks (CPU shards) are the unsharded run's,
    bit for bit."""
    kept = ref.kept_sweeps(T, 10)
    base = auto(cohort, state_sweeps=kept)
    got = auto(cohort, state_sweeps=kept, mesh=["cpu"] * shards,
               **{mode: True})
    for a, b in zip(base, got):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_the_counters(cohort, monkeypatch):
    """`auto.mle_exps` counts the profile's exponentials where they are
    evaluated: chains x (3 x 64 + 1) profile points x variants a sweep;
    `auto.diverged` the chains diverged at the call's end (two chains made
    to diverge at their first sweep)."""
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb
    from bigsnpr_tpu_torch.utils.profiling import recording

    m, NC = cohort["m"], len(P_INIT)
    with recording() as rec:
        multi = auto(cohort, burn_in=3, num_iter=2)
    assert rec.counters["auto.mle_exps"] == 5 * NC * 193 * (-(-m // 4) * 4)
    assert rec.counters["auto.diverged"] == 0
    assert all(np.isfinite(c["beta_est"]).all() for c in multi)

    orig = gb._AutoRun.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        gap0 = torch.full((NC,), torch.inf, dtype=self.dt)
        gap0[[1, 3]] = -1.0
        self.gap0 = gap0

    monkeypatch.setattr(gb._AutoRun, "__init__", init)
    with recording() as rec:
        multi = auto(cohort, burn_in=3, num_iter=2)
    assert rec.counters["auto.diverged"] == 2
    assert [bool(np.isnan(c["beta_est"]).all()) for c in multi] == \
        [False, True, False, True, False, False]


def _graph_against_direct(dev, NC=30, m=100_003):
    """`MleGraph` on `dev` against `_mle_alpha_profile` called directly,
    on new inputs at each replay: bit-equal, and the same count of
    exponentials a call."""
    from bigsnpr_tpu_torch.pgs import gibbs
    from bigsnpr_tpu_torch.utils.profiling import recording

    gen = torch.Generator(device=dev).manual_seed(3)
    lv = torch.randn(m, generator=gen, device=dev) * 0.5 - 1.4
    graph = gibbs.MleGraph((-0.5, 1.5), NC)
    for _ in range(3):
        s = torch.rand(NC, generator=gen, device=dev) * 1e-4 + 1e-6
        causal = torch.rand((NC, m), generator=gen, device=dev) < 0.03
        wts = torch.randint(0, 4, (NC, m), generator=gen,
                            device=dev).float() * causal
        b2 = torch.randn((NC, m), generator=gen, device=dev) ** 2 * 1e-4
        with recording() as rec:
            got = graph(s, wts, lv, b2)
        with recording() as want_rec:
            want = gibbs._mle_alpha_profile(s, wts, lv, b2, (-0.5, 1.5),
                                            rows=NC)
        for g, w in zip(got, want):
            assert g.device == w.device and torch.equal(g, w)
        assert rec.counters == want_rec.counters
        assert rec.counters["auto.mle_exps"] == NC * 193 * (-(-m // 4) * 4)
    assert graph.graph is not None


@pytest.mark.cuda
def test_the_graphed_mle_is_the_direct_one_on_the_card():
    """On a card the sampler's MLE replays a CUDA graph of
    `_mle_alpha_profile`: bit-equal to the direct call, on new inputs at
    each replay, at the benchmark cell's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _graph_against_direct(torch.device("cuda"))


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_the_graphed_mle_on_a_card_that_is_not_current():
    """A graph captured on cuda:1 while cuda:0 is the current device holds
    cuda:1's launches: every replay follows its new inputs."""
    _two_cards()
    with torch.cuda.device(0):
        _graph_against_direct(torch.device("cuda:1"))
        assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_shard_chains_over_two_cards(cohort):
    """shard_chains over cuda:0 and cuda:1 (a group each, each with its
    own graph of the MLE) against the unsharded run on cuda:0: every
    output, the sigma2 path and the kept states, bit for bit."""
    _two_cards()
    kept = ref.kept_sweeps(T, 10)
    base = auto(cohort, state_sweeps=kept, device="cuda:0")
    got = auto(cohort, state_sweeps=kept, device="cuda:0",
               mesh=["cuda:0", "cuda:1"], shard_chains=True)
    assert all(np.isfinite(c["beta_est"]).all() for c in base)
    for a, b in zip(base, got):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
