"""The plain references against the program's CPU path at a small size:
what the reference works out again from the bytes agrees with what the
program derives."""

import numpy as np
import pytest
import torch

from benchlib import cohorts
from benchref import ldpred2 as ref
from benchref import pca as rpca

DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def ld_case():
    import bigsnpr_tpu_torch as bp

    torch.set_num_threads(min(4, torch.get_num_threads()))
    n, m = 1500, 2000
    packed, sizes = cohorts.ld_cohort(torch, DEV, n, m, 31, 100, 300, 0.995,
                                      (0.05, 0.5), 0.05, 0.01, 3)
    y = cohorts.phenotype(torch, packed, n, 31, 0.4, 80)
    train = np.sort(np.random.default_rng(1).permutation(n)[:1100])
    pack = bp.GenoPack(packed=packed.numpy(), n=n)
    return bp, packed, n, m, sizes, y, train, pack


def test_gwas(ld_case):
    bp, packed, n, m, _, y, train, pack = ld_case
    g = bp.big_univLinReg(pack, y[train], ind_row=train, device=DEV)
    b, se = ref.gwas(packed, n, torch.as_tensor(train), y[train])
    assert np.max(np.abs(b - g["estim"]) / se) < 1e-4
    assert np.max(np.abs(se - g["std.err"]) / se) < 1e-4


def test_ld_ldsc_and_blocks(ld_case):
    bp, packed, n, m, _, y, train, pack = ld_case
    corr = bp.snp_cor(pack, ind_row=train, size=100, thr_r2=0.01,
                      device=DEV)
    i, j, r = ref.ld(packed, n, torch.as_tensor(train), 100, 0.01)
    up = corr.upper.tocoo()
    off = up.row != up.col
    prog = dict(zip(zip(up.row[off], up.col[off]), up.data[off]))
    mine = dict(zip(zip(i, j), r))
    assert set(prog) == set(mine)
    assert max(abs(prog[k] - mine[k]) for k in mine) < 1e-12
    ls = ref.ld_scores(i, j, r, m)
    np.testing.assert_allclose(ls, corr.col_sums_sq(), rtol=1e-12)
    g = bp.big_univLinReg(pack, y[train], ind_row=train, device=DEV)
    df = {"beta": g["estim"], "beta_se": g["std.err"],
          "n_eff": np.full(m, 1100.0)}
    h2 = bp.snp_ldsc2(corr, df)["h2"]
    mine_h2 = ref.ldsc_h2(ls, m, (g["estim"] / g["std.err"]) ** 2,
                          df["n_eff"])
    assert mine_h2 == pytest.approx(h2, rel=1e-10)
    np.testing.assert_array_equal(ref.exact_blocks(i, j, m),
                                  bp.auto_blocks(corr))


def test_scaling_and_scores(ld_case):
    bp, packed, n, m, _, _, train, pack = ld_case
    sc = bp.bed_scaleBinom(pack, device=DEV)
    c, s = rpca.scaling(packed, n)
    np.testing.assert_allclose(c.numpy(), sc["center"], rtol=1e-12)
    np.testing.assert_allclose(s.numpy(), sc["scale"], rtol=1e-12)
    beta = np.random.default_rng(2).standard_normal(m)
    test = np.setdiff1d(np.arange(n), train)
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        got = bp.snp_PRS(pack.subset(ind_row=test, device=DEV), beta,
                         device=DEV)[:, 0]
    assert ref.rel_gap(got, ref.scores(packed, n, test, beta)[:, 0]) < 1e-5


def test_round_to():
    from benchref.common import round_to

    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-12, -3.0e-5])
    t = round_to(x, "tf32")
    assert t[0] == 1.0 and t[1] == 1.0      # ties to even
    assert t[2] == 1 + 2**-10
    assert abs(t[3] + 3.0e-5) / 3.0e-5 < 2**-11
    assert round_to(x, "bf16")[1] == 1.0


def test_grid_replay_matches_the_program_at_every_kind_of_model(ld_case):
    """The replay with the program's draws gives the program's effects,
    for sparse and dense models and p = 1 among them."""
    bp, packed, n, m, _, y, train, pack = ld_case
    corr = bp.snp_cor(pack, ind_row=train, size=100, thr_r2=0.01,
                      device=DEV)
    g = bp.big_univLinReg(pack, y[train], ind_row=train, device=DEV)
    df = {"beta": g["estim"], "beta_se": g["std.err"],
          "n_eff": np.full(m, 1100.0)}
    grid = {"p": np.array([0.01, 1.0, 0.01, 1.0]),
            "h2": np.full(4, 0.4), "sparse": np.array([0, 0, 1, 1], bool)}
    got = bp.snp_ldpred2_grid(corr, df, grid, burn_in=2, num_iter=3,
                              blocks=bp.auto_blocks(corr), seed=7,
                              device=DEV)
    R = ref.derive(packed, n, train, y[train], 100, 0.01)
    want = ref.replay_grid(R, grid["h2"], grid["p"], grid["sparse"],
                           np.arange(4), 4, 7, 2, 3)
    for c in range(4):
        assert ref.rel_gap(got[:, c], want[c]) < 1e-4, c
