"""Port parity: lassosum2 on the blocked bands.

On the CPU `snp_lassosum2(blocks=...)` drives the sweep kernel's twin,
`lassosum_sweep_plain`, through `lassosum_cd_blocked`; both are held
against the JAX package's `snp_lassosum2(blocks=...)` (its XLA
`lassosum_cd_blocked` under vmap) on the same block-diagonal LD
(tests/test_blocked.py's fixture): betas within 1e-6 of max |beta| in
float32 and 1e-12 in float64 (the CD is deterministic and both packages
run its operations in one order; in float32 the twin fuses the dp
update's multiply-add, which the JAX package's CPU programs contract, and
rounds dp1 = pf delta + 1 twice, as they do, and agrees bit for bit),
the same num_iter for every grid point, the same grid and sparsity, and
the same stopping rules (converged, dfmax, diverged -> NaN). In float64 the JAX package's blocked CD fails to trace (its scan
mixes int32 and int64 indices under x64; ROADMAP queue 3), so the port is
held against its unblocked CD, the same function on block-diagonal LD."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bigsnpr_tpu.ops.corr import SparseLD as JaxSparseLD
from bigsnpr_tpu.pgs.lassosum2 import snp_lassosum2 as j_lassosum2
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import gibbs_kernels as gk

torch.set_num_threads(2)
TOL = {"float32": 1e-6, "float64": 1e-12}


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def blockdiag(seed=8, sizes=(40, 25, 60, 35), inflate=1.0):
    """tests/test_blocked.py's block-diagonal LD and sumstats; `inflate`
    scales the off-diagonal entries (> 1 makes the matrix indefinite, so
    the CD can diverge)."""
    rng = np.random.default_rng(seed)
    m = sum(sizes)
    mats = []
    for sz in sizes:
        A = rng.normal(size=(sz, sz + 30))
        C = np.corrcoef(np.cumsum(A, axis=0)) * inflate
        np.fill_diagonal(C, 1.0)
        mats.append(C)
    up = sp.triu(sp.block_diag(mats).tocsc()).tocsc()
    beta = rng.normal(0, 0.05, m)
    df_beta = {"beta": beta, "beta_se": np.full(m, 0.05),
               "n_eff": rng.uniform(8000, 12000, m)}
    port = interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)
    return JaxSparseLD(upper=up), port, df_beta, np.asarray(sizes)


def jax_blocks(dtype, sizes):
    """The blocks argument of the JAX reference run (see the docstring)."""
    return None if dtype == "float64" else sizes


def compare(jres, pres, tol):
    jb, jg = jres
    pb, pg = pres
    np.testing.assert_array_equal(pg["num_iter"], jg["num_iter"].to_numpy())
    for key in ("lambda", "delta", "sparsity"):
        np.testing.assert_array_equal(pg[key], jg[key].to_numpy())
    np.testing.assert_array_equal(np.isnan(pb), np.isnan(jb))
    ok = np.isfinite(jb)
    assert np.abs(pb[ok] - jb[ok]).max() <= tol * np.abs(jb[ok]).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lassosum2_blocked_matches_jax(dtype):
    jc, pc, df_beta, sizes = blockdiag()
    kw = dict(nlambda=8, maxiter=300, dtype=dtype)
    jres = j_lassosum2(jc, df_beta, blocks=jax_blocks(dtype, sizes), **kw)
    before = dict(gk.launches)
    pres = pt.snp_lassosum2(pc, df_beta, blocks=sizes, **kw)
    assert gk.launches == before                      # CPU: the twin
    compare(jres, pres, TOL[dtype])
    assert pres[0].shape == (sizes.sum(), 4 * 8)
    assert (pres[1]["num_iter"] < 300).all()          # all converged


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lassosum2_stopping_rules_match_jax(dtype):
    """Indefinite LD makes the low-delta points diverge (NaN columns); a
    small dfmax stops the dense end of the path; maxiter caps the rest.
    The per-point iteration counts and the NaN pattern are the JAX
    package's."""
    jc, pc, df_beta, sizes = blockdiag(seed=3, inflate=1.6)
    kw = dict(nlambda=6, maxiter=60, dfmax=50, delta=(1e-4, 0.05, 2.0),
              dtype=dtype)
    jres = j_lassosum2(jc, df_beta, blocks=jax_blocks(dtype, sizes), **kw)
    pres = pt.snp_lassosum2(pc, df_beta, blocks=sizes, **kw)
    compare(jres, pres, TOL[dtype])
    it = pres[1]["num_iter"]
    assert np.isnan(pres[0]).any() and (it < 60).any()


def test_check_interval_does_not_change_the_result(monkeypatch):
    """Grid points freeze once done, so reading the done flags every k
    sweeps gives the same betas and counts as reading them every sweep."""
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb

    def run(every):
        monkeypatch.setattr(pgb, "LASSO_CHECK_EVERY", every)
        return pgb.lassosum_cd_blocked(sb, bh, pf, lam, delta, 1e9, 1e-5, 200)

    _, pc, df_beta, sizes = blockdiag(seed=5)
    bb = pgb.build_block_bands(pc, sizes)
    sb = bb.device_put("cpu")
    bh = np.asarray(df_beta["beta"]) / 0.5
    pf = np.ones(bb.m)
    lam, delta = np.array([0.2, 0.05, 0.01]), np.array([0.1, 0.1, 1.0])
    a, b = run(1), run(7)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0, equal_nan=True)
    assert torch.equal(a[1], b[1])
    assert len(set(a[1].tolist())) > 1                # points stop apart


def test_unblocked_raises():
    """blocks=None (slice 5) runs the unblocked CD, one band over every
    variant: on block-diagonal LD it is the blocked CD, the same rows in
    the same order (num_iter equal, betas within 1e-6)."""
    _, pc, df_beta, sizes = blockdiag()
    un = pt.snp_lassosum2(pc, df_beta, nlambda=6, maxiter=200)
    bl = pt.snp_lassosum2(pc, df_beta, nlambda=6, maxiter=200, blocks=sizes)
    np.testing.assert_array_equal(un[1]["num_iter"], bl[1]["num_iter"])
    np.testing.assert_allclose(un[0], bl[0], rtol=1e-6, atol=1e-12,
                               equal_nan=True)


def test_seq_log_matches_jax():
    from bigsnpr_tpu.pgs.lassosum2 import seq_log as j_seq_log

    np.testing.assert_array_equal(pt.seq_log(0.1, 30.0, 50),
                                  j_seq_log(0.1, 30.0, 50))
