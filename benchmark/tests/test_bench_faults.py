"""With the timed path broken underneath, a run's `correct` comes out
false: for each fault a cell can have (one card, so no exchange between
chips): a step that returns its state unchanged, half of the batch left
out with the mean taken over the rest, an answer altered where it is
produced. The harness runs as it does on the card, on the CPU."""

import numpy as np
import pytest
import torch


def _pca_state_unchanged(mp):
    from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator

    mp.setattr(GenoOperator, "power_dev",
               lambda self, V: (self.cprod_dev(V), V))


def _pca_half_the_samples(mp):
    import bigsnpr_tpu_torch.linalg.randomsvd as rs

    orig = rs.call_scaling

    def half(fun, pack, ind_row, device):
        return orig(fun, pack, np.arange(pack.n // 2), device)

    mp.setattr(rs, "call_scaling", half)


def _pca_answer_altered(mp):
    import bigsnpr_tpu_torch.linalg.randomsvd as rs

    orig = rs._device_krylov

    def altered(*a, **kw):
        d, u, v, niter = orig(*a, **kw)
        d = d.copy()
        d[0] *= 1.001
        return d, u, v, niter

    mp.setattr(rs, "_device_krylov", altered)


def _sweep_state_unchanged(mp):
    from bigsnpr_tpu_torch.ops import gibbs_kernels

    def unchanged(sb, dp, cb, bh, C2, C4, s1, u, z, iop, p, sparse, shrink,
                  no_jump, per_block=False):
        NC = cb.shape[0]
        z = torch.zeros_like(cb)
        w = torch.zeros((NC, sb.nblk) if per_block else (NC,),
                        dtype=cb.dtype)
        return cb.clone(), torch.zeros_like(cb, dtype=torch.bool), z, z, z, \
            w, w.clone()

    mp.setattr(gibbs_kernels, "sweep", unchanged)


def _scores_altered(mp):
    import bigsnpr_tpu_torch as bp

    orig = bp.snp_prodVec

    def altered(*a, **kw):
        out = np.array(orig(*a, **kw), dtype=np.float64)
        out.reshape(len(out), -1)[0] += 1.0
        return out

    mp.setattr(bp, "snp_prodVec", altered)


def _grid_half_the_models(mp):
    import bigsnpr_tpu_torch as bp

    orig = bp.snp_ldpred2_grid

    def half(corr, df_beta, grid, **kw):
        h = len(grid["p"]) // 2
        out = orig(corr, df_beta, {k: np.asarray(v)[:h] for k, v in
                                   grid.items()}, **kw)
        return np.concatenate([out, out], axis=1)[:, :len(grid["p"])]

    mp.setattr(bp, "snp_ldpred2_grid", half)


FAULTS = [
    ("pca_ukbb.randomsvd", _pca_state_unchanged),
    ("pca_ukbb.randomsvd", _pca_half_the_samples),
    ("pca_ukbb.randomsvd", _pca_answer_altered),
    ("ldpred2_hm3.grid", _sweep_state_unchanged),
    ("ldpred2_hm3.grid", _grid_half_the_models),
    ("ldpred2_hm3.grid", _scores_altered),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_makes_the_run_incorrect(cell, fault, small_run,
                                         monkeypatch):
    fault(monkeypatch)
    line, checks = small_run(cell)
    assert line["correct"] is False
    assert any(not v <= lim for _, v, lim in checks)
