"""The six entry points that refused the JAX package's `DosagePack` before
slice 6c (the test keeps its name): each now does on a DosagePack what
the JAX package's does. snp_colstats, snp_cprodVec, snp_prodVec and
snp_ld_scores agree with it (colstats 1e-12 relative, the byte products
1e-5 of max |JAX|, LD scores 1e-5); snp_counts and bed_MAF take 2-bit
codes only and raise AttributeError in both packages."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core.dosage import DosagePack
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop

torch.set_num_threads(2)


def dosage_pack(seed=0, n=37, m=11):
    """Byte codes over all 256 values: hard calls, NA, imputed hard calls,
    the 201 dosage levels and the tail 208..255 that CODE_DOSAGE reads as
    missing (NaN)."""
    rng = np.random.default_rng(seed)
    return DosagePack(codes=rng.integers(0, 256, (m, n), dtype=np.uint8),
                      n=n)


def _colstats(mod, p):
    s = mod.snp_colstats(p)
    return np.concatenate([s["sumX"], s["denoX"], s["nona"]])


ENTRY_POINTS = {
    "snp_counts": (lambda mod, p: mod.snp_counts(p), None),
    "snp_colstats": (_colstats, 1e-12),
    "bed_MAF": (lambda mod, p: mod.bed_MAF(p), None),
    "snp_cprodVec": (lambda mod, p: np.asarray(
        mod.snp_cprodVec(p, np.linspace(-1, 1, p.n))), 1e-5),
    "snp_prodVec": (lambda mod, p: np.asarray(
        mod.snp_prodVec(p, np.linspace(-1, 1, p.m))), 1e-5),
    "snp_ld_scores": (lambda mod, p: mod.snp_ld_scores(p, size=5), 1e-5),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_dosage_pack_is_refused(name):
    fn, tol = ENTRY_POINTS[name]
    jd = dosage_pack()
    pd_ = interop.dosage_from_numpy(jd.codes, jd.n)
    with pt.config.options(device="cpu"):
        if tol is None:
            with pytest.raises(AttributeError):
                fn(bt, jd)
            with pytest.raises(AttributeError, match="DosagePack"):
                fn(pt, pd_)
            return
        ref, out = fn(bt, jd), fn(pt, pd_)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()
