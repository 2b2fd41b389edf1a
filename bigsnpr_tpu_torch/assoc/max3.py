"""MAX3 / CATT trend tests (reference R/MAX3.R:3-107).

A copy of `bigsnpr_tpu/assoc/max3.py`: the genotype counts of cases and
controls come from the port's `snp_counts` on the device, the trend
statistics are host numpy."""

from __future__ import annotations

import numpy as np

from bigsnpr_tpu_torch.assoc.mhtest import MHTest, chisq_log10_predictor
from bigsnpr_tpu_torch.ops.stats import snp_counts


def zcatt(counts_cases, counts_controls, val):
    """Z_CATT(x) per variant for each x in val (reference ZCATT,
    R/MAX3.R:3-28). counts_*: (3, m) genotype count matrices."""
    rj = np.asarray(counts_cases, dtype=np.float64)
    sj = np.asarray(counts_controls, dtype=np.float64)
    r = rj.sum(axis=0)
    s = sj.sum(axis=0)
    n = r + s
    phi = r / n
    num = rj * (1 - phi) - sj * phi
    pj = (rj + sj) / n
    coef = n * phi * (1 - phi)

    out = []
    for x in np.atleast_1d(val):
        x2 = np.array([0.0, x, 1.0])[:, None]
        num2 = (x2 * num).sum(axis=0)
        deno = (x2**2 * pj).sum(axis=0) - ((x2 * pj).sum(axis=0)) ** 2
        with np.errstate(invalid="ignore", divide="ignore"):
            out.append(num2 / np.sqrt(coef * deno))
    return np.stack(out, axis=1)  # (m, len(val))


def snp_MAX3(pack, y01_train, ind_train=None, val=(0, 0.5, 1),
             device=None) -> MHTest:
    """Reference snp_MAX3 (R/MAX3.R:81-107)."""
    y01 = np.asarray(y01_train)
    if ind_train is None:
        ind_train = np.arange(pack.n)
    ind_train = np.asarray(ind_train)
    assert len(y01) == len(ind_train)
    ind_cases = ind_train[y01 == 1]
    ind_controls = ind_train[y01 != 1]

    cc = snp_counts(pack, ind_row=ind_cases, device=device)[:3]
    ct = snp_counts(pack, ind_row=ind_controls, device=device)[:3]
    stats = zcatt(cc, ct, val)
    stats = np.nan_to_num(stats)
    return MHTest(score=(stats**2).max(axis=1),
                  predict=chisq_log10_predictor(1))
