"""The port's entry points that do not take byte-coded dosages yet refuse
the JAX package's `DosagePack` with NotImplementedError naming ROADMAP
slice 6c, as `snp_cor` does, instead of failing on a missing
`device_packed`."""

import numpy as np
import pytest

from bigsnpr_tpu.core.dosage import DosagePack
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.ops import ldscores, matvec, stats


def dosage_pack(seed=0, n=37, m=11):
    rng = np.random.default_rng(seed)
    return DosagePack(codes=rng.integers(0, 256, (m, n), dtype=np.uint8),
                      n=n)


ENTRY_POINTS = {
    "snp_counts": lambda p: stats.snp_counts(p),
    "snp_colstats": lambda p: stats.snp_colstats(p),
    "bed_MAF": lambda p: stats.bed_MAF(p),
    "snp_cprodVec": lambda p: matvec.snp_cprodVec(p, np.ones(p.n)),
    "snp_prodVec": lambda p: matvec.snp_prodVec(p, np.ones(p.m)),
    "snp_ld_scores": lambda p: ldscores.snp_ld_scores(p),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_dosage_pack_is_refused(name):
    with pt.config.options(device="cpu"):
        with pytest.raises(NotImplementedError,
                           match=f"{name} on a DosagePack: ROADMAP slice 6c"):
            ENTRY_POINTS[name](dosage_pack())
