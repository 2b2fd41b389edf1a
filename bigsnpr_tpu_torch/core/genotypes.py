"""The bigSNP-equivalent container.

A `GenoPack` bundles a 2-bit-packed genotype matrix (variant-major, the
PLINK .bed layout minus its 3-byte header) with sample (`fam`) and variant
(`map`) metadata — the analog of the reference's
bigSNP = {genotypes: FBM.code256, fam, map} (reference R/bigSNP-class.R:17-36),
with column contracts from reference R/utils.R:49-53.

`fam` and `map` are dicts of numpy columns under the same column names as
the JAX package's DataFrames (`FAM_COLS`, `MAP_COLS`); `to_frame` turns
one into a pandas DataFrame for callers that want it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core import unpack
from bigsnpr_tpu_torch.core.codes import BED_CODE_NUM

FAM_COLS = ["family.ID", "sample.ID", "paternal.ID", "maternal.ID", "sex", "affection"]
MAP_COLS = ["chromosome", "marker.ID", "genetic.dist", "physical.pos", "allele1", "allele2"]

# bytes per chunk of a host->device upload or a device repack
_CHUNK_BYTES = 256 << 20


def take_rows(cols: Optional[dict], idx) -> Optional[dict]:
    """Row subset of a dict of columns (None stays None)."""
    if cols is None:
        return None
    idx = np.asarray(idx)
    return {k: np.asarray(v)[idx] for k, v in cols.items()}


def to_frame(cols: dict):
    """A dict of columns (fam, map, a GWAS result) as a pandas DataFrame.
    Imports pandas; nothing on the package's main path calls it."""
    import pandas as pd

    return pd.DataFrame(cols)


@dataclass
class GenoPack:
    """2-bit packed genotype matrix + metadata.

    packed: (m, ceil(n/4)) uint8, variant-major — row j holds variant j's
            n genotypes, 4 per byte, low bits first.
    """

    packed: np.ndarray  # (m, nb) uint8 (numpy or numpy.memmap)
    n: int              # number of samples
    fam: Optional[dict] = None
    map: Optional[dict] = None
    _device_cache: dict = field(default_factory=dict, repr=False,
                                compare=False)
    _op_cache: object = field(default=None, repr=False, compare=False)

    @property
    def m(self) -> int:
        return self.packed.shape[0]

    @property
    def shape(self):
        """(n_samples, m_variants) — matches the reference's G orientation."""
        return (self.n, self.m)

    def device_packed(self, device=None) -> torch.Tensor:
        """The packed bytes as a (m, nb) uint8 tensor on `device` (cached
        per device). Uploads in row chunks into one preallocated tensor,
        so a memory-mapped pack is never copied whole on the host."""
        dev = config.resolve_device(device)
        key = str(dev)
        if key not in self._device_cache:
            src = self.packed
            m, nb = src.shape
            out = torch.empty((m, nb), dtype=torch.uint8, device=dev)
            step = max(1, _CHUNK_BYTES // max(nb, 1))
            for r0 in range(0, m, step):
                # a read-only memmap slice is copied to a writable buffer
                part = np.require(src[r0:r0 + step], requirements=["C", "W"])
                out[r0:r0 + len(part)].copy_(torch.from_numpy(part))
            self._device_cache[key] = out
        return self._device_cache[key]

    # -- dense views (host, for oracles/small data) --------------------------
    def to_dosage(self) -> np.ndarray:
        """(n, m) float64 dosage with NaN for missing (host-side)."""
        codes = unpack.np_unpack_codes(np.asarray(self.packed), self.n)
        return BED_CODE_NUM[codes].T  # (n, m)

    def subset(self, ind_row=None, ind_col=None, device=None) -> "GenoPack":
        """Materialized subset (reference snp_subset, R/subset-QC.R:33-98).

        A row subset is repacked with torch on `device`; the result keeps
        that tensor as its device copy, so it is not uploaded again."""
        ind_col = np.arange(self.m) if ind_col is None else np.asarray(ind_col)
        new_map = take_rows(self.map, ind_col)
        if ind_row is None:
            # column-only subset: plain row gather of packed bytes
            return GenoPack(packed=np.ascontiguousarray(
                np.asarray(self.packed)[ind_col]), n=self.n,
                fam=self.fam, map=new_map)
        ind_row = np.asarray(ind_row)
        dev = config.resolve_device(device)
        src = self.device_packed(dev)
        out = subset_packed(src, torch.as_tensor(ind_col, device=dev),
                            torch.as_tensor(ind_row, device=dev))
        sub = GenoPack(packed=out.cpu().numpy(), n=len(ind_row),
                       fam=take_rows(self.fam, ind_row), map=new_map)
        sub._device_cache[str(dev)] = out
        return sub


def subset_packed(src: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """(m, nb) packed -> (len(rows), ceil(len(cols)/4)) packed holding
    variants `rows` and samples `cols`, pad bits zero (the byte layout of
    `bigsnpr_tpu.native.bed_subset_pack`). Chunked over variants."""
    n_out = len(cols)
    nb_out = (n_out + 3) // 4
    cols = cols.long()
    byte = cols >> 2
    shift = ((cols & 3) * 2).to(torch.uint8)
    # pad the sample gather to whole bytes; pad positions get code 0
    pad = nb_out * 4 - n_out
    out_shift = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                             device=src.device)
    out = torch.empty((len(rows), nb_out), dtype=torch.uint8,
                      device=src.device)
    step = max(1, _CHUNK_BYTES // max(4 * n_out, 1))
    for r0 in range(0, len(rows), step):
        r = rows[r0:r0 + step].long()
        codes = (src[r][:, byte] >> shift) & 3              # (k, n_out)
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad))
        quads = codes.reshape(len(r), nb_out, 4) << out_shift
        out[r0:r0 + len(r)] = (quads[..., 0] | quads[..., 1]
                               | quads[..., 2] | quads[..., 3])
    return out


def snp_subset(pack: GenoPack, ind_row=None, ind_col=None) -> GenoPack:
    return pack.subset(ind_row, ind_col)


def snp_fake(n: int, m: int, *, seed: Optional[int] = None,
             maf_range=(0.05, 0.45), na_prob: float = 0.0) -> GenoPack:
    """Random test GenoPack (reference snp_fake, R/fake.R:27-54).

    Genotypes ~ Binomial(2, p_j) with p_j ~ U(maf_range); optional missing.
    Draws the same numpy stream as the JAX package's snp_fake, so one seed
    gives the same bytes in both."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(*maf_range, size=m)
    dosage = rng.binomial(2, p[:, None], size=(m, n)).astype(float)
    if na_prob > 0:
        dosage[rng.random((m, n)) < na_prob] = np.nan
    codes = unpack.np_dosage_to_codes(dosage)
    fam = {
        "family.ID": np.array([f"F{i}" for i in range(n)]),
        "sample.ID": np.array([f"S{i}" for i in range(n)]),
        "paternal.ID": np.zeros(n, dtype=np.int64),
        "maternal.ID": np.zeros(n, dtype=np.int64),
        "sex": rng.integers(1, 3, n), "affection": rng.integers(1, 3, n),
    }
    map_ = {
        "chromosome": np.ones(m, dtype=np.int64),
        "marker.ID": np.array([f"SNP{j}" for j in range(m)]),
        "genetic.dist": np.zeros(m),
        "physical.pos": np.arange(1, m + 1) * 1000,
        "allele1": np.full(m, "A"), "allele2": np.full(m, "C"),
    }
    return GenoPack(packed=unpack.np_pack_codes(codes), n=n, fam=fam, map=map_)
