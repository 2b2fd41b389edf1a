"""The bigSNP-equivalent container.

A `GenoPack` bundles a 2-bit-packed genotype matrix (variant-major, the
PLINK .bed layout minus its 3-byte header) with sample (`fam`) and variant
(`map`) metadata — the analog of the reference's
bigSNP = {genotypes: FBM.code256, fam, map} (reference R/bigSNP-class.R:17-36),
with column contracts from reference R/utils.R:49-53.

`fam` and `map` are dicts of numpy columns under the same column names as
the JAX package's DataFrames (`FAM_COLS`, `MAP_COLS`); `to_frame` turns
one into a pandas DataFrame for callers that want it.

The `.gpk` store (`GenoPack.save`, `snp_attach`) is the JAX package's:
`packed.bin` (the packed bytes) and `meta.json` byte for byte, and `fam` /
`map` as `fam.parquet` / `map.parquet`, written and read with pyarrow,
imported only when a pack carries them (port DEVIATIONS #9). `snp_attach`
also attaches a reference bigsnpr `.rds` + `.bk` pair.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
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


def upload_rows(src, dev) -> torch.Tensor:
    """A (rows, width) uint8 host array (numpy or a memmap) as a tensor on
    `dev`, copied in row chunks into one preallocated tensor, so a
    memory-mapped array is never copied whole on the host."""
    m, w = src.shape
    out = torch.empty((m, w), dtype=torch.uint8, device=dev)
    step = max(1, _CHUNK_BYTES // max(w, 1))
    for r0 in range(0, m, step):
        # a read-only memmap slice is copied to a writable buffer
        part = np.require(src[r0:r0 + step], requirements=["C", "W"])
        out[r0:r0 + len(part)].copy_(torch.from_numpy(part))
    return out


def write_rows(src, path) -> None:
    """A (rows, width) host array written to `path` in row chunks."""
    step = max(1, _CHUNK_BYTES // max(src.shape[1], 1))
    with open(path, "wb") as f:
        for r0 in range(0, src.shape[0], step):
            np.ascontiguousarray(src[r0:r0 + step]).tofile(f)


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
            self._device_cache[key] = upload_rows(self.packed, dev)
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

    # -- persistence ---------------------------------------------------------
    def save(self, path: str | os.PathLike) -> str:
        """The `.gpk` store (see the module note): packed.bin in row chunks
        (a memory-mapped pack is never read whole), meta.json, and fam /
        map as parquet where the pack has them; returns its path."""
        path = Path(path)
        if path.suffix != ".gpk":
            path = path.with_suffix(".gpk")
        path.mkdir(parents=True, exist_ok=True)
        write_rows(self.packed, path / "packed.bin")
        meta = {"n": int(self.n), "m": int(self.m), "version": 1}
        (path / "meta.json").write_text(json.dumps(meta))
        if self.fam is not None:
            _write_parquet(path / "fam.parquet", self.fam)
        if self.map is not None:
            _write_parquet(path / "map.parquet", self.map)
        return str(path)


def _write_parquet(path, cols: dict) -> None:
    """A dict of columns as a parquet file (pyarrow, imported here)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({k: np.asarray(v) for k, v in cols.items()}),
                   path)


def _read_parquet(path) -> dict:
    """A parquet file (the port's or one pandas wrote) as a dict of numpy
    columns, strings as str arrays; a stored pandas index is dropped."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    out = {}
    for name, col in zip(table.column_names, table.columns):
        if name.startswith("__index_level_"):
            continue
        if pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
            vals = col.to_pylist()
            out[name] = (np.array(vals, dtype=str) if None not in vals
                         else np.array(vals, dtype=object))
        else:
            out[name] = col.to_numpy()
    return out


def snp_attach(path: str | os.PathLike, mmap: bool = True) -> "GenoPack":
    """Re-attach a saved GenoPack (reference snp_attach,
    R/read-plink.R:128-139): a `.gpk` store, the port's or the JAX
    package's, or a reference bigsnpr `.rds` + `.bk` pair
    (`snp_attach_rds`)."""
    path = Path(path)
    if path.suffix == ".rds":
        return snp_attach_rds(path, mmap=mmap)
    meta = json.loads((path / "meta.json").read_text())
    n, m = meta["n"], meta["m"]
    nb = (n + 3) // 4
    if mmap:
        packed = np.memmap(path / "packed.bin", dtype=np.uint8, mode="r",
                           shape=(m, nb))
    else:
        packed = np.fromfile(path / "packed.bin",
                             dtype=np.uint8).reshape(m, nb)
    fam = (_read_parquet(path / "fam.parquet")
           if (path / "fam.parquet").exists() else None)
    map_ = (_read_parquet(path / "map.parquet")
            if (path / "map.parquet").exists() else None)
    return GenoPack(packed=packed, n=n, fam=fam, map=map_)


def snp_save(pack: "GenoPack", path: str | os.PathLike) -> str:
    return pack.save(path)


def snp_attach_rds(rds_path, bk_path=None, mmap: bool = True):
    """Attach a reference bigsnpr/bigstatsr `.rds` + `.bk` pair
    (reference snp_attach, R/read-plink.R:128-139), including the
    relocatable backingfile fix-up (:135-137): the stored absolute path
    is replaced by the `.bk` of the same basename next to the `.rds`.

    The `.bk` is the FBM byte matrix, column-major (nrow x ncol) on disk,
    i.e. variant-major rows when viewed as (ncol, nrow). Hard-call code
    tables (all values in {0, 1, 2, NA}) repack to a 2-bit GenoPack; any
    other code256 (e.g. CODE_DOSAGE) attaches as a `DosagePack` on the
    `.bk` bytes with the original table, as in the JAX package."""
    from bigsnpr_tpu_torch.utils.rds import REnv, read_rds, to_frame, unwrap

    rds_path = Path(rds_path)
    obj = read_rds(rds_path)
    cls = unwrap(getattr(obj, "attrs", {}).get("class"))
    cls = [cls] if isinstance(cls, str) else list(cls or [])
    fam = map_ = None
    if "bigSNP" in cls:
        names = list(unwrap(obj.attrs["names"]))
        parts = dict(zip(names, obj.value))
        fbm = parts["genotypes"]
        if parts.get("fam") is not None:
            fam = to_frame(parts["fam"])
        if parts.get("map") is not None:
            map_ = to_frame(parts["map"])
    else:
        fbm = obj  # bare FBM.code256

    env = fbm.attrs[".xData"]
    assert isinstance(env, REnv), "not a RefClass FBM object"

    def field_of(name):
        return unwrap(env.frame[f".->{name}"])

    nrow = int(np.asarray(field_of("nrow"))[0])
    ncol = int(np.asarray(field_of("ncol"))[0])
    code256 = np.asarray(field_of("code256"), dtype=np.float64)
    stored_bk = field_of("backingfile")
    stored_bk = stored_bk[0] if isinstance(stored_bk, list) else stored_bk

    if bk_path is None:
        # basename may carry Windows separators from the creator machine
        base = str(stored_bk).replace("\\", "/").rsplit("/", 1)[-1]
        cand = rds_path.parent / base
        bk_path = cand if cand.exists() else Path(str(stored_bk))
    bk_path = Path(bk_path)
    if not bk_path.exists():
        raise FileNotFoundError(f"backingfile not found: {bk_path}")
    expect = nrow * ncol
    actual = bk_path.stat().st_size
    if actual < expect:
        raise ValueError(f"backingfile too small: {actual} < {expect}")

    codes = np.memmap(bk_path, dtype=np.uint8, mode="r", shape=(ncol, nrow))
    if not mmap:
        codes = np.asarray(codes)
    finite = code256[np.isfinite(code256)]
    if not np.isin(finite, (0.0, 1.0, 2.0)).all():
        from bigsnpr_tpu_torch.core.dosage import DosagePack

        return DosagePack(codes=codes, n=nrow, code256=code256, fam=fam,
                          map=map_)
    lut = unpack.np_dosage_to_codes(code256[None, :])[0]  # byte -> 2 bits
    out = np.empty((ncol, (nrow + 3) // 4), dtype=np.uint8)
    step = max(1, (1 << 24) // max(nrow, 1))   # ~16 MB chunks
    for j0 in range(0, ncol, step):
        out[j0:j0 + step] = unpack.np_pack_codes(lut[codes[j0:j0 + step]])
    return GenoPack(packed=out, n=nrow, fam=fam, map=map_)


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
    out = torch.empty((len(rows), nb_out), dtype=torch.uint8,
                      device=src.device)
    step = max(1, _CHUNK_BYTES // max(4 * n_out, 1))
    for r0 in range(0, len(rows), step):
        r = rows[r0:r0 + step].long()
        # (k, n_out) codes; the pad positions of the last byte get code 0
        out[r0:r0 + len(r)] = unpack.pack_codes((src[r][:, byte] >> shift)
                                                & 3)
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
