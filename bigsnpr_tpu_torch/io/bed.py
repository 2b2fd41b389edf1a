"""PLINK .bed/.bim/.fam I/O.

The .bed body (after the 3 magic bytes) in SNP-major mode IS the canonical
packed format, so reading is a zero-copy memmap (the reference instead
inflates 2-bit codes to a byte-per-genotype FBM, reference
src/read-plink.cpp:13-56). The .fam/.bim text files are parsed without
pandas into dicts of numpy columns.

Magic bytes 0x6c 0x1b 0x01 (reference src/bed-acc-xptr.cpp:14-35).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from bigsnpr_tpu_torch.core.genotypes import GenoPack, FAM_COLS, MAP_COLS
from bigsnpr_tpu_torch.utils.assertions import check_args

_BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


def _typed(values):
    """A text column as int64, else float64, else str (pandas' inference
    for a whitespace table)."""
    for dtype in (np.int64, np.float64):
        try:
            return np.array(values, dtype=dtype)
        except ValueError:
            pass
    return np.array(values, dtype=str)


def _read_table(path, names) -> dict:
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    for i, r in enumerate(rows):
        if len(r) != len(names):
            raise ValueError(f"{path}: line {i + 1} has {len(r)} fields, "
                             f"expected {len(names)}")
    cols = list(zip(*rows)) if rows else [()] * len(names)
    return {name: _typed(list(col)) for name, col in zip(names, cols)}


def _write_table(path, cols: dict) -> None:
    def fmt(v):
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        return str(v)

    keys = list(cols)
    with open(path, "w") as f:
        for row in zip(*(cols[k] for k in keys)):
            f.write("\t".join(fmt(v) for v in row) + "\n")


def read_bed(bedfile, mmap: bool = True) -> GenoPack:
    """Read .bed (+ sibling .bim/.fam) into a GenoPack.

    Reference: snp_readBed (R/read-plink.R:27-65) + bed() class
    (R/bed-class.R:65-134), collapsed into one zero-inflation step."""
    bedfile = Path(bedfile)
    fam = _read_table(bedfile.with_suffix(".fam"), FAM_COLS)
    bim = _read_table(bedfile.with_suffix(".bim"), MAP_COLS)
    n, m = len(fam[FAM_COLS[0]]), len(bim[MAP_COLS[0]])
    nb = (n + 3) // 4

    with open(bedfile, "rb") as f:
        magic = f.read(3)
    if magic != _BED_MAGIC:
        raise ValueError(f"{bedfile} is not a SNP-major .bed file (bad magic {magic!r}).")
    expected = 3 + m * nb
    actual = os.path.getsize(bedfile)
    if actual != expected:
        raise ValueError(f"{bedfile}: expected {expected} bytes, found {actual}.")

    if mmap:
        packed = np.memmap(bedfile, dtype=np.uint8, mode="r", offset=3, shape=(m, nb))
    else:
        packed = np.fromfile(bedfile, dtype=np.uint8, offset=3).reshape(m, nb)
    return GenoPack(packed=packed, n=n, fam=fam, map=bim)


@check_args()
def snp_readBed(bedfile, backingfile=None, mmap: bool = True) -> GenoPack:
    """Read and (optionally) persist as a `.gpk` store (reference
    snp_readBed)."""
    pack = read_bed(bedfile, mmap=mmap)
    if backingfile is not None:
        pack.save(backingfile)
    return pack


def snp_writeBed(pack: GenoPack, bedfile) -> str:
    """Write a GenoPack back to .bed/.bim/.fam.

    Reference: snp_writeBed (R/write-plink.R:15-44, src/write-plink.cpp:13-52).
    Round-trips byte-identically for data read from a .bed."""
    bedfile = Path(bedfile)
    with open(bedfile, "wb") as f:
        f.write(_BED_MAGIC)
        src = pack.packed
        step = max(1, (256 << 20) // max(src.shape[1], 1))
        for r0 in range(0, src.shape[0], step):
            np.ascontiguousarray(src[r0:r0 + step]).tofile(f)
    if pack.fam is not None:
        _write_table(bedfile.with_suffix(".fam"), pack.fam)
    if pack.map is not None:
        _write_table(bedfile.with_suffix(".bim"), pack.map)
    return str(bedfile)


def snp_readBed2(bedfile, backingfile=None, ind_row=None, ind_col=None,
                 mmap: bool = True, device=None) -> GenoPack:
    """Read a row/col subset of a .bed (reference snp_readBed2,
    R/read-plink.R:72-111); the repack runs with torch on `device`; with
    `backingfile`, persisted as a `.gpk` store."""
    pack = read_bed(bedfile, mmap=mmap)
    if ind_row is not None or ind_col is not None:
        pack = pack.subset(ind_row=ind_row, ind_col=ind_col, device=device)
    if backingfile is not None:
        pack.save(backingfile)
    return pack


bed = read_bed  # the reference's bed() constructor maps a bedfile


def snp_attachExtdata(name: str = "example.bed") -> GenoPack:
    """Attach the reference's bundled test dataset if available.

    Reference: snp_attachExtdata (R/read-plink.R:152-158), data at
    inst/extdata/example{,-missing}.bed (517 x 4,542) of the reference
    checkout that the BIGSNPR_REFERENCE environment variable names."""
    base = os.environ.get("BIGSNPR_REFERENCE", "")
    if base:
        p = Path(base) / "inst" / "extdata" / name
        if p.exists():
            return read_bed(p)
    raise FileNotFoundError(
        f"reference extdata {name} not found; set BIGSNPR_REFERENCE or use "
        "snp_fake().")
