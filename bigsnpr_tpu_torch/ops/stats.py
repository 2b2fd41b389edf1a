"""Columnwise statistics, counts, and scaling.

Counterparts of the reference's single-pass C++/OpenMP column kernels:
  - snp_colstats: per-column sum & centered SSQ (reference src/colstats.cpp:8-35)
  - snp_counts:   4-level histograms (reference src/bed-fun.cpp:51-98)
  - snp_MAF / bed_MAF / scaling (reference R/binom-scaling.R)

Counts are integers decoded and summed on the device, block by block;
everything after them is float64 on the host, as in the JAX package. On a
byte-coded `DosagePack`, `snp_colstats` (and so `snp_MAF` and the
scalings) decodes the codes through code256 in float64 on the device;
`snp_counts` / `bed_MAF` take 2-bit codes only and raise AttributeError
there, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.unpack import unpack_codes
from bigsnpr_tpu_torch.ops.blocks import (byte_rows, decode_bytes, pick_block,
                                          present_bytes)


def snp_counts(pack, ind_row=None, block=None, device=None) -> np.ndarray:
    """(4, m) int32 counts of dosage 0/1/2/NA per variant.

    Reference: bed_counts / bed_col_counts_cpp (src/bed-fun.cpp:51-98).
    A DosagePack has no 2-bit codes: AttributeError, as in the JAX
    package."""
    if hasattr(pack, "code256"):
        raise AttributeError(
            "snp_counts: a DosagePack has no 2-bit codes ('packed'); use "
            "snp_colstats")
    dev = config.resolve_device(device)
    n, m = pack.n, pack.m
    block = block or 4 * pick_block(n)   # uint8 codes: 4x the f32 block
    packed = pack.device_packed(dev)
    ir = (None if ind_row is None
          else torch.as_tensor(np.asarray(ind_row), dtype=torch.long,
                               device=dev))
    out = torch.empty((4, m), dtype=torch.int32, device=dev)
    for b0 in range(0, m, block):
        codes = unpack_codes(packed[b0:b0 + block], n)
        if ir is not None:
            codes = codes[:, ir]
        for r, code in enumerate((3, 2, 0, 1)):   # dosage 0, 1, 2, NA
            out[r, b0:b0 + block] = (codes == code).sum(1, dtype=torch.int32)
    return out.cpu().numpy()


bed_counts = snp_counts


def snp_colstats(pack, ind_row=None, dtype=np.float64, device=None):
    """Per-column {sumX, denoX, nona} over non-missing entries.

    sumX = sum(x), denoX = sum(x^2) - sumX^2/nona (centered SSQ).
    Reference: snp_colstats (src/colstats.cpp:8-35, no-NA assumption) and
    bed_colstats (src/bed-fun.cpp:9-46, NA-aware). Always NA-aware; on
    complete data the two coincide. A DosagePack's dosages are decoded
    through its code256 (NaN = missing) and summed in float64."""
    if hasattr(pack, "code256"):
        return _dosage_colstats(pack, ind_row=ind_row, device=device)
    counts = snp_counts(pack, ind_row=ind_row, device=device).astype(dtype)
    c0, c1, c2, cna = counts
    nona = c0 + c1 + c2
    sumX = c1 + 2 * c2
    ssq = c1 + 4 * c2
    denoX = ssq - sumX**2 / np.maximum(nona, 1)
    return {"sumX": sumX, "denoX": denoX, "nona": nona.astype(np.int64)}


def _dosage_colstats(pack, ind_row=None, device=None):
    """colstats of a DosagePack: float64 dosages decoded on the device
    (code256 gather) block by block, NaN skipped (the JAX package's host
    nansum over `to_dosage()`)."""
    dev = config.resolve_device(device)
    n, m = pack.n, pack.m
    codes = pack.device_codes(dev)
    table = torch.as_tensor(np.asarray(pack.code256, np.float64),
                            device=dev)
    ir = (None if ind_row is None
          else torch.as_tensor(np.asarray(ind_row), dtype=torch.long,
                               device=dev))
    block = byte_rows(n)
    out = torch.empty((3, m), dtype=torch.float64, device=dev)
    for b0 in range(0, m, block):
        c = codes[b0:b0 + block]
        if ir is not None:
            c = c[:, ir]
        d = decode_bytes(c, table)
        ok = present_bytes(c, table)
        out[0, b0:b0 + block] = d.sum(1)
        out[1, b0:b0 + block] = (d * d).sum(1)
        out[2, b0:b0 + block] = ok.sum(1)
    sumX, ssq, nona = out.cpu().numpy()
    denoX = ssq - sumX**2 / np.maximum(nona, 1)
    return {"sumX": sumX, "denoX": denoX, "nona": nona.astype(np.int64)}


def snp_MAF(pack, ind_row=None, nploidy: int = 2, device=None) -> np.ndarray:
    """Minor allele frequency (reference snp_MAF, R/binom-scaling.R:94-106),
    divided by the non-missing count (bed_MAF semantics)."""
    s = snp_colstats(pack, ind_row=ind_row, device=device)
    af = s["sumX"] / np.maximum(nploidy * s["nona"], 1)
    return np.minimum(af, 1 - af)


def bed_MAF(pack, ind_row=None, device=None) -> dict:
    """Reference bed_MAF (R/binom-scaling.R:203-222): {ac, mac, af, maf, N}
    as a dict of numpy columns. A DosagePack raises AttributeError
    (`snp_counts`), as in the JAX package."""
    counts = snp_counts(pack, ind_row=ind_row, device=device)
    ac = counts[1] + 2 * counts[2]
    nb_nona = counts[:3].sum(0)
    af = ac / np.maximum(2 * nb_nona, 1)
    return {"ac": ac, "mac": np.minimum(ac, 2 * nb_nona - ac),
            "af": af, "maf": np.minimum(af, 1 - af), "N": nb_nona}


def snp_scaleBinom(nploidy: int = 2):
    """Binomial(nploidy, p) scaling: center = nploidy*af,
    scale = sqrt(nploidy*af*(1-af)) (reference R/binom-scaling.R:62-77)."""

    def fun(pack, ind_row=None, device=None):
        s = snp_colstats(pack, ind_row=ind_row, device=device)
        af = s["sumX"] / np.maximum(nploidy * s["nona"], 1)
        return {"center": nploidy * af,
                "scale": np.sqrt(nploidy * af * (1 - af))}

    return fun


def bed_scaleBinom(pack, ind_row=None, device=None):
    """Reference bed_scaleBinom (R/binom-scaling.R:133-142), NA-aware af."""
    return snp_scaleBinom(2)(pack, ind_row=ind_row, device=device)


def snp_scaleAlpha(alpha: float = -1.0):
    """center = 2p, scale = (2p(1-p))^(-alpha/2)
    (reference snp_scaleAlpha, R/binom-scaling.R:12-27)."""

    def fun(pack, ind_row=None, device=None):
        s = snp_colstats(pack, ind_row=ind_row, device=device)
        af = s["sumX"] / np.maximum(2 * s["nona"], 1)
        return {"center": 2 * af, "scale": (2 * af * (1 - af)) ** (-alpha / 2)}

    return fun


def as_scaling_fun(center, scale, ind_col=None):
    """Wrap explicit center/scale vectors as a fun_scaling
    (bigstatsr::as_scaling_fun)."""
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)

    def fun(pack, ind_row=None, device=None):
        if pack.m == len(center):
            return {"center": center, "scale": scale}
        raise ValueError("as_scaling_fun: length mismatch with pack")

    return fun
