"""2-bit genotype decode, in numpy (host) and torch (device).

A byte holds 4 genotypes, low bits first; 2-bit code c decodes to allele
count via {0: 2, 1: NA, 2: 1, 3: 0} (reference src/bed-acc.h:22-37).

Closed forms (branch-free):
    dosage(c) = 2 - ((c + 1) >> 1)   for c in {0, 2, 3}
    is_na(c)  = (c == 1)

The scaled accessor fuses (x - center) / scale with NA -> 0
(reference src/bed-acc.h:86-115: per-column 4-entry lookup, NA_VAL=0).
The numpy functions are copies of `bigsnpr_tpu/core/unpack.py`.
"""

from __future__ import annotations

import numpy as np
import torch

_SHIFTS = np.array([0, 2, 4, 6], dtype=np.uint8)


# ---------------------------------------------------------------------------
# torch versions (any device)
# ---------------------------------------------------------------------------

def unpack_codes(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(m, nb) uint8 -> (m, n) uint8 2-bit codes in {0,1,2,3}.

    Trailing pad bits of the last byte are dropped (PLINK zero-pads,
    which would otherwise decode to dosage 2)."""
    m, nb = packed.shape
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    g = (packed[:, :, None] >> shifts) & 3
    return g.reshape(m, nb * 4)[:, :n]


def codes_to_dosage(codes: torch.Tensor, dtype=torch.float32):
    """2-bit codes -> (dosage in {0,1,2} as dtype, NA mask); NA positions
    get dosage 0 in the returned array."""
    na = codes == 1
    d = (2 - ((codes.to(torch.int32) + 1) >> 1)).to(dtype)
    return torch.where(na, torch.zeros((), dtype=dtype, device=d.device),
                       d), na


def unpack_dosage(packed: torch.Tensor, n: int, dtype=torch.float32):
    """(m, nb) packed -> ((m, n) dosage, (m, n) NA mask)."""
    return codes_to_dosage(unpack_codes(packed, n), dtype=dtype)


def unpack_standardized(packed: torch.Tensor, n: int, center: torch.Tensor,
                        scale: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """(m, nb) packed -> (m, n) standardized (x - center)/scale, NA -> 0."""
    d, na = unpack_dosage(packed, n, dtype=dtype)
    xt = (d - center[:, None].to(dtype)) / scale[:, None].to(dtype)
    return torch.where(na, torch.zeros((), dtype=dtype, device=xt.device),
                       xt)


# ---------------------------------------------------------------------------
# numpy host-side versions (for I/O paths and oracles)
# ---------------------------------------------------------------------------

def np_unpack_codes(packed: np.ndarray, n: int) -> np.ndarray:
    m, nb = packed.shape
    g = (packed[:, :, None] >> _SHIFTS[None, None, :]) & 3
    return g.reshape(m, nb * 4)[:, :n]


def np_pack_codes(codes: np.ndarray) -> np.ndarray:
    """(m, n) 2-bit codes -> (m, ceil(n/4)) packed bytes (PLINK layout,
    zero pad bits)."""
    m, n = codes.shape
    nb = (n + 3) // 4
    padded = np.zeros((m, nb * 4), dtype=np.uint8)
    padded[:, :n] = codes
    quads = padded.reshape(m, nb, 4)
    return (
        quads[:, :, 0]
        | (quads[:, :, 1] << 2)
        | (quads[:, :, 2] << 4)
        | (quads[:, :, 3] << 6)
    ).astype(np.uint8)


def np_dosage_to_codes(dosage: np.ndarray) -> np.ndarray:
    """(m, n) float dosage in {0,1,2,NaN} -> 2-bit codes."""
    codes = np.full(dosage.shape, 1, dtype=np.uint8)  # NA
    codes[dosage == 0] = 3
    codes[dosage == 1] = 2
    codes[dosage == 2] = 0
    return codes
