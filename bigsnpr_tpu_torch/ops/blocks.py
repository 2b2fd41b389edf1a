"""Variant-block size for streaming decodes (`pick_block` of
`bigsnpr_tpu/ops/blocks.py`).

Genotype ops that decode to a dense matrix stream over variant blocks, so
the 16x-inflated dense matrix never materializes whole in device memory
(reference src/*.cpp: OpenMP `parallel for` over columns, e.g.
src/bed-prod-vec.cpp:29-51).
"""

from __future__ import annotations

import torch

# entries of one decoded block of byte codes: its int64 gather indices
# take 512 MB
BYTE_ENTRIES = 64 << 20


def pick_block(n: int, target_bytes: int = 256 * 1024 * 1024, lo: int = 8,
               hi: int = 16384) -> int:
    """Variant-block size so one decoded f32 block is ~target_bytes."""
    b = max(lo, min(hi, target_bytes // max(1, 4 * n)))
    # keep it a multiple of 8 for clean tiling
    return max(lo, (b // 8) * 8)


def byte_rows(width: int, block=None) -> int:
    """Rows of `width` byte codes to decode at once on the device: `block`
    or ~256 MB of float32 (`pick_block`), at most BYTE_ENTRIES entries."""
    return max(1, min(block or pick_block(width),
                      BYTE_ENTRIES // max(width, 1)))


def decode_bytes(codes: torch.Tensor, table: torch.Tensor, center=None,
                 scale=None) -> torch.Tensor:
    """(B, n) byte codes -> (B, n) values table[c] in the table's dtype, or
    (table[c] - center) / scale with a value per row when center / scale
    are given, and 0 where table[c] is NaN (missing). One gather from a
    256-entry table ((B, 256) when standardizing), so each value is that
    of the JAX package's elementwise arithmetic."""
    T = table
    if center is not None:
        T = (table[None, :] - center[:, None]) / scale[:, None]
    T = torch.where(torch.isnan(table), torch.zeros((), dtype=T.dtype,
                                                    device=T.device), T)
    idx = codes.long()
    return torch.gather(T, 1, idx) if T.dim() == 2 else T[idx]


def present_bytes(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, n) bool: the byte codes whose table entry is not NaN."""
    return (~torch.isnan(table))[codes.long()]
