"""Variant-block size for streaming decodes (`pick_block` of
`bigsnpr_tpu/ops/blocks.py`).

Genotype ops that decode to a dense matrix stream over variant blocks, so
the 16x-inflated dense matrix never materializes whole in device memory
(reference src/*.cpp: OpenMP `parallel for` over columns, e.g.
src/bed-prod-vec.cpp:29-51).
"""

from __future__ import annotations


def pick_block(n: int, target_bytes: int = 256 * 1024 * 1024, lo: int = 8,
               hi: int = 16384) -> int:
    """Variant-block size so one decoded f32 block is ~target_bytes."""
    b = max(lo, min(hi, target_bytes // max(1, 4 * n)))
    # keep it a multiple of 8 for clean tiling
    return max(lo, (b // 8) * 8)
