"""Plain decoding of 2-bit PLINK bytes, and the rounding of a control.

PLINK's 2-bit codes: 0 two copies of the first allele (dosage 2 of the
counted allele), 1 missing, 2 heterozygous (1), 3 none (0); four samples
a byte, low bits first. Imports torch and numpy only.
"""

from __future__ import annotations

import torch

SHIFTS = (0, 2, 4, 6)


def codes(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, nb) bytes -> (rows, n) codes in {0, 1, 2, 3}."""
    sh = torch.tensor(SHIFTS, dtype=torch.uint8, device=packed.device)
    return ((packed[:, :, None] >> sh) & 3).reshape(packed.shape[0], -1)[:, :n]


def dosage(packed: torch.Tensor, n: int, dtype=torch.float64):
    """(rows, n) dosages, 0 where missing, and the (rows, n) mask of the
    calls that are present."""
    c = codes(packed, n)
    table = torch.tensor([2.0, 0.0, 1.0, 0.0], dtype=dtype,
                         device=packed.device)
    return table[c.long()], c != 1


def standardized(packed: torch.Tensor, n: int, center, scale,
                 dtype=torch.float64, fmt=None) -> torch.Tensor:
    """(rows, n) of (dosage - center) / scale, 0 where missing: one
    gather from a 4-entry table a variant, its entries rounded to `fmt`
    (see `round_to`) where given."""
    c = center.to(dtype)[:, None]
    inv = torch.where(scale > 0, 1 / scale.to(dtype), 0.0)[:, None]
    table = torch.cat([(2 - c) * inv, torch.zeros_like(c), (1 - c) * inv,
                       (0 - c) * inv], dim=1)                     # (rows, 4)
    if fmt is not None:
        table = round_to(table, fmt)
    return torch.gather(table, 1, codes(packed, n).long())


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """x rounded to the nearest value of a lower format, returned in x's
    dtype: "tf32" (10-bit mantissa, the tensor cores' float32 input) or
    "bf16". A control computes its operands so, on any device."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if fmt != "tf32":
        raise ValueError(f"unknown format {fmt!r}")
    f = x.to(torch.float32).contiguous()
    i = f.view(torch.int32)
    # round to nearest even on the 13 dropped mantissa bits
    bias = ((i >> 13) & 1) + 0x0FFF
    r = ((i + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(f), r, f).to(x.dtype)
