#!/usr/bin/env python3
"""Write `wgmma_bf16.cuh`: one inline-PTX wrapper a tile width for Hopper's
`wgmma.mma_async` m64nNk16 f32 += bf16 x bf16 with A from registers and B
from shared memory (K-major, through a 64-bit matrix descriptor). Inline
asm needs every accumulator register named in its string, so the widths
are written out.

    python3 bigsnpr_tpu_torch/csrc/gen_wgmma_bf16.py
"""

from pathlib import Path

# the wgmma columns TERMS x BNC of ops/geno_kernels.py::PLANE_BNC
WIDTHS = (16, 24, 32, 48, 64, 72, 80, 96)

HEAD = """\
// Generated by gen_wgmma_bf16.py: do not edit by hand.
//
// Op<N>::rs(d, a, desc_b, accumulate): d (m64 x N, f32, N/2 registers a
// thread) = A (64 x 16 bf16 in registers: a[0..3], the m16n8k16 A fragment
// of each warp's 16 rows) . B (N x 16 bf16, K-major shared-memory
// descriptor)^T, plus d where `accumulate` is not 0.
// The accumulator of each warp's 16 rows is laid out as mma.sync's C:
// d[4j + e] sits at row g + 8 (e >> 1), column 8j + 2tg + (e & 1).

#pragma once

#include <cstdint>

namespace wgmma_bf16 {

template <int N>
struct Op;
"""


def regs(n, first):
    return ", ".join(f"%{first + i}" for i in range(n))


def outs(n):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def width(n):
    r = n // 2
    return (
        f"template <>\nstruct Op<{n}> {{\n"
        f"  static __device__ __forceinline__ void rs(float (&d)[{r}], "
        f"const uint32_t (&a)[4], uint64_t db,\n"
        f"                                            int accumulate) {{\n"
        f"    asm volatile(\n"
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'        "{{{regs(r, 0)}}}, {{{regs(4, r)}}}, %{r + 4}, p, 1, 1, 0;'
        f'\\n}}\\n"\n'
        f"        : {outs(r)}\n"
        f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),\n'
        f'          "r"(accumulate));\n'
        f"  }}\n}};\n"
    )


def main():
    body = HEAD + "\n" + "\n".join(width(n) for n in WIDTHS)
    body += "\n}  // namespace wgmma_bf16\n"
    out = Path(__file__).resolve().parent / "wgmma_bf16.cuh"
    out.write_text(body)


if __name__ == "__main__":
    main()
