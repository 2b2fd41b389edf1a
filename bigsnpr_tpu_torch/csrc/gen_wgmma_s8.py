#!/usr/bin/env python3
"""Write `wgmma_s8.cuh`: one inline-PTX wrapper a tile width for Hopper's
`wgmma.mma_async` m64nNk32 s32 += s8 x s8, with A from shared memory
(`Op<N>::ss`) or from registers (`Op<N>::rs`) and B from shared
memory, both through 64-bit matrix descriptors. Inline asm needs every
accumulator register named in its string, so the widths are written out.

    python3 bigsnpr_tpu_torch/csrc/gen_wgmma_s8.py
"""

from pathlib import Path

WIDTHS = (16, 32, 48, 64, 80, 96, 128)

HEAD = """\
// Generated by gen_wgmma_s8.py: do not edit by hand.
//
// Op<N>::ss(d, desc_a, desc_b): d (m64 x N, s32, N/2 registers a thread)
// += A (64 x 32 s8, shared-memory descriptor) . B (N x 32 s8, K-major
// shared-memory descriptor)^T. Op<N>::rs(d, a, desc_b): the same with A
// in registers (a[0..3], the m16n8k32 A fragment of each warp's 16 rows).
// The accumulator of each warp's 16 rows is laid out as mma.sync's C:
// d[4j + e] sits at row g + 8 (e >> 1), column 8j + 2tg + (e & 1).

#pragma once

#include <cstdint>

namespace wgmma_s8 {

template <int N>
struct Op;
"""


def regs(n, first):
    return ", ".join(f"%{first + i}" for i in range(n))


def outs(n):
    return ", ".join(f'"+r"(d[{i}])' for i in range(n))


def width(n):
    r = n // 2
    ss = (
        f"template <>\nstruct Op<{n}> {{\n"
        f"  static __device__ __forceinline__ void ss(int (&d)[{r}], "
        f"uint64_t da, uint64_t db) {{\n"
        f"    asm volatile(\n"
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "\n'
        f'        "{{{regs(r, 0)}}}, %{r}, %{r + 1}, p;\\n}}\\n"\n'
        f"        : {outs(r)}\n"
        f'        : "l"(da), "l"(db), "r"(1));\n'
        f"  }}\n"
        f"  static __device__ __forceinline__ void rs(int (&d)[{r}], "
        f"const uint32_t (&a)[4], uint64_t db) {{\n"
        f"    asm volatile(\n"
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "\n'
        f'        "{{{regs(r, 0)}}}, {{{regs(4, r)}}}, %{r + 4}, p;\\n}}\\n"\n'
        f"        : {outs(r)}\n"
        f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),\n'
        f'          "r"(1));\n'
        f"  }}\n}};\n"
    )
    return ss


def main():
    body = HEAD + "\n" + "\n".join(width(n) for n in WIDTHS)
    body += "\n}  // namespace wgmma_s8\n"
    out = Path(__file__).resolve().parent / "wgmma_s8.cuh"
    out.write_text(body)


if __name__ == "__main__":
    main()
