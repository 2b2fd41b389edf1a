#!/usr/bin/env python3
"""Where the bit-plane GEMM's time goes, on one GPU (K1, K2 and K7,
bigsnpr_tpu_torch/csrc/geno_split.cu: plane_wgmma_kernel<PROD, TERMS, BNC>).

    python3 plane_variants_probe.py [--n N] [--m M] [--l L ...]
                                    [--variants NAME ...]

On random packed bytes (n samples x m variants) and random operands, times
K2 and K1 (prod and cprod, three terms) and K7 (prod and cprod, two
terms) as GEMM +
epilogue on an operand prepared once, with CUDA events over 5 launches
after a warm-up. Then builds variants of the kernel source that leave one
piece of work out or change one step, and times the four again on each.
The variants give wrong sums: they exist only to be timed.

  no_decode  the A fragments are constants: the packed bytes are neither
             read from shared memory nor decoded
  no_mma     no wgmma is issued; the decoded fragments are folded into one
             accumulator so that the decode stays
  no_copy    the producer copies no packed bytes (the readers decode
             whatever the stage holds)
  no_tma     the producer loads no operand tiles

Prints the card's name and power limit first. Needs a CUDA device and
nvcc; the variants are built under bigsnpr_tpu_torch/_build/variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

A_DECL = "        uint32_t a[2][4][4];  // [plane][k-step][register]\n"
MMA = ("        wgmma_fence();\n"
       "#pragma unroll\n"
       "        for (int ks = 0; ks < 4; ++ks)\n"
       "#pragma unroll\n"
       "          for (int pl = 0; pl < 2; ++pl)\n"
       "            wgmma_bf16::Op<N>::rs(\n"
       "                acc[pl], a[pl][ks],\n"
       "                dB + ((PROD ? pl : 0) * KS + qp) * (B_BYTES >> 4) + "
       "2 * ks,\n"
       "                qp > 0 || ks > 0);  // the stage's first k-step starts "
       "anew\n")
CONSTS = ("        } else {\n"
          "#pragma unroll\n"
          "          for (int q = 0; q < 2; ++q)\n"
          "#pragma unroll\n"
          "            for (int ks = 0; ks < 4; ++ks)\n"
          "#pragma unroll\n"
          "              for (int r = 0; r < 4; ++r)\n"
          "                a[q][ks][r] = 0x3F803F80u ^ (q + ks + r);\n"
          "        }\n")
FOLD = ("        } else {\n"
        "          uint32_t x = 0u;\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 2; ++q)\n"
        "#pragma unroll\n"
        "            for (int ks = 0; ks < 4; ++ks)\n"
        "#pragma unroll\n"
        "              for (int r = 0; r < 4; ++r) x ^= a[q][ks][r];\n"
        "          acc[0][0] += __uint_as_float(x & 0x3F800000u);\n"
        "        }\n")
COPY = "        for (int e = pt; e < PR * CH; e += PRODUCERS) {"
TMA = ("          mbar_expect_tx(full + s, BP * KS * B_BYTES);\n"
       "          // plane pl's sub-tile i: its terms' BNC-row boxes, stacked\n"
       "          for (int pl = 0; pl < BP; ++pl)")
VARIANTS = {
    "no_decode": [(A_DECL, A_DECL + "        if (p.m < 0) {\n"),
                  (MMA, CONSTS + MMA)],
    "no_mma": [(MMA, "        if (p.m < 0) {\n" + MMA + FOLD)],
    "no_copy": [(COPY, "        for (int e = pt; e < (p.m < 0 ? PR * CH "
                       ": 0); e += PRODUCERS) {")],
    "no_tma": [(TMA, "          mbar_arrive(full + s);\n"
                     "          for (int pl = 0; pl < (p.m < 0 ? BP : 0); "
                     "++pl)")],
}


def families(U, V):
    """The timed instantiation families: (name, prod, terms, operand)."""
    return (("K2 prod", True, 3, U), ("K1 cprod", False, 3, V),
            ("K7 prod", True, 2, U), ("K7 cprod", False, 2, V))


def variant_source(src, name):
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the kernel source changed")
        src = src.replace(old, new)
    return src


def at_depth(gk, plan, prod, terms, m, n, ksub):
    """`plan` with its ring at stages of `ksub` 64-deep sub-tiles, the
    depth split as often as before."""
    ring = gk.plane_ring(prod, terms, plan["bn"], ksub, m if prod else n)
    kps = -(-ring["ktiles"] // plan["splits"])
    return {**plan, **ring, "kps": kps, "splits": -(-ring["ktiles"] // kps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--l", type=int, nargs="+", default=[20, 1])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--ksub", type=int, nargs="*", default=[],
                    help="also time the base at these stage depths (64-deep "
                    "sub-tiles a stage)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("plane_variants_probe: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from bigsnpr_tpu_torch.ops import cuda_build
    from bigsnpr_tpu_torch.ops import geno_kernels as gk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    src = gk.SPLIT_SOURCE.read_text()
    csrc = gk.SPLIT_SOURCE.parent

    def build(name):
        d = cuda_build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        path = d / "geno_split.cu"
        path.write_text(variant_source(src, name))
        return name, cuda_build.build(path, extra=gk.SPLIT_FLAGS)

    with ThreadPoolExecutor(len(args.variants) + 1) as pool:
        base = pool.submit(gk.build_split)
        libs = dict(pool.map(build, args.variants))
        base.result()

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    n, m = args.n, args.m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    P = torch.randint(0, 256, (m, (n + 3) // 4), dtype=torch.uint8,
                      device="cuda", generator=gen)
    c = 2 * torch.rand(m, device="cuda", generator=gen)
    inv = torch.rand(m, device="cuda", generator=gen) + 0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for l in args.l:
        V = torch.randn(n, l, device="cuda", generator=gen)
        U = torch.randn(m, l, device="cuda", generator=gen)
        cases = []
        for name, prod, terms, W in families(U, V):
            plan = gk.plane_plan(prod, terms, m, n, l, sms)
            op, sums, rc = gk._plane_operands(prod, terms, W, c, inv, plan)
            if rc != 0:
                raise RuntimeError(f"{name}: operand preparation failed {rc}")

            def f(prod=prod, terms=terms, op=op, sums=sums, plan=plan):
                out, rc = gk._plane_gemm(prod, terms, P, n, op, sums, l, c,
                                         inv, plan)
                if rc != 0:
                    raise RuntimeError(f"GEMM launch failed {rc}")
                return out
            cases.append((name, f))
            print(f"l={l} {name:8s} {ms(f):.3f} ms (BN {plan['bn']} x "
                  f"{plan['n_tiles']}, {plan['stages']} stages of {plan['ksub']} "
                  f"sub-tiles, splits "
                  f"{plan['splits']})", flush=True)
        for ksub in args.ksub:
            times = []
            for name, prod, terms, W in families(U, V):
                plan = at_depth(gk, gk.plane_plan(prod, terms, m, n, l, sms),
                                prod, terms, m, n, ksub)
                op, sums, rc = gk._plane_operands(prod, terms, W, c, inv,
                                                  plan)
                times.append(f"{name} {ms(lambda: gk._plane_gemm(prod, terms, P, n, op, sums, l, c, inv, plan)):.3f} ({plan['stages']} stages)")
            print(f"l={l} ksub {ksub}: {', '.join(times)} ms", flush=True)
        load = gk._load_split
        for vname, path in libs.items():
            lib = ctypes.CDLL(str(path))
            gk._bind_split(lib)
            gk._load_split = lambda lib=lib: lib
            times = [f"{name} {ms(f):.3f}" for name, f in cases]
            print(f"l={l} variant {vname:9s}: {', '.join(times)} ms",
                  flush=True)
        gk._load_split = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
