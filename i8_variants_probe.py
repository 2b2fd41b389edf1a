#!/usr/bin/env python3
"""Where the int8 GEMM's time goes, on one GPU (K6 / K8,
bigsnpr_tpu_torch/csrc/geno_i8.cu).

    python3 i8_variants_probe.py [--n N] [--m M] [--l L ...]

On random packed bytes (n samples x m variants), their int8 planes and
random operands, times each of the eight instantiations (cprod / prod,
NA / NA-free, K6 / K8) as GEMM + epilogue on operands prepared once,
beside `torch._int_mm` on the pre-decoded planes, with CUDA events over 5
launches after a warm-up. Then builds variants of the kernel source that
leave one piece of work out or change one access order, and times the
instantiations each variant touches. The variants give wrong sums: they
exist only to be timed.

  no_transpose  prod: wgmma on an unwritten staging tile (no loads,
                decode or transposes of the A tile)
  no_decode     K6 prod: the packed bytes are not decoded
  rs_no_decode  K6 cprod: the A fragments are made from constants
  cprod_order   K8 prod: the same boxes read in cprod's order (each CTA
                its own 128 rows, advancing along them)
  rotated       K8 prod: each CTA starts its walk down the variants at a
                different row

Prints the card's name and power limit first. Needs a CUDA device and
nvcc; the variants are built under bigsnpr_tpu_torch/_build/variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

K6_PROD_A = ("          uint8_t* Ab = MAT ? st + BP * B_BYTES\n"
             + " " * 28 + ": staging + (it & 1) * P * MS * TILE;\n")
PROD_END = ("          fence_proxy_async();\n"
            "          warpgroup_sync(1 + wg);\n"
            "          A = Ab;")
VARIANTS = {
    "no_transpose": [(K6_PROD_A, K6_PROD_A + "          if (p.m < 0) {\n"),
                     (PROD_END, "          }\n" + PROD_END)],
    "no_decode": [("geno_decode::decode_byte(byte, t[i][v], na[i][v]);",
                   "t[i][v] = byte * 0x01010101u; na[i][v] = byte;")],
    "rs_no_decode": [("const uint32_t x = At[rl * RAW + o[h] + idx];",
                      "const uint32_t x = static_cast<uint32_t>(idx);")],
    "cprod_order": [("const int x = PROD ? r0 + 128 * i : k0, "
                     "y = PROD ? k0 : r0;",
                     "const int x = PROD ? (k0 + 128 * i) % 49920 : k0, "
                     "y = r0;")],
    "rotated": [("        const int k0 = kt * BK;\n        if (!MAT) {",
                 "        const int k0 = (PROD ? kt0 + (kt - kt0 + mt * 97) % "
                 "(kt1 - kt0) : kt) * BK;\n        if (!MAT) {")],
}
# which instantiations (prod, mat) each variant touches
TOUCHES = {"no_transpose": {(True, False), (True, True)},
           "no_decode": {(True, False)}, "rs_no_decode": {(False, False)},
           "cprod_order": {(True, True)}, "rotated": {(True, True)}}


def variant_source(src, name):
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the kernel source changed")
        src = src.replace(old, new)
    return src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--l", type=int, nargs="+", default=[20])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("i8_variants_probe: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from bigsnpr_tpu_torch.ops import cuda_build
    from bigsnpr_tpu_torch.ops import geno_kernels as gk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    src = gk.I8_SOURCE.read_text()
    csrc = gk.I8_SOURCE.parent

    def build(name):
        d = cuda_build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        path = d / "geno_i8.cu"
        path.write_text(variant_source(src, name))
        return name, cuda_build.build(path, extra=gk.I8_FLAGS)

    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        base = pool.submit(gk.build_i8)
        libs = dict(pool.map(build, VARIANTS))
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
    P0 = P & ~(P & ~(P >> 1) & 0x55)          # every NA code made 00
    c = 2 * torch.rand(m, device="cuda", generator=gen)
    inv = torch.rand(m, device="cuda", generator=gen) + 0.5
    T8, NA8 = gk.int8m_planes(P, n)
    F = torch.nn.functional
    for l in args.l:
        V = torch.randn(n, l, device="cuda", generator=gen)
        U = torch.randn(m, l, device="cuda", generator=gen)
        cases = []
        for nona in (False, True):
            planes = [T8] if nona else [T8, NA8]
            for prod in (False, True):
                if prod:
                    zb8, zbs, za8, zas, zsum = gk._prod_i8_operands(U, c, inv,
                                                                     nona)
                    dg = [zb8] if nona else [zb8, za8]
                    At = [t.t().contiguous() for t in planes]
                    lib = ms(lambda: [torch._int_mm(a, d.t())
                                      for a, d in zip(At, dg)])
                    del At
                else:
                    q8, qs, qsum, A = gk._cprod_i8_operands(V, c, inv)
                    dp = F.pad(q8, (0, T8.shape[1] - n))
                    lib = ms(lambda: [torch._int_mm(a, dp.t())
                                      for a in planes])
                for mat in (False, True):
                    s = (T8, None if nona else NA8) if mat else (P0 if nona
                                                                 else P)
                    if prod:
                        f = (lambda s=s, dg=dg, zbs=zbs, zas=zas, zsum=zsum,
                             nona=nona: gk._launch_i8(
                                 True, nona, s, n, dg, n, l, zbs,
                                 zbs if nona else zas, zsum, None, None))
                    else:
                        f = (lambda s=s, q8=q8, qs=qs, qsum=qsum, A=A,
                             nona=nona: gk._launch_i8(
                                 False, nona, s, n, [q8], m, l, qs, qs, qsum,
                                 A, inv))
                    name = (("prod_i8" if prod else "cprod_i8")
                            + ("m" if mat else "") + ("_nona" if nona else ""))
                    cases.append((name, prod, mat, f))
                    print(f"l={l} {name:15s} {ms(f):.3f} ms "
                          f"(torch._int_mm {lib:.3f} ms)", flush=True)
        load = gk._load_i8
        for vname, path in libs.items():
            lib = ctypes.CDLL(str(path))
            gk._bind_i8(lib)
            gk._load_i8 = lambda lib=lib: lib
            times = [f"{name} {ms(f):.3f}" for name, prod, mat, f in cases
                     if (prod, mat) in TOUCHES[vname]]
            print(f"l={l} variant {vname:13s}: {', '.join(times)} ms",
                  flush=True)
        gk._load_i8 = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
