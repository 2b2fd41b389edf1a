#!/usr/bin/env python3
"""Time the int8 bit-plane kernel K6 (bigsnpr_tpu_torch/csrc/geno_i8.cu) by
depth split on one GPU.

    python3 k6_probe.py [--n N] [--m M] [--l L ...]

On random packed bytes (n samples x m variants) and random operands, for
each l and each of the four instantiations (cprod_i8, prod_i8 and their
_nona twins), the wrapper is timed with CUDA events over 5 launches after
a warm-up at depth splits 1, 2, 4, 8, 16 and at the split `i8_plan`
chooses; the raw int32 sums must be equal at every split. Prints the card's
name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SPLITS = (1, 2, 4, 8, 16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--l", type=int, nargs="+", default=[12, 20])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bigsnpr_tpu_torch.ops import geno_kernels as gk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    n, m = args.n, args.m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    P = torch.randint(0, 256, (m, (n + 3) // 4), dtype=torch.uint8,
                      device="cuda", generator=gen)
    c = 2 * torch.rand(m, device="cuda", generator=gen)
    inv = torch.rand(m, device="cuda", generator=gen) + 0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count

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

    ok = True
    for l in args.l:
        V = torch.randn(n, l, device="cuda", generator=gen)
        U = torch.randn(m, l, device="cuda", generator=gen)
        print(f"n={n}, m={m}, l={l}: ms a wrapper call by depth splits",
              flush=True)
        for prod, kern, W in ((0, gk.cprod_i8, V), (1, gk.prod_i8, U)):
            for nona in (False, True):
                planned = gk.i8_plan(prod, nona, False, m, n, l,
                                     sms)["splits"]
                ref = kern(P, n, W, c, inv, nona, True, 1)[1]
                times = []
                for s in SPLITS + (planned,):
                    raw = kern(P, n, W, c, inv, nona, True, s)[1]
                    ok &= bool(torch.equal(raw, ref))
                    t = ms(lambda: kern(P, n, W, c, inv, nona, False, s))
                    times.append(f"{s}: {t:.3f}")
                name = ("prod_i8" if prod else "cprod_i8") + (
                    "_nona" if nona else "")
                print(f"  {name:14s} {{{', '.join(times)}}} (planned: "
                      f"{planned})", flush=True)
    print("raw sums equal at every split" if ok
          else "FAIL: raw sums differ between splits", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
