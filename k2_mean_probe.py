#!/usr/bin/env python3
"""K2 (the "highest" prod, `geno_kernels.prod`) against a float64 product
on operands whose columns do not average zero.

    python3 k2_mean_probe.py [--root DIR]     # on a GPU
    python3 k2_mean_probe.py --emulate        # on the CPU

The bit-plane algebra sums t * zB and zA over all m variants; where U's
columns do not average zero (U = 1, all-positive or all-negative weights)
both sums grow like m while the result grows like sqrt(m), so float32
sums can lose the result. On a GPU, for the package under --root (this
checkout by default; a checkout of another commit compares two kernels),
it makes a cohort on the card (allele frequencies U(0.05, 0.5), 1% NA on
5% of the variants, centred and scaled by its own means) at 2,003 and
50,000 samples x 100,000 variants, and prints max |K2 - float64| and
max |twin - float64| over max |float64| for operands N(0,1),
|N(0,1)| + 1, 1 and -|N(0,1)| - 1, with the wrapper's time (5 launches
after one). --emulate models K2's float32 sums on the CPU (64 samples x
99,840 variants: each 256-variant stage summed exactly, rounded to f32
and added in f32 in order; the row sums in f32 blocks of 64) without and
with the centring.
"""

from __future__ import annotations

import argparse
import sys
import time


def cohort(torch, dev, g, n, m, chunk=10_000):
    """packed (m, nb) uint8, center, inv (m,) f32, dosages (m, n) uint8
    and the NA mask, made on the card chunk by chunk."""
    nb = (n + 3) // 4
    packed = torch.empty((m, nb), dtype=torch.uint8, device=dev)
    d = torch.empty((m, n), dtype=torch.uint8, device=dev)
    na = torch.zeros((m, n), dtype=torch.bool, device=dev)
    c = torch.empty(m, dtype=torch.float64, device=dev)
    inv = torch.empty(m, dtype=torch.float64, device=dev)
    code_of = torch.tensor([3, 2, 0], dtype=torch.uint8, device=dev)
    for j0 in range(0, m, chunk):
        k = min(chunk, m - j0)
        p = 0.05 + 0.45 * torch.rand(k, device=dev, generator=g)
        dj = sum((torch.rand(k, n, device=dev, generator=g)
                  < p[:, None]).to(torch.uint8) for _ in range(2))
        nj = ((torch.rand(k, n, device=dev, generator=g) < 0.01)
              & ((torch.arange(k, device=dev) + j0) % 20 == 0)[:, None])
        code = code_of[dj.long()]
        code[nj] = 1
        code = torch.nn.functional.pad(code, (0, 4 * nb - n)).view(k, nb, 4)
        packed[j0:j0 + k] = (code[..., 0] | code[..., 1] << 2
                             | code[..., 2] << 4 | code[..., 3] << 6)
        d[j0:j0 + k], na[j0:j0 + k] = dj, nj
        dd = torch.where(nj, float("nan"), dj.double())
        cj = torch.nanmean(dd, 1)
        sd = torch.sqrt(torch.nanmean((dd - cj[:, None]) ** 2, 1))
        c[j0:j0 + k] = cj
        inv[j0:j0 + k] = torch.where(sd > 0, 1 / sd, torch.zeros_like(sd))
    return packed, c.float(), inv.float(), d, na


def product64(torch, d, na, c, inv, U, chunk=8192):
    """The float64 product X~ U from the dosages, NA -> 0."""
    out = torch.zeros((d.shape[1], U.shape[1]), dtype=torch.float64,
                      device=U.device)
    for j0 in range(0, d.shape[0], chunk):
        s = slice(j0, j0 + chunk)
        x = (d[s].double() - c[s, None].double()) * inv[s, None].double()
        out += torch.where(na[s], 0.0, x).T @ U[s].double()
    return out


def on_card(root):
    import torch

    if not torch.cuda.is_available():
        print("k2_mean_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from bigsnpr_tpu_torch.ops import geno_kernels as gk

    print(f"package {gk.__file__}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for n, m in ((2003, 100_000), (50_000, 100_000)):
        packed, c, inv, d, na = cohort(torch, dev, g, n, m)
        for kind, l in (("N(0,1)", 20), ("|N(0,1)|+1", 20), ("1", 1),
                        ("-|N(0,1)|-1", 20)):
            U = torch.randn(m, l, device=dev, generator=g)
            U = {"N(0,1)": U, "|N(0,1)|+1": U.abs() + 1,
                 "1": torch.ones_like(U), "-|N(0,1)|-1": -U.abs() - 1}[kind]
            out = gk.prod(packed, n, U, c, inv)
            twin = gk.prod_plain(packed, n, U, c, inv)
            ref = product64(torch, d, na, c, inv, U)
            s = float(ref.abs().max())
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                gk.prod(packed, n, U, c, inv)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / 5 * 1e3
            print(f"n={n} m={m} l={l} U={kind}: K2 "
                  f"{float((out.double() - ref).abs().max()) / s:.3e}, twin "
                  f"{float((twin.double() - ref).abs().max()) / s:.3e} of "
                  f"max|f64| {s:.1f}; wrapper {ms:.3f} ms", flush=True)
        del packed, d, na
        torch.cuda.empty_cache()
    return 0


def emulate():
    import numpy as np
    import torch

    def bf16(v):
        return np.float32(torch.tensor(float(v)).to(torch.bfloat16).item())

    def f32_in_order(stages):
        acc = np.zeros(stages.shape[0], np.float32)
        for k in range(stages.shape[1]):
            acc = (acc + stages[:, k]).astype(np.float32)
        return acc

    rng = np.random.default_rng(0)
    n, m = 64, 99_840
    x = rng.binomial(2, rng.uniform(0.05, 0.5, m), (n, m)).astype(float)
    c, sd = x.mean(0), x.std(0)
    inv = np.where(sd > 0, 1 / np.where(sd > 0, sd, 1), 0)
    t = 2 - x                       # the T plane's values
    for name, U in (("N(0,1)", rng.standard_normal(m)),
                    ("|N(0,1)|+1", np.abs(rng.standard_normal(m)) + 1),
                    ("1", np.ones(m))):
        truth = ((x - c) * inv) @ U
        zB = (U * inv).astype(np.float32)
        zA = (U * (2 - c) * inv).astype(np.float32)
        blocks = zA.reshape(-1, 64).sum(1, dtype=np.float32)
        sumv32 = f32_in_order(blocks[None, :])[0]
        sumv = zA.astype(float).sum()
        alpha = bf16(sumv / (2 - c).sum())
        for centred in (False, True):
            a = alpha if centred else np.float32(0)
            op = (zB - a).astype(np.float32).astype(float)
            pt = f32_in_order((t * op).reshape(n, -1, 256).sum(2)
                              .astype(np.float32))
            if centred:
                out = (sumv - float(a) * t.sum(1)) - pt.astype(float)
            else:
                out = sumv32 - pt
            err = np.abs(out - truth).max() / np.abs(truth).max()
            print(f"U={name} {'centred' if centred else 'uncentred'}: "
                  f"{err:.2e} of max |float64|", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose bigsnpr_tpu_torch to run")
    ap.add_argument("--emulate", action="store_true",
                    help="the CPU model of K2's float32 sums instead")
    args = ap.parse_args(argv)
    return emulate() if args.emulate else on_card(args.root)


if __name__ == "__main__":
    sys.exit(main())
