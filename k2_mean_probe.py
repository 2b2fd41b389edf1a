#!/usr/bin/env python3
"""K2 and K1 (the "highest" prod and cprod, `geno_kernels.prod` and
`cprod`) against a float64 product on operands whose columns do not
average zero.

    python3 k2_mean_probe.py [--root DIR] [--kernels K2 K1]   # on a GPU
    python3 k2_mean_probe.py --emulate        # on the CPU

The bit-plane algebra sums t * w and w over the whole depth (K2: the m
variants of zB, zA; K1: the n samples of V); where the operand's columns
do not average zero (1, all-positive or all-negative weights, the GWAS
operand's intercept column) both sums grow like the depth while the
result grows like its square root, so float32 sums can lose the result.
On a GPU, for the package under --root (this checkout by default; a
checkout of another commit compares two kernels), it makes a cohort on
the card (allele frequencies U(0.05, 0.5), 1% NA on 5% of the variants,
centred and scaled by its own means) at 2,003 and 50,000 samples x
100,000 variants, and prints max |kernel - float64| and max |twin -
float64| over max |float64| (and as absolute errors for an operand of
ones, whose exact K1 product is near 0), with the wrapper's time (5
launches after one): K2 for operands U = N(0,1), |N(0,1)| + 1, 1 and
-|N(0,1)| - 1; K1 for V = N(0,1), |N(0,1)| + 1, -|N(0,1)| - 1 at l = 20,
1 at l = 1, and the GWAS operands [yr | Q] of big_univLinReg (its
operator: scale 1) with 10 covariates (l = 12) and none (l = 2).
--emulate models the float32 sums on the CPU, each 256-deep stage summed
exactly, rounded to f32 and added in f32 in order: K2 on 64 samples x
99,840 variants (the row sums in f32 blocks of 64) and K1 on 99,840
samples x 64 variants, each without and with the centring (K1 also with
A = (2 - c) s rounded to f32).
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


def product64(torch, d, na, c, inv, U, chunk=8192, prod=True):
    """The float64 product X~ U (prod) or X~^T U from the dosages, NA ->
    0."""
    m = d.shape[0]
    out = torch.zeros((d.shape[1] if prod else m, U.shape[1]),
                      dtype=torch.float64, device=U.device)
    for j0 in range(0, m, chunk):
        s = slice(j0, j0 + chunk)
        x = torch.where(na[s], 0.0, (d[s].double() - c[s, None].double())
                        * inv[s, None].double())
        if prod:
            out += x.T @ U[s].double()
        else:
            out[s] = x @ U.double()
    return out


def wrapper_ms(torch, fn, reps=5):
    """Milliseconds a call: the host clock around `reps` calls, after a
    synchronize and before another."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def on_card(root, kernels=("K2", "K1")):
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
                        ("-|N(0,1)|-1", 20)) if "K2" in kernels else ():
            U = torch.randn(m, l, device=dev, generator=g)
            U = {"N(0,1)": U, "|N(0,1)|+1": U.abs() + 1,
                 "1": torch.ones_like(U), "-|N(0,1)|-1": -U.abs() - 1}[kind]
            out = gk.prod(packed, n, U, c, inv)
            twin = gk.prod_plain(packed, n, U, c, inv)
            ref = product64(torch, d, na, c, inv, U)
            s = float(ref.abs().max())
            ms = wrapper_ms(torch, lambda: gk.prod(packed, n, U, c, inv))
            print(f"n={n} m={m} l={l} U={kind}: K2 "
                  f"{float((out.double() - ref).abs().max()) / s:.3e}, twin "
                  f"{float((twin.double() - ref).abs().max()) / s:.3e} of "
                  f"max|f64| {s:.1f}; wrapper {ms:.3f} ms", flush=True)
        if "K1" in kernels:
            k1_on_card(torch, gk, dev, g, packed, c, inv, d, na, n, m)
        del packed, d, na
        torch.cuda.empty_cache()
    return 0


def k1_on_card(torch, gk, dev, g, packed, c, inv, d, na, n, m):
    """K1 against float64 on V of nonzero mean and the GWAS operands."""
    ones = torch.ones_like(inv)
    for kind, l in (("N(0,1)", 20), ("|N(0,1)|+1", 20), ("-|N(0,1)|-1", 20),
                    ("1", 1), ("[yr | 1 | 10 cov]", 12), ("[yr | 1]", 2)):
        V = torch.randn(n, l, device=dev, generator=g, dtype=torch.float64)
        s_inv = inv
        if kind.startswith("["):        # big_univLinReg's operand, scale 1
            C = torch.cat([torch.ones(n, 1, device=dev, dtype=V.dtype),
                           V[:, :l - 2]], 1)
            Q = torch.linalg.qr(C)[0]
            y = V[:, -1]
            V = torch.cat([(y - Q @ (Q.T @ y))[:, None], Q], 1)
            s_inv = ones
        else:
            V = {"N(0,1)": V, "|N(0,1)|+1": V.abs() + 1,
                 "-|N(0,1)|-1": -V.abs() - 1,
                 "1": torch.ones_like(V)}[kind]
        V = V.float().contiguous()
        out = gk.cprod(packed, n, V, c, s_inv)
        twin = gk.cprod_plain(packed, n, V, c, s_inv)
        ref = product64(torch, d, na, c, s_inv, V, prod=False)
        s = float(ref.abs().max())
        e_k = float((out.double() - ref).abs().max())
        e_t = float((twin.double() - ref).abs().max())
        ms = wrapper_ms(torch, lambda: gk.cprod(packed, n, V, c, s_inv))
        print(f"n={n} m={m} l={l} V={kind}: K1 {e_k / s:.3e}, twin "
              f"{e_t / s:.3e} of max|f64| {s:.3e} (abs {e_k:.3e} / "
              f"{e_t:.3e}); wrapper {ms:.3f} ms", flush=True)


def emulate_k1(np, bf16, f32_in_order):
    """K1's float32 sums on the CPU: 99,840 samples x 64 variants, no NA,
    the T plane's sums of V (uncentred) or V - gamma in 256-deep stages;
    uncentred (sum - pna) A - pt s in f32 (K7's epilogue), centred in
    float64 with A exact or rounded to f32."""
    rng = np.random.default_rng(1)
    n, m = 99_840, 64
    x = rng.binomial(2, rng.uniform(0.05, 0.5, m), (n, m)).astype(float)
    c = x.mean(0).astype(np.float32)
    sd = x.std(0)
    inv = np.where(sd > 0, 1 / np.where(sd > 0, sd, 1), 0).astype(np.float32)
    t = 2 - x                       # the T plane's values
    c64, inv64 = c.astype(float), inv.astype(float)
    A64 = (2 - c64) * inv64         # exact: two f32 factors
    A32 = A64.astype(np.float32)
    T = t.sum(0)
    for name, V in (("N(0,1)", rng.standard_normal(n)),
                    ("|N(0,1)|+1", np.abs(rng.standard_normal(n)) + 1),
                    ("1", np.ones(n))):
        V = V.astype(np.float32)
        truth = ((x - c64) * inv64).T @ V.astype(float)
        sumv = V.astype(float).sum()
        gamma = bf16(sumv / n)
        sumv32 = f32_in_order(V.reshape(-1, 64).sum(1, dtype=np.float32)
                              [None, :])[0]
        for label in ("uncentred", "centred, A f32", "centred"):
            g0 = np.float32(0) if label == "uncentred" else gamma
            op = (V - g0).astype(np.float32).astype(float)
            pt = f32_in_order((t * op[:, None]).reshape(-1, 256, m).sum(1)
                              .T.astype(np.float32)).astype(float)
            if label == "uncentred":
                out = ((sumv32 * A32).astype(np.float32)
                       - (pt.astype(np.float32) * inv)).astype(float)
            else:
                A = A64 if label == "centred" else A32.astype(float)
                out = (sumv * A - float(g0) * T * inv64) - pt * inv64
            err = np.abs(out - truth).max()
            print(f"K1 V={name} {label}: {err:.2e} abs, "
                  f"{err / np.abs(truth).max():.2e} of max |float64|",
                  flush=True)


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
            print(f"K2 U={name} {'centred' if centred else 'uncentred'}: "
                  f"{err:.2e} of max |float64|", flush=True)
    emulate_k1(np, bf16, f32_in_order)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose bigsnpr_tpu_torch to run")
    ap.add_argument("--emulate", action="store_true",
                    help="the CPU model of K2's and K1's float32 sums "
                    "instead")
    ap.add_argument("--kernels", nargs="+", choices=("K2", "K1"),
                    default=["K2", "K1"], help="the kernels to probe on a GPU")
    args = ap.parse_args(argv)
    return emulate() if args.emulate else on_card(args.root, args.kernels)


if __name__ == "__main__":
    sys.exit(main())
