#!/usr/bin/env python3
"""Time the sweep kernel's unblocked mode (the "global-dp" launches) at
slice 5's band shape for the package under --root, or compare two trees
in one call.

    python3 gdp_probe.py [--root DIR] [--m M] [--W W] [--reps R] [--seed S]
    python3 gdp_probe.py --compare PARENT_DIR [--m M] [--W W] [--reps R]

One band of M (100,000) variants and half-width W (458: 917 wide, slice
5's), float32, made on the card from --seed (band[j, W + d] =
0.995^|d| x U(0.5, 1), 1 on the diagonal); LDpred2-auto's 30 chains
(shrink 0.95, no sign jumps) and lassosum2's 120 grid points (4 deltas x
30 lambdas, one point in five frozen, from the state after 3 sweeps). For
each: the plan's mode, ms a sweep (CUDA events over R sweeps after one
warm-up, each on a fresh copy of the state) and a SHA-256 of one sweep's
outputs (dp, betas, partial sums), which two trees whose kernels do the
same arithmetic in the same order share. --compare runs the tree at
PARENT_DIR, this tree, this tree and PARENT_DIR again, each in its own
process (each builds its kernels in its own `_build/`), and prints the
times side by side and whether the hashes agree. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

import numpy as np


def make_case(torch, gsk, m, W, seed):
    """The probe's band (a SweepBands on the card), LDpred2 state for 30
    chains and lassosum2 state for 120 grid points after 3 sweeps."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.arange(-W, W + 1, device=dev)
    band = (0.995 ** d.abs().double()).float() * (
        0.5 + 0.5 * torch.rand((m, 2 * W + 1), generator=g, device=dev))
    band[:, W] = 1.0
    j = torch.arange(m, device=dev)[:, None] + d[None]
    band = torch.where((j >= 0) & (j < m), band, 0.0)  # no partner past the ends
    sb = gsk.SweepBands([(band.cpu().numpy()[None],
                          np.arange(m, dtype=np.int32)[None])], m, dev)
    del band, j
    f = lambda *shape, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(  # noqa: E731
        shape, generator=g, device=dev)
    NC, NG = 30, 120
    st = dict(bh=0.02 * torch.randn(m, generator=g, device=dev),
              C2=f(NC, m, lo=0.1, hi=0.9), C4=f(NC, m, lo=1e-4, hi=1e-3),
              s1=f(NC, m, lo=1.0, hi=2.0), u=f(NC, m),
              z=torch.randn((NC, m), generator=g, device=dev),
              cb=0.02 * torch.randn((NC, m), generator=g, device=dev)
              * (f(NC, m) < 0.3),
              inv_odd_p=f(NC, lo=1.0, hi=1e3), p=f(NC, lo=1e-3, hi=0.5),
              sparse=torch.arange(NC, device=dev) % 2 == 1,
              dp=0.02 * torch.randn((NC, sb.dp_len), generator=g,
                                    device=dev))
    ls = dict(pf=f(m, lo=0.8, hi=1.5),
              lam=torch.as_tensor(np.tile(np.geomspace(0.05, 5e-4, 30), 4),
                                  dtype=torch.float32, device=dev),
              delta=torch.as_tensor(np.repeat([0.001, 0.01, 0.1, 1.0], 30),
                                    dtype=torch.float32, device=dev),
              dp=sb.dp0(NG), beta=torch.zeros((NG, m), device=dev),
              active=torch.arange(NG, device=dev) % 5 != 3)
    for _ in range(3):
        gsk.lassosum_sweep(sb, ls["dp"], ls["beta"], st["bh"], ls["pf"],
                           ls["lam"], ls["delta"],
                           torch.ones(NG, dtype=torch.bool, device=dev))
    return sb, st, ls


def time_case(torch, gsk, sb, st, ls, reps):
    """(LDpred2 ms a sweep, its outputs' hash, lassosum ms, hash)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def sweep():
        dp = st["dp"].clone()
        out = gsk.sweep(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"],
                        st["s1"], st["u"], st["z"], st["inv_odd_p"], st["p"],
                        st["sparse"], 0.95, True)
        return (dp,) + tuple(out)

    def lasso():
        dp, beta = ls["dp"].clone(), ls["beta"].clone()
        out = gsk.lassosum_sweep(sb, dp, beta, st["bh"], ls["pf"],
                                 ls["lam"], ls["delta"], ls["active"])
        return (dp, beta) + tuple(out)

    return (timed(sweep), digest(sweep()), timed(lasso), digest(lasso()))


def run(root, m, W, reps, seed):
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import bigsnpr_tpu_torch  # noqa: F401
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    if not os.path.abspath(bigsnpr_tpu_torch.__file__).startswith(root):
        raise SystemExit(f"imported {bigsnpr_tpu_torch.__file__}, not {root}")
    sb, st, ls = make_case(torch, gsk, m, W, seed)
    ms_s, h_s, ms_l, h_l = time_case(torch, gsk, sb, st, ls, reps)
    plans = {k: tuple(v) for k, v in sb.plans.items()}
    print(f"RESULT root={root} sweep_ms={ms_s:.3f} sweep_hash={h_s} "
          f"lasso_ms={ms_l:.3f} lasso_hash={h_l} plans={plans} "
          f"launches={dict(gsk.launches)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--compare", default=None)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--W", type=int, default=458)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gdp_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if args.compare is None:
        run(args.root, args.m, args.W, args.reps, args.seed)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for tag, root in (("parent", args.compare), ("this", here),
                      ("this", here), ("parent", args.compare)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--m", str(args.m), "--W", str(args.W), "--reps",
             str(args.reps), "--seed", str(args.seed)],
            capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stdout.write(out.stderr[-4000:])
            return 1
        line = [x for x in out.stdout.splitlines()
                if x.startswith("RESULT")][-1]
        kv = dict(x.split("=", 1) for x in line.split()[1:6])
        results.append((tag, kv))
    for tag, kv in results:
        print(f"{tag:7s} sweep {kv['sweep_ms']:>9s} ms  lassosum "
              f"{kv['lasso_ms']:>9s} ms  hashes {kv['sweep_hash']} "
              f"{kv['lasso_hash']}")
    same = len({(kv["sweep_hash"], kv["lasso_hash"])
                for _, kv in results}) == 1
    print(f"one sweep's outputs identical in both trees: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
