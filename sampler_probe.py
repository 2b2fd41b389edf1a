#!/usr/bin/env python3
"""Time LDpred2-auto's blocked sampler a sweep (the kernel and the torch
work around it) on slice 2's shape, for the package under --root or for
two trees in one call, and check which per-chain reductions give a chain
the same bits whatever the number of chains beside it (what makes
`shard_chains` bit-equal to the unsharded run).

    python3 sampler_probe.py [--root DIR] [--sweeps S] [--chains C]
    python3 sampler_probe.py --compare PARENT_DIR [...]

The bands are gdp_probe.py's slice-2 blocked bands (67 LD blocks of
204-2,926 variants, 100,000 in all), made on the card from --seed, with
random marginal effects; `gibbs_auto_blocked_multi` runs C (30) chains
(shrink 0.95, no sign jumps, the MLE on), 5 burn-in sweeps and S (50)
kept, after a warm-up call; ms a sweep is the host wall clock of the
call over its sweeps, to a torch.cuda.synchronize(). --compare runs the
tree at PARENT_DIR, this tree, this tree and PARENT_DIR again, each in
its own process. Then, in this process: torch's row sum of a (30, k)
float32 tensor (k = 67, 100,001 and 1,000,000) and a batched product of
(30, 64, 8,192) by (30, 8,192, 1), against the same on rows 0-14, 15-29
and 7: equal bits or not; where the tree has them, the same for
`pgs.gibbs.row_sums` and the MLE profile (`pgs.gibbs._profile`, m =
100,000 and 3,001) on those rows reduced as 30. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np


def run(root, args):
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import bigsnpr_tpu_torch
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb
    from bigsnpr_tpu_torch.pgs.gibbs import chain_generators

    if not os.path.abspath(bigsnpr_tpu_torch.__file__).startswith(root):
        raise SystemExit(f"imported {bigsnpr_tpu_torch.__file__}, not {root}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gdp_probe

    dev = torch.device("cuda")
    sb = gdp_probe.make_blocked(torch, gsk, args.seed)[0]
    rng = np.random.default_rng(args.seed)
    m, NC = sb.m, args.chains
    bh = rng.normal(0, 0.01, m)
    N = np.full(m, 15_000.0)
    lv = 2 * np.log(1 / np.sqrt(N * 0.01 ** 2 + bh ** 2))
    kw = dict(shrink_corr=0.95, p_bounds=(1e-5, 1.0),
              alpha_bounds=np.array([-0.5, 1.5]), mean_ld=20.0,
              no_jump_sign=True)

    def call(burn, keep):
        return gb.gibbs_auto_blocked_multi(
            sb, bh, N, lv, np.geomspace(1e-4, 0.2, NC), 0.4,
            chain_generators(args.seed, NC, dev), burn_in=burn,
            num_iter=keep, **kw)

    call(1, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(5, args.sweeps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (5 + args.sweeps)
    print(f"RESULT root={root} ms_a_sweep={ms:.3f} "
          f"launches={gsk.launches['sweep']}", flush=True)


def invariance():
    import torch

    from bigsnpr_tpu_torch.pgs import gibbs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    parts = ((0, 15), (15, 30), (7, 8))

    def check(name, fn, x):
        full = fn(x)
        same = all(torch.equal(fn(x[lo:hi].contiguous()), full[lo:hi])
                   for lo, hi in parts)
        print(f"  {name}: the rows' bits independent of the rows beside "
              f"them: {same}", flush=True)

    port = hasattr(gibbs, "row_sums")
    for k in (67, 100_001, 1_000_000):
        x = torch.randn((30, k), generator=g, device=dev)
        check(f"x.sum(1), k = {k}", lambda t: t.sum(1), x)
        if port:
            check(f"row_sums as 30 rows, k = {k}",
                  lambda t: gibbs.row_sums(t, 30), x)
    if port:
        for m in (100_000, 3_001):
            a = -0.5 + 2 * torch.rand((30, 64), generator=g, device=dev)
            w = (torch.rand((30, m), generator=g, device=dev) < 0.1).float()
            lv = -8 + torch.randn(m, generator=g, device=dev)
            b2 = 1e-4 * torch.rand((30, m), generator=g, device=dev)
            ps = torch.full((30,), 1e-5, device=dev)
            sa, nb, wb = (w * lv).sum(1), w.sum(1), w * b2

            def prof(rows, lo=0, hi=30, a=a, sa=sa, nb=nb, wb=wb, lv=lv):
                return gibbs._profile(
                    a[lo:hi], sa[lo:hi], nb[lo:hi], wb[lo:hi].contiguous(),
                    lv, ps[lo:hi] / 2, ps[lo:hi] * 2, rows)[0]
            full = prof(30)
            same = all(torch.equal(prof(30, lo, hi), full[lo:hi])
                       for lo, hi in parts)
            print(f"  the MLE profile as 30 rows, m = {m}: the rows' bits "
                  f"independent of the rows beside them: {same}", flush=True)
    E = torch.rand((30, 64, 8192), generator=g, device=dev)
    w = torch.rand((30, 8192, 1), generator=g, device=dev)
    full = torch.bmm(E, w)
    same = all(torch.equal(torch.bmm(E[lo:hi].contiguous(),
                                     w[lo:hi].contiguous()), full[lo:hi])
               for lo, hi in parts)
    print(f"  bmm (30, 64, 8192) x (30, 8192, 1): the batches' bits "
          f"independent of the batches beside them: {same}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--compare", default=None)
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--chains", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sampler_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if args.compare is None:
        run(args.root, args)
        invariance()
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for tag, root in (("parent", args.compare), ("this", here),
                      ("this", here), ("parent", args.compare)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--sweeps", str(args.sweeps), "--chains", str(args.chains),
             "--seed", str(args.seed)], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stdout.write(out.stderr[-4000:])
            return 1
        line = [x for x in out.stdout.splitlines()
                if x.startswith("RESULT")][-1]
        results.append((tag, dict(x.split("=", 1) for x in line.split()[1:])))
    for tag, kv in results:
        print(f"{tag:7s} {kv['ms_a_sweep']:>9s} ms a sweep")
    return 0


if __name__ == "__main__":
    sys.exit(main())
