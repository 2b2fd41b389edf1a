#!/usr/bin/env python3
"""Time the sweep kernel (gibbs_ring_kernel) on one band over every
variant (slice 5's shape) or on bucketed LD blocks (slices 2 and 4's), for
the package under --root, or compare two trees in one call.

    python3 gdp_probe.py [--blocked] [--root DIR] [--m M] [--W W] [--reps R]
                         [--seed S]
    python3 gdp_probe.py [--blocked] --compare PARENT_DIR [...]

Default: one band of M (100,000) variants and half-width W (458: 917 wide,
slice 5's), float32, made on the card from --seed (band[j, W + d] =
0.995^|d| x U(0.5, 1), 1 on the diagonal); LDpred2-auto's 30 chains
(shrink 0.95, no sign jumps) and lassosum2's 120 grid points (4 deltas x
30 lambdas, one point in five frozen, from the state after 3 sweeps).

--blocked: slice 2's shape, 67 LD blocks of 204-2,926 variants (100,000 in
all) at half-widths 255, 383 or 511 (up to 1,023 wide), bucketed by
(half-width, rows rounded up to 128) as the blocked samplers' bands are,
with LDpred2-auto's 30 chains (shrink 0.95, no sign jumps) and the grid's
9 cells (shrink 1, sign jumps allowed); and slice 4's, 42 blocks of
200-3,999 variants at half-widths up to 255, with lassosum2's 120 grid
points as above. Every band, state and block size is made from --seed.

For each case: the plan, ms a sweep (CUDA events over R sweeps after one
warm-up, each on a fresh copy of the state) and a SHA-256 of one sweep's
outputs (dp, betas, partial sums; floats hashed after adding +0, which
maps -0 to +0, so that a skipped frozen grid point, whose dp keeps a -0
that 0 x band would turn into +0, hashes as the twin's arithmetic leaves
it), which two trees whose kernels do the same arithmetic in the same
order share. --compare runs the tree at PARENT_DIR, this tree, this tree
and PARENT_DIR again, each in its own process (each builds its kernels in
its own `_build/`), and prints the times side by side and whether the
hashes agree. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

import numpy as np


def random_band(torch, g, rows, W, dev):
    """(rows, 2W + 1) band: 0.995^|d| x U(0.5, 1), 1 on the diagonal, 0
    past the ends."""
    d = torch.arange(-W, W + 1, device=dev)
    band = (0.995 ** d.abs().double()).float() * (
        0.5 + 0.5 * torch.rand((rows, 2 * W + 1), generator=g, device=dev))
    band[:, W] = 1.0
    j = torch.arange(rows, device=dev)[:, None] + d[None]
    return torch.where((j >= 0) & (j < rows), band, 0.0)


def make_case(torch, gsk, m, W, seed):
    """The probe's band (a SweepBands on the card), LDpred2 state for 30
    chains and lassosum2 state for 120 grid points after 3 sweeps."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    band = random_band(torch, g, m, W, dev)
    sb = gsk.SweepBands([(band.cpu().numpy()[None],
                          np.arange(m, dtype=np.int32)[None])], m, dev)
    del band
    return sb, sweep_state(torch, sb, g, 30), lasso_state(torch, gsk, sb, g)


def blocked_bands(torch, gsk, g, sizes, widths):
    """Blocks of `sizes` variants at half-widths `widths`, bucketed by
    (half-width, rows rounded up to 128): a SweepBands on the card."""
    dev = torch.device("cuda")
    starts = np.concatenate([[0], np.cumsum(sizes)])
    groups = {}
    for b, (n, W) in enumerate(zip(sizes, widths)):
        groups.setdefault((int(W), -(-int(n) // 128) * 128), []).append(b)
    buckets = []
    for (W, mbk), blks in sorted(groups.items()):
        bands = np.zeros((len(blks), mbk, 2 * W + 1), np.float32)
        gidx = np.full((len(blks), mbk), -1, np.int32)
        for k, b in enumerate(blks):
            n = int(sizes[b])
            bands[k, :n] = random_band(torch, g, n, W, dev).cpu().numpy()
            gidx[k, :n] = np.arange(starts[b], starts[b] + n)
        buckets.append((bands, gidx))
    return gsk.SweepBands(buckets, int(starts[-1]), dev)


def make_blocked(torch, gsk, seed):
    """Slice 2's blocked bands with 30- and 9-chain LDpred2 states, and
    slice 4's with a 120-point lassosum2 state after 3 sweeps."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = rng.integers(204, 2927, 67)
    sizes[:2] = 204, 2926
    sizes = np.round(sizes * 100_000 / sizes.sum()).astype(np.int64)
    sizes = np.clip(sizes, 204, 2926)
    widths = np.minimum(rng.choice([255, 383, 511], 67, p=[0.1, 0.2, 0.7]),
                        sizes - 1)
    sb2 = blocked_bands(torch, gsk, g, sizes, widths)
    sizes4 = rng.integers(200, 4000, 42)
    sizes4[:2] = 200, 3999
    sizes4 = np.clip(np.round(sizes4 * 100_000 / sizes4.sum()), 200,
                     3999).astype(np.int64)
    widths4 = np.minimum(rng.choice([127, 191, 255], 42), sizes4 - 1)
    sb4 = blocked_bands(torch, gsk, g, sizes4, widths4)
    return (sb2, sweep_state(torch, sb2, g, 30), sweep_state(torch, sb2, g, 9),
            sb4, lasso_state(torch, gsk, sb4, g))


def sweep_state(torch, sb, g, NC):
    """One LDpred2 sweep's state and pre-drawn u / z for NC chains."""
    dev, m = sb.device, sb.m
    f = lambda *shape, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(  # noqa: E731
        shape, generator=g, device=dev)
    return dict(bh=0.02 * torch.randn(m, generator=g, device=dev),
                C2=f(NC, m, lo=0.1, hi=0.9), C4=f(NC, m, lo=1e-4, hi=1e-3),
                s1=f(NC, m, lo=1.0, hi=2.0), u=f(NC, m),
                z=torch.randn((NC, m), generator=g, device=dev),
                cb=0.02 * torch.randn((NC, m), generator=g, device=dev)
                * (f(NC, m) < 0.3),
                inv_odd_p=f(NC, lo=1.0, hi=1e3), p=f(NC, lo=1e-3, hi=0.5),
                sparse=torch.arange(NC, device=dev) % 2 == 1,
                dp=0.02 * torch.randn((NC, sb.dp_len), generator=g,
                                      device=dev))


def lasso_state(torch, gsk, sb, g):
    """lassosum2's 120 grid points after 3 sweeps, one in five frozen."""
    dev, m, NG = sb.device, sb.m, 120
    ls = dict(bh=0.02 * torch.randn(m, generator=g, device=dev),
              pf=0.8 + 0.7 * torch.rand(m, generator=g, device=dev),
              lam=torch.as_tensor(np.tile(np.geomspace(0.05, 5e-4, 30), 4),
                                  dtype=torch.float32, device=dev),
              delta=torch.as_tensor(np.repeat([0.001, 0.01, 0.1, 1.0], 30),
                                    dtype=torch.float32, device=dev),
              dp=sb.dp0(NG), beta=torch.zeros((NG, m), device=dev),
              active=torch.arange(NG, device=dev) % 5 != 3)
    for _ in range(3):
        gsk.lassosum_sweep(sb, ls["dp"], ls["beta"], ls["bh"], ls["pf"],
                           ls["lam"], ls["delta"],
                           torch.ones(NG, dtype=torch.bool, device=dev))
    return ls


def timed(torch, fn, reps):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
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
        t = t + 0 if t.is_floating_point() else t     # -0 -> +0
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sweep_case(torch, gsk, sb, st, reps, shrink=0.95, no_jump=True):
    """(LDpred2 ms a sweep, its outputs' hash)."""
    def sweep():
        dp = st["dp"].clone()
        out = gsk.sweep(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"],
                        st["s1"], st["u"], st["z"], st["inv_odd_p"], st["p"],
                        st["sparse"], shrink, no_jump)
        return (dp,) + tuple(out)

    return timed(torch, sweep, reps), digest(sweep())


def lasso_case(torch, gsk, sb, ls, reps):
    """(lassosum ms a sweep, its outputs' hash)."""
    def lasso():
        dp, beta = ls["dp"].clone(), ls["beta"].clone()
        out = gsk.lassosum_sweep(sb, dp, beta, ls["bh"], ls["pf"],
                                 ls["lam"], ls["delta"], ls["active"])
        return (dp, beta) + tuple(out)

    return timed(torch, lasso, reps), digest(lasso())


def time_case(torch, gsk, sb, st, ls, reps):
    """(LDpred2 ms a sweep, its outputs' hash, lassosum ms, hash) on one
    band (ring_variants_probe.py's entry)."""
    return (sweep_case(torch, gsk, sb, st, reps)
            + lasso_case(torch, gsk, sb, ls, reps))


def run(root, args):
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import bigsnpr_tpu_torch  # noqa: F401
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    if not os.path.abspath(bigsnpr_tpu_torch.__file__).startswith(root):
        raise SystemExit(f"imported {bigsnpr_tpu_torch.__file__}, not {root}")
    res, plans = {}, {}
    if args.blocked:
        sb2, st30, st9, sb4, ls = make_blocked(torch, gsk, args.seed)
        res["auto30"] = sweep_case(torch, gsk, sb2, st30, args.reps)
        res["grid9"] = sweep_case(torch, gsk, sb2, st9, args.reps, 1.0,
                                  False)
        res["lasso120"] = lasso_case(torch, gsk, sb4, ls, args.reps)
        plans = {"slice2": {k: tuple(v) for k, v in sb2.plans.items()},
                 "slice4": {k: tuple(v) for k, v in sb4.plans.items()}}
    else:
        sb, st, ls = make_case(torch, gsk, args.m, args.W, args.seed)
        res["sweep"] = sweep_case(torch, gsk, sb, st, args.reps)
        res["lasso"] = lasso_case(torch, gsk, sb, ls, args.reps)
        plans = {k: tuple(v) for k, v in sb.plans.items()}
    kv = " ".join(f"{k}_ms={ms:.3f} {k}_hash={h}" for k, (ms, h) in
                  res.items())
    print(f"RESULT root={root} {kv}", flush=True)
    print(f"  plans={plans} launches={dict(gsk.launches)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--compare", default=None)
    ap.add_argument("--blocked", action="store_true")
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
        run(args.root, args)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for tag, root in (("parent", args.compare), ("this", here),
                      ("this", here), ("parent", args.compare)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--m", str(args.m), "--W", str(args.W), "--reps",
             str(args.reps), "--seed", str(args.seed)]
            + (["--blocked"] if args.blocked else []),
            capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stdout.write(out.stderr[-4000:])
            return 1
        line = [x for x in out.stdout.splitlines()
                if x.startswith("RESULT")][-1]
        results.append((tag, dict(x.split("=", 1) for x in line.split()[1:])))
    names = [k[:-3] for k in results[0][1] if k.endswith("_ms")]
    for tag, kv in results:
        print(f"{tag:7s} " + "  ".join(
            f"{n} {kv[n + '_ms']:>9s} ms ({kv[n + '_hash']})" for n in names))
    same = all(len({kv[n + "_hash"] for _, kv in results}) == 1
               for n in names)
    print(f"one sweep's outputs identical in both trees (-0 folded): {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
