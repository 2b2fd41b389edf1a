#!/usr/bin/env python3
"""Where the ring mode's time goes, on one GPU (the sweep kernel's
gibbs_ring_kernel<T, LASSO>, bigsnpr_tpu_torch/csrc/gibbs_sweep.cu).

    python3 ring_variants_probe.py [--m M] [--W W] [--reps R]
                                   [--variants NAME ...]

On gdp_probe.py's band (M variants, half-width W; slice 5's shape by
default), times the LDpred2 sweep at 30 chains and the lassosum mode at
120 grid points (ms a sweep, CUDA events over R sweeps after a warm-up),
then builds variants of the kernel source, each a set of the changes
below, and times them on the same state. A variant that only changes how
the code is laid out keeps the outputs' hash; the others give wrong
results and exist only to be timed.

  roll       the row warp's chain of 32 rows a tile is a loop, not unrolled
  no_update  the update threads skip the window's rank-32 update (they
             still fold the partials, stage the band and move dp in and
             out)
  direct     (no rebuild) the plan's band stages turned off: the update
             threads read the band in place
  one_chain  (no rebuild) one chain a CTA whatever the plan says
  off_chain  a row's broadcast diff no longer depends on its scalar step
             (the step still runs): the chain without the step's latency
  no_div     the LDpred2 step's two divisions are multiplications
  no_exp     the LDpred2 step's exp is left out
  clock      clock64() around the phases of a tile, for CTA 0 (the row
             warps of chains 0 and 1 in the lassosum mode):
             the row warp's start of tile (strip copy issued, inputs
             loaded), chain of rows, wait for the update threads and end
             of tile; the update threads' wait for the row warp, their
             fold (and warp 0's strip copies), their rank-32 update (with
             its waits for the band stages) and the rest of the step.
             Written
             over the LDpred2 sweep's postp and beta_inc outputs (the
             lassosum mode's betas of grid points 0 and 1); printed as
             cycles a tile (median and 90th percentile, tiles >= 1)

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

CHANGES = {
    "roll": [("#pragma unroll\n          for (int i = 0; i < RK; ++i) row(i);",
              "#pragma unroll 1\n          for (int i = 0; i < RK; ++i) row(i);")],
    "no_update": [("for (int k = 0; P.q0 + k * RNU < span; k += 2) {",
                   "for (int k = 0; P.q0 + k * RNU < 0; k += 2) {"),
                  ("mk[k] = (P.valid(q) && hi >= lo) ? (2u << hi) - (1u << lo) : 0u;",
                   "mk[k] = 0u;")],
    "off_chain": [("const T d = __shfl_sync(0xffffffffu, diff, i);",
                   "const T d = __shfl_sync(0xffffffffu, cur * T(1e-30), i);")],
    "no_div": [("T(1) / (T(1) + iops1 * exp_t(-C3 * C3 / in.c4 * T(0.5)));",
                "T(1) * (T(1) + iops1 * exp_t(-C3 * C3 * in.c4 * T(0.5)));")],
    "no_exp": [("T(1) / (T(1) + iops1 * exp_t(-C3 * C3 / in.c4 * T(0.5)));",
                "T(1) / (T(1) + iops1 * (-C3 * C3 / in.c4 * T(0.5)));")],
    "clock": [
        ("        const int64_t f0 = f00 + (int64_t)j0 * wk;\n",
         "        const long long tcs = clock64();\n"
         "        const int64_t f0 = f00 + (int64_t)j0 * wk;\n"),
        ("        ring::mbar_wait(sfull + t % RSTRIPS, (t / RSTRIPS) & 1);\n",
         "        const long long tc0 = clock64();\n"
         "        ring::mbar_wait(sfull + t % RSTRIPS, (t / RSTRIPS) & 1);\n"),
        ("        // this tile's entries are complete for it: back to the ring\n",
         "        const long long tc1 = clock64();\n"),
        ("        const int en = j0 + RK + W + lane;\n",
         "        const long long tc2 = clock64();\n"
         "        const int en = j0 + RK + W + lane;\n"),
        ("        ring::mbar_arrive(ready + (t & 1));\n"
         "        if (lane < nrow && in.g >= 0) {",
         "        const long long tc3 = clock64();\n"
         "        if (lane == 0 && blockIdx.y == 0 && 4 * t + 3 < a.m) {\n"
         "          T* q = (LASSO ? a.out_beta : a.out_postp)\n"
         "                 + (int64_t)c * a.m + 4 * t;\n"
         "          q[0] = T(tc0 - tcs); q[1] = T(tc1 - tc0);\n"
         "          q[2] = T(tc2 - tc1); q[3] = T(tc3 - tc2);\n"
         "        }\n"
         "        ring::mbar_arrive(ready + (t & 1));\n"
         "        if (lane < nrow && in.g >= 0) {"),
        ("      ring::mbar_wait(ready + (t & 1), (t >> 1) & 1);\n",
         "      const long long tu0 = clock64();\n"
         "      ring::mbar_wait(ready + (t & 1), (t >> 1) & 1);\n"
         "      const long long tu1 = clock64();\n"),
        ("      // every entry the tile reaches but the row warp's two tiles: the\n",
         "      const long long tub = clock64();\n"
         "      // every entry the tile reaches but the row warp's two tiles: the\n"),
        ("      if (t >= 1) {  // entries j0 - RK .. j0 - 1: no later row touches them\n",
         "      const long long tu2 = clock64();\n"
         "      if (t >= 1) {  // entries j0 - RK .. j0 - 1: no later row touches them\n"),
        ("      ring::mbar_arrive(done + (t & 1));\n",
         "      const long long tu3 = clock64();\n"
         "      if (ut == 0 && blockIdx.y == 0 && 4 * t + 3 < a.m &&\n"
         "          (!LASSO || nct > 1)) {\n"
         "        T* q = LASSO ? a.out_beta + (int64_t)(c0 + 1) * a.m + 4 * t\n"
         "                     : a.out_binc + (int64_t)c0 * a.m + 4 * t;\n"
         "        q[0] = T(tu1 - tu0); q[1] = T(tub - tu1);\n"
         "        q[2] = T(tu2 - tub); q[3] = T(tu3 - tu2);\n"
         "      }\n"
         "      ring::mbar_arrive(done + (t & 1));\n")],
}
VARIANTS = {"roll": ["roll"], "no_update": ["no_update"],
            "off_chain": ["off_chain"], "no_div": ["no_div"],
            "no_exp": ["no_exp"], "clock": ["clock"]}


def variant_source(src, name):
    for key in VARIANTS[name]:
        for old, new in CHANGES[key]:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: the kernel source changed")
            src = src.replace(old, new)
    return src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--W", type=int, default=458)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--variants", nargs="*",
                    default=["direct", "one_chain", *VARIANTS])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ring_variants_probe: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import gdp_probe
    from bigsnpr_tpu_torch.ops import cuda_build
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    src = gsk.SOURCE.read_text()

    def build(name):
        d = cuda_build.BUILD_DIR / "variants" / name.replace("+", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in gsk.SOURCE.parent.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        path = d / gsk.SOURCE.name
        path.write_text(variant_source(src, name))
        return name, cuda_build.build(path, extra=gsk.EXTRA_FLAGS)

    built = [v for v in args.variants if v in VARIANTS]
    with ThreadPoolExecutor(len(built) + 1) as pool:
        base = pool.submit(gsk.build)
        libs = dict(pool.map(build, built))
        base.result()
    case = gdp_probe.make_case(torch, gsk, args.m, args.W, args.seed)
    print(f"plans: {[tuple(v) for v in case[0].plans.values()]}", flush=True)

    def show(name):
        ms_s, h_s, ms_l, h_l = gdp_probe.time_case(torch, gsk, *case,
                                                   args.reps)
        print(f"{name:16s} LDpred2 {ms_s:9.3f} ms ({h_s})  lassosum "
              f"{ms_l:9.3f} ms ({h_l})", flush=True)
        if name == "clock":
            clocks(*case)

    def clocks(sb, st, ls):
        dp = st["dp"].clone()
        out = gsk.sweep(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"],
                        st["s1"], st["u"], st["z"], st["inv_odd_p"], st["p"],
                        st["sparse"], 0.95, True)
        beta = ls["beta"].clone()
        gsk.lassosum_sweep(sb, ls["dp"].clone(), beta, st["bh"], ls["pf"],
                           ls["lam"], ls["delta"], ls["active"])
        T = -(-sb.max_rows // gsk.RING_ROWS)
        row = ("start of tile", "chain of rows", "wait for update",
               "end of tile")
        upd = ("wait for row warp", "fold and strips",
               "rank-32 update (band stages awaited)", "rest")
        for what, t, names in (("LDpred2 row warp", out[2][0], row),
                               ("LDpred2 update threads", out[3][0], upd),
                               ("lassosum row warp", beta[0], row),
                               ("lassosum update threads", beta[1], upd)):
            x = t[:4 * T].double().view(T, 4)[1:, :len(names)].cpu()
            q = torch.quantile(x, torch.tensor([0.5, 0.9],
                                               dtype=torch.float64), dim=0)
            print(f"  {what}, cycles a tile (median / p90): " + ", ".join(
                f"{n} {q[0, k]:.0f} / {q[1, k]:.0f}"
                for k, n in enumerate(names)), flush=True)

    show("base")
    for name, change in (("direct", dict(stage=0)),
                         ("one_chain", dict(nct=1, threads=gsk.ring_threads(1)))):
        if name in args.variants:
            saved = dict(case[0].plans)
            for k, v in saved.items():
                case[0].plans[k] = v._replace(**change)
            show(name)
            case[0].plans.update(saved)
    load = gsk._load
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        gsk._bind(lib)
        gsk._load = lambda lib=lib: lib
        show(name)
    gsk._load = load
    show("base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
