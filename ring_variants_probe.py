#!/usr/bin/env python3
"""Where the sweep kernel's time goes, on one GPU (gibbs_ring_kernel<T,
LASSO, NCMAX>, bigsnpr_tpu_torch/csrc/gibbs_sweep.cu).

    python3 ring_variants_probe.py [--blocked] [--m M] [--W W] [--reps R]
                                   [--variants NAME ...]

On gdp_probe.py's band (M variants, half-width W; slice 5's shape by
default), times the LDpred2 sweep at 30 chains and the lassosum mode at
120 grid points (ms a sweep, CUDA events over R sweeps after a warm-up);
with --blocked, on gdp_probe.py's blocked bands, the LDpred2 sweep at 30
chains, 9 (the grid, shrink 1) and 1 (K3's shape) on slice 2's shape and
the lassosum mode at 120 grid points on slice 4's. Then it builds
variants of the kernel source, each a set of the changes below (with the
plan's constants that mirror them), prints ptxas' registers and spills
of each, and times them on the same state. A variant that only changes
how the code is laid out or grouped keeps the outputs' hash; the others
give wrong results and exist only to be timed.

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
  c8, c4, c3 eight, four or three chains a CTA at most (the wide
             instantiation's launch bound: 96, 128 or 168 registers a
             thread), not seven
  s16        band stages of 16 rows, not 8 (four are then two tiles)
  s3         three band stages, not four (a tile's rows)
  late_nxt   the row warp loads the next tile's inputs after the tile's
             rows, not before them
  clock      (one band only) clock64() around the phases of a tile, for
             CTA 0 (the row
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
         "        if (lane == 0 && blockIdx.x == 0 && 4 * t + 3 < a.m) {\n"
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
         "      if (ut == 0 && blockIdx.x == 0 && 4 * t + 3 < a.m &&\n"
         "          (!LASSO || nct > 1)) {\n"
         "        T* q = LASSO ? a.out_beta + (int64_t)(c0 + 1) * a.m + 4 * t\n"
         "                     : a.out_binc + (int64_t)c0 * a.m + 4 * t;\n"
         "        q[0] = T(tu1 - tu0); q[1] = T(tub - tu1);\n"
         "        q[2] = T(tu2 - tub); q[3] = T(tu3 - tu2);\n"
         "      }\n"
         "      ring::mbar_arrive(done + (t & 1));\n")],
}
CHANGES.update({
    "c8": [("constexpr int RMAXC = 7;", "constexpr int RMAXC = 8;")],
    "c4": [("constexpr int RMAXC = 7;", "constexpr int RMAXC = 4;")],
    "s16": [("constexpr int RSR = 8;", "constexpr int RSR = 16;")],
    "s3": [("constexpr int RSTAGES = 4;", "constexpr int RSTAGES = 3;")],
    "c3": [("constexpr int RMAXC = 7;", "constexpr int RMAXC = 3;")],
    "late_nxt": [("""        const RingIn<T, LASSO> nxt = ring_load<T, LASSO>(a, g1, c);
""", ""), ("""        // this tile's entries are complete for it: back to the ring
""", """        const RingIn<T, LASSO> nxt = ring_load<T, LASSO>(a, g1, c);
        // this tile's entries are complete for it: back to the ring
""")],
})
VARIANTS = {"roll": ["roll"], "no_update": ["no_update"],
            "off_chain": ["off_chain"], "no_div": ["no_div"],
            "no_exp": ["no_exp"], "clock": ["clock"], "c8": ["c8"],
            "c4": ["c4"], "c3": ["c3"], "s16": ["s16"], "s3": ["s3"],
            "late_nxt": ["late_nxt"]}
# the plan's constants that a variant changes with the kernel's
PLAN = {"c8": dict(RING_MAX_CHAINS=8), "c4": dict(RING_MAX_CHAINS=4),
        "c3": dict(RING_MAX_CHAINS=3),
        "s16": dict(RING_STAGE_ROWS=16),
        "s3": dict(RING_STAGES=3)}


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
    ap.add_argument("--blocked", action="store_true")
    ap.add_argument("--variants", nargs="*",
                    default=["direct", "one_chain", *VARIANTS])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ring_variants_probe: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke
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

    built = [v for v in args.variants if v in VARIANTS
             and not (args.blocked and v == "clock")]
    with ThreadPoolExecutor(len(built) + 1) as pool:
        base = pool.submit(gsk.build)
        libs = dict(pool.map(build, built))
        base_lib = base.result()
    for name, path in [("base", base_lib), *libs.items()]:
        print(f"{name}:", flush=True)
        chip_smoke.sweep_ptxas_summary(path)
    if args.blocked:
        sb2, st30, st9, sb4, ls = gdp_probe.make_blocked(torch, gsk,
                                                         args.seed)
        st1 = {k: v[:1] if v.dim() == 2 or k in ("inv_odd_p", "p", "sparse")
               else v for k, v in st30.items()}
    else:
        case = gdp_probe.make_case(torch, gsk, args.m, args.W, args.seed)

    def show(name):
        if args.blocked:
            res = [(what, *gdp_probe.sweep_case(torch, gsk, sb2, st, args.reps,
                                                *sh))
                   for what, st, sh in (("auto30", st30, (0.95, True)),
                                        ("grid9", st9, (1.0, False)),
                                        ("K3", st1, (0.95, True)))]
            res.append(("lasso120", *gdp_probe.lasso_case(torch, gsk, sb4, ls,
                                                          args.reps)))
            print(f"{name:16s} " + "  ".join(
                f"{w} {ms:8.3f} ms ({h})" for w, ms, h in res), flush=True)
            print(f"  plans {[tuple(v) for v in sb2.plans.values()]} "
                  f"{[tuple(v) for v in sb4.plans.values()]}", flush=True)
            return
        ms_s, h_s, ms_l, h_l = gdp_probe.time_case(torch, gsk, *case,
                                                   args.reps)
        print(f"{name:16s} LDpred2 {ms_s:9.3f} ms ({h_s})  lassosum "
              f"{ms_l:9.3f} ms ({h_l})", flush=True)
        print(f"  plans {[tuple(v) for v in case[0].plans.values()]}",
              flush=True)
        if name == "clock":
            clocks(*case)

    bands = [sb2, sb4] if args.blocked else [case[0]]

    def replan(**consts):
        """Plan anew with the plan's constants set to `consts`."""
        for k, v in consts.items():
            setattr(gsk, k, v)
        for sb in bands:
            sb.plans.clear()

    def clocks(sb, st, ls):
        dp = st["dp"].clone()
        out = gsk.sweep(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"],
                        st["s1"], st["u"], st["z"], st["inv_odd_p"], st["p"],
                        st["sparse"], 0.95, True)
        beta = ls["beta"].clone()
        gsk.lassosum_sweep(sb, ls["dp"].clone(), beta, ls["bh"], ls["pf"],
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

    defaults = {k: getattr(gsk, k) for k in
                ("RING_MAX_CHAINS", "RING_STAGE_ROWS", "RING_ENTRIES",
                 "RING_STAGES")}
    show("base")
    for name, change in (("direct", dict(stage=0)),
                         ("one_chain", dict(nct=1, threads=gsk.ring_threads(1)))):
        if name in args.variants:
            for sb in bands:
                for k, v in list(sb.plans.items()):
                    pl = v._replace(**change)
                    sb.plans[k] = pl._replace(smem=gsk.ring_smem_bytes(
                        pl.nct, pl.ring_len, sb.band.element_size(),
                        pl.stage))
            show(name)
            replan()
    load = gsk._load
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        gsk._bind(lib)
        gsk._load = lambda lib=lib: lib
        replan(**PLAN.get(name, {}))
        show(name)
        replan(**defaults)
    gsk._load = load
    show("base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
