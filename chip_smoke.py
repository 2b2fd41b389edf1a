#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py [--seed S] [--n N] [--m M]

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build the CUDA kernels from bigsnpr_tpu_torch/csrc/ (nvcc);
  3. hold each kernel against its plain-torch twin on the card at awkward
     shapes (n = 1, 2, 3 mod 4, ragged m, NA, monomorphic and scale-0
     variants, l in {1, 12, 20, 50}), then on the first 4,096 variants of
     the full-size cohort;
  4. the main path at full size: a 50,000 x 100,000 cohort written to
     .bed, then snp_readBed -> bed_scaleBinom -> snp_randomSVD(k=10) ->
     snp_simuPheno -> big_univLinReg(covar = PCs) -> gwas_pvalues ->
     snp_PRS(50 thresholds), with the kernels' launch counts; its results
     are checked with no JAX (PCA residuals, GWAS against a dense float64
     regression, r(PRS, y) on the test set);
  5. each kernel timed at every shape the main path gives it, beside its
     plain twin, one torch.matmul on the pre-decoded f32 matrix, and its
     bound.

The last two lines are the kernel table and {"ok": true, "device": ...}.
Without a CUDA device the script exits non-zero and prints no result.
`--rehearse-cpu` runs the same phases on the CPU through the twins at the
given small size, to check the script itself; it too ends non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
TOL = 1e-4   # kernel vs twin: max |diff| <= TOL * max |twin|, f32 sums in two orders
SOURCE = "bigsnpr_tpu_torch/csrc/geno_gemm.cu"
REPLACES = {"cprod": "bigsnpr_tpu/ops/pallas_kernels.py:583",
            "prod": "bigsnpr_tpu/ops/pallas_kernels.py:636"}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class Timer:
    """Milliseconds per call: CUDA events around `reps` calls on the card,
    the host clock on the CPU."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def __call__(self, fn, reps=5, warmup=1):
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def rel_err(out, ref):
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    return err, err / max(scale, 1e-30)


def check_kernel_pair(gk, torch, dev, packed, n, center, inv, l, rng, tag):
    """K1 and K2 against their twins on one input; returns max abs errors."""
    m = packed.shape[0]
    V = torch.as_tensor(rng.standard_normal((n, l)), dtype=torch.float32,
                        device=dev)
    U = torch.as_tensor(rng.standard_normal((m, l)), dtype=torch.float32,
                        device=dev)
    errs = {}
    for name, kern, plain, W in (("cprod", gk.cprod, gk.cprod_plain, V),
                                 ("prod", gk.prod, gk.prod_plain, U)):
        out = kern(packed, n, W, center, inv)
        ref = plain(packed, n, W, center, inv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"{tag} {name}: non-finite output")
        err, rel = rel_err(out, ref)
        if rel > TOL:
            fail(f"{tag} {name} l={l}: rel max err {rel:.3e} > {TOL}")
        errs[name] = err
        log(f"  {tag} {name:5s} n={n} m={m} l={l}: max abs err {err:.3e} "
            f"(rel {rel:.2e})")
    return errs


def small_pack(rng, n, m):
    """Random codes with 5% NA, a monomorphic variant every 37 and an
    all-NA variant; the pad bits of the last byte are zero, as in a .bed."""
    codes = rng.choice(np.array([0, 2, 3], np.uint8), size=(m, n))
    codes[rng.random((m, n)) < 0.05] = 1
    codes[::37] = 0
    codes[m // 2] = 1
    nb = (n + 3) // 4
    pad = np.zeros((m, nb * 4), np.uint8)
    pad[:, :n] = codes
    q = pad.reshape(m, nb, 4)
    return (q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4 | q[..., 3] << 6
            ).astype(np.uint8)


def phase_small_shapes(gk, torch, dev, rng):
    log("[3] kernels vs plain twins at awkward shapes")
    for n, m, l in ((1001, 777, 1), (1002, 1500, 12), (1003, 3001, 20),
                    (4097, 513, 50), (20000, 2100, 20)):
        packed = torch.as_tensor(small_pack(rng, n, m), device=dev)
        center = rng.uniform(0.1, 1.9, m)
        scale = rng.uniform(0.3, 1.0, m)
        scale[::11] = 0.0                       # scale-0 rule: inv 0, center 2
        inv = np.where(scale > 0, 1 / np.where(scale > 0, scale, 1), 0.0)
        center = np.where(scale > 0, center, 2.0)
        check_kernel_pair(
            gk, torch, dev, packed, n,
            torch.as_tensor(center, dtype=torch.float32, device=dev),
            torch.as_tensor(inv, dtype=torch.float32, device=dev), l, rng,
            "small")


def make_cohort(torch, dev, n, m, seed, chunk=4096):
    """(m, ceil(n/4)) packed genotypes made on the device from `seed`:
    3 populations (Balding-Nichols, Fst 0.02) over ancestral allele
    frequencies ~ U(0.05, 0.5); 1% NA on 5% of the variants."""
    rng = np.random.default_rng(seed)
    p_anc = rng.uniform(0.05, 0.5, m)
    F = 0.02
    a, b = p_anc * (1 - F) / F, (1 - p_anc) * (1 - F) / F
    P = np.clip(rng.beta(a[:, None], b[:, None], size=(m, 3)), 1e-3, 1 - 1e-3)
    pop = rng.integers(0, 3, n)
    na_var = rng.random(m) < 0.05
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pop_t = torch.as_tensor(pop, device=dev)
    nb = (n + 3) // 4
    out = np.empty((m, nb), np.uint8)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    code_of = torch.tensor([3, 2, 0], dtype=torch.uint8, device=dev)
    for j0 in range(0, m, chunk):
        j1 = min(m, j0 + chunk)
        p = torch.as_tensor(P[j0:j1], dtype=torch.float32, device=dev)[:, pop_t]
        d = ((torch.rand(p.shape, generator=gen, device=dev) < p).to(torch.uint8)
             + (torch.rand(p.shape, generator=gen, device=dev) < p))
        codes = code_of[d.long()]
        miss = torch.rand(p.shape, generator=gen, device=dev) < 0.01
        miss &= torch.as_tensor(na_var[j0:j1], device=dev)[:, None]
        codes[miss] = 1
        codes = torch.nn.functional.pad(codes, (0, nb * 4 - n))
        out[j0:j1] = ((codes.view(j1 - j0, nb, 4) << shifts).sum(-1)
                      .to(torch.uint8).cpu().numpy())
    return out, pop


def dense_linreg(torch, dev, pack, y, covar, ind_row, cols):
    """Reference OLS, float64 on the device, per variant j of `cols`:
    y ~ 1 + covar + x_j with x_j mean-imputed; returns (estim, std.err)."""
    from bigsnpr_tpu_torch.core.unpack import unpack_dosage

    packed = pack.device_packed(dev)[torch.as_tensor(cols, device=dev)]
    d, na = unpack_dosage(packed, pack.n, dtype=torch.float64)
    ir = torch.as_tensor(ind_row, device=dev)
    d, na = d[:, ir], na[:, ir]
    mean = d.sum(1) / (~na).sum(1).clamp(min=1)
    X = torch.where(na, mean[:, None], d)                    # (k, n)
    yt = torch.as_tensor(y, dtype=torch.float64, device=dev)
    C = torch.as_tensor(np.column_stack([np.ones(len(y)), covar]),
                        dtype=torch.float64, device=dev)
    n, K = C.shape
    beta, se = [], []
    for k0 in range(0, len(cols), 100):
        x = X[k0:k0 + 100]
        A = torch.cat([C.expand(len(x), n, K), x[:, :, None]], dim=2)
        AtA = A.transpose(1, 2) @ A
        coef = torch.linalg.solve(AtA, A.transpose(1, 2) @ yt)
        rss = ((yt - (A @ coef[:, :, None])[..., 0]) ** 2).sum(1)
        cov = torch.linalg.inv(AtA)[:, K, K]
        beta.append(coef[:, K])
        se.append(torch.sqrt(rss / (n - K - 1) * cov))
    return torch.cat(beta).cpu().numpy(), torch.cat(se).cpu().numpy()


def phase_main_path(bp, gk, torch, dev, packed_np, pop, n, m, seed, tmp):
    log(f"[4] main path at n={n} samples x m={m} variants "
        f"({packed_np.nbytes / 1e9:.3f} GB packed)")
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(n)
    ind_train, ind_test = np.sort(perm[: n * 4 // 5]), np.sort(perm[n * 4 // 5:])
    times = {}

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        log(f"  {name:16s} {times[name]:9.3f} s")
        return out

    fam = {"family.ID": np.arange(n), "sample.ID": np.arange(n),
           "paternal.ID": np.zeros(n, np.int64),
           "maternal.ID": np.zeros(n, np.int64),
           "sex": np.ones(n, np.int64), "affection": pop + 1}
    bim = {"chromosome": np.ones(m, np.int64),
           "marker.ID": np.array([f"rs{j}" for j in range(m)]),
           "genetic.dist": np.zeros(m), "physical.pos": np.arange(1, m + 1) * 100,
           "allele1": np.full(m, "A"), "allele2": np.full(m, "G")}
    bedfile = os.path.join(tmp, "cohort.bed")
    src = bp.GenoPack(packed=packed_np, n=n, fam=fam, map=bim)

    gk.reset_launches()
    stage("snp_writeBed", lambda: bp.snp_writeBed(src, bedfile))
    pack = stage("snp_readBed", lambda: bp.snp_readBed(bedfile))
    sc = stage("bed_scaleBinom", lambda: bp.bed_scaleBinom(pack))
    svd = stage("snp_randomSVD", lambda: bp.snp_randomSVD(pack, k=10))
    sim = stage("snp_simuPheno",
                lambda: bp.snp_simuPheno(pack, h2=0.2, M=m // 50, seed=seed))
    y = sim["pheno"]
    gwas = stage("big_univLinReg", lambda: bp.big_univLinReg(
        pack, y[ind_train], covar=svd.u[ind_train], ind_row=ind_train))
    lpS = stage("gwas_pvalues", lambda: -bp.gwas_pvalues(gwas, log10=True))
    thr = np.linspace(0, np.quantile(lpS, 0.9999), 50)
    prs = stage("snp_PRS", lambda: bp.snp_PRS(
        pack, gwas["estim"], ind_test=ind_test, lpS_keep=lpS, thr_list=thr))
    launches = dict(gk.launches)
    log(f"  total            {sum(times.values()):9.3f} s; kernel launches "
        f"{launches}; randomSVD depths {svd.niter}")
    for k, v in launches.items():
        if dev.type == "cuda" and v <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # -- results, checked with the port's own means and dense float64 ------
    log("  checks:")
    if not (np.all(np.isfinite(svd.d)) and svd.u.shape == (n, 10)
            and svd.v.shape == (m, 10)):
        fail("randomSVD output shape or values")
    op = bp.GenoOperator(pack, sc["center"], sc["scale"])
    U = torch.as_tensor(svd.u, dtype=torch.float32, device=dev)
    Vv = torch.as_tensor(svd.v, dtype=torch.float32, device=dev)
    d = torch.as_tensor(svd.d, dtype=torch.float32, device=dev)
    res_v = ((op.cprod_dev(U) - Vv * d).norm(dim=0) / d).cpu().numpy()
    res_u = ((op.prod_dev(Vv) - U * d).norm(dim=0) / d).cpu().numpy()
    log(f"    PCA d = {np.round(svd.d, 3).tolist()}")
    log(f"    PCA |X~'u - d v|/d max {res_v.max():.2e} (limit 1e-3); "
        f"|X~ v - d u|/d max {res_u.max():.2e}")
    if res_v.max() > 1e-3:
        fail("randomSVD residual above 1e-3")
    # the 3 populations (Fst 0.02 over 100,000 variants) must separate on
    # the first two PCs
    r2_pop = max(np.corrcoef(svd.u[:, k], pop == p)[0, 1] ** 2
                 for k in range(2) for p in range(3))
    log(f"    PCA max r^2(PC1/2, population) {r2_pop:.3f} (floor 0.5)")
    if not r2_pop > 0.5:
        fail("the first two PCs do not separate the populations")

    cols = np.sort(rng.choice(m, 1000, replace=False))
    b_ref, se_ref = dense_linreg(torch, dev, pack, y[ind_train],
                                 svd.u[ind_train], ind_train, cols)
    b, se = gwas["estim"][cols], gwas["std.err"][cols]
    e_b = np.abs(b - b_ref) / (np.abs(b_ref) + se_ref)
    e_se = np.abs(se - se_ref) / se_ref
    log(f"    GWAS vs dense f64 on 1000 variants: estim max "
        f"|d|/(|b|+se) {e_b.max():.2e}, std.err max rel {e_se.max():.2e} "
        f"(limit 1e-4)")
    if e_b.max() > 1e-4 or e_se.max() > 1e-4:
        fail("GWAS disagrees with the dense float64 regression")

    if prs.shape != (len(ind_test), 50) or not np.isfinite(prs).all():
        fail(f"PRS shape {prs.shape} or non-finite values")
    r = np.array([np.corrcoef(prs[:, i], y[ind_test])[0, 1]
                  if prs[:, i].std() > 0 else 0.0 for i in range(50)])
    best = int(np.nanargmax(r))
    # h2 = 0.2 over M = m/50 causal variants at 40,000 training samples:
    # an ideal predictor reaches r ~ 0.4 (Daetwyler); r under the null has
    # sd 1/sqrt(10,000) = 0.01. Floor 0.1: well above chance, below C+T.
    log(f"    r(PRS, y) on {len(ind_test)} test samples: best {r[best]:.3f} "
        f"at threshold {thr[best]:.2f} (floor 0.1)")
    if not r[best] > 0.1:
        fail("PRS does not predict the phenotype")
    return pack, sc, launches


# (kernel, l, samples, what calls it on the main path); the JSON line
# carries the power step's rows, the shape of 25 of each kernel's launches
SHAPES = (("cprod", 20, "all", "randomSVD power step"),
          ("cprod", 12, "all", "big_univLinReg, [yr | 1 | 10 PCs]"),
          ("prod", 20, "all", "randomSVD power step"),
          ("prod", 1, "all", "snp_simuPheno"),
          ("prod", 50, "test", "snp_PRS, 50 thresholds"))


def kernel_rows(gk, torch, dev, pack, sc, launches, n_test, reps=10):
    """Time K1/K2 at each shape the main path gives them, beside the twin
    and one torch.matmul on the pre-decoded f32 matrix; the bound is the
    larger of bytes / 3.35 TB/s and 2nml f32 FLOP / 67 TFLOP/s."""
    from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator

    op = GenoOperator(pack, sc["center"], sc["scale"], device=dev)
    n, m = pack.n, pack.m
    packed, c, inv = op.packed, op.center, op.inv
    log(f"[5] kernel timings on the {n} x {m} cohort")
    X = torch.empty((m, n), dtype=torch.float32, device=dev)  # pre-decoded
    for j0 in range(0, m, 4096):
        X[j0:j0 + 4096] = gk.standardized(packed[j0:j0 + 4096], n,
                                          c[j0:j0 + 4096], inv[j0:j0 + 4096])
    rng = np.random.default_rng(7)
    timer = Timer(torch, dev)
    rows = []
    for name, l, samples, what in SHAPES:
        ns = n if samples == "all" else n_test
        P = packed if ns == n else packed[:, :(ns + 3) // 4].contiguous()
        Xs = X if ns == n else X[:, :ns]
        kern, plain = ((gk.cprod, gk.cprod_plain) if name == "cprod"
                       else (gk.prod, gk.prod_plain))
        W = torch.as_tensor(rng.standard_normal((ns if name == "cprod" else m,
                                                 l)),
                            dtype=torch.float32, device=dev)
        out, ref = kern(P, ns, W, c, inv), plain(P, ns, W, c, inv)
        err, rel = rel_err(out, ref)
        if rel > TOL:
            fail(f"full-size {name} l={l}: rel max err {rel:.3e} > {TOL}")
        del out, ref
        ms = timer(lambda: kern(P, ns, W, c, inv), reps=reps)
        plain_ms = timer(lambda: plain(P, ns, W, c, inv), reps=3)
        lib = (lambda: Xs @ W) if name == "cprod" else (lambda: Xs.T @ W)
        library_ms = timer(lib, reps=reps)
        rows_out = m if name == "cprod" else ns
        nbytes = P.numel() + 4 * (W.numel() + 2 * m + rows_out * l)
        flops = 2.0 * ns * m * l
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"  {name:5s} l={l:2d} n={ns}: kernel {ms:.3f} ms, twin "
            f"{plain_ms:.3f} ms, torch.matmul on decoded {library_ms:.3f} ms, "
            f"bound {max(t_bytes, t_ops):.3f} ms ({bound_by}: "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB); max abs err "
            f"{err:.3e} (rel {rel:.2e}) [{what}]")
        if l == 20:
            rows.append({
                "name": f"geno_{name} ({'K1' if name == 'cprod' else 'K2'})",
                "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": bound_by, "library_ms": library_ms})
    del X
    return rows


def phase_slice(gk, torch, dev, packed_np, n, rng, timer, l=20, k=4096):
    """The first 4,096 variants of the cohort across all samples."""
    log(f"[3b] kernels vs twins on the first {k} variants x {n} samples")
    packed = torch.as_tensor(np.ascontiguousarray(packed_np[:k]), device=dev)
    center = torch.full((k,), 0.6, dtype=torch.float32, device=dev)
    inv = torch.full((k,), 1.5, dtype=torch.float32, device=dev)
    check_kernel_pair(gk, torch, dev, packed, n, center, inv, l, rng, "slice")
    V = torch.as_tensor(rng.standard_normal((n, l)), dtype=torch.float32,
                        device=dev)
    U = torch.as_tensor(rng.standard_normal((k, l)), dtype=torch.float32,
                        device=dev)
    X = gk.standardized(packed, n, center, inv)
    for name, kern, plain, W, lib in (
            ("cprod", gk.cprod, gk.cprod_plain, V, lambda: X @ V),
            ("prod", gk.prod, gk.prod_plain, U, lambda: X.T @ U)):
        log(f"  {name:5s}: kernel "
            f"{timer(lambda: kern(packed, n, W, center, inv), 10):.3f} ms, "
            f"twin {timer(lambda: plain(packed, n, W, center, inv), 3):.3f} "
            f"ms, torch.matmul on decoded {timer(lib, 10):.3f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "bigsnpr_tpu_torch")):
        print("chip_smoke: bigsnpr_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import bigsnpr_tpu_torch as bp
    from bigsnpr_tpu_torch.ops import geno_kernels as gk

    dev = torch.device("cpu" if args.rehearse_cpu else "cuda")
    bp.config.set_device(str(dev))
    t_start = time.perf_counter()

    log("[1] device")
    smi = "not measured (CPU rehearsal)"
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
            f"CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")

    if dev.type == "cuda":
        log("[2] build")
        t0 = time.perf_counter()
        lib = gk.build(verbose=True)
        log(f"  built {os.path.relpath(lib, here)} in "
            f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    timer = Timer(torch, dev)
    phase_small_shapes(gk, torch, dev, rng)

    t0 = time.perf_counter()
    packed_np, pop = make_cohort(torch, dev, args.n, args.m, args.seed)
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} s")
    phase_slice(gk, torch, dev, packed_np, args.n, rng, timer,
                k=min(4096, args.m))

    with tempfile.TemporaryDirectory() as tmp:
        pack, sc, launches = phase_main_path(bp, gk, torch, dev, packed_np,
                                             pop, args.n, args.m, args.seed,
                                             tmp)
        rows = kernel_rows(gk, torch, dev, pack, sc, launches,
                           n_test=args.n - args.n * 4 // 5)
        del pack
    log(f"  wall time {time.perf_counter() - t_start:.1f} s")

    if dev.type != "cuda":
        print("chip_smoke: CPU rehearsal passed; no device result",
              file=sys.stderr)
        return 3
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
