#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py [--seed S] [--n N] [--m M] [--n2 N2] [--m2 M2]
                          [--burn-in B] [--num-iter I] [--n3 N3] [--m3 M3]
                          [--region R] [--n4 N4] [--m4 M4] [--n-thr T]
                          [--n-stack S] [--n5 N5] [--m5 M5] [--burn-in5 B]
                          [--num-iter5 I] [--gdp-rows R] [--n6 N6]
                          [--n6-ref R6] [--m6 M6] [--n-sumstats S]
                          [--n-grm G] [--n7 N7] [--m7 M7]
                          [--lasso-points P]

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. build the CUDA kernels from bigsnpr_tpu_torch/csrc/ (one nvcc a
     source, the three started together);
  3. hold K1 and K2 (bf16 bit planes against the operand, centred, split
     into three bf16 terms) against their plain-torch twins
     on the card at awkward shapes (n = 1, 2, 3 mod 4, ragged m, NA, monomorphic and
     scale-0 variants, l in {1, 12, 20, 50}), then on the first 4,096
     variants of the slice-1 cohort;
  4. slice 1 at full size: a 50,000 x 100,000 cohort written to .bed, then
     snp_readBed -> bed_scaleBinom -> snp_randomSVD(k=10) -> snp_simuPheno
     -> big_univLinReg(covar = PCs) -> gwas_pvalues -> snp_PRS(50
     thresholds), with the kernels' launch counts; its results are checked
     with no JAX (PCA residuals, GWAS against a dense float64 regression,
     r(PRS, y) on the test set);
  5. K1/K2 timed at every shape slice 1 gives them, beside the plain twin,
     one torch.matmul on the pre-decoded f32 matrix, and the bound: the
     GEMM on prepared operands and the whole wrapper, the bound of the
     bf16 plane algebra beside that of the f32 product; each held with
     its twin within 1e-5 of a float64 product, also on operands of mean
     far from zero (K2: |N(0,1)| + 1 at l = 20 and 1 at l = 1; K1:
     |N(0,1)| + 1 at l = 20 and the GWAS operand [yr | 1 | 10 PCs] within
     1e-5, V = 1, whose exact product is near 0, within 4x the twin's
     error), K1's two launches bit-equal and its depth splits 1, 2, 5 and
     16 within 1e-5 of each other; then K2 at 2^23 + 4,097 variants and K1
     at 2^23 + 4,097 samples (64 on the other side, random bytes), where
     the plan splits the depth into runs of at most 2^23 (the three-term
     count column stays exact in each): against the twin and float64 as
     above, and an explicit splits=1 refused;
  6. slice 2 at full size: a 20,000 x 100,000 cohort made on the card with
     latent-Gaussian AR(1) LD inside blocks of 200-3,000 variants (1% NA on
     5% of the variants), then snp_simuPheno(h2 0.4, 1,000 causal) ->
     big_univLinReg on 15,000 training samples -> snp_cor(ind_row =
     training, size 500, thr_r2 0.01, finalize "device") -> snp_ldsc2 ->
     auto_blocks + build_block_bands -> snp_ldpred2_auto(30 chains, the
     vignette's p grid, burn-in 500, 200 kept) -> ldpred2_auto_chain_qc ->
     snp_ldpred2_grid(3 x 3 p x h2 around the LDSC h2; burn-in 50, 100
     kept) -> snp_PRS on the
     5,000 test samples; the pair sums of a 1,000-variant slab against a
     float64 product, the device finalize against the host one, and the
     statistical checks (LDSC h2, chain h2, chain QC, r(PRS, y)); then
     snp_cor without the r2 floor, for what that floor saves;
  7. the Gibbs sweep kernel against its twin on the same pre-drawn u / z at
     the K3 shape (1 chain), a K4 shape (narrow bucket) and the two shapes
     the main path launches on the slice-2 bands (LDpred2-auto's 30 chains,
     and the grid's 9 cells with shrink 1 and sign jumps allowed), plus a
     float64 case, each run twice for bit-equality, timed beside the twin,
     its bound and the design's floors (the longest block's row floor, the
     card's issue floor, the band read once a chain tile), with its plan;
  8. torch.profiler around a 20-sweep snp_ldpred2_auto call on the slice-2
     data: the device's busy share and the kernels that take it (and the
     same in slice 5, [16], on the unblocked sampler);
  9. K6 (the int8 bit-plane kernels, csrc/geno_i8.cu) against its twin in
     its four instantiations at awkward shapes (n = 0..3 mod 4, ragged m,
     l in {1, 12, 20, 21}, NA and NA-free packs, monomorphic and scale-0
     variants): raw int32 sums equal, float32 within 1e-6 of max |twin|,
     two launches bit-equal; and the masked int8 operator;
 10. slice 3 at full size, pallas_mxu "int8": a 50,000 x 100,000 cohort
     made on the card (3 populations, Fst 0.02, over slice 2's AR(1) LD
     blocks; 22 chromosomes; one planted 5,000-variant long-range-LD
     region loaded by an "inversion" carrier status), 5,000 samples held
     out; snp_autoSVD(k = 10) -> snp_pcadapt -> bed_projectSelfPCA ->
     snp_simuPheno -> big_univLinReg(covar = PCs) -> gwas_pvalues, with
     K1/K2 launching 0 times from autoSVD through the GWAS (simuPheno's
     K2 aside); checks: the region found and dropped, populations on
     PC1-2 (training and projected), pcadapt's enrichment for high-Fst
     variants, GWAS against dense float64, and the same autoSVD on K1/K2
     giving the same subset and lrldr;
 11. K6 timed at the slice's shapes and at full width, NA and NA-free,
     beside the twin, torch._int_mm on pre-decoded planes and the bound;
     snp_randomSVD on an NA-free copy runs the _nona kernels alone;
 12. K7 (the bf16 bit-plane kernels, csrc/geno_split.cu) against its twin
     at awkward shapes (n = 0..3 mod 4, ragged m, l in {1, 12, 20, 21}, NA
     and NA-free packs, monomorphic and scale-0 variants): within 1e-5 of
     max |twin|, two launches bit-equal, both within 2e-5 of max |float64
     product|; then the masked split2 operator;
 13. slice 4 at full size, pallas_mxu "split2": a 20,000 x 100,000 cohort
     made on the card (slice 3's generator and 22 chromosomes, 3
     populations, no planted region), 15,000 training and 5,000 test
     samples; snp_randomSVD(k = 10) -> snp_simuPheno(h2 0.4, 1,000 causal)
     -> big_univLinReg(covar = PCs) -> gwas_pvalues -> snp_grid_clumping
     (7 x 4 grid) -> snp_grid_PRS(50 thresholds) on the training samples
     -> snp_grid_stacking on the scores of --n-stack (2,000) of them ->
     prediction of the test samples; then snp_cor (size 500 kb, thr_r2
     0.01) -> auto_blocks + bands -> snp_lassosum2(blocks, 4 x 30 grid) ->
     snp_PRS of the grid point chosen on half the test set; with K1 and K6
     launching 0 times from randomSVD through the GWAS, the same
     randomSVD on K1/K2, GWAS against dense float64, the native greedy
     against the fixed point on every cell of one chromosome, K2 against
     its twin at the grid PRS's (l = 650; also within 1e-5 of float64,
     timed, and its share of the grid PRS stage), lassosum2 scores' and
     prediction's shapes, and r(SCT, y_test), r(lassosum2, y_test) on the
     other half;
 14. K7 timed at the slice's shapes and at 50,000 x 100,000 (l = 20, random
     bytes), its GEMM on prepared operands and the whole wrapper, beside
     its twin, torch.matmul in bf16 on pre-decoded planes and its bound;
     the sweep kernel's lassosum mode at the slice's bands with its 120
     grid points, bit-equal to its twin, beside it, its bound and its
     floors;
 15. K8 (csrc/geno_i8.cu on int8 planes materialized once, int8m_planes)
     against its twin and K6 in its four instantiations at [9]'s shapes:
     raw int32 sums equal to both, outputs bit-equal to K6's; the masked
     int8m operator bit-equal to the int8 one; the sweep kernel and its
     lassosum mode against their twins on a float64 band of one block
     (--gdp-rows 29,100 rows; the "global" launches) and on 12 float32
     blocks at 30 chains and 120 grid points, several a CTA, there also
     bit-equal at one chain a CTA;
 16. slice 5 at 20,000 x 100,000 (slice 2's one-chromosome generator,
     15,000 training / 5,000 test): bed_scaleBinom ->
     GenoOperator(mxu="int8m") -> snp_randomSVD(op=) (K8 only, d / u / v
     bit-equal to the same SVD on K6; K8 against its twin at the slice's
     operands) -> snp_simuPheno -> big_univLinReg (no covariates, as in
     slice 2) -> snp_cor -> snp_ldsc2 -> snp_ldpred2_auto(blocks=None, 30
     chains, --burn-in5 300 + --num-iter5 200 sweeps, 5 timed first; the
     JAX default burn-in is 500) -> chain QC
     -> snp_ldpred2_grid(blocks=None, 3 x 3) and return_sampling_betas ->
     snp_lassosum2(blocks=None, 4 x 30) -> snp_PRS, every sweep on the
     one band; torch.profiler around 20 of the LDpred2-auto sweeps: the
     device's idle share, the driver's time a sweep beside the kernel's;
 17. (a, inside [11]) K8 timed on slice 3's 50,000 x 100,000 planes, l =
     12 and 20, NA and NA-free, beside its twin, torch._int_mm on the same
     planes and its bound, and the NA-free randomSVD on an int8m operator;
     (b) the sweep kernel at slice 5's band, LDpred2-auto's 30 chains and
     lassosum2's 120 grid points: held against its twin and timed beside
     its bound and its row floor;
 18. slice 6 on one cohort made on the card (slice 3's generator, 3
     populations, 22 chromosomes) of 2,504 reference samples (the 1000G
     panel's size) and 20,000 target samples over 200,000 variants, the
     target's map with 5% of the variants dropped, 10% reversed (genotypes
     2 - x), 5% strand-flipped and 1% ambiguous: the target's 0.95 GB
     through GenoPack.save -> snp_attach (bytes and snp_counts equal,
     GB/s); snp_match of 1,000,000 sumstats rows (the target's map and
     rows at absent positions) against the reference map (the planted
     matches, flips, reversals, removals and every beta's sign);
     bed_projectPCA(reference, reversed target, k = 10) on K1 / K2 (the
     projection equal to the unreversed target's on the same SVD within
     1e-3, PC1-2 separating the populations); bed_GRM on 10,000 target
     samples (64 rows against float64 within 1e-5, symmetric, its time
     beside 2 n^2 m over the f32 peak); snp_MAX3 (a planted causal
     variant first), snp_fst (near the generator's), snp_ancestry_summary
     (a 60/30/10 mix within 0.05) and snp_asGeneticPos (monotone); each
     stage timed on the host clock to a torch.cuda.synchronize();
 19. slice 6c, imputed dosages: slice 2's generator at 20,000 x 100,000
     (--n7, --m7) turned into 8-bit probability pairs (70% of the variants
     certain, the rest mixed with the HWE prior, an INFO spread) and
     written as a BGEN v1.2 layout-2 zlib file with its .bgi (`write_bgen`,
     compressed in a thread pool); snp_readBGI -> snp_readBGEN (GB/s; the
     native decode bit-equal to the per-variant Python decode on 1,000
     variants, info / freq within 1e-12; read_as="random" on 2,000, whose
     hard calls equal the certain dosages) -> snp_MAF and QC (MAF > 0.01,
     INFO > 0.3) -> snp_scaleBinom -> snp_randomSVD(k = 10) on the byte
     path (residual) -> a phenotype through snp_prodVec (h2 0.4, 1,000
     causal) -> marginal statistics through snp_cprodVec on 15,000
     training samples -> snp_cor (r within 1e-5 of float64 on a
     1,000-variant slab) -> snp_ldsc2 -> auto_blocks + bands ->
     snp_ldpred2_grid (3 x 3, the sweep kernel) -> snp_PRS on the 5,000
     test samples -> snp_clumping(S = |z|) -> snp_PRS at 50 thresholds ->
     snp_ld_scores -> snp_prodBGEN (device engine within 5e-6 of the host
     engine, r > 0.9999 against the pack's snp_prodVec) ->
     round_to_hardcalls -> snp_PRS on K2 (r > 0.99 against the dosage
     PRS) -> DosagePack.save / load; each stage timed; the sweep kernel and
     K2 must launch on the path; then the byte path timed at l = 20 beside
     its bound and torch.matmul, and warmup (every source built, K1, K2
     and the sweep kernel launched once each).

The last two lines are the kernel table and {"ok": true, "device": ...}.
Without a CUDA device the script exits non-zero and prints no result.
`--rehearse-cpu` runs the same phases on the CPU through the twins at the
given small size, to check the script itself (the statistical checks of
slices 2, 3, 6 and 6c are printed but only enforced on the card;
--lasso-points cuts the lassosum twin's grid in [14] and [15], --n6 to
--n-grm slice 6, --n7 / --m7 slice 6c); it too ends non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sqlite3
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
TOL = 1e-4   # kernel vs twin: max |diff| <= TOL * max |twin|, f32 sums in two orders
SOURCES = {"cprod": "bigsnpr_tpu_torch/csrc/geno_split.cu",
           "prod": "bigsnpr_tpu_torch/csrc/geno_split.cu"}
REPLACES = {"cprod": "bigsnpr_tpu/ops/pallas_kernels.py:583",
            "prod": "bigsnpr_tpu/ops/pallas_kernels.py:636"}
DENSE_TOL = 1e-5   # K1 / K2 and their twins vs float64: max |diff| / max |f64|
SWEEP_SOURCE = "bigsnpr_tpu_torch/csrc/gibbs_sweep.cu"
I8_SOURCE = "bigsnpr_tpu_torch/csrc/geno_i8.cu"
I8_REPLACES = {"cprod_i8": "bigsnpr_tpu/ops/pallas_kernels.py:255",
               "cprod_i8_nona": "bigsnpr_tpu/ops/pallas_kernels.py:273",
               "prod_i8": "bigsnpr_tpu/ops/pallas_kernels.py:290",
               "prod_i8_nona": "bigsnpr_tpu/ops/pallas_kernels.py:311"}
I8_TOL = 1e-6   # K6 vs twin: same integer sums, same f32 epilogue (--fmad=false)
I8M_REPLACES = {"cprod_i8m": "bigsnpr_tpu/ops/pallas_kernels.py:463",
                "cprod_i8m_nona": "bigsnpr_tpu/ops/pallas_kernels.py:450",
                "prod_i8m": "bigsnpr_tpu/ops/pallas_kernels.py:493",
                "prod_i8m_nona": "bigsnpr_tpu/ops/pallas_kernels.py:478"}
PEAK_INT8_OP_PER_S = 1979e12
SPLIT_SOURCE = "bigsnpr_tpu_torch/csrc/geno_split.cu"
SPLIT_REPLACES = {"cprod_split": "bigsnpr_tpu/ops/pallas_kernels.py:136",
                  "prod_split": "bigsnpr_tpu/ops/pallas_kernels.py:165"}
SPLIT_TOL = 1e-5     # K7 vs twin: f32 sums of exact products in two orders
SPLIT_DENSE_TOL = 2e-5   # K7 and twin vs float64 (tests/test_pallas.py's bound)
PEAK_BF16_FLOP_PER_S = 989e12
LASSO_REPLACES = "bigsnpr_tpu/pgs/gibbs_blocked.py:1427"
# the unblocked samplers' lax.scans, which the sweep kernel also replaces
GDP_REPLACES = {"sweep": "bigsnpr_tpu/pgs/gibbs.py:28",
                "lassosum": "bigsnpr_tpu/pgs/gibbs.py:373"}
K7 = tuple(SPLIT_REPLACES)
K1K2 = ("cprod", "prod")
K6 = tuple(I8_REPLACES)
SWEEP_TOL = 1e-5   # sweep vs twin: max |diff| <= SWEEP_TOL * max |twin|
# the sweep kernel's row floor: a row's dependent chain in the row warp (its
# scalar step from dp[j + W], one shuffle of the diff, one multiply and add
# into the next lane's entry; no barrier, no memory access). LDpred2:
# ~12 dependent float ops, two IEEE divisions and an exp, ~200 cycles in
# float32 and ~500 in float64; lassosum: ~8 ops and one division, ~100 and
# ~250. Printed beside the bound: the longest block's rows x this
RING_ROW_CYCLES = {("sweep", 4): 200, ("sweep", 8): 500,
                   ("lassosum", 4): 100, ("lassosum", 8): 250}
# the card's issue floor: the instructions a row warp issues a row (every
# lane runs the step: ~100 for the LDpred2 step in float32, about twice in
# float64, half for lassosum; an estimate, not a count of the SASS), plus
# one multiply-add instruction a band value and 32 chains, over 132 SMs x
# 4 schedulers issuing one a cycle
ROW_ISSUE = {("sweep", 4): 100, ("sweep", 8): 200,
             ("lassosum", 4): 50, ("lassosum", 8): 100}
SMS, SCHEDULERS = 132, 4
CLOCK_HZ = 1.98e9
N_CHAINS = 30     # LDpred2-auto chains: the vignette's vec_p_init length
GRID_CELLS = 9    # LDpred2-grid: 3 p x 3 h2


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class Timer:
    """Milliseconds per call: CUDA events around `reps` calls after
    `warmup` on the card; on the CPU (a rehearsal, whose times are never
    reported) the host clock around one call."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def __call__(self, fn, reps=5, warmup=1):
        torch = self.torch
        if self.dev.type != "cuda":
            reps, warmup = 1, 0
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
    for k in K1K2:
        if dev.type == "cuda" and launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if dev.type == "cuda" and any(launches[k] for k in K6):
        fail("slice 1 (pallas_mxu \"highest\") launched K6")

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


def bound_planes(P, W_rows, l, rows_out, nm, terms):
    """Least time of a bit-plane product (K2: 3 terms, K7: 2): bytes read
    once and written once over 3.35 TB/s, or 2 planes x terms x 2 l n m
    bf16 operations over 989 TFLOP/s, the larger."""
    nbytes = P.numel() + 4 * (W_rows * l + 2 * P.shape[0] + rows_out * l)
    ops = 2.0 * 2 * terms * l * nm
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_BF16_FLOP_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, nbytes, ops


def plane_launch_only(gk, prod, terms, P, n, W, c, inv):
    """One bit-plane GEMM (with its epilogue) on an operand prepared once
    (`_plane_operands`): what the library yardstick also leaves out.
    Returns the function and the plan it runs on."""
    m = P.shape[0]
    l = W.shape[1]
    plan = gk.plane_plan(prod, terms, m, n, l,
                         gk._sm_count(W.device) if W.is_cuda else 132)
    if not W.is_cuda:     # CPU rehearsal: the wrapper runs its twin
        kern = ({True: gk.prod, False: gk.cprod} if terms == 3 else
                {True: gk.prod_split, False: gk.cprod_split})[prod]
        return (lambda: kern(P, n, W, c, inv)), plan
    op, sums, rc = gk._plane_operands(prod, terms, W, c, inv, plan)
    if rc != 0:
        fail(f"the bit-plane operand preparation failed: {rc} ({plan})")

    def run():
        out, rc = gk._plane_gemm(prod, terms, P, n, op, sums, l, c, inv,
                                 plan)
        if rc != 0:
            fail(f"the bit-plane GEMM launch failed: {rc} ({plan})")
        return out
    return run, plan


def product64(torch, packed, n, c, inv, W, prod, chunk=4096):
    """The float64 product X~ W (prod) or X~^T W (cprod), variant chunk by
    chunk, NA -> 0."""
    m = packed.shape[0]
    W64 = W.double()
    out = torch.zeros((n if prod else m, W.shape[1]), dtype=torch.float64,
                      device=W.device)
    for j0 in range(0, m, chunk):
        j1 = min(m, j0 + chunk)
        X = dense64(torch, packed[j0:j1], n, c[j0:j1], inv[j0:j1])
        if prod:
            out += X.T @ W64[j0:j1]
        else:
            out[j0:j1] = X @ W64
    return out


def rel64(y, ref64):
    """max |y - ref64| / max |ref64|."""
    return float((y.double() - ref64).abs().max()) / max(
        float(ref64.abs().max()), 1e-300)


def check_dense(torch, P, n, c, inv, W, out, ref, what, prod=True):
    """K2 (prod) or K1 and its twin against a float64 product: both within
    DENSE_TOL of max |float64|; returns the two relative errors."""
    ref64 = product64(torch, P, n, c, inv, W, prod)
    d_k, d_t = rel64(out, ref64), rel64(ref, ref64)
    if max(d_k, d_t) > DENSE_TOL:
        fail(f"{'K2' if prod else 'K1'} ({what}) or its twin is off the "
             f"float64 product: {d_k:.2e} / {d_t:.2e} > {DENSE_TOL}")
    return d_k, d_t


def kernel_rows(gk, torch, dev, pack, sc, launches, n_test, reps=10):
    """Time K1/K2 at each shape the main path gives them, beside the twin
    and one torch.matmul on the pre-decoded f32 matrix. The bound is that
    of the bf16 plane algebra (2 planes x 3 terms x 2nml / 989 TFLOP/s),
    with the f32 product's beside it. Each kernel is timed as its GEMM on
    an operand prepared once and as the whole wrapper, and held with its
    twin within 1e-5 of a float64 product; then on operands of mean far
    from zero (`k1_checks` for K1)."""
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
        prod = name == "prod"
        ns = n if samples == "all" else n_test
        P = packed if ns == n else packed[:, :(ns + 3) // 4].contiguous()
        Xs = X if ns == n else X[:, :ns]
        kern, plain = ((gk.prod, gk.prod_plain) if prod
                       else (gk.cprod, gk.cprod_plain))
        W = torch.as_tensor(rng.standard_normal((m if prod else ns, l)),
                            dtype=torch.float32, device=dev)
        out, ref = kern(P, ns, W, c, inv), plain(P, ns, W, c, inv)
        err, rel = rel_err(out, ref)
        if rel > TOL:
            fail(f"full-size {name} l={l}: rel max err {rel:.3e} > {TOL}")
        d64 = check_dense(torch, P, ns, c, inv, W, out, ref, what, prod)
        del out, ref
        wrapper_ms = timer(lambda: kern(P, ns, W, c, inv), reps=reps)
        plain_ms = timer(lambda: plain(P, ns, W, c, inv), reps=3)
        lib = (lambda: Xs.T @ W) if prod else (lambda: Xs @ W)
        library_ms = timer(lib, reps=reps)
        rows_out = ns if prod else m
        t_f32 = 2.0 * ns * m * l / PEAK_F32_FLOP_PER_S * 1e3
        run, plan = plane_launch_only(gk, prod, 3, P, ns, W, c, inv)
        ms = timer(run, reps=reps)
        del run
        bound, bound_by, nbytes, ops = bound_planes(
            P, m if prod else ns, l, rows_out, ns * m, 3)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        log(f"  {name:5s} l={l:2d} n={ns}: kernel {ms:.3f} ms (GEMM + "
            f"epilogue on an operand prepared once; the whole wrapper "
            f"{wrapper_ms:.3f} ms; {ops / ms / 1e9:.1f} TFLOP/s bf16), "
            f"twin {plain_ms:.3f} ms, torch.matmul on decoded "
            f"{library_ms:.3f} ms, {plan_text(plan)}; bound "
            f"{bound:.3f} ms ({bound_by}: {ops / 1e12:.3f} TFLOP bf16 "
            f"over 989 TFLOP/s = "
            f"{ops / PEAK_BF16_FLOP_PER_S * 1e3:.3f} ms; "
            f"{nbytes / 1e9:.3f} GB over 3.35 TB/s = {t_bytes:.3f} ms; "
            f"the f32 product's bound {max(t_f32, t_bytes):.3f} ms); max "
            f"abs err {err:.3e} (rel {rel:.2e}, limit {TOL}); vs "
            f"float64: kernel {d64[0]:.2e}, twin {d64[1]:.2e} (limit "
            f"{DENSE_TOL}) [{what}]")
        if l == 20:
            rows.append({
                "name": f"geno_{name} ({'K2' if prod else 'K1'})",
                "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": library_ms})
    del X
    # K2 on operands whose columns do not average zero (all-positive
    # weights, U = 1): its plane sums grow like m, the result like sqrt(m)
    for l, kind in ((20, "|N(0,1)| + 1"), (1, "1")):
        W = torch.as_tensor(np.abs(rng.standard_normal((m, l))) + 1 if l > 1
                            else np.ones((m, 1)), dtype=torch.float32,
                            device=dev)
        out = gk.prod(packed, n, W, c, inv)
        ref = gk.prod_plain(packed, n, W, c, inv)
        err, rel = rel_err(out, ref)
        d64 = check_dense(torch, packed, n, c, inv, W, out, ref,
                          f"operand {kind}")
        log(f"  prod  l={l:2d} n={n}, operand {kind} (mean far from 0): "
            f"rel max err {rel:.2e} against the twin (limit {TOL}); vs "
            f"float64: kernel {d64[0]:.2e}, twin {d64[1]:.2e} (limit "
            f"{DENSE_TOL})")
        if rel > TOL:
            fail(f"K2 on operand {kind}: rel max err {rel:.3e} > {TOL}")
        del out, ref
    k1_checks(gk, torch, dev, pack, sc, op, rng)
    depth_checks(gk, torch, dev)
    return rows


def depth_product64(torch, packed, n, c, inv, W, prod, chunk=1 << 20):
    """`product64` with the depth in chunks: variants (prod) or samples
    (cprod, whole bytes of the pack), so that no float64 tile of the
    decoded matrix is larger than chunk x its other side."""
    if prod:
        return product64(torch, packed, n, c, inv, W, True, chunk)
    out = torch.zeros((packed.shape[0], W.shape[1]), dtype=torch.float64,
                      device=W.device)
    for s0 in range(0, n, chunk):
        s1 = min(n, s0 + chunk)
        out += dense64(torch, packed[:, s0 // 4:(s1 + 3) // 4], s1 - s0, c,
                       inv) @ W[s0:s1].double()
    return out


def depth_checks(gk, torch, dev, extra=4097):
    """K2 at 2^23 + 4,097 variants and K1 at 2^23 + 4,097 samples (the
    depth past which one run's count column would not stay exact in f32;
    64 on the other side, l = 20; a CPU rehearsal 8 and l = 2, for the
    twin's sake), on random bytes: the plan's depth runs, each at most
    2^23; the kernel against its twin (TOL) and both against a float64
    product (DENSE_TOL); an explicit splits=1 raises ValueError."""
    K = gk.MAX_COUNT_DEPTH + extra
    side, l = (64, 20) if dev.type == "cuda" else (8, 2)
    sms = gk._sm_count(dev) if dev.type == "cuda" else 132
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    for prod in (True, False):
        m, n = (K, side) if prod else (side, K)
        name, tag = ("prod", "K2") if prod else ("cprod", "K1")
        P = torch.randint(0, 256, (m, (n + 3) // 4), dtype=torch.uint8,
                          device=dev, generator=g)
        p = torch.rand(m, device=dev, generator=g) * 0.45 + 0.05
        c = 2 * p
        inv = torch.rsqrt(2 * p * (1 - p))
        W = torch.randn((m if prod else n, l), device=dev, generator=g)
        plan = gk.plane_plan(prod, 3, m, n, l, sms)
        run = plan["kps"] * 64 * plan["ksub"]
        kern, plain = ((gk.prod, gk.prod_plain) if prod
                       else (gk.cprod, gk.cprod_plain))
        out, ref = kern(P, n, W, c, inv), plain(P, n, W, c, inv)
        err, rel = rel_err(out, ref)
        ms = Timer(torch, dev)(lambda: kern(P, n, W, c, inv), reps=3)
        ref64 = depth_product64(torch, P, n, c, inv, W, prod)
        d_k, d_t = rel64(out, ref64), rel64(ref, ref64)
        try:    # the wrapper on the card; a rehearsal's runs the twin
            if dev.type == "cuda":
                kern(P, n, W, c, inv, splits=1)
            else:
                gk.plane_plan(prod, 3, m, n, l, sms, splits=1)
            refused = False
        except ValueError:
            refused = True
        log(f"  depth past 2^23: {tag} ({name}) at depth {K} (m={m}, n={n}, "
            f"l={l}): the plan runs {plan['splits']} depth splits of at most "
            f"{run} (<= 2^23 = {gk.MAX_COUNT_DEPTH}); the wrapper {ms:.3f} "
            f"ms; vs the twin rel max "
            f"err {rel:.2e} (limit {TOL}); vs float64: kernel {d_k:.2e}, "
            f"twin {d_t:.2e} (limit {DENSE_TOL}); explicit splits=1 raises "
            f"ValueError: {refused}")
        if not torch.isfinite(out).all():
            fail(f"{tag} past 2^23: non-finite output")
        if run > gk.MAX_COUNT_DEPTH or plan["splits"] < 2:
            fail(f"{tag} past 2^23: a depth run of {run}")
        if rel > TOL:
            fail(f"{tag} past 2^23: rel max err {rel:.3e} > {TOL}")
        if max(d_k, d_t) > DENSE_TOL:
            fail(f"{tag} past 2^23 or its twin is off the float64 product: "
                 f"{d_k:.2e} / {d_t:.2e} > {DENSE_TOL}")
        if not refused:
            fail(f"{tag} past 2^23: an explicit splits=1 was not refused")
        del P, W, out, ref, ref64


def k1_checks(gk, torch, dev, pack, sc, op, rng, splits=(1, 2, 5, 16)):
    """K1 on operands whose columns do not average zero, against a float64
    product: |N(0,1)| + 1 at l = 20, and the GWAS operand [yr | Q] at
    l = 12 (Q from the QR of [1 | 10 covariates], as big_univLinReg builds
    it, on its operator: the variant means, scale 1), within DENSE_TOL of
    max |float64|; V = 1, whose exact product is near 0, within 4x the
    twin's max abs error. The twin (f32 on decoded values: each (d - c)
    rounds the same way in every sample) is printed beside, not held, on
    these operands. Then two launches bit-equal and the depth split in
    `splits` runs, each within DENSE_TOL of max |unsplit|."""
    from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator

    n, m = pack.n, pack.m
    gop = GenoOperator(pack, sc["center"], np.ones(m), device=dev)
    Q, _ = np.linalg.qr(np.column_stack([np.ones(n),
                                         rng.standard_normal((n, 10))]))
    y = rng.standard_normal(n)
    cases = (("|N(0,1)| + 1", op, np.abs(rng.standard_normal((n, 20))) + 1),
             ("[yr | 1 | 10 PCs], GWAS", gop,
              np.column_stack([y - Q @ (Q.T @ y), Q])),
             ("1", op, np.ones((n, 1))))
    for kind, o, Vn in cases:
        V = torch.as_tensor(Vn, dtype=torch.float32, device=dev)
        args = (o.packed, n, V, o.center, o.inv)
        out, ref = gk.cprod(*args), gk.cprod_plain(*args)
        ref64 = product64(torch, o.packed, n, o.center, o.inv, V, False)
        e_k = float((out.double() - ref64).abs().max())
        e_t = float((ref.double() - ref64).abs().max())
        s64 = max(float(ref64.abs().max()), 1e-300)
        log(f"  cprod l={V.shape[1]:2d} n={n}, operand {kind}: vs float64 "
            f"(max |f64| {s64:.3e}): kernel {e_k:.3e} abs ({e_k / s64:.2e}), "
            f"twin {e_t:.3e} abs ({e_t / s64:.2e}); limit "
            + ("4x the twin's abs error" if kind == "1" else
               f"{DENSE_TOL} of max |f64| for the kernel"))
        if not torch.isfinite(out).all():
            fail(f"K1 on operand {kind}: non-finite output")
        if kind == "1" and e_k > 4 * e_t:
            fail(f"K1 on V = 1: abs err {e_k:.3e} > 4 x the twin's {e_t:.3e}")
        if kind != "1" and e_k > DENSE_TOL * s64:
            fail(f"K1 on operand {kind}: {e_k / s64:.2e} of max |float64| "
                 f"> {DENSE_TOL}")
        del out, ref, ref64
    V = torch.as_tensor(rng.standard_normal((n, 20)), dtype=torch.float32,
                        device=dev)
    args = (op.packed, n, V, op.center, op.inv)
    a, b = gk.cprod(*args), gk.cprod(*args)
    if not torch.equal(a, b):
        fail("K1: two launches differ")
    worst = 0.0
    for sp in splits:
        got = gk.cprod(*args, splits=sp)
        worst = max(worst, rel_err(got, a)[1])
    log(f"  cprod l=20 n={n}: two launches bit-equal; depth splits "
        f"{list(splits)} within {worst:.2e} of max |unsplit| (limit "
        f"{DENSE_TOL})")
    if worst > DENSE_TOL:
        fail(f"K1's depth splits differ by {worst:.2e} > {DENSE_TOL}")


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


# ---------------------------------------------------------------------------
# slice 2: LD -> LDSC -> blocked LDpred2-auto / grid -> PRS
# ---------------------------------------------------------------------------

def block_sizes(rng, m, bmin, bmax):
    """Block sizes drawn uniformly in [bmin, bmax] summing to m."""
    sizes = []
    while sum(sizes) < m:
        sizes.append(int(rng.integers(bmin, bmax + 1)))
    sizes[-1] -= sum(sizes) - m
    if sizes[-1] < bmin and len(sizes) > 1:
        last = sizes.pop()          # merged into the block before it
        sizes[-1] += last
    return np.asarray(sizes)


# GRCh37 autosome lengths in Mb: slice 3's 22 chromosomes take shares of
# the variants in these proportions
CHROM_MB = (249, 243, 198, 191, 181, 171, 159, 146, 141, 135, 135, 133, 115,
            107, 102, 90, 81, 78, 59, 63, 48, 51)
# the LD cohorts' AR(1) lag-1 correlation (slices 2 and 3), the
# populations' Fst, and the share of haplotypes that carry slice 3's
# "inversion"
RHO = 0.995
FST = 0.02
CARRIER_FREQ = 0.2


def chromosome_bounds(sizes, m):
    """Start of each of the 22 chromosomes (and m), in proportion to
    CHROM_MB, each moved to the nearest LD-block boundary where the blocks
    are many enough to keep them distinct."""
    share = np.cumsum(CHROM_MB) / np.sum(CHROM_MB)
    target = np.r_[0, np.round(share * m).astype(np.int64)]
    edges = np.r_[0, np.cumsum(sizes)]
    snapped = edges[np.abs(edges[None, :] - target[:, None]).argmin(1)]
    return snapped if np.all(np.diff(snapped) > 0) else target


def make_ld_cohort(torch, dev, n, m, seed, bmin, bmax, chunk=4096, pops=0,
                   region_len=0):
    """(m, ceil(n/4)) packed genotypes made on the device from `seed`, with
    LD in independent blocks: each haplotype is a latent Gaussian AR(1)
    along the block (lag-k correlation RHO^k), thresholded at the
    variant's allele frequency ~ U(0.05, 0.5); 1% NA on 5% of the
    variants. Returns the packed bytes on the device, the block sizes and
    a dict of what else was drawn. All blocks advance one position a
    step, longest first.

    pops > 0 gives each sample one of `pops` populations whose allele
    frequencies are Balding-Nichols draws (Fst FST) around the ancestral
    ones. region_len > 0 lays out 22 chromosomes (`chromosome_bounds`) and
    plants a long-range-LD region of that many contiguous variants on the
    first: each haplotype carries an "inversion" with probability
    CARRIER_FREQ (whatever its population), and a carrier's threshold at
    every variant of the region moves by +-U(0.5, 1.5) latent sd. Without
    them, the draws are those of slice 2."""
    from scipy.stats import norm

    rng = np.random.default_rng(seed + 2)
    sizes = block_sizes(rng, m, bmin, bmax)
    order = np.argsort(-sizes, kind="stable")
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    p_anc = rng.uniform(0.05, 0.5, m)
    thr_np = norm.isf(p_anc)[:, None]                       # (m, pops or 1)
    na_var = torch.as_tensor(rng.random(m) < 0.05, device=dev)
    info = {}
    pop = np.zeros(n, np.int64)
    if pops:
        a, b = p_anc * (1 - FST) / FST, (1 - p_anc) * (1 - FST) / FST
        P = np.clip(rng.beta(a[:, None], b[:, None], size=(m, pops)), 1e-3,
                    1 - 1e-3)
        pop = rng.integers(0, pops, n)
        thr_np = norm.isf(P)
        info.update(pop=pop, P=P)
    shift = None
    if region_len:
        bounds = chromosome_bounds(sizes, m)
        length = min(region_len, int(0.6 * (bounds[1] - bounds[0])))
        j0 = bounds[0] + (bounds[1] - bounds[0] - length) // 3
        sh = np.zeros(m)
        sh[j0:j0 + length] = (rng.choice([-1.0, 1.0], length)
                              * rng.uniform(0.5, 1.5, length))
        carrier = rng.random((2, n)) < CARRIER_FREQ
        shift = torch.as_tensor(sh, dtype=torch.float32, device=dev)
        carr_t = torch.as_tensor(carrier, dtype=torch.float32, device=dev)
        info.update(bounds=bounds, region=(j0, j0 + length), carrier=carrier)
    thr = torch.as_tensor(thr_np, dtype=torch.float32, device=dev)
    pop_t = torch.as_tensor(pop, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    B = len(sizes)
    start_t = torch.as_tensor(starts[order], device=dev)
    sizes_sorted = sizes[order]
    code_of = torch.tensor([3, 2, 0], dtype=torch.uint8, device=dev)
    codes = torch.empty((m, n), dtype=torch.uint8, device=dev)
    z = torch.randn((2, n, B), generator=gen, device=dev)
    a = float(np.sqrt(1 - RHO * RHO))
    for j in range(int(sizes.max())):
        if j:
            z = RHO * z + a * torch.randn((2, n, B), generator=gen,
                                          device=dev)
        k = int((sizes_sorted > j).sum())
        var = start_t[:k] + j
        th = thr[var][:, pop_t].T                           # (n, k)
        if shift is not None:
            th = th[None] - carr_t[:, :, None] * shift[var][None, None, :]
        d = (z[:, :, :k] > th).sum(0)                       # (n, k)
        miss = ((torch.rand((n, k), generator=gen, device=dev) < 0.01)
                & na_var[var])
        codes[var] = torch.where(miss, 1, code_of[d]).T.to(torch.uint8)
    nb = (n + 3) // 4
    packed = torch.empty((m, nb), dtype=torch.uint8, device=dev)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    for j0 in range(0, m, chunk):
        c = torch.nn.functional.pad(codes[j0:j0 + chunk], (0, nb * 4 - n))
        packed[j0:j0 + chunk] = (c.view(-1, nb, 4) << shifts).sum(-1).to(
            torch.uint8)
    del codes, z
    return packed, sizes, info


def check_pair_sums(torch, dev, bp, pack, train, size, thr_r2, k=1000):
    """On a slab of k variants of the training rows: the integer pair sums
    against a float64 product of independently decoded planes, and the
    device finalize against the host float64 one."""
    from bigsnpr_tpu_torch.core.unpack import unpack_dosage
    from bigsnpr_tpu_torch.ops import corr as pcorr

    k = min(k, pack.m)
    sub = pack.subset(ind_row=train, ind_col=np.arange(k))
    P = sub.device_packed(dev)
    n = sub.n
    t0 = k // 2
    sums = pcorr._pair_sums_block(P[t0:k], P[:k], n)
    d, na = unpack_dosage(P[:k], n, dtype=torch.float64)
    mk = (~na).double()
    x = d * mk
    A = torch.cat([x[t0:], (x * x)[t0:], mk[t0:]])
    C = torch.cat([x, x * x, mk])
    G = A @ C.T
    B, Wb = k - t0, k
    ref = (G[0:B, 0:Wb], G[0:B, 2 * Wb:], G[2 * B:, 0:Wb],
           G[B:2 * B, 2 * Wb:], G[2 * B:, Wb:2 * Wb], G[2 * B:, 2 * Wb:])
    bad = sum(int((s.double() != r).sum()) for s, r in zip(sums, ref))
    log(f"  pair sums of a {k}-variant slab ({n} samples): {bad} of "
        f"{6 * B * Wb} integers differ from the float64 product (limit 0)")
    if bad:
        fail("integer pair sums disagree with the float64 product")
    xt, mt = pcorr._planes(P[t0:k], n, 0, P.shape[1], -(-n // 8) * 8)
    xb, mb = pcorr._planes(P[:k], n, 0, P.shape[1], -(-n // 8) * 8)
    A8, C8 = torch.cat([xt, xt * xt, mt]), torch.cat([xb, xb * xb, mb])
    timer = Timer(torch, dev)
    t_mm = timer(lambda: pcorr._exact_mm(A8, C8, True), reps=5)
    t_all = timer(lambda: pcorr._pair_sums_block(P[t0:k], P[:k], n), reps=5)
    t_f64 = timer(lambda: A @ C.T, reps=3)
    log(f"  pair-sum product ({3 * B} x {n}) @ ({n} x {3 * Wb}) int8: "
        f"{t_mm:.3f} ms (torch._int_mm); whole block (decode + product) "
        f"{t_all:.3f} ms; the float64 product {t_f64:.3f} ms")
    kw = dict(ind_row=train, ind_col=np.arange(k), size=size, thr_r2=thr_r2)
    host = bp.snp_cor(pack, **kw).to_dense()
    devf = bp.snp_cor(pack, finalize="device", **kw).to_dense()
    err = float(np.abs(devf - host).max())
    log(f"  device finalize vs host float64 finalize on the slab: max abs "
        f"{err:.3e} (limit 3e-7), same kept set "
        f"{bool(np.array_equal(devf != 0, host != 0))}")
    if err > 3e-7 or not np.array_equal(devf != 0, host != 0):
        fail("device finalize disagrees with the host finalize")


def phase_slice2(bp, gsk, gk, torch, dev, args):
    n, m = args.n2, args.m2
    log(f"[6] slice 2 at n={n} samples x m={m} variants")
    t0 = time.perf_counter()
    packed, sizes, _ = make_ld_cohort(torch, dev, n, m, args.seed,
                                      args.bmin, args.bmax)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} "
        f"s: {len(sizes)} LD blocks of {sizes.min()}-{sizes.max()} variants")
    pack = bp.GenoPack(packed=packed.cpu().numpy(), n=n)
    pack._device_cache[str(dev)] = packed
    rng = np.random.default_rng(args.seed + 3)
    perm = rng.permutation(n)
    n_train = n * 3 // 4
    train, test = np.sort(perm[:n_train]), np.sort(perm[n_train:])
    size, thr_r2 = 500, 0.01
    times, sweeps = {}, {}

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        before = gsk.launches["sweep"]
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        sweeps[name] = gsk.launches["sweep"] - before
        log(f"  {name:22s} {times[name]:9.3f} s   sweep launches "
            f"{sweeps[name]}")
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    gsk.reset_launches()
    sim = stage("snp_simuPheno", lambda: bp.snp_simuPheno(
        pack, h2=0.4, M=min(1000, m // 10), seed=args.seed))
    y = sim["pheno"]
    gwas = stage("big_univLinReg", lambda: bp.big_univLinReg(
        pack, y[train], ind_row=train))
    df_beta = {"beta": gwas["estim"], "beta_se": gwas["std.err"],
               "n_eff": np.full(m, float(n_train))}
    corr = stage("snp_cor", lambda: bp.snp_cor(
        pack, ind_row=train, size=size, thr_r2=thr_r2, finalize="device"))
    ldsc = stage("snp_ldsc2", lambda: bp.snp_ldsc2(corr, df_beta))
    h2_ldsc = float(ldsc["h2"])
    bb = stage("auto_blocks + bands", lambda: bp.build_block_bands(
        corr, bp.auto_blocks(corr)))
    stage("bands to the device", lambda: bb.device_put(dev))
    p_init = np.geomspace(1e-4, 0.2, N_CHAINS)

    def run_auto(burn_in, num_iter):
        return bp.snp_ldpred2_auto(
            corr, df_beta, h2_init=max(h2_ldsc, 1e-3), vec_p_init=p_init,
            burn_in=burn_in, num_iter=num_iter, allow_jump_sign=False,
            shrink_corr=0.95, blocks=bb)

    auto = stage("snp_ldpred2_auto", lambda: run_auto(args.burn_in,
                                                      args.num_iter))
    keep, beta_auto = stage("ldpred2_auto_chain_qc",
                            lambda: bp.ldpred2_auto_chain_qc(auto))
    h2s = np.asarray([0.7, 1.0, 1.4]) * max(h2_ldsc, 1e-3)
    ps = np.asarray([1e-3, 1e-2, 1e-1])
    grid = {"p": np.repeat(ps, 3), "h2": np.tile(h2s, 3),
            "sparse": np.zeros(GRID_CELLS, bool)}
    beta_grid = stage("snp_ldpred2_grid", lambda: bp.snp_ldpred2_grid(
        corr, df_beta, grid, burn_in=min(50, args.burn_in),
        num_iter=min(100, args.num_iter), blocks=bb))
    prs = stage("snp_PRS", lambda: bp.snp_PRS(pack, beta_auto,
                                              ind_test=test))
    launches = {"sweep": gsk.launches["sweep"], **gk.launches}
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else float("nan"))
    log(f"  total {sum(times.values()):.3f} s; launches {launches}; device "
        f"memory peak {peak:.2f} GB; LD nnz {corr.upper.nnz}, "
        f"{len(bb.buckets)} buckets, bands {bb.nbytes / 1e9:.3f} GB")
    if dev.type == "cuda" and launches["sweep"] <= 0:
        fail("the sweep kernel was not launched on slice 2")

    log("  checks:")
    check_pair_sums(torch, dev, bp, pack, train, size, thr_r2)
    enforce = dev.type == "cuda"
    frac = bb.dropped_r2_frac
    log(f"    dropped_r2_frac of the auto blocks {frac:.4f} (limit 0.05)")
    if frac > 0.05:
        fail("auto blocks drop too much LD")
    h2_kept = float(np.mean([auto[i]["h2_est"] for i in np.nonzero(keep)[0]])
                    ) if keep.any() else float("nan")
    finite = sum(np.isfinite(r["h2_est"]) for r in auto)
    log(f"    LDSC h2 {h2_ldsc:.4f}; chains finite {finite}/{len(auto)}, "
        f"kept by chain QC {int(keep.sum())} (floor 1); mean h2_est of the "
        f"kept {h2_kept:.4f} (both in [0.2, 0.6]; true 0.4)")
    r_auto = float(np.corrcoef(prs[:, 0], y[test])[0, 1])
    log(f"    r(PRS_auto, y_test) {r_auto:.4f} on {len(test)} test samples "
        f"(floor 0.1; null sd {1 / np.sqrt(len(test)):.3f}); grid cells "
        f"finite {int(np.isfinite(beta_grid).all(0).sum())}/9")
    bad = [] if not enforce else [
        what for what, ok in (
            ("LDSC h2", 0.2 <= h2_ldsc <= 0.6),
            ("chain QC", keep.sum() >= 1),
            ("mean h2_est of kept chains", 0.2 <= h2_kept <= 0.6),
            ("r(PRS_auto, y_test)", r_auto > 0.1)) if not ok]
    if bad:
        fail(f"slice 2 checks failed: {bad}")
    no_floor_cost(torch, dev, bp, pack, train, size)
    launches["auto_sweeps"] = sweeps["snp_ldpred2_auto"]
    launches["grid_sweeps"] = sweeps["snp_ldpred2_grid"]
    return bb, launches, run_auto


def no_floor_cost(torch, dev, bp, pack, train, size, max_block=4096,
                  min_size=32):
    """What snp_cor without an r^2 floor (thr_r2 = 0) gives the blocked
    samplers: its time and entry count, and whether auto_blocks could
    still cut exactly. Where every adjacent pair is kept, the whole
    chromosome is one LD component, and auto_blocks would hand all of it
    to snp_ldsplit, whose dynamic program walks ~m x max_block cost
    entries max_K times; that count is printed, the call is not made."""
    m = pack.m
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    full = bp.snp_cor(pack, ind_row=train, size=size, finalize="device")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    window = m + m * size - size * (size + 1) // 2
    adjacent = int(np.count_nonzero(full.upper.diagonal(1)))
    max_K = max(2, -(-m // min_size))
    entries = int(np.minimum(np.arange(1, m + 1), max_block).sum())
    log(f"  snp_cor without the r2 floor (thr_r2 0): {secs:.3f} s, LD nnz "
        f"{full.upper.nnz} of the {window} pairs in the window; adjacent "
        f"pairs kept {adjacent} of {m - 1}")
    if adjacent == m - 1:
        log(f"    no exact cut exists: auto_blocks would pass one {m}-variant "
            f"block to snp_ldsplit (max_K {max_K}), ~{entries:.2e} cost "
            f"entries x {max_K} passes = {float(entries) * max_K:.2e} "
            f"steps; not run")


def sweep_inputs(torch, sb, NC, rng):
    """One sweep's state and pre-drawn u / z on the bands' device."""
    m, dt, dev = sb.m, sb.dtype, sb.device
    f = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return dict(bh=f(rng.normal(0, 0.02, m)),
                C2=f(rng.uniform(0.1, 0.9, (NC, m))),
                C4=f(rng.uniform(1e-4, 1e-3, (NC, m))),
                s1=f(rng.uniform(1.0, 2.0, (NC, m))),
                u=f(rng.uniform(0, 1, (NC, m))),
                z=f(rng.normal(0, 1, (NC, m))),
                cb=f(rng.normal(0, 0.02, (NC, m)) * (rng.random((NC, m))
                                                    < 0.3)),
                inv_odd_p=f(rng.uniform(1, 1e3, NC)),
                p=f(rng.uniform(1e-3, 0.5, NC)),
                sparse=torch.as_tensor(np.arange(NC) % 2 == 1, device=dev),
                dp=f(rng.normal(0, 0.02, (NC, sb.dp_len))))


def narrow_bands(bp, rng, sizes, width):
    """Block-diagonal AR(1)-like LD truncated to `width` off the diagonal
    (a narrow bucket, the shape the JAX package sends to K4)."""
    import scipy.sparse as sp

    mats = []
    for sz in sizes:
        lag = np.abs(np.subtract.outer(np.arange(sz), np.arange(sz)))
        C = np.where(lag <= width, 0.9 ** lag * rng.uniform(0.8, 1.0),
                     0.0)
        np.fill_diagonal(C, 1.0)
        mats.append(sp.coo_matrix(C))      # no stored zeros past `width`
    up = sp.triu(sp.block_diag(mats, format="csc")).tocsc()
    return bp.build_block_bands(bp.SparseLD(upper=up), sizes)


def sweep_bound(sb, NC, nct):
    """Least time of one sweep at this run's bands: the larger of the bytes
    it must move (band once, per-variant inputs and outputs, dp in and
    out) over 3.35 TB/s and its float operations (2 (2W + 1) for the AXPY
    plus ~30 for the step, per chain and row) over 67 TFLOP/s. Beside it,
    the band read once per chain tile (nct chains a CTA)."""
    sz = sb.band.element_size()
    rows = sb.blk_rows.cpu().numpy().astype(np.int64)
    wk = 2 * sb.blk_W.cpu().numpy().astype(np.int64) + 1
    band = int((rows * wk).sum()) * sz
    per_chain = (6 * sz          # read: cb, C2, C4, s1, u, z
                 + 4 * sz        # written: beta, postp, beta_inc, dps
                 + 1)            # written: causal (one byte)
    io = (NC * sb.m * per_chain
          + sb.m * sz                        # read: bh
          + int(sb.gidx.numel()) * 4         # read: slot -> variant table
          + 2 * NC * sb.dp_len * sz          # dp read and written
          + 2 * NC * sb.nblk * sz)           # written: h2_inc, gap per block
    t_bytes = (band + io) / PEAK_BYTES_PER_S * 1e3
    t_ops = NC * float((rows * (2 * wk + 30)).sum()) / PEAK_F32_FLOP_PER_S \
        * 1e3
    t_tiles = (band * -(-NC // nct) + io) / PEAK_BYTES_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_tiles


def ring_floor_ms(sb, kind):
    """The kernel's row floor: the longest block's rows x one row's
    dependent chain (RING_ROW_CYCLES) at CLOCK_HZ."""
    return (sb.max_rows * RING_ROW_CYCLES[(kind, sb.band.element_size())]
            / CLOCK_HZ * 1e3)


def issue_floor_ms(sb, NC, kind):
    """The card's issue floor of a sweep: every (chain, row)'s row-warp
    instructions (ROW_ISSUE) and one multiply-add instruction a band value
    and 32 chains, over SMS x SCHEDULERS issuing one a cycle."""
    rows = sb.blk_rows.cpu().numpy().astype(np.int64)
    wk = 2 * sb.blk_W.cpu().numpy().astype(np.int64) + 1
    instr = NC * (float(rows.sum()) * ROW_ISSUE[(kind, sb.band.element_size())]
                  + float((rows * wk).sum()) / 32)
    return instr / (SMS * SCHEDULERS) / CLOCK_HZ * 1e3


def sweep_plan_text(sb, pl, NC):
    """The sweep's plan for NC chains: chains a CTA, CTAs, threads, ring,
    band stages, shared memory and the block order."""
    if pl is None:
        return "no plan (not launched on the card)"
    rows = sb.blk_rows.cpu().numpy()[sb.order]
    order = ("one block" if sb.nblk == 1 else
             f"blocks longest first ({rows[0]} .. {rows[-1]} rows), a "
             f"block's chain tiles side by side")
    return (f"{pl.nct} chains a CTA, {sb.nblk * -(-NC // pl.nct)} CTAs of "
            f"{pl.threads} threads, ring of {pl.ring_len} slots, "
            + (f"band stages of {pl.stage} values a row"
               if pl.stage else "band read in place")
            + f", {pl.smem} B of shared memory; {order}")


def phase_sweep_kernels(bp, gsk, torch, dev, bb, launches, timer, seed):
    log("[7] Gibbs sweep kernel vs its twin (same pre-drawn u / z)")
    rng = np.random.default_rng(seed + 4)
    narrow = narrow_bands(bp, rng, rng.integers(90, 129, 24), 12)
    sb = bb.device_put(dev)
    # (tag, what, bands, chains, shrink_corr, no_jump_sign, replaces): the
    # K5 and grid cases are the two launches of slice 2's main path
    cases = (("K3", "1 chain", sb, 1, 0.95, True,
              "bigsnpr_tpu/pgs/gibbs_pallas.py:37"),
             ("K4", "narrow bucket, 9 chains", narrow.device_put(dev), 9,
              1.0, False, "bigsnpr_tpu/pgs/gibbs_pallas.py:171"),
             ("K5", f"{N_CHAINS} chains", sb, N_CHAINS, 0.95, True,
              "bigsnpr_tpu/pgs/gibbs_pallas.py:302"),
             ("grid", f"{GRID_CELLS} grid cells", sb, GRID_CELLS, 1.0, False,
              "bigsnpr_tpu/pgs/gibbs_pallas.py:302"),
             ("f64", "4 chains, float64", bb.device_put(dev, np.float64), 4,
              0.95, True, None))
    rows = []
    for tag, what, sb, NC, shrink, no_jump, replaces in cases:
        st = sweep_inputs(torch, sb, NC, rng)

        def run(fn):
            dp = st["dp"].clone()
            out = fn(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"],
                     st["s1"], st["u"], st["z"], st["inv_odd_p"], st["p"],
                     st["sparse"], shrink, no_jump)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return (dp,) + tuple(out)

        got, again = run(gsk.sweep), run(gsk.sweep)
        t = time.perf_counter()
        ref = run(gsk.sweep_plain)
        plain_ms = (time.perf_counter() - t) * 1e3
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        names = ("dp", "new_beta", "causal", "postp", "beta_inc", "dps",
                 "h2_inc", "gap")
        errs = {}
        for name, a, b in zip(names, got, ref):
            if name == "causal":
                errs[name] = int((a != b).sum())
                continue
            errs[name] = (float((a - b).abs().max()),
                          SWEEP_TOL * max(float(b.abs().max()), 1e-30))
        log(f"  {tag} shape ({what}): {sb.nblk} blocks, {sb.max_rows} rows "
            f"in the longest, width up to {sb.wkmax}, {NC} chains")
        log("    max |kernel - twin| (limit): " + ", ".join(
            f"{k} {v[0]:.2e} ({v[1]:.1e})" if k != "causal"
            else f"causal {v} differ (0)" for k, v in errs.items())
            + f"; two launches bit-equal: {repeat}")
        if errs["causal"] or not repeat or any(
                v[0] > v[1] for k, v in errs.items() if k != "causal"):
            fail(f"sweep kernel {tag} disagrees with its twin or does not "
                 f"repeat")
        ms = timer(lambda: gsk.sweep(sb, st["dp"], st["cb"], st["bh"],
                                     st["C2"], st["C4"], st["s1"], st["u"],
                                     st["z"], st["inv_odd_p"], st["p"],
                                     st["sparse"], shrink, no_jump), reps=5)
        pl = sb.plans.get(NC)
        bound, by, t_tiles = sweep_bound(sb, NC, pl.nct if pl else NC)
        t_row, t_issue = ring_floor_ms(sb, "sweep"), issue_floor_ms(
            sb, NC, "sweep")
        cyc = RING_ROW_CYCLES[("sweep", sb.band.element_size())]
        log(f"    plan: {sweep_plan_text(sb, pl, NC)}")
        log(f"    kernel {ms:.3f} ms a sweep, twin {plain_ms:.1f} ms, bound "
            f"{bound:.3f} ms ({by}); this design's floors: the longest "
            f"block's row floor {t_row:.3f} ms ({cyc} cycles a row), the "
            f"card's issue floor {t_issue:.3f} ms, the band once per chain "
            f"tile {t_tiles:.3f} ms; {ms / max(t_row, t_issue, 1e-9):.2f}x "
            f"the larger floor")
        if tag == "f64":
            continue
        rows.append({
            "name": f"gibbs_sweep ({tag} shape: {what})", "route": "cuda",
            "source": SWEEP_SOURCE, "replaces": replaces,
            # slice 2's main path: LDpred2-auto's sweeps take the K5 shape,
            # the grid's the grid shape; K3's and K4's run on no slice
            "launches": {"K5": launches["auto_sweeps"],
                         "grid": launches["grid_sweeps"]}.get(tag, 0),
            "max_abs_err": max(v[0] for k, v in errs.items()
                               if k != "causal"),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    return rows


def phase_profile(torch, dev, run_auto, label="[8]", sweep_kernel=None):
    """torch.profiler around one snp_ldpred2_auto call of 20 sweeps (1 in
    a CPU rehearsal, whose twin makes ~10^5 events a sweep): the device's
    busy share of the call's wall time (one stream, so the kernels' summed
    device time is its busy time) and the kernels that take it. Only device
    events count: a host op's device time repeats that of the kernels it
    launched. With `sweep_kernel` (a substring of the sweep kernel's
    name), the same inside the sweeps' own window, and the driver's time
    a sweep beside the kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sweeps = 20 if dev.type == "cuda" else 1
    log(f"{label} profile of snp_ldpred2_auto, {sweeps} sweeps")
    run_auto(0, 1)                                   # warm
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_auto(sweeps // 2, sweeps - sweeps // 2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and a.self_device_time_total > 0]
    busy = sum(a.self_device_time_total for a in avgs) / 1e3
    if not avgs:
        log(f"  wall {wall:.1f} ms; device time not measured (no device "
            f"events in the trace)")
        return
    log(f"  wall {wall:.1f} ms ({wall / sweeps:.2f} ms a sweep); device "
        f"busy {busy:.1f} ms = {100 * busy / wall:.1f}% (idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    for a in sorted(avgs, key=lambda a: -a.self_device_time_total)[:8]:
        log(f"    {a.self_device_time_total / 1e3:9.3f} ms  {a.count:6d} x  "
            f"{a.key[:70]}")
    if sweep_kernel is None:
        return
    # the sweeps' own window, from the first sweep kernel's start to the
    # last one's end on the device (the call's set-up, such as a band
    # build, lies before it): its busy share, and the driver's time a
    # sweep (start to start) beside the kernel's
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = sorted((e for e in dev if sweep_kernel in e.name),
                  key=lambda e: e.time_range.start)
    if len(kern) < 2:
        return
    t0, t1 = kern[0].time_range.start, kern[-1].time_range.end
    busy_w = sum(max(0, min(e.time_range.end, t1)
                     - max(e.time_range.start, t0)) for e in dev) / 1e3
    win = (t1 - t0) / 1e3
    period = (kern[-1].time_range.start - kern[0].time_range.start) / 1e3 \
        / (len(kern) - 1)
    k_ms = sum(e.time_range.end - e.time_range.start for e in kern) / 1e3 \
        / len(kern)
    log(f"  over the sweeps' window ({len(kern)} launches of {sweep_kernel}, "
        f"{win:.1f} ms): device busy {busy_w:.1f} ms = "
        f"{100 * busy_w / win:.1f}% (idle {100 * (1 - busy_w / win):.1f}%); "
        f"the driver's time a sweep {period:.3f} ms, the kernel's "
        f"{k_ms:.3f} ms: host and other work {period - k_ms:.3f} ms a sweep")


# ---------------------------------------------------------------------------
# slice 3: int8 scheme (K6) -> autoSVD -> pcadapt -> projection -> GWAS
# ---------------------------------------------------------------------------

def clear_na(packed):
    """A copy of the packed bytes with every NA code (01) made 00."""
    return packed & ~(packed & ~(packed >> 1) & 0x55)


def i8_case(torch, dev, rng, n, m, l, na):
    """A pack with NA (or none) on the card, monomorphic variants every 13
    and scale-0 variants every 7, with center / inv and random operands."""
    packed = small_pack(rng, n, m) if na else clear_na(small_pack(rng, n, m))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    inv = rng.uniform(0.5, 3.0, m)
    inv[::7] = 0.0
    c = np.where(inv > 0, rng.uniform(0.1, 1.9, m), 2.0)
    return (torch.as_tensor(packed, device=dev), n, f(c), f(inv),
            f(rng.standard_normal((n, l))), f(rng.standard_normal((m, l))))


def check_i8(gk, torch, dev, packed, n, c, inv, V, U, nona, tag):
    """K6 cprod and prod against the twin on one input: raw int32 sums
    equal, f32 within I8_TOL of max |twin|, two launches bit-equal."""
    for kind, kern, plain, W in (("cprod_i8", gk.cprod_i8, gk.cprod_i8_plain,
                                  V),
                                 ("prod_i8", gk.prod_i8, gk.prod_i8_plain,
                                  U)):
        key = kind + ("_nona" if nona else "")
        got, raw = kern(packed, n, W, c, inv, nona=nona, return_raw=True)
        again = kern(packed, n, W, c, inv, nona=nona)
        ref, raw_ref = plain(packed, n, W, c, inv, nona=nona,
                             return_raw=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        raw_eq = torch.equal(raw, raw_ref)
        err, rel = rel_err(got, ref)
        bit = torch.equal(got, ref)
        repeat = torch.equal(got, again)
        log(f"  {tag} {key:13s} n={n} m={packed.shape[0]} l={W.shape[1]}: "
            f"raw int32 sums equal {raw_eq}; max abs err {err:.3e} (rel "
            f"{rel:.1e}, limit {I8_TOL}); bit-equal to the twin {bit}; two "
            f"launches bit-equal {repeat}")
        if not (raw_eq and repeat and rel <= I8_TOL
                and torch.isfinite(got).all()):
            fail(f"K6 {key} ({tag}) disagrees with its twin or does not "
                 f"repeat")


def phase_i8_small(bp, gk, torch, dev, rng):
    log("[9] K6 (int8 bit planes) vs its twin at awkward shapes")
    for n, m, l in ((1000, 777, 1), (1001, 1500, 12), (1002, 3001, 20),
                    (1003, 513, 21), (20000, 2100, 20)):
        for na in (True, False):
            check_i8(gk, torch, dev, *i8_case(torch, dev, rng, n, m, l, na),
                     nona=not na, tag="small")
    # the masked operator: ind_row / ind_col scattered and gathered on the
    # device around the kernels, against the plain-torch operator
    n, m = 3001, 2500
    pack = bp.GenoPack(packed=small_pack(rng, n, m), n=n)
    sc = bp.bed_scaleBinom(pack, device=dev)
    rows = np.sort(rng.choice(n, 2000, replace=False))
    cols = np.sort(rng.choice(m, 1300, replace=False))
    ops = [ctor(pack, sc["center"], sc["scale"], ind_row=rows, ind_col=cols,
                device=dev, mxu="int8")
           for ctor in (bp.GenoOperator, bp.TorchOperator)]
    V = torch.as_tensor(rng.standard_normal((len(rows), 20)),
                        dtype=torch.float32, device=dev)
    (B, Y), (Br, Yr) = (op.power_dev(V) for op in ops)
    errs = [rel_err(B, Br)[1], rel_err(Y, Yr)[1]]
    log(f"  masked int8 operator ({len(rows)} of {n} rows, {len(cols)} of "
        f"{m} variants, nona {ops[0].nona}): power step rel err {errs[0]:.1e}"
        f" / {errs[1]:.1e} against the plain operator; bit-equal "
        f"{torch.equal(B, Br) and torch.equal(Y, Yr)}")
    if max(errs) > I8_TOL:
        fail("the masked int8 operator disagrees with the plain one")


def pop_r2(scores, pop):
    """Share of the variance of the score columns that the population
    labels explain: 1 - within-population / total sum of squares."""
    tot = ((scores - scores.mean(0)) ** 2).sum()
    within = sum(((scores[pop == p] - scores[pop == p].mean(0)) ** 2).sum()
                 for p in np.unique(pop))
    return 1.0 - within / tot


def variant_fst(P, pop):
    """Fst of each variant from the populations' allele frequencies,
    weighted by the populations' sizes."""
    w = np.bincount(pop, minlength=P.shape[1]) / len(pop)
    pbar = P @ w
    return ((P - pbar[:, None]) ** 2 @ w) / (pbar * (1 - pbar))


def make_slice3(bp, torch, dev, args):
    """The slice-3 cohort, its 22 chromosomes with sorted positions, and
    the training / held-out split."""
    n, m = args.n3, args.m3
    t0 = time.perf_counter()
    packed, sizes, info = make_ld_cohort(
        torch, dev, n, m, args.seed + 10, args.bmin, args.bmax,
        pops=3, region_len=args.region)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    bounds = info["bounds"]
    chrs = np.repeat(np.arange(1, 23), np.diff(bounds))
    rng = np.random.default_rng(args.seed + 11)
    # ~3 kb between variants: a 500 kb clumping window holds ~170
    gaps = 1 + rng.exponential(3000.0, m).astype(np.int64)
    pos = np.empty(m, np.int64)
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        pos[c0:c1] = np.cumsum(gaps[c0:c1])
    j0, j1 = info["region"]
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} "
        f"s: {len(sizes)} LD blocks of {sizes.min()}-{sizes.max()} variants "
        f"(AR(1) rho {RHO}), 3 populations (Fst {FST}), 22 "
        f"chromosomes of {np.diff(bounds).min()}-{np.diff(bounds).max()} "
        f"variants; long-range-LD region: variants {j0}-{j1 - 1} "
        f"(chromosome 1, {pos[j0]}-{pos[j1 - 1]} bp), carrier haplotype "
        f"frequency {info['carrier'].mean():.3f}")
    pack = bp.GenoPack(packed=packed.cpu().numpy(), n=n)
    pack._device_cache[str(dev)] = packed
    perm = rng.permutation(n)
    n_held = max(1, n // 10)
    held, train = np.sort(perm[:n_held]), np.sort(perm[n_held:])
    return pack, chrs, pos, info, train, held


def phase_slice3(bp, gk, torch, dev, args):
    n, m = args.n3, args.m3
    log(f"[10] slice 3 at n={n} samples x m={m} variants, pallas_mxu "
        f"\"int8\"")
    pack, chrs, pos, info, train, held = make_slice3(bp, torch, dev, args)
    pop = info["pop"]
    times = {}

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name:22s} {times[name]:9.3f} s")
        return out

    kw = dict(infos_chr=chrs, infos_pos=pos, ind_row=train, k=10)
    timer = bp.StageTimer()
    gk.reset_launches()
    with bp.config.options(pallas_mxu="int8"):
        svd = stage("snp_autoSVD", lambda: bp.snp_autoSVD(pack, timer=timer,
                                                          **kw))
        # K = 2: the population PCs of 3 populations (the reference's
        # pcadapt vignette takes K from the scree plot); K = 10 below
        pc = stage("snp_pcadapt", lambda: bp.snp_pcadapt(
            pack, svd.u[:, :2], ind_row=train, ind_col=svd.subset))
        proj = stage("bed_projectSelfPCA", lambda: bp.bed_projectSelfPCA(
            svd, pack, ind_row=held))
        path = dict(gk.launches)
        sim = stage("snp_simuPheno", lambda: bp.snp_simuPheno(
            pack, h2=0.4, M=m // 100, seed=args.seed))
        y = sim["pheno"]
        gk.reset_launches()
        gwas = stage("big_univLinReg", lambda: bp.big_univLinReg(
            pack, y[train], covar=svd.u, ind_row=train))
        lp = stage("gwas_pvalues", lambda: -bp.gwas_pvalues(gwas, log10=True))
        for k, v in gk.launches.items():
            path[k] += v
    log("  autoSVD stages: " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in timer.times.items()))
    log(f"  autoSVD: {len(svd.subset)} variants kept of {m} after "
        f"{svd.niter} randomSVD depths in the last call; lrldr "
        f"{ {k: v.tolist() for k, v in svd.lrldr.items()} }")
    log(f"  kernel launches from snp_autoSVD through big_univLinReg "
        f"(snp_simuPheno's K2 excluded): {path}")
    if dev.type == "cuda":
        if path["cprod"] or path["prod"]:
            fail("K1/K2 launched on the int8 path")
        if not (path["cprod_i8"] and path["prod_i8"]):
            fail("K6 (NA) was not launched on the slice-3 path")

    log("  checks:")
    enforce = dev.type == "cuda"
    bad = []
    # the planted long-range-LD region
    j0, j1 = info["region"]
    maf = bp.bed_MAF(pack, ind_row=train, device=dev)
    ok_maf = (maf["mac"] >= 10) & (maf["maf"] >= 0.02)
    excl = np.nonzero(~ok_maf | (chrs != 1))[0]
    clumped = bp.snp_clumping(pack, infos_chr=chrs, ind_row=train,
                              thr_r2=0.2, size=500, infos_pos=pos,
                              exclude=excl, device=dev)
    in_reg = clumped[(clumped >= j0) & (clumped < j1)]
    lost = 1 - np.isin(in_reg, svd.subset).mean() if len(in_reg) else 0.0
    lr = svd.lrldr
    mids = (lr["Start"] + lr["Stop"]) / 2
    hit = (lr["Chr"] == 1) & (mids >= pos[j0]) & (mids <= pos[j1 - 1])
    log(f"    LRLD region {pos[j0]}-{pos[j1 - 1]} bp on chromosome 1: "
        f"{int(hit.sum())} lrldr intervals centred in it ("
        + ", ".join(f"{a}-{b}" for a, b in zip(lr["Start"][hit],
                                                 lr["Stop"][hit]))
        + f"); {len(in_reg)} of its variants clumped, {100 * lost:.1f}% of "
        f"them dropped by the outlier loop (floor 75%)")
    if not (hit.any() and lost >= 0.75):
        bad.append("LRLD region")
    # populations on PC1-2, training scores and projected held-out samples
    r2_train = pop_r2(svd.u[:, :2] * svd.d[:2], pop[train])
    r2_held = pop_r2(proj["OADP_proj"][:, :2], pop[held])
    log(f"    population labels explain {r2_train:.4f} of PC1-2 score "
        f"variance (training), {r2_held:.4f} (held-out, OADP) (floor 0.9)")
    if not (r2_train >= 0.9 and r2_held >= 0.9):
        bad.append("population PCs")
    # pcadapt: enrichment of the top-Fst variants among the 100 smallest p
    fst = variant_fst(info["P"], pop)[svd.subset]
    top = np.argsort(-fst)[:max(1, len(fst) // 100)]
    chance = 100 * len(top) / len(fst)
    pc10 = bp.snp_pcadapt(pack, svd.u, ind_row=train, ind_col=svd.subset)
    for K, res in ((2, pc), (10, pc10)):
        hits = len(np.intersect1d(top, np.argsort(res.lpval())[:100]))
        log(f"    pcadapt, K = {K}: {hits} of the 100 smallest p-values among "
            f"the {len(top)} highest-Fst variants of the subset (chance "
            f"{chance:.2f}): {hits / chance:.1f}-fold"
            + (" (floor 5)" if K == 2 else " (not gated: PCs 3-10 are the "
               "LD-lifted bulk, whose tails lead)"))
        if K == 2 and not hits / chance > 5:
            bad.append("pcadapt enrichment")
    # GWAS against dense float64 OLS
    rng = np.random.default_rng(args.seed + 12)
    cols = np.sort(rng.choice(m, min(1000, m), replace=False))
    b_ref, se_ref = dense_linreg(torch, dev, pack, y[train], svd.u, train,
                                 cols)
    b, se = gwas["estim"][cols], gwas["std.err"][cols]
    e_b = np.abs(b - b_ref) / (np.abs(b_ref) + se_ref)
    e_se = np.abs(se - se_ref) / se_ref
    log(f"    GWAS (int8) vs dense f64 on {len(cols)} variants: estim max "
        f"|d|/(|b|+se) {e_b.max():.2e}, std.err max rel {e_se.max():.2e} "
        f"(limit 1e-4); finite p-values {np.isfinite(lp).mean():.4f}")
    if e_b.max() > 1e-4 or e_se.max() > 1e-4:
        fail("int8 GWAS disagrees with the dense float64 regression")
    # the same autoSVD on K1/K2
    with bp.config.options(pallas_mxu="highest"):
        t = time.perf_counter()
        svd_h = bp.snp_autoSVD(pack, **kw)
        t_h = time.perf_counter() - t
    same_lr = all(np.array_equal(svd.lrldr[k], svd_h.lrldr[k])
                  for k in svd.lrldr)
    same = np.array_equal(svd.subset, svd_h.subset)
    d_rel = float(np.max(np.abs(svd.d - svd_h.d) / svd_h.d))
    cos = np.abs(np.sum(svd.u * svd_h.u, axis=0))
    log(f"  snp_autoSVD on K1/K2 (pallas_mxu \"highest\"): {t_h:.3f} s; same "
        f"subset {same}, same lrldr {same_lr}; d max rel diff {d_rel:.2e} "
        f"(limit 1e-4); min |cos(u_int8, u_highest)| {cos.min():.6f} "
        f"(floor 0.999)")
    if not (same and same_lr and d_rel <= 1e-4 and cos.min() >= 0.999):
        fail("autoSVD on K6 differs from autoSVD on K1/K2")
    if bad and enforce:
        fail(f"slice 3 checks failed: {bad}")
    return pack, svd, train, path


def ptxas_summary(lib_path, kernel, pat, kind):
    """One line an instantiation of `kernel` from ptxas' report (`-Xptxas
    -v`, kept beside the library): registers, static shared memory, stack
    and spills; `pat` matches the mangled template arguments and `kind`
    names them. The ring's shared memory is dynamic: the plan's is printed
    where the kernel is timed."""
    import re
    from bigsnpr_tpu_torch.ops import cuda_build
    text = cuda_build.report(lib_path).read_text()
    lines = []
    for part in re.split(r"Compiling entry function '", text)[1:]:
        t = re.search(pat, part.split("'", 1)[0])
        if t is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        smem = re.search(r"(\d+) bytes smem", part)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", part)
        lines.append(f"    {kind(t)}: "
                     f"{regs[1] if regs else '?'} registers, "
                     f"{smem[1] if smem else 0} B static smem, stack / spill "
                     f"stores / loads "
                     f"{'/'.join(spill.groups()) if spill else '?'} B")
    log(f"  ptxas, {kernel}: {len(lines)} instantiations")
    for line in lines:
        log(line)
    for m in re.finditer(r"Performance Loss: (wgmma[^']*?) (?:in|for) the "
                         r"function '([^']*)'", text):
        t = re.search(pat, m[2])
        if t is not None:
            log(f"    {kind(t)}: {m[1]}")


def i8_ptxas_summary(lib_path):
    """K6 / K8: i8_wgmma_kernel<PROD, NONA, MAT, BN>."""
    ptxas_summary(
        lib_path, "i8_wgmma_kernel<PROD, NONA, MAT, BN>",
        r"i8_wgmma_kernelILb(\d)ELb(\d)ELb(\d)ELi(\d+)E",
        lambda t: ((("K8 " if t[3] == "1" else "K6 ")
                    + ("prod" if t[1] == "1" else "cprod")
                    + (" nona" if t[2] == "1" else "")).ljust(15)
                   + f" BN {t[4]:>3s}"))


def plane_ptxas_summary(lib_path):
    """K1 / K2 / K7: plane_wgmma_kernel<PROD, TERMS, BNC>."""
    ptxas_summary(
        lib_path, "plane_wgmma_kernel<PROD, TERMS, BNC>",
        r"plane_wgmma_kernelILb(\d)ELi(\d)ELi(\d+)E",
        lambda t: ((("K2 " if t[1] == "1" else "K1 ") if t[2] == "3" else
                    "K7 ") + ("prod" if t[1] == "1" else "cprod")).ljust(9)
                  + f" BNC {t[3]:>3s}")


def sweep_ptxas_summary(lib_path):
    """The sweep kernel: gibbs_ring_kernel<T, LASSO, NCMAX> (NCMAX: the
    chains a CTA the instantiation holds, whose launch bound caps its
    registers)."""
    ptxas_summary(
        lib_path, "gibbs_ring_kernel<T, LASSO, NCMAX>",
        r"gibbs_ring_kernelI([fd])Lb(\d)ELi(\d+)E",
        lambda t: (("float32 " if t[1] == "f" else "float64 ")
                   + ("lassosum" if t[2] == "1" else "LDpred2 ").ljust(9)
                   + f" NCMAX {t[3]}"))


def bound_i8(P, W_rows, l, rows_out, planes, nm):
    """Least time of a K6 product: bytes read once and written once over
    3.35 TB/s, or 2 (4l) n m int8 operations a plane over 1,979 TOP/s."""
    nbytes = P.numel() + 4 * (W_rows * l + 2 * P.shape[0] + rows_out * l)
    ops = 2.0 * 4 * l * nm * planes
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OP_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, nbytes, ops


def int_mm_yardstick(torch, T8, kind, digits):
    """torch._int_mm on pre-decoded int8 planes (m, ldn) (K8's, from
    `int8m_planes`) and the same digits (the decode is not timed): returns
    a function running one product. cprod contracts over the planes' ldn
    columns, the digits zero-padded to them; prod over the m variants."""
    F = torch.nn.functional
    if kind == "cprod":
        ldn = T8[0].shape[1]
        digs = [F.pad(d, (0, ldn - d.shape[1])) for d in digits]
        return lambda: [torch._int_mm(a, d.t()) for a, d in
                        zip(T8, digs * len(T8))]
    pad = -T8[0].shape[0] % 8
    A = [F.pad(t.t(), (0, pad)).contiguous() for t in T8]
    digs = [F.pad(d, (0, pad)) for d in digits]
    return lambda: [torch._int_mm(a, d.t()) for a, d in zip(A, digs)]


def i8_launch_only(gk, prod, nona, src, n, W, c, inv):
    """One GEMM + epilogue launch (`_launch_i8`) on operands prepared once
    (digits, scales, sums): what the torch._int_mm yardstick also leaves
    out. Returns the function and the plan it runs on."""
    mat = isinstance(src, tuple)
    m = src[0].shape[0] if mat else src.shape[0]
    l = W.shape[1]
    plan = gk.i8_plan(prod, nona, mat, m, n, l,
                      gk._sm_count(W.device) if W.is_cuda else 132)
    if not W.is_cuda:     # CPU rehearsal: the wrapper runs its twin
        kern = {(False, False): gk.cprod_i8, (True, False): gk.prod_i8,
                (False, True): gk.cprod_i8m, (True, True): gk.prod_i8m}
        extra = {} if mat else {"nona": nona}
        return (lambda: kern[prod, mat](src, n, W, c, inv, **extra)), plan
    if prod:
        zb8, zbs, za8, zas, zsum = gk._prod_i8_operands(W, c, inv, nona)
        digits = [zb8] if nona else [zb8, za8]

        def run():
            return gk._launch_i8(True, nona, src, n, digits, n, l, zbs,
                                 zbs if nona else zas, zsum, None, None)
    else:
        q8, qscale, qsum, A = gk._cprod_i8_operands(W, c, inv)

        def run():
            return gk._launch_i8(False, nona, src, n, [q8], m, l, qscale,
                                 qscale, qsum, A, inv)
    return run, plan


def plan_text(plan):
    depth = f" of {plan['ksub']} sub-tiles" if "ksub" in plan else ""
    return (f"plan: BN {plan['bn']} x {plan['n_tiles']}, {plan['stages']} "
            f"stages{depth}, {plan['smem']} B smem, grid {plan['grid']}, "
            f"splits {plan['splits']}")


def bound_i8m(planes, W_rows, l, rows_out, n, m):
    """Least time of a K8 product: the planes' bytes read once (m x ldn
    each), the operand, center and inv read and the output written, over
    3.35 TB/s; or 2 (4l) n m int8 operations a plane over 1,979 TOP/s."""
    P = [p for p in planes if p is not None]
    nbytes = sum(p.numel() for p in P) + 4 * (W_rows * l + 2 * m
                                              + rows_out * l)
    ops = 2.0 * 4 * l * n * m * len(P)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OP_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, nbytes, ops


def phase_i8_timed(bp, gk, torch, dev, pack, svd, train, path, args, reps=5):
    n, m = pack.n, pack.m
    P = pack.device_packed(dev)
    log(f"[11] K6 timed on the {n} x {m} slice-3 pack")
    sc = bp.bed_scaleBinom(pack, ind_row=train, device=dev)
    op = bp.GenoOperator(pack, sc["center"], sc["scale"], ind_row=train,
                         ind_col=svd.subset, device=dev, mxu="int8")
    c, inv = op.center, op.inv
    rng = np.random.default_rng(args.seed + 13)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    V20 = op._scatter(f(rng.standard_normal((len(train), 20))), op.row_idx, n)
    U20 = op._scatter(f(rng.standard_normal((len(svd.subset), 20))),
                      op.col_idx, m)
    V12 = op._scatter(f(rng.standard_normal((len(train), 12))), op.row_idx, n)
    Vf, Uf = f(rng.standard_normal((n, 20))), f(rng.standard_normal((m, 20)))
    nona_P = clear_na(P)
    timer = Timer(torch, dev)
    # K8's materialized planes, which are also the pre-decoded planes of
    # the library yardstick; clear_na leaves the T plane as it is (NA and
    # the cleared code 00 both have t = 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    T8, NA8 = gk.int8m_planes(P, n)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    if not torch.equal(gk.int8m_planes(nona_P[:4096], n, nona=True)[0],
                       T8[:4096]):
        fail("the NA-free copy's T plane differs from the pack's")
    planes = {False: [T8, NA8], True: [T8]}
    cases = (("cprod_i8", P, V20, False, "autoSVD power step, subset x "
              "training rows"),
             ("prod_i8", P, U20, False, "autoSVD power step"),
             ("cprod_i8", P, V12, False, "big_univLinReg, [yr | 1 | 10 PCs]"),
             ("cprod_i8", P, Vf, False, "full width"),
             ("prod_i8", P, Uf, False, "full width"),
             ("cprod_i8_nona", nona_P, Vf, True, "full width, NA-free copy"),
             ("prod_i8_nona", nona_P, Uf, True, "full width, NA-free copy"))
    rows, seen = [], set()
    for key, pk_, W, nona, what in cases:
        cprod = key.startswith("cprod")
        kern = gk.cprod_i8 if cprod else gk.prod_i8
        plain = gk.cprod_i8_plain if cprod else gk.prod_i8_plain
        l = W.shape[1]
        got, raw = kern(pk_, n, W, c, inv, nona=nona, return_raw=True)
        ref, raw_ref = plain(pk_, n, W, c, inv, nona=nona, return_raw=True)
        err, rel = rel_err(got, ref)
        if not (torch.equal(raw, raw_ref) and rel <= I8_TOL):
            fail(f"full-size {key} ({what}) disagrees with its twin")
        bit = torch.equal(got, ref)
        del got, ref, raw, raw_ref
        run, plan = i8_launch_only(gk, not cprod, nona, pk_, n, W, c, inv)
        ms = timer(run, reps=reps)
        wrapper_ms = timer(lambda: kern(pk_, n, W, c, inv, nona=nona),
                           reps=reps)
        del run
        plain_ms = timer(lambda: plain(pk_, n, W, c, inv, nona=nona), reps=1,
                         warmup=0)
        if cprod:
            digits = [gk._cprod_i8_operands(W, c, inv)[0]]
        else:
            zb8, _, za8, _, _ = gk._prod_i8_operands(W, c, inv, nona)
            digits = [zb8] if nona else [zb8, za8]
        lib = int_mm_yardstick(torch, planes[nona], "cprod" if cprod
                               else "prod", digits)
        library_ms = timer(lib, reps=reps)
        del lib
        n_planes = 1 if nona else 2
        bound, by, nbytes, ops = bound_i8(pk_, n if cprod else m, l,
                                          m if cprod else n, n_planes, n * m)
        log(f"  {key:13s} l={l:2d}: kernel {ms:.3f} ms (GEMM + epilogue on "
            f"prepared operands; the whole wrapper {wrapper_ms:.3f} ms; "
            f"{ops / ms / 1e9:.1f} TOP/s, {nbytes / ms / 1e9:.3f} TB/s), twin "
            f"{plain_ms:.1f} ms, torch._int_mm on pre-decoded planes "
            f"{library_ms:.3f} ms (decode not timed), {plan_text(plan)}; "
            f"bound {bound:.3f} ms ({by}: 2 x {4 * l} x "
            f"{n} x {m} x {n_planes} plane(s) = {ops / 1e12:.3f} TOP over "
            f"1,979 TOP/s = {ops / PEAK_INT8_OP_PER_S * 1e3:.3f} ms; "
            f"{nbytes / 1e9:.3f} GB over 3.35 TB/s = "
            f"{nbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms); max abs err "
            f"{err:.2e}, bit-equal {bit} [{what}]")
        if key not in seen and l == 20:
            seen.add(key)
            rows.append({
                "name": f"geno_{key} (K6)", "route": "cuda",
                "source": I8_SOURCE, "replaces": I8_REPLACES[key],
                "launches": path[key], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms})
    rows += k8_timed(gk, torch, dev, P, nona_P, n, planes, build_s, args,
                     reps)
    del planes, T8, NA8
    # the NA-free copy through the operator: only the _nona kernels run
    nona_pack = bp.GenoPack(packed=pack.packed, n=n)
    nona_pack._device_cache[str(dev)] = nona_P
    gk.reset_launches()
    with bp.config.options(pallas_mxu="int8"):
        t = time.perf_counter()
        svd0 = bp.snp_randomSVD(nona_pack, k=10)
        secs = time.perf_counter() - t
    nona_path = dict(gk.launches)
    log(f"  snp_randomSVD(k=10) on the NA-free copy, int8: {secs:.3f} s, "
        f"{svd0.niter} depths, launches {nona_path}")
    # ... and the same on an int8m operator (the K8 _nona kernels)
    sc0 = bp.bed_scaleBinom(nona_pack, device=dev)
    op0 = bp.GenoOperator(nona_pack, sc0["center"], sc0["scale"], device=dev,
                          mxu="int8m")
    gk.reset_launches()
    t = time.perf_counter()
    svd0m = bp.snp_randomSVD(None, {"center": sc0["center"],
                                    "scale": sc0["scale"]}, op=op0, k=10)
    secs = time.perf_counter() - t
    del op0
    nona_path.update({k: v for k, v in gk.launches.items() if "i8m" in k})
    same = all(np.array_equal(getattr(svd0m, a), getattr(svd0, a))
               for a in ("d", "u", "v"))
    log(f"  snp_randomSVD(k=10) on the NA-free copy, int8m operator: "
        f"{secs:.3f} s, {svd0m.niter} depths, launches {dict(gk.launches)}; "
        f"d, u, v bit-equal to the int8 run {same}")
    if dev.type == "cuda" and not (
            nona_path["cprod_i8_nona"] and nona_path["prod_i8_nona"]
            and nona_path["cprod_i8m_nona"] and nona_path["prod_i8m_nona"]
            and sum(v for k, v in nona_path.items()
                    if not k.endswith("_nona")) == 0):
        fail("the NA-free randomSVDs did not run on the _nona kernels alone")
    for r in rows:
        key = r["name"].split()[0][len("geno_"):]
        if key.endswith("_nona"):
            r["launches"] = nona_path[key]
    return rows


def k8_timed(gk, torch, dev, P, nona_P, n, planes, build_s, args, reps):
    """[17a] K8 on the slice-3 pack's planes, l = 12 and 20, with NA and
    NA-free: raw sums equal to its twin's and to K6's on the same operands,
    ms a launch beside its twin, torch._int_mm on the same planes and its
    bound. The JSON rows are the l = 20 ones; their launches are set by
    the slice-5 path (NA) and the NA-free int8m randomSVD."""
    m = P.shape[0]
    T8, NA8 = planes[False]
    log(f"[17a] K8 timed on the {n} x {m} slice-3 pack: planes built in "
        f"{build_s:.3f} s, {(T8.numel() + NA8.numel()) / 1e9:.3f} GB "
        f"(T + NA, {T8.shape[1]} bytes a variant); {T8.numel() / 1e9:.3f} "
        f"GB NA-free")
    rng = np.random.default_rng(args.seed + 14)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    c, inv = f(rng.uniform(0.1, 1.9, m)), f(rng.uniform(0.5, 3.0, m))
    timer = Timer(torch, dev)
    rows = []
    for l in (20, 12):
        V, U = f(rng.standard_normal((n, l))), f(rng.standard_normal((m, l)))
        for nona in (False, True):
            pl = (T8, None) if nona else (T8, NA8)
            pk_ = nona_P if nona else P
            for cprod in (True, False):
                key = ("cprod_i8m" if cprod else "prod_i8m") + (
                    "_nona" if nona else "")
                kern = gk.cprod_i8m if cprod else gk.prod_i8m
                plain = gk.cprod_i8m_plain if cprod else gk.prod_i8m_plain
                k6 = gk.cprod_i8 if cprod else gk.prod_i8
                W = V if cprod else U
                got, raw = kern(pl, n, W, c, inv, return_raw=True)
                ref, raw_ref = plain(pl, n, W, c, inv, return_raw=True)
                out6, raw6 = k6(pk_, n, W, c, inv, nona=nona,
                                return_raw=True)
                err, rel = rel_err(got, ref)
                ok = (torch.equal(raw, raw_ref) and torch.equal(raw, raw6)
                      and torch.equal(got, out6) and rel <= I8_TOL)
                del got, ref, raw, raw_ref, out6, raw6
                if not ok:
                    fail(f"full-size {key} l={l} disagrees with its twin or "
                         f"with K6")
                run, plan = i8_launch_only(gk, not cprod, nona, pl, n, W, c,
                                           inv)
                ms = timer(run, reps=reps)
                wrapper_ms = timer(lambda: kern(pl, n, W, c, inv), reps=reps)
                del run
                plain_ms = timer(lambda: plain(pl, n, W, c, inv), reps=1,
                                 warmup=0)
                if cprod:
                    digits = [gk._cprod_i8_operands(W, c, inv)[0]]
                else:
                    zb8, _, za8, _, _ = gk._prod_i8_operands(W, c, inv, nona)
                    digits = [zb8] if nona else [zb8, za8]
                lib = int_mm_yardstick(torch, planes[nona], "cprod" if cprod
                                       else "prod", digits)
                library_ms = timer(lib, reps=reps)
                del lib
                bound, by, nbytes, ops = bound_i8m(
                    pl, n if cprod else m, l, m if cprod else n, n, m)
                log(f"  {key:14s} l={l:2d}: kernel {ms:.3f} ms (GEMM + "
                    f"epilogue on prepared operands; the whole wrapper "
                    f"{wrapper_ms:.3f} ms; {nbytes / ms / 1e9:.3f} TB/s, "
                    f"{ops / ms / 1e9:.1f} TOP/s), twin {plain_ms:.1f} ms, "
                    f"torch._int_mm on the same planes {library_ms:.3f} ms, "
                    f"{plan_text(plan)}; bound {bound:.3f} ms ({by}: "
                    f"{nbytes / 1e9:.3f} GB over 3.35 TB/s = "
                    f"{nbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms; "
                    f"{ops / 1e12:.3f} TOP over 1,979 TOP/s = "
                    f"{ops / PEAK_INT8_OP_PER_S * 1e3:.3f} ms); raw int32 "
                    f"sums equal to the twin's and K6's, output bit-equal to "
                    f"K6's; max abs err to the twin {err:.2e}")
                if l == 20:
                    rows.append({
                        "name": f"geno_{key} (K8)", "route": "cuda",
                        "source": I8_SOURCE, "replaces": I8M_REPLACES[key],
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": library_ms})
    return rows


# ---------------------------------------------------------------------------
# slice 4: split2 scheme (K7) -> randomSVD -> GWAS -> SCT; lassosum2
# ---------------------------------------------------------------------------

def dense64(torch, packed, n, c, inv):
    """The float64 standardized matrix (m, n) of a pack, NA -> 0."""
    from bigsnpr_tpu_torch.core.unpack import unpack_dosage

    d, na = unpack_dosage(packed, n, dtype=torch.float64)
    x = (d - c.double()[:, None]) * inv.double()[:, None]
    return torch.where(na, torch.zeros((), dtype=torch.float64,
                                       device=x.device), x)


def check_split(gk, torch, dev, packed, n, c, inv, V, U, tag):
    """K7 cprod and prod against the twin and a float64 product on one
    input: twin within SPLIT_TOL of max |twin|, both within SPLIT_DENSE_TOL
    of max |float64|, two launches bit-equal."""
    X = dense64(torch, packed, n, c, inv)
    for kind, kern, plain, W, ref64 in (
            ("cprod_split", gk.cprod_split, gk.cprod_split_plain, V,
             X @ V.double()),
            ("prod_split", gk.prod_split, gk.prod_split_plain, U,
             X.T @ U.double())):
        got, again = kern(packed, n, W, c, inv), kern(packed, n, W, c, inv)
        ref = plain(packed, n, W, c, inv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        scale = float(ref64.abs().max())
        d_got = float((got.double() - ref64).abs().max()) / scale
        d_ref = float((ref.double() - ref64).abs().max()) / scale
        repeat = torch.equal(got, again)
        log(f"  {tag} {kind:11s} n={n} m={packed.shape[0]} l={W.shape[1]}: "
            f"max abs err {err:.3e} (rel {rel:.1e}, limit {SPLIT_TOL}); vs "
            f"float64: kernel {d_got:.1e}, twin {d_ref:.1e} (limit "
            f"{SPLIT_DENSE_TOL}); two launches bit-equal {repeat}")
        if not (repeat and rel <= SPLIT_TOL and d_got <= SPLIT_DENSE_TOL
                and d_ref <= SPLIT_DENSE_TOL and torch.isfinite(got).all()):
            fail(f"K7 {kind} ({tag}) disagrees with its twin, float64 or "
                 f"itself")


def phase_split_small(bp, gk, torch, dev, rng):
    log("[12] K7 (bf16 bit planes, operand split hi + lo) vs its twin at "
        "awkward shapes")
    for n, m, l in ((1000, 777, 1), (1001, 1500, 12), (1002, 3001, 20),
                    (1003, 513, 21), (20000, 2100, 20)):
        for na in (True, False):
            packed, n_, c, inv, V, U = i8_case(torch, dev, rng, n, m, l, na)
            check_split(gk, torch, dev, packed, n_, c, inv, V, U,
                        "small" if na else "NA-free")
    n, m = 3001, 2500
    pack = bp.GenoPack(packed=small_pack(rng, n, m), n=n)
    sc = bp.bed_scaleBinom(pack, device=dev)
    rows = np.sort(rng.choice(n, 2000, replace=False))
    cols = np.sort(rng.choice(m, 1300, replace=False))
    ops = [ctor(pack, sc["center"], sc["scale"], ind_row=rows, ind_col=cols,
                device=dev, mxu="split2")
           for ctor in (bp.GenoOperator, bp.TorchOperator)]
    V = torch.as_tensor(rng.standard_normal((len(rows), 20)),
                        dtype=torch.float32, device=dev)
    (B, Y), (Br, Yr) = (op.power_dev(V) for op in ops)
    errs = [rel_err(B, Br)[1], rel_err(Y, Yr)[1]]
    log(f"  masked split2 operator ({len(rows)} of {n} rows, {len(cols)} of "
        f"{m} variants): power step rel err {errs[0]:.1e} / {errs[1]:.1e} "
        f"against the plain operator (limit {SPLIT_TOL})")
    if max(errs) > SPLIT_TOL:
        fail("the masked split2 operator disagrees with the plain one")


def make_slice4(bp, torch, dev, args):
    """The slice-4 cohort (slice 3's generator, 3 populations, no planted
    region), its 22 chromosomes with ~3 kb positions, and the split."""
    n, m = args.n4, args.m4
    t0 = time.perf_counter()
    packed, sizes, info = make_ld_cohort(torch, dev, n, m, args.seed + 20,
                                         args.bmin, args.bmax, pops=3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    bounds = chromosome_bounds(sizes, m)
    chrs = np.repeat(np.arange(1, 23), np.diff(bounds))
    rng = np.random.default_rng(args.seed + 21)
    gaps = 1 + rng.exponential(3000.0, m).astype(np.int64)
    pos = np.empty(m, np.int64)
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        pos[c0:c1] = np.cumsum(gaps[c0:c1])
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} "
        f"s: {len(sizes)} LD blocks of {sizes.min()}-{sizes.max()} variants "
        f"(AR(1) rho {RHO}), 3 populations (Fst {FST}), 22 chromosomes of "
        f"{np.diff(bounds).min()}-{np.diff(bounds).max()} variants")
    pack = bp.GenoPack(packed=packed.cpu().numpy(), n=n)
    pack._device_cache[str(dev)] = packed
    perm = rng.permutation(n)
    n_train = n * 3 // 4
    return (pack, chrs, pos, np.sort(perm[:n_train]), np.sort(perm[n_train:]),
            info["pop"])


def check_greedy_one_chromosome(bp, pack, chrs, pos, lpS, train, all_keep,
                                dev):
    """The native greedy against the fixed point on every cell of the
    smallest chromosome, from the same banded r^2; both against the keep
    sets of snp_grid_clumping."""
    from bigsnpr_tpu_torch.ops import clumping as pcl
    from bigsnpr_tpu_torch.pgs import sct as psct

    chrom = int(np.argmin(np.bincount(chrs)[1:])) + 1
    ind = np.nonzero(chrs == chrom)[0]
    sub = pack.subset(ind_row=train, ind_col=ind, device=dev)
    thrs = (0.01, 0.05, 0.1, 0.2, 0.5, 0.8, 0.95)
    bases = (50, 100, 200, 500)
    ei, ej, r2 = psct._banded_r2(sub, pos[ind].astype(np.float64),
                                 1000.0 * max(bases) / min(thrs),
                                 thr_r2_floor=min(thrs), device=dev)
    rank = np.empty(len(ind), np.int64)
    rank[np.argsort(-lpS[ind], kind="stable")] = np.arange(len(ind))
    dist = np.abs(pos[ind][ej] - pos[ind][ei])
    same, t_nat, t_plain, cell = 0, 0.0, 0.0, 0
    for thr in thrs:
        for base in bases:
            sel = (dist <= 1000.0 * base / thr) & (r2 > thr)
            t = time.perf_counter()
            a = pcl._greedy_fixed_point(len(ind), rank, ei[sel], ej[sel])
            t_nat += time.perf_counter() - t
            t = time.perf_counter()
            b = pcl._greedy_fixed_point_plain(len(ind), rank, ei[sel],
                                              ej[sel])
            t_plain += time.perf_counter() - t
            same += int(np.array_equal(a, b)
                        and np.array_equal(ind[a], all_keep[chrom][cell]))
            cell += 1
    log(f"    native greedy vs the fixed point on chromosome {chrom} ("
        f"{len(ind)} variants, {len(ei)} edges with r2 > 0.01): {same} of "
        f"{cell} cells the same keep set, also as snp_grid_clumping's; "
        f"native {t_nat:.3f} s, fixed point {t_plain:.3f} s for the 28")
    if same != cell:
        fail("the native greedy disagrees with the fixed point")


def best_column_r(bp, pack, multi, y_train, test, y_test):
    """r on the test samples of the single C+T column that correlates best
    with y on the training samples."""
    from bigsnpr_tpu_torch.pgs import sct as psct

    S = np.asarray(multi.scores)
    sd = S.std(0)
    ok = sd > 0
    r_tr = np.zeros(S.shape[1])
    r_tr[ok] = ((S[:, ok] - S[:, ok].mean(0)).T @ (y_train - y_train.mean())
                / (len(y_train) * sd[ok] * y_train.std()))
    col = int(np.argmax(r_tr))
    n_thr = len(multi.grid_lpS_thr)
    keep_sets = [k for c in psct._chrom_order(multi.all_keep)
                 for k in multi.all_keep[c]]
    keep = keep_sets[col // n_thr]
    B = np.zeros(pack.m)
    thr = multi.grid_lpS_thr[col % n_thr]
    B[keep] = multi.betas[keep] * (multi.lpS[keep] > thr)
    pred = bp.snp_prodVec(pack.subset(ind_row=test), B)
    return float(np.corrcoef(pred, y_test)[0, 1]), float(r_tr[col])


def stack_rows(n_train, args):
    """Positions among the training samples of the --n-stack that the
    stacking runs on, drawn from the seed."""
    return np.sort(np.random.default_rng(args.seed + 25).choice(
        n_train, min(args.n_stack, n_train), replace=False))


def check_k2_slice4(bp, gk, torch, dev, pack, train, test, multi, final,
                    beta_l, grid_s, grid_launches):
    """K2 against its twin on the operands slice 4 gives it: the training
    samples' pack with the grid PRS's first weight matrix (13 cells x 50
    thresholds: l = 650), the test samples' pack with the lassosum2 grid's
    betas and with the SCT prediction's beta.G. At the grid PRS's width
    also against a float64 product, timed (GEMM on a prepared operand, the
    whole wrapper, torch.matmul on the decoded f32 matrix, the bound), and
    its launches' share of the grid PRS stage."""
    from bigsnpr_tpu_torch.ops import matvec
    from bigsnpr_tpu_torch.pgs import sct as psct

    keep_sets = [k for c in psct._chrom_order(multi.all_keep)
                 for k in multi.all_keep[c]]
    group = psct.grid_group_size(pack.m, len(multi.grid_lpS_thr))
    B = psct.grid_weights(pack.m, keep_sets[:group], multi.betas, multi.lpS,
                          multi.grid_lpS_thr)
    sub_test = pack.subset(ind_row=test, device=dev)
    timer = Timer(torch, dev)
    for i, (sub, W, what) in enumerate((
            (pack.subset(ind_row=train, device=dev), B,
             "snp_grid_PRS, one group of cells"),
            (sub_test, np.nan_to_num(beta_l), "lassosum2 grid scores"),
            (sub_test, final["beta.G"], "SCT prediction"))):
        packed, W, _, c, inv = matvec._prep(sub, W, sub.m, what, None, None,
                                            dev)
        got = gk.prod(packed, sub.n, W, c, inv)
        ref = gk.prod_plain(packed, sub.n, W, c, inv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not (rel <= TOL and torch.isfinite(got).all()):
            fail(f"K2 disagrees with its twin at slice 4's {what}")
        ms = timer(lambda: gk.prod(packed, sub.n, W, c, inv), reps=3)
        log(f"    K2 vs its twin at n={sub.n} m={sub.m} l={W.shape[1]} "
            f"[{what}]: max abs err {err:.3e} (rel {rel:.2e}, limit {TOL}); "
            f"the whole wrapper {ms:.3f} ms")
        if i:
            continue
        d64 = check_dense(torch, packed, sub.n, c, inv, W, got, ref, what)
        del got, ref
        run, plan = plane_launch_only(gk, True, 3, packed, sub.n, W, c, inv)
        gemm_ms = timer(run, reps=3)
        del run
        X = torch.empty((sub.m, sub.n), dtype=torch.float32, device=dev)
        for j0 in range(0, sub.m, 4096):
            X[j0:j0 + 4096] = gk.standardized(
                packed[j0:j0 + 4096], sub.n, c[j0:j0 + 4096],
                inv[j0:j0 + 4096])
        library_ms = timer(lambda: X.T @ W, reps=3)
        del X
        l = W.shape[1]
        bound, by, nbytes, ops = bound_planes(packed, sub.m, l, sub.n,
                                              sub.n * sub.m, 3)
        t_f32 = 2.0 * sub.n * sub.m * l / PEAK_F32_FLOP_PER_S * 1e3
        log(f"      vs float64: kernel {d64[0]:.2e}, twin {d64[1]:.2e} "
            f"(limit {DENSE_TOL}); GEMM + epilogue on a prepared operand "
            f"{gemm_ms:.3f} ms ({ops / gemm_ms / 1e9:.1f} TFLOP/s bf16), "
            f"torch.matmul on the decoded f32 matrix {library_ms:.3f} ms, "
            f"{plan_text(plan)}; bound {bound:.3f} ms ({by}: "
            f"{ops / 1e12:.3f} TFLOP bf16; the f32 product's "
            f"{t_f32:.3f} ms); snp_grid_PRS launched K2 {grid_launches} "
            f"times (groups of up to {l} columns): {grid_launches} x "
            f"{ms:.3f} ms = "
            f"{grid_launches * ms / 1e3:.3f} s of the stage's {grid_s:.3f} s "
            f"({100 * grid_launches * ms / 1e3 / max(grid_s, 1e-9):.1f}%)")


def phase_slice4(bp, gk, gsk, torch, dev, args):
    n, m = args.n4, args.m4
    log(f"[13] slice 4 at n={n} samples x m={m} variants, pallas_mxu "
        f"\"split2\"")
    pack, chrs, pos, train, test, pop = make_slice4(bp, torch, dev, args)
    times = {}

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        log(f"  {name:26s} {times[name]:9.3f} s")
        return out

    gk.reset_launches()
    gsk.reset_launches()
    with bp.config.options(pallas_mxu="split2"):
        svd = stage("snp_randomSVD", lambda: bp.snp_randomSVD(
            pack, k=10, ind_row=train))
        sim = stage("snp_simuPheno", lambda: bp.snp_simuPheno(
            pack, h2=0.4, M=min(1000, m // 10), seed=args.seed))
        y = sim["pheno"]
        gwas = stage("big_univLinReg", lambda: bp.big_univLinReg(
            pack, y[train], covar=svd.u, ind_row=train))
    path = dict(gk.launches)
    lpS = stage("gwas_pvalues", lambda: -bp.gwas_pvalues(gwas, log10=True))
    all_keep, grid = stage("snp_grid_clumping", lambda: bp.snp_grid_clumping(
        pack, chrs, pos, lpS, ind_row=train))
    k2_before = gk.launches["prod"]
    multi = stage("snp_grid_PRS", lambda: bp.snp_grid_PRS(
        pack, all_keep, gwas["estim"], lpS, n_thr_lpS=args.n_thr,
        ind_row=train))
    grid_launches = gk.launches["prod"] - k2_before
    # the stacking on the scores of args.n_stack of the training samples:
    # its host CD costs (samples x 30,800 columns) a pass
    stack = stack_rows(len(train), args)
    final = stage("snp_grid_stacking", lambda: bp.snp_grid_stacking(
        dataclasses.replace(multi, scores=multi.scores[stack]),
        y[train[stack]]))
    pred = stage("prediction (test samples)", lambda: bp.snp_prodVec(
        pack.subset(ind_row=test), final["beta.G"]) + final["intercept"])
    # lassosum2 on the same cohort: chromosomes 1e9 bp apart, so no
    # window holds two of them
    pos_all = chrs.astype(np.float64) * 1e9 + pos
    corr = stage("snp_cor", lambda: bp.snp_cor(
        pack, ind_row=train, size=500, thr_r2=0.01, infos_pos=pos_all,
        finalize="device"))
    bb = stage("auto_blocks + bands", lambda: bp.build_block_bands(
        corr, bp.auto_blocks(corr)))
    df_beta = {"beta": gwas["estim"], "beta_se": gwas["std.err"],
               "n_eff": np.full(m, float(len(train)))}
    sweeps0 = gsk.launches["lassosum"]
    beta_l, gp = stage("snp_lassosum2", lambda: bp.snp_lassosum2(
        corr, df_beta, blocks=bb, nlambda=args.nlambda,
        maxiter=args.lasso_maxiter))
    half = len(test) // 2
    scores_l = stage("lassosum2 grid scores", lambda: bp.snp_prodVec(
        pack.subset(ind_row=test), np.nan_to_num(beta_l)))
    r_first = np.array([np.corrcoef(scores_l[:half, i], y[test][:half])[0, 1]
                        if scores_l[:half, i].std() > 0 else -1.0
                        for i in range(beta_l.shape[1])])
    best = int(np.argmax(np.nan_to_num(r_first, nan=-1.0)))
    prs_l = stage("snp_PRS (lassosum2)", lambda: bp.snp_PRS(
        pack, beta_l[:, best], ind_test=test[half:]))
    launches = dict(gk.launches)
    launches["lassosum"] = gsk.launches["lassosum"] - sweeps0
    log(f"  total {sum(times.values()):.3f} s; kernel launches {launches}")
    log(f"  launches from snp_randomSVD through big_univLinReg (snp_simuPheno"
        f"'s K2 included): {path}")
    enforce = dev.type == "cuda"
    if enforce:
        if path["cprod"] or any(path[k] for k in K6):
            fail("K1 or K6 launched on the split2 path")
        if not (path["cprod_split"] and path["prod_split"]):
            fail("K7 was not launched on the slice-4 path")
        if launches["lassosum"] <= 0:
            fail("the lassosum mode was not launched")

    log("  checks:")
    with bp.config.options(pallas_mxu="highest"):
        t = time.perf_counter()
        svd_h = bp.snp_randomSVD(pack, k=10, ind_row=train)
        t_h = time.perf_counter() - t
    d_rel = float(np.max(np.abs(svd.d - svd_h.d) / svd_h.d))
    cos = np.abs(np.sum(svd.u * svd_h.u, axis=0))
    log(f"    snp_randomSVD on K7 vs on K1/K2 ({t_h:.3f} s): d max rel diff "
        f"{d_rel:.2e} (limit 1e-4), min |cos(u_split2, u_highest)| "
        f"{cos.min():.6f} (floor 0.999); depths {svd.niter} / {svd_h.niter}")
    if not (d_rel <= 1e-4 and cos.min() >= 0.999):
        fail("randomSVD on K7 differs from randomSVD on K1/K2")
    rng = np.random.default_rng(args.seed + 22)
    cols = np.sort(rng.choice(m, min(1000, m), replace=False))
    b_ref, se_ref = dense_linreg(torch, dev, pack, y[train], svd.u, train,
                                 cols)
    b, se = gwas["estim"][cols], gwas["std.err"][cols]
    e_b = np.abs(b - b_ref) / (np.abs(b_ref) + se_ref)
    e_se = np.abs(se - se_ref) / se_ref
    log(f"    GWAS (split2) vs dense f64 on {len(cols)} variants: estim max "
        f"|d|/(|b|+se) {e_b.max():.2e}, std.err max rel {e_se.max():.2e} "
        f"(limit 1e-4)")
    if e_b.max() > 1e-4 or e_se.max() > 1e-4:
        fail("split2 GWAS disagrees with the dense float64 regression")
    n_sets = sum(len(v) for v in all_keep.values())
    kept = [len(k) for v in all_keep.values() for k in v]
    log(f"    grid: {len(grid['size'])} cells x {len(all_keep)} chromosomes "
        f"= {n_sets} keep sets of {min(kept)}-{max(kept)} variants; scores "
        f"{multi.scores.shape[0]} x {multi.scores.shape[1]} float32 "
        f"({multi.scores.nbytes / 1e9:.2f} GB)")
    check_greedy_one_chromosome(bp, pack, chrs, pos, lpS, train, all_keep,
                                dev)
    check_k2_slice4(bp, gk, torch, dev, pack, train, test, multi, final,
                    beta_l, times["snp_grid_PRS"], grid_launches)
    y_test = y[test]
    r_sct = float(np.corrcoef(pred, y_test)[0, 1])
    r_ct, r_ct_train = best_column_r(bp, pack, multi, y[train], test, y_test)
    mod = final["mod"]
    log(f"    r(SCT prediction, y_test) {r_sct:.4f} on {len(test)} test "
        f"samples (floor 0.1; null sd {1 / np.sqrt(len(test)):.3f}); the best "
        f"single C+T column: r {r_ct:.4f} on the test samples ({r_ct_train:.4f}"
        f" on the {len(train)} training ones); stacking on {len(stack)} of "
        f"them: alpha {mod.alpha}, "
        f"{int((mod.beta != 0).sum())} of {len(mod.beta)} columns non-zero")
    r_l = float(np.corrcoef(prs_l[:, 0], y_test[half:])[0, 1])
    n_div = int(np.isnan(beta_l).any(0).sum())
    it = gp["num_iter"]
    log(f"    lassosum2: grid point {best} (lambda {gp['lambda'][best]:.4g}, "
        f"delta {gp['delta'][best]}) chosen on {half} test samples; r on the "
        f"other {len(test) - half}: {r_l:.4f} (floor 0.1); {n_div} of "
        f"{len(it)} grid points diverged; sweeps a point {it.min()}-"
        f"{it.max()}, {launches['lassosum']} launches; LD nnz "
        f"{corr.upper.nnz}, {len(bb.buckets)} buckets, dropped_r2_frac "
        f"{bb.dropped_r2_frac:.4f}")
    bad = [] if not enforce else [
        what for what, ok in (("r(SCT, y_test)", r_sct > 0.1),
                              ("r(lassosum2, y_test)", r_l > 0.1)) if not ok]
    if bad:
        fail(f"slice 4 checks failed: {bad}")
    return dict(pack=pack, train=train, svd=svd, corr=corr, bb=bb,
                df_beta=df_beta, path=path, launches=launches)


def bf16_planes(gk, torch, P, n):
    """Pre-decoded bf16 T and NA planes (m, n) of a pack, for the library
    yardstick (the decode is not timed)."""
    m = P.shape[0]
    T = torch.empty((m, n), dtype=torch.bfloat16, device=P.device)
    NA = torch.empty_like(T)
    for j0 in range(0, m, 2048):
        t8, na8 = gk.int_planes(P[j0:j0 + 2048], n)
        T[j0:j0 + 2048] = t8
        NA[j0:j0 + 2048] = na8
    return T, NA


def phase_split_timed(bp, gk, torch, dev, s4, args, reps=5):
    """K7 at the shapes of the slice and at 50,000 x 100,000 on random
    bytes, as its GEMM on an operand prepared once and as the whole
    wrapper, beside its twin, bf16 torch.matmul on pre-decoded planes and
    its bound."""
    pack, train, svd = s4["pack"], s4["train"], s4["svd"]
    n, m = pack.n, pack.m
    log(f"[14] K7 timed on the {n} x {m} slice-4 pack and at "
        f"{args.n} x {args.m} on random bytes; the lassosum mode")
    timer = Timer(torch, dev)
    rng = np.random.default_rng(args.seed + 23)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    op = bp.GenoOperator(pack, svd.center, svd.scale, ind_row=train,
                         device=dev, mxu="split2")
    P, c, inv = op.packed, op.center, op.inv
    big_n, big_m = args.n, args.m
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 24)
    Pb = torch.randint(0, 256, (big_m, (big_n + 3) // 4), generator=gen,
                       device=dev, dtype=torch.uint8)
    cb = f(rng.uniform(0.1, 1.9, big_m))
    ib = f(rng.uniform(0.5, 3.0, big_m))
    cases = (("cprod_split", P, n, c, inv,
              op._scatter(f(rng.standard_normal((len(train), 20))),
                          op.row_idx, n), "randomSVD power step, training rows"),
             ("prod_split", P, n, c, inv, f(rng.standard_normal((m, 20))),
              "randomSVD power step"),
             ("cprod_split", P, n, c, inv,
              op._scatter(f(rng.standard_normal((len(train), 12))),
                          op.row_idx, n), "big_univLinReg, [yr | 1 | 10 PCs]"),
             ("cprod_split", Pb, big_n, cb, ib,
              f(rng.standard_normal((big_n, 20))), "full width, random bytes"),
             ("prod_split", Pb, big_n, cb, ib,
              f(rng.standard_normal((big_m, 20))), "full width, random bytes"))
    rows = {}
    planes = {}
    for key, P_, n_, c_, i_, W, what in cases:
        cprod = key == "cprod_split"
        kern = gk.cprod_split if cprod else gk.prod_split
        plain = gk.cprod_split_plain if cprod else gk.prod_split_plain
        l = W.shape[1]
        got, ref = kern(P_, n_, W, c_, i_), plain(P_, n_, W, c_, i_)
        err, rel = rel_err(got, ref)
        if rel > SPLIT_TOL:
            fail(f"full-size {key} ({what}) disagrees with its twin")
        del got, ref
        wrapper_ms = timer(lambda: kern(P_, n_, W, c_, i_), reps=reps)
        run, plan = plane_launch_only(gk, not cprod, 2, P_, n_, W, c_, i_)
        ms = timer(run, reps=reps)
        del run
        plain_ms = timer(lambda: plain(P_, n_, W, c_, i_), reps=1, warmup=0)
        if id(P_) not in planes:
            planes.clear()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            planes[id(P_)] = bf16_planes(gk, torch, P_, n_)
        T, NA = planes[id(P_)]
        if cprod:
            qs = gk._cprod_split_operands(W, c_, i_)[0].T.contiguous()
            lib = lambda: (T @ qs, NA @ qs)  # noqa: E731
        else:
            zbs, zas = gk._prod_split_operands(W, c_, i_)[:2]
            lib = lambda: (zbs @ T, zas @ NA)  # noqa: E731
        library_ms = timer(lib, reps=reps)
        bound, by, nbytes, ops = bound_planes(
            P_, n_ if cprod else P_.shape[0], l,
            P_.shape[0] if cprod else n_, n_ * P_.shape[0], 2)
        log(f"  {key:11s} l={l:2d} n={n_} m={P_.shape[0]}: kernel {ms:.3f} "
            f"ms (GEMM + epilogue on an operand prepared once; the whole "
            f"wrapper {wrapper_ms:.3f} ms; {ops / ms / 1e9:.1f} TFLOP/s), "
            f"{plan_text(plan)}, twin {plain_ms:.1f} ms, bf16 "
            f"torch.matmul on pre-decoded "
            f"planes {library_ms:.3f} ms (decode not timed), bound "
            f"{bound:.3f} ms ({by}: {ops / 1e12:.3f} TFLOP over 989 TFLOP/s ="
            f" {ops / PEAK_BF16_FLOP_PER_S * 1e3:.3f} ms; {nbytes / 1e9:.3f} "
            f"GB over 3.35 TB/s = {nbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms); "
            f"max abs err {err:.2e} (rel {rel:.1e}) [{what}]")
        if what.startswith("full width"):
            rows[key] = {
                "name": f"geno_{key} (K7)", "route": "cuda",
                "source": SPLIT_SOURCE, "replaces": SPLIT_REPLACES[key],
                "launches": s4["path"][key], "max_abs_err": err, "ms": ms,
                "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms}
    del planes, Pb
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return [rows[k] for k in K7] + [phase_lasso_timed(bp, torch, dev, s4,
                                                      args)]


def lasso_bound(sb, NG):
    """Least time of one lassosum sweep at this run's bands: bytes (band
    once, per-variant bh and pf, each point's betas read and written and
    its dp in and out, the partials) over 3.35 TB/s, or its float
    operations (2 (2W + 1) for the AXPY plus ~15 for the step, per point
    and row) over 67 TFLOP/s."""
    sz = sb.band.element_size()
    rows = sb.blk_rows.cpu().numpy().astype(np.int64)
    wk = 2 * sb.blk_W.cpu().numpy().astype(np.int64) + 1
    band = int((rows * wk).sum()) * sz
    io = (2 * sb.m * sz + int(sb.gidx.numel()) * 4
          + NG * (2 * sb.m * sz + 2 * sb.dp_len * sz + 3 * sb.nblk * 4))
    t_bytes = (band + io) / PEAK_BYTES_PER_S * 1e3
    t_ops = NG * float((rows * (2 * wk + 15)).sum()) / PEAK_F32_FLOP_PER_S \
        * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by


def phase_lasso_timed(bp, torch, dev, s4, args):
    """The lassosum mode at the slice's bands and grid (4 deltas x 30
    lambdas; --lasso-points / 4 lambdas in a CPU rehearsal), from the
    state after 5 sweeps: kernel and twin bit-equal."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk
    from bigsnpr_tpu_torch.pgs import ldpred2 as pld

    sb = s4["bb"].device_put(dev)
    bh, N, _ = pld._df_beta_arrays(s4["df_beta"])
    pf = np.sqrt(np.max(N) / N)
    lam0 = np.max(np.abs(bh / pf))
    per = args.lasso_points // 4
    lam = np.tile(bp.seq_log(lam0, 0.01 * lam0, per + 1)[1:], 4)
    delta = np.repeat([0.001, 0.01, 0.1, 1.0], per)
    NG = len(lam)
    f = lambda a: torch.as_tensor(a, dtype=sb.dtype, device=dev)  # noqa: E731
    bh_t, pf_t, lam_t, del_t = f(bh), f(pf), f(lam), f(delta)
    active = torch.ones(NG, dtype=torch.bool, device=dev)
    active[::7] = False
    dp, beta = sb.dp0(NG), torch.zeros((NG, sb.m), dtype=sb.dtype, device=dev)
    for _ in range(5):
        gsk.lassosum_sweep(sb, dp, beta, bh_t, pf_t, lam_t, del_t,
                           torch.ones(NG, dtype=torch.bool, device=dev))

    def run(fn):
        d, b = dp.clone(), beta.clone()
        out = fn(sb, d, b, bh_t, pf_t, lam_t, del_t, active)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (d, b) + tuple(out)

    got, again = run(gsk.lassosum_sweep), run(gsk.lassosum_sweep)
    t = time.perf_counter()
    ref = run(gsk.lassosum_sweep_plain)
    plain_ms = (time.perf_counter() - t) * 1e3
    bit = all(torch.equal(a, r) for a, r in zip(got, ref))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    err = max(float((a.double() - r.double()).abs().max())
              for a, r in zip(got, ref))
    timer = Timer(torch, dev)
    ms = timer(lambda: gsk.lassosum_sweep(sb, dp.clone(), beta.clone(), bh_t,
                                          pf_t, lam_t, del_t, active), reps=5)
    bound, by = lasso_bound(sb, NG)
    pl = sb.plans.get(gsk.plan_key(NG, True))
    t_row, t_issue = ring_floor_ms(sb, "lassosum"), issue_floor_ms(
        sb, int(active.sum()), "lassosum")
    log(f"  lassosum mode ({NG} grid points, {int(active.sum())} active; "
        f"{sb.nblk} blocks, {sb.max_rows} rows in the longest, width up to "
        f"{sb.wkmax}): kernel {ms:.3f} ms a sweep, twin {plain_ms:.1f} ms, "
        f"bound {bound:.3f} ms ({by}); bit-equal to the twin {bit} (max abs "
        f"diff {err:.1e}); two launches bit-equal {repeat}")
    log(f"    plan: {sweep_plan_text(sb, pl, NG)}")
    log(f"    floors: the longest block's row floor {t_row:.3f} ms "
        f"({RING_ROW_CYCLES[('lassosum', sb.band.element_size())]} cycles a "
        f"row), the card's issue floor {t_issue:.3f} ms (active points); "
        f"{ms / max(t_row, t_issue, 1e-9):.2f}x the larger floor")
    if not (bit and repeat):
        fail("the lassosum mode disagrees with its twin or does not repeat")
    return {"name": f"gibbs_sweep lassosum mode (lassosum2, {NG} grid "
                    "points)",
            "route": "cuda", "source": SWEEP_SOURCE,
            "replaces": LASSO_REPLACES,
            "launches": s4["launches"]["lassosum"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


# ---------------------------------------------------------------------------
# slice 5: K8 (int8m) under randomSVD -> GWAS -> the unblocked LDpred2 and
# lassosum2 on the sweep kernel, one band over every variant
# ---------------------------------------------------------------------------

def check_i8m(gk, torch, dev, packed, n, c, inv, V, U, nona, tag):
    """K8 cprod and prod on the pack's planes against the twin and K6: raw
    int32 sums equal to both, the output bit-equal to K6's and within
    I8_TOL of the twin's, two launches bit-equal."""
    planes = gk.int8m_planes(packed, n, nona)
    for kind, kern, plain, k6, W in (
            ("cprod_i8m", gk.cprod_i8m, gk.cprod_i8m_plain, gk.cprod_i8, V),
            ("prod_i8m", gk.prod_i8m, gk.prod_i8m_plain, gk.prod_i8, U)):
        key = kind + ("_nona" if nona else "")
        got, raw = kern(planes, n, W, c, inv, return_raw=True)
        again = kern(planes, n, W, c, inv)
        ref, raw_ref = plain(planes, n, W, c, inv, return_raw=True)
        out6, raw6 = k6(packed, n, W, c, inv, nona=nona, return_raw=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        eq = (torch.equal(raw, raw_ref), torch.equal(raw, raw6),
              torch.equal(got, out6), torch.equal(got, again))
        err, rel = rel_err(got, ref)
        log(f"  {tag} {key:14s} n={n} m={packed.shape[0]} l={W.shape[1]}: "
            f"raw int32 sums equal to the twin's {eq[0]}, to K6's {eq[1]}; "
            f"output bit-equal to K6's {eq[2]}; max abs err to the twin "
            f"{err:.3e} (rel {rel:.1e}, limit {I8_TOL}); two launches "
            f"bit-equal {eq[3]}")
        if not (all(eq) and rel <= I8_TOL and torch.isfinite(got).all()):
            fail(f"K8 {key} ({tag}) disagrees with its twin or K6, or does "
                 f"not repeat")


def band_ld(bp, rows, width, seed):
    """Banded AR-like LD over `rows` variants (lag-d correlation ~0.95^d
    up to `width`), one LD component: the one block of the unblocked
    samplers."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    diags = [np.ones(rows)] + [0.95 ** d * rng.uniform(0.8, 1.0, rows - d)
                               for d in range(1, width + 1)]
    up = sp.diags(diags, list(range(width + 1)), format="csc").tocsc()
    return bp.SparseLD(upper=up)


def phase_i8m_small(bp, gk, torch, dev, rng):
    log("[15] K8 (materialized int8 planes) vs its twin and K6 at awkward "
        "shapes; the sweep kernel on one band and on blocks vs its twin")
    for n, m, l in ((1000, 777, 1), (1001, 1500, 12), (1002, 3001, 20),
                    (1003, 513, 21), (20000, 2100, 20)):
        for na in (True, False):
            packed, n_, c, inv, V, U = i8_case(torch, dev, rng, n, m, l, na)
            check_i8m(gk, torch, dev, packed, n_, c, inv, V, U,
                      nona=not na, tag="small" if na else "NA-free")
    # the masked int8m operator against the int8 one and the plain one
    n, m = 3001, 2500
    pack = bp.GenoPack(packed=small_pack(rng, n, m), n=n)
    sc = bp.bed_scaleBinom(pack, device=dev)
    rows = np.sort(rng.choice(n, 2000, replace=False))
    cols = np.sort(rng.choice(m, 1300, replace=False))
    ops = [ctor(pack, sc["center"], sc["scale"], ind_row=rows, ind_col=cols,
                device=dev, mxu=mxu)
           for ctor, mxu in ((bp.GenoOperator, "int8m"),
                             (bp.GenoOperator, "int8"),
                             (bp.TorchOperator, "int8m"))]
    V = torch.as_tensor(rng.standard_normal((len(rows), 20)),
                        dtype=torch.float32, device=dev)
    (B, Y), (B8, Y8), (Br, Yr) = (op.power_dev(V) for op in ops)
    same8 = torch.equal(B, B8) and torch.equal(Y, Y8)
    errs = [rel_err(B, Br)[1], rel_err(Y, Yr)[1]]
    log(f"  masked int8m operator ({len(rows)} of {n} rows, {len(cols)} of "
        f"{m} variants): power step bit-equal to the int8 operator's "
        f"{same8}; rel err {errs[0]:.1e} / {errs[1]:.1e} against the plain "
        f"operator (limit {I8_TOL})")
    if not same8 or max(errs) > I8_TOL:
        fail("the masked int8m operator disagrees with the int8 or the plain "
             "one")


def plan_at(gsk, dev, sb, NC, nct, lasso=False):
    """The sweep's (or with `lasso` the lassosum mode's) launch for NC
    chains at nct chains a CTA (the plan's ring, its stages where they
    still fit)."""
    smem = gsk.max_smem(dev)
    pl = gsk.plan(sb, NC, smem, lasso)
    elem = sb.band.element_size()
    stage = pl.stage if gsk.ring_smem_bytes(nct, pl.ring_len, elem,
                                            pl.stage) <= smem else 0
    return gsk.SweepPlan(nct, gsk.ring_threads(nct), pl.ring_len, stage,
                         gsk.ring_smem_bytes(nct, pl.ring_len, elem, stage))


def at_one_chain(gsk, torch, dev, sb, NC, fn, lasso=False):
    """fn() with the sweep (the lassosum mode) planned at one chain a CTA
    (the card only), the plan restored after."""
    if dev.type != "cuda":
        return fn()
    key = gsk.plan_key(NC, lasso)
    saved = sb.plans.get(key)
    sb.plans[key] = plan_at(gsk, dev, sb, NC, 1, lasso)
    try:
        return fn()
    finally:
        if saved is None:
            del sb.plans[key]
        else:
            sb.plans[key] = saved


def gdp_sweep_case(bp, gsk, torch, dev, sb, NC, rng, tag, timer,
                   one_chain=False):
    """The sweep on one band ("global" launches) or on blocks against its
    twin on the card (same pre-drawn u / z): SWEEP_TOL, causal equal, two
    launches bit-equal; with `one_chain`, also bit-equal when run at one
    chain a CTA. Returns (max abs err, kernel ms, twin ms)."""
    st = sweep_inputs(torch, sb, NC, rng)
    key = "sweep_global" if sb.nblk == 1 else "sweep"

    def run(fn):
        dp = st["dp"].clone()
        out = fn(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"], st["s1"],
                 st["u"], st["z"], st["inv_odd_p"], st["p"], st["sparse"],
                 0.95, True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (dp,) + tuple(out)

    before = gsk.launches[key]
    got, again = run(gsk.sweep), run(gsk.sweep)
    launched = gsk.launches[key] > before
    one = (at_one_chain(gsk, torch, dev, sb, NC, lambda: run(gsk.sweep))
           if one_chain else None)
    t = time.perf_counter()
    ref = run(gsk.sweep_plain)
    plain_ms = (time.perf_counter() - t) * 1e3
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    same = one is None or all(torch.equal(a, b) for a, b in zip(got, one))
    causal_diff = int((got[2] != ref[2]).sum())
    errs = [(float((a - b).abs().max()),
             SWEEP_TOL * max(float(b.abs().max()), 1e-30))
            for i, (a, b) in enumerate(zip(got, ref)) if i != 2]
    ms = timer(lambda: gsk.sweep(sb, st["dp"].clone(), st["cb"], st["bh"],
                                 st["C2"], st["C4"], st["s1"], st["u"],
                                 st["z"], st["inv_odd_p"], st["p"],
                                 st["sparse"], 0.95, True), reps=3)
    log(f"  sweep, {tag}: {sb.nblk} blocks, {sb.max_rows} rows in the "
        f"longest, width up to {sb.wkmax}, {NC} chains "
        f"({sweep_plan_text(sb, sb.plans.get(NC), NC)}): max |kernel - "
        f"twin| {max(e[0] for e in errs):.2e} (limit {SWEEP_TOL} x max "
        f"|twin|), causal {causal_diff} differ (0); two launches bit-equal "
        f"{repeat}" + ("" if one is None else
                       f"; bit-equal at one chain a CTA {same}")
        + f"; kernel {ms:.3f} ms a sweep, twin {plain_ms:.1f} ms")
    if dev.type == "cuda" and not launched:
        fail(f"the sweep ({tag}) was not counted in launches[{key!r}]")
    if causal_diff or not repeat or not same or any(
            e[0] > e[1] for e in errs):
        fail(f"the sweep ({tag}) disagrees with its twin, or does not "
             f"repeat")
    return max(e[0] for e in errs), ms, plain_ms


def gdp_lasso_case(bp, gsk, torch, dev, sb, NG, rng, tag, timer,
                   one_chain=False):
    """The lassosum mode on one band or on blocks against its twin on the
    card, from the state after 3 sweeps, one point in five frozen:
    bit-equal, two launches bit-equal; with `one_chain` also bit-equal at
    one point a CTA, as in `gdp_sweep_case`. Returns (max abs err, kernel
    ms, twin ms)."""
    f = lambda a: torch.as_tensor(a, dtype=sb.dtype, device=dev)  # noqa: E731
    m = sb.m
    key = "lassosum_global" if sb.nblk == 1 else "lassosum"
    bh, pf = f(rng.normal(0, 0.02, m)), f(rng.uniform(0.8, 1.5, m))
    lam = f(np.geomspace(0.05, 5e-4, NG))
    delta = f(np.repeat([0.001, 0.01, 0.1, 1.0], -(-NG // 4))[:NG])
    dp, beta = sb.dp0(NG), torch.zeros((NG, m), dtype=sb.dtype, device=dev)
    for _ in range(3):
        gsk.lassosum_sweep(sb, dp, beta, bh, pf, lam, delta,
                           torch.ones(NG, dtype=torch.bool, device=dev))
    active = torch.as_tensor(np.arange(NG) % 5 != 3, device=dev)

    def run(fn):
        d, b = dp.clone(), beta.clone()
        out = fn(sb, d, b, bh, pf, lam, delta, active)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (d, b) + tuple(out)

    before = gsk.launches[key]
    got, again = run(gsk.lassosum_sweep), run(gsk.lassosum_sweep)
    launched = gsk.launches[key] > before
    one = (at_one_chain(gsk, torch, dev, sb, NG,
                        lambda: run(gsk.lassosum_sweep), lasso=True)
           if one_chain else None)
    t = time.perf_counter()
    ref = run(gsk.lassosum_sweep_plain)
    plain_ms = (time.perf_counter() - t) * 1e3
    bit = all(torch.equal(a, r) for a, r in zip(got, ref))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    same = one is None or all(torch.equal(a, b) for a, b in zip(got, one))
    err = max(float((a.double() - r.double()).abs().max())
              for a, r in zip(got, ref))
    ms = timer(lambda: gsk.lassosum_sweep(sb, dp.clone(), beta.clone(), bh,
                                          pf, lam, delta, active), reps=3)
    log(f"  lassosum, {tag}: {sb.nblk} blocks, {sb.max_rows} rows in the "
        f"longest, width up to {sb.wkmax}, {NG} grid points "
        f"({int(active.sum())} active; "
        f"{sweep_plan_text(sb, sb.plans.get(gsk.plan_key(NG, True)), NG)}): "
        f"bit-equal to the "
        f"twin {bit} (max abs diff {err:.1e}); two launches bit-equal "
        f"{repeat}" + ("" if one is None else
                       f"; bit-equal at one point a CTA {same}")
        + f"; kernel {ms:.3f} ms a sweep, twin {plain_ms:.1f} ms")
    if dev.type == "cuda" and not launched:
        fail(f"the lassosum mode ({tag}) was not counted in "
             f"launches[{key!r}]")
    if not (bit and repeat and same):
        fail(f"the lassosum mode ({tag}) disagrees with its twin, or does "
             f"not repeat")
    return err, ms, plain_ms


def phase_gdp_small(bp, gsk, torch, dev, args):
    """The sweep and its lassosum mode against their twins: in float64 on
    one band of --gdp-rows variants (a "global" launch, one chain's dp past
    the 227 KB of shared memory a block may use), and in float32 on 12
    blocks of 100-700 variants (half-width up to 64) at slice 5's 30
    chains and 120 grid points, several chains a CTA, there also bit-equal
    at one chain a CTA. [17b] holds the one-band launches at slice 5's
    band."""
    from bigsnpr_tpu_torch.pgs.band import one_block_bands

    rng = np.random.default_rng(args.seed + 32)
    timer = Timer(torch, dev)
    cases = (("float64, one band", np.float64, 4, 6, lambda: one_block_bands(
                 band_ld(bp, args.gdp_rows, 64, args.seed + 33),
                 dtype=np.float64)),
             ("float32, 12 blocks", np.float32, N_CHAINS, args.lasso_points,
              lambda: narrow_bands(bp, rng, rng.integers(100, 701, 12), 64)))
    for tag, dt, NC, NG, bands in cases:
        sb = bands().device_put(dev, dtype=dt)
        several = sb.nblk > 1
        gdp_sweep_case(bp, gsk, torch, dev, sb, NC, rng, tag, timer,
                       one_chain=several)
        bound, by, _ = sweep_bound(sb, NC, 1)
        log(f"    bound {bound:.3f} ms ({by}); row floor "
            f"{ring_floor_ms(sb, 'sweep'):.3f} ms")
        gdp_lasso_case(bp, gsk, torch, dev, sb, NG, rng, tag, timer,
                       one_chain=several)
        bound, by = lasso_bound(sb, NG)
        log(f"    bound {bound:.3f} ms ({by}); row floor "
            f"{ring_floor_ms(sb, 'lassosum'):.3f} ms")
        del sb


def check_i8m_at(gk, torch, dev, op, rng):
    """K8 against its twin at the slice's operands: the operator's planes
    (every sample) and l = 20, randomSVD's power-step width."""
    n, m = op.n_full, op.m_full
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    for key, kern, plain, W in (
            ("cprod_i8m", gk.cprod_i8m, gk.cprod_i8m_plain,
             f(rng.standard_normal((n, 20)))),
            ("prod_i8m", gk.prod_i8m, gk.prod_i8m_plain,
             f(rng.standard_normal((m, 20))))):
        got, raw = kern(op.planes, n, W, op.center, op.inv, return_raw=True)
        ref, raw_ref = plain(op.planes, n, W, op.center, op.inv,
                             return_raw=True)
        same = torch.equal(raw, raw_ref)
        err, rel = rel_err(got, ref)
        log(f"    K8 {key} vs its twin at n={n} m={m} l=20 [randomSVD power "
            f"step]: raw int32 sums equal {same}; max abs err {err:.2e} "
            f"(rel {rel:.1e}, limit {I8_TOL})")
        if not same or rel > I8_TOL:
            fail(f"K8 {key} disagrees with its twin at the slice's shape")


def phase_slice5(bp, gk, gsk, torch, dev, args):
    n, m = args.n5, args.m5
    log(f"[16] slice 5 at n={n} samples x m={m} variants: int8m randomSVD -> "
        f"GWAS -> the unblocked LDpred2-auto / grid / sampling and lassosum2")
    t0 = time.perf_counter()
    # slice 2's generator: one population. On one chromosome of AR(1)
    # blocks the top PCs are LD blocks, not populations, so neither a
    # structured cohort nor PC covariates leave sumstats that LDpred2 can
    # fit with this LD; the PCs are the PCA stage's own result.
    packed, sizes, _ = make_ld_cohort(torch, dev, n, m, args.seed + 30,
                                      args.bmin, args.bmax)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} "
        f"s: {len(sizes)} LD blocks of {sizes.min()}-{sizes.max()} variants "
        f"(AR(1) rho {RHO}), one population, one chromosome")
    pack = bp.GenoPack(packed=packed.cpu().numpy(), n=n)
    pack._device_cache[str(dev)] = packed
    rng = np.random.default_rng(args.seed + 31)
    perm = rng.permutation(n)
    n_train = n * 3 // 4
    train, test = np.sort(perm[:n_train]), np.sort(perm[n_train:])
    times, counts = {}, {}
    modes = ("sweep", "sweep_global", "lassosum", "lassosum_global")

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        before = dict(gsk.launches)
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        counts[name] = {k: gsk.launches[k] - before[k] for k in modes
                        if gsk.launches[k] > before[k]}
        log(f"  {name:34s} {times[name]:9.3f} s   sweep launches "
            f"{counts[name] or 0}")
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    gsk.reset_launches()
    sc = stage("bed_scaleBinom", lambda: bp.bed_scaleBinom(
        pack, ind_row=train, device=dev))
    scd = {"center": sc["center"], "scale": sc["scale"]}
    op = stage("GenoOperator(mxu=\"int8m\"): planes", lambda: bp.GenoOperator(
        pack, sc["center"], sc["scale"], ind_row=train, device=dev,
        mxu="int8m"))
    gk.reset_launches()
    svd = stage("snp_randomSVD (int8m operator)", lambda: bp.snp_randomSVD(
        None, scd, op=op, k=10))
    svd_path = dict(gk.launches)
    plane_gb = sum(p.numel() for p in op.planes if p is not None) / 1e9
    before = dict(gk.launches)      # the comparison's launches do not count
    check_i8m_at(gk, torch, dev, op, rng)
    gk.launches.update(before)
    del op
    op8 = bp.GenoOperator(pack, sc["center"], sc["scale"], ind_row=train,
                          device=dev, mxu="int8")
    svd8 = stage("snp_randomSVD (int8 operator)", lambda: bp.snp_randomSVD(
        None, scd, op=op8, k=10))
    del op8
    sim = stage("snp_simuPheno", lambda: bp.snp_simuPheno(
        pack, h2=0.4, M=min(1000, m // 10), seed=args.seed))
    y = sim["pheno"]
    gwas = stage("big_univLinReg", lambda: bp.big_univLinReg(
        pack, y[train], ind_row=train))
    df_beta = {"beta": gwas["estim"], "beta_se": gwas["std.err"],
               "n_eff": np.full(m, float(n_train))}
    corr = stage("snp_cor", lambda: bp.snp_cor(
        pack, ind_row=train, size=500, thr_r2=0.01, finalize="device"))
    ldsc = stage("snp_ldsc2", lambda: bp.snp_ldsc2(corr, df_beta))
    h2_ldsc = float(ldsc["h2"])
    h2i = max(h2_ldsc, 1e-3)
    p_init = np.geomspace(1e-4, 0.2, N_CHAINS)

    def run_auto(burn_in, num_iter):
        return bp.snp_ldpred2_auto(
            corr, df_beta, h2_init=h2i, vec_p_init=p_init, burn_in=burn_in,
            num_iter=num_iter, allow_jump_sign=False, shrink_corr=0.95)

    # the sweeps are the depth that may be cut: five first, timed
    stage("snp_ldpred2_auto, 5 sweeps", lambda: run_auto(2, 3))
    n_auto = args.burn_in5 + args.num_iter5
    log(f"    {times['snp_ldpred2_auto, 5 sweeps'] / 5 * 1e3:.1f} ms a sweep "
        f"of {N_CHAINS} chains with the band build; {n_auto} sweeps follow")
    auto = stage("snp_ldpred2_auto (unblocked)", lambda: run_auto(
        args.burn_in5, args.num_iter5))
    before = dict(gsk.launches)     # the profile's launches do not count
    phase_profile(torch, dev, run_auto, label="  [16]",
                  sweep_kernel="gibbs_ring_kernel")
    gsk.launches.update(before)
    keep, beta_auto = stage("ldpred2_auto_chain_qc",
                            lambda: bp.ldpred2_auto_chain_qc(auto))
    h2s = np.asarray([0.7, 1.0, 1.4]) * h2i
    ps = np.asarray([1e-3, 1e-2, 1e-1])
    grid = {"p": np.repeat(ps, 3), "h2": np.tile(h2s, 3),
            "sparse": np.zeros(GRID_CELLS, bool)}
    gb_in, gn_it = min(50, args.burn_in5), min(100, args.num_iter5)
    beta_grid = stage("snp_ldpred2_grid (unblocked)",
                      lambda: bp.snp_ldpred2_grid(corr, df_beta, grid,
                                                  burn_in=gb_in,
                                                  num_iter=gn_it))
    one = {"p": [ps[1]], "h2": [h2i], "sparse": [False]}
    samples = stage("snp_ldpred2_grid, sampling betas",
                    lambda: bp.snp_ldpred2_grid(
                        corr, df_beta, one, burn_in=gb_in, num_iter=gn_it,
                        return_sampling_betas=True))
    beta_l, gp = stage("snp_lassosum2 (unblocked)", lambda: bp.snp_lassosum2(
        corr, df_beta, nlambda=args.nlambda, maxiter=args.lasso_maxiter))
    prs = stage("snp_PRS", lambda: bp.snp_PRS(pack, beta_auto,
                                              ind_test=test))
    half = len(test) // 2
    scores_l = stage("lassosum2 grid scores", lambda: bp.snp_prodVec(
        pack.subset(ind_row=test), np.nan_to_num(beta_l)))
    launches = {**gk.launches, **gsk.launches}
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else float("nan"))
    sweeps_auto = counts["snp_ldpred2_auto (unblocked)"].get("sweep_global", 0)
    log(f"  total {sum(times.values()):.3f} s; launches {launches}; device "
        f"memory peak {peak:.2f} GB; int8m planes {plane_gb:.2f} GB; LD nnz "
        f"{corr.upper.nnz}")
    if sweeps_auto:
        log(f"  LDpred2-auto: {times['snp_ldpred2_auto (unblocked)'] / sweeps_auto * 1e3:.1f}"
            f" ms a sweep of {N_CHAINS} chains ({sweeps_auto} sweeps)")
    log(f"  launches inside the int8m snp_randomSVD: {svd_path}")
    enforce = dev.type == "cuda"
    if enforce:
        if any(svd_path[k] for k in K1K2 + K6 + K7) or svd_path[
                "cprod_i8m_nona"] or svd_path["prod_i8m_nona"]:
            fail("the int8m randomSVD launched K1, K6, K7 or a _nona K8")
        if not (svd_path["cprod_i8m"] and svd_path["prod_i8m"]):
            fail("K8 was not launched by the int8m randomSVD")
        if not (launches["sweep_global"] and launches["lassosum_global"]):
            fail("the sweep kernel was not launched on slice 5's one band")
        if launches["sweep"] or launches["lassosum"]:
            fail("slice 5's unblocked samplers launched on blocked bands")

    log("  checks:")
    same = (svd.niter == svd8.niter and all(
        np.array_equal(getattr(svd, a), getattr(svd8, a))
        for a in ("d", "u", "v")))
    d_rel = float(np.max(np.abs(svd.d - svd8.d) / svd8.d))
    log(f"    snp_randomSVD on K8 vs on K6: d, u, v bit-equal {same} (depths "
        f"{svd.niter} / {svd8.niter}; d max rel diff {d_rel:.1e})")
    if not same:
        fail("randomSVD on K8 is not bit-equal to randomSVD on K6")
    h2_kept = float(np.mean([auto[i]["h2_est"] for i in np.nonzero(keep)[0]])
                    ) if keep.any() else float("nan")
    finite = sum(np.isfinite(r["h2_est"]) for r in auto)
    log(f"    LDSC h2 {h2_ldsc:.4f}; chains finite {finite}/{len(auto)}, "
        f"kept by chain QC {int(keep.sum())}; mean h2_est of the kept "
        f"{h2_kept:.4f} (both in [0.2, 0.6]; true 0.4)")
    r_auto = float(np.corrcoef(prs[:, 0], y[test])[0, 1])
    r_first = np.array([np.corrcoef(scores_l[:half, i], y[test][:half])[0, 1]
                        if scores_l[:half, i].std() > 0 else -1.0
                        for i in range(beta_l.shape[1])])
    best = int(np.argmax(np.nan_to_num(r_first, nan=-1.0)))
    r_l = float(np.corrcoef(scores_l[half:, best], y[test][half:])[0, 1])
    it = gp["num_iter"]
    cell = int(np.nonzero((grid["p"] == ps[1]) & (grid["h2"] == h2i))[0][0])
    r_samp = (float(np.corrcoef(samples.mean(1), beta_grid[:, cell])[0, 1])
              if np.isfinite(samples).all() and np.isfinite(
                  beta_grid[:, cell]).all() else float("nan"))
    log(f"    r(PRS_auto, y_test) {r_auto:.4f} on {len(test)} test samples "
        f"(floor 0.1; null sd {1 / np.sqrt(len(test)):.3f}); grid cells "
        f"finite {int(np.isfinite(beta_grid).all(0).sum())}/{GRID_CELLS}; "
        f"sampling betas {samples.shape}, finite "
        f"{bool(np.isfinite(samples).all())}, r(their mean, the grid cell's "
        f"beta) {r_samp:.4f}")
    log(f"    lassosum2: grid point {best} (lambda {gp['lambda'][best]:.4g}, "
        f"delta {gp['delta'][best]}) chosen on {half} test samples; r on the "
        f"other {len(test) - half}: {r_l:.4f} (floor 0.1); "
        f"{int(np.isnan(beta_l).any(0).sum())} of {len(it)} grid points "
        f"diverged; sweeps a point {it.min()}-{it.max()}")
    bad = [] if not enforce else [
        what for what, ok in (
            ("LDSC h2", 0.2 <= h2_ldsc <= 0.6),
            ("chain QC", keep.sum() >= 1),
            ("mean h2_est of kept chains", 0.2 <= h2_kept <= 0.6),
            ("r(PRS_auto, y_test)", r_auto > 0.1),
            ("r(lassosum2, y_test)", r_l > 0.1)) if not ok]
    if bad:
        fail(f"slice 5 checks failed: {bad}")
    return dict(corr=corr, svd_path=svd_path, launches=launches)


def phase_gdp_timed(bp, gsk, torch, dev, s5, args):
    """[17b] the sweep kernel at slice 5's band and at the main path's
    launch shapes (LDpred2-auto's 30 chains, lassosum2's grid), held
    against its twin and timed beside its bound and row floor; the kernel
    table's rows, with the launches of the slice-5 path."""
    from bigsnpr_tpu_torch.pgs.band import one_block_bands

    log("[17b] the sweep kernel at the slice-5 band, against its twin and "
        "timed")
    sb = one_block_bands(s5["corr"]).device_put(dev)
    rng = np.random.default_rng(args.seed + 34)
    timer = Timer(torch, dev)
    err, ms, plain_ms = gdp_sweep_case(bp, gsk, torch, dev, sb, N_CHAINS, rng,
                                       "slice-5 band", timer)
    bound, by, _ = sweep_bound(sb, N_CHAINS, 1)
    floor = ring_floor_ms(sb, "sweep")
    log(f"    bound {bound:.3f} ms ({by}); row floor {floor:.3f} ms "
        f"({RING_ROW_CYCLES[('sweep', 4)]} cycles a row); "
        f"{ms / max(floor, 1e-9):.2f}x that floor")
    rows = [{"name": f"gibbs_sweep one band (LDpred2, {sb.max_rows} "
                     f"rows, {N_CHAINS} chains)", "route": "cuda",
             "source": SWEEP_SOURCE, "replaces": GDP_REPLACES["sweep"],
             "launches": s5["launches"]["sweep_global"], "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": None}]
    NG = 4 * args.nlambda
    err, ms, plain_ms = gdp_lasso_case(bp, gsk, torch, dev, sb, NG, rng,
                                       "slice-5 band", timer)
    bound, by = lasso_bound(sb, NG)
    floor = ring_floor_ms(sb, "lassosum")
    log(f"    bound {bound:.3f} ms ({by}); row floor {floor:.3f} ms "
        f"({RING_ROW_CYCLES[('lassosum', 4)]} cycles a row); "
        f"{ms / max(floor, 1e-9):.2f}x that floor")
    rows.append({"name": f"gibbs_sweep lassosum mode, one band (lassosum2, "
                         f"{sb.max_rows} rows, {NG} grid points)",
                 "route": "cuda", "source": SWEEP_SOURCE,
                 "replaces": GDP_REPLACES["lassosum"],
                 "launches": s5["launches"]["lassosum_global"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": by, "library_ms": None})
    return rows


# ---------------------------------------------------------------------------
# slice 6: data in (the .gpk store, snp_match, bed_projectPCA) and the
# remaining statistics (the GRM, MAX3, Fst, ancestry, genetic positions)
# ---------------------------------------------------------------------------

PAIRS = np.array([("A", "C"), ("A", "G"), ("C", "A"), ("G", "A"),
                  ("C", "T"), ("T", "C"), ("G", "T"), ("T", "G")])
AMBIGUOUS = np.array([("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")])
COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C"}


def reverse_rows(torch, packed, rows, n):
    """Dosage x -> 2 - x on the variant rows `rows` of a packed tensor, in
    place: codes 0 and 3 swap (NA and het stay), the pad bits stay 0."""
    lut = torch.tensor([sum((3 - ((b >> s) & 3) if (b >> s) & 3 in (0, 3)
                             else (b >> s) & 3) << s for s in (0, 2, 4, 6))
                        for b in range(256)], dtype=torch.uint8,
                       device=packed.device)
    rows = torch.as_tensor(rows, dtype=torch.long, device=packed.device)
    new = lut[packed[rows].long()]
    if n % 4:
        new[:, -1] &= (1 << (2 * (n % 4))) - 1
    packed[rows] = new


def make_slice6(bp, torch, dev, args):
    """One cohort made on the device (slice 3's generator, 3 populations,
    22 chromosomes, no planted region) of --n6-ref reference samples and
    --n6 target samples over --m6 variants; a reference map (alleles drawn
    from the non-ambiguous pairs, 1% ambiguous A/T or C/G), and a target
    that drops 5% of the variants, reverses the alleles of 10% (genotypes
    2 - x) and strand-flips 5% (non-ambiguous ones only)."""
    n_ref, n_t, m = args.n6_ref, args.n6, args.m6
    n = n_ref + n_t
    t0 = time.perf_counter()
    packed, sizes, info = make_ld_cohort(torch, dev, n, m, args.seed + 60,
                                         args.bmin, args.bmax, pops=3)
    bounds = chromosome_bounds(sizes, m)
    chrs = np.repeat(np.arange(1, 23), np.diff(bounds))
    rng = np.random.default_rng(args.seed + 61)
    gaps = 1 + rng.exponential(3000.0, m).astype(np.int64)
    pos = np.empty(m, np.int64)
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        pos[c0:c1] = np.cumsum(gaps[c0:c1])
    al = PAIRS[rng.integers(0, len(PAIRS), m)]
    amb = rng.random(m) < 0.01
    al[amb] = AMBIGUOUS[rng.integers(0, 4, int(amb.sum()))]
    ref_map = {"chromosome": chrs,
               "marker.ID": np.array([f"rs{j}" for j in range(m)]),
               "genetic.dist": np.zeros(m), "physical.pos": pos,
               "allele1": al[:, 0].copy(), "allele2": al[:, 1].copy()}
    cohort = bp.GenoPack(packed=packed.cpu().numpy(), n=n)
    cohort._device_cache[str(dev)] = packed
    pop = info["pop"]
    ref_rows, tgt_rows = np.arange(n_ref), np.arange(n_ref, n)
    ref = cohort.subset(ind_row=ref_rows, device=dev)
    ref.map = ref_map
    kept = np.flatnonzero(rng.random(m) >= 0.05)
    rev = rng.random(len(kept)) < 0.10
    flip = (~rev) & (~amb[kept]) & (rng.random(len(kept)) < 0.05 / 0.9)
    target = cohort.subset(ind_row=tgt_rows, ind_col=kept, device=dev)
    t_rev = bp.GenoPack(packed=target.packed.copy(), n=n_t)
    dp = target.device_packed(dev).clone()
    reverse_rows(torch, dp, np.flatnonzero(rev), n_t)
    t_rev.packed = dp.cpu().numpy()
    t_rev._device_cache[str(dev)] = dp
    a1, a2 = al[kept, 0].copy(), al[kept, 1].copy()
    a1[rev], a2[rev] = al[kept, 1][rev], al[kept, 0][rev]
    for a in (a1, a2):
        a[flip] = [COMPLEMENT[x] for x in a[flip]]
    t_rev.map = {"chromosome": chrs[kept],
                 "marker.ID": ref_map["marker.ID"][kept],
                 "genetic.dist": np.zeros(len(kept)),
                 "physical.pos": pos[kept], "allele1": a1, "allele2": a2}
    del cohort, packed
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} "
        f"s: {len(sizes)} LD blocks of {sizes.min()}-{sizes.max()} variants, "
        f"3 populations (Fst {FST}), 22 chromosomes; reference {n_ref} x "
        f"{m} ({ref.packed.nbytes / 1e9:.3f} GB), target {n_t} x "
        f"{len(kept)} ({target.packed.nbytes / 1e9:.3f} GB): {m - len(kept)} "
        f"variants dropped, {int(rev.sum())} reversed, {int(flip.sum())} "
        f"strand-flipped, {int(amb[kept].sum())} ambiguous kept")
    return {"ref": ref, "target": target, "t_rev": t_rev, "kept": kept,
            "rev": rev, "flip": flip, "amb": amb, "pop_ref": pop[ref_rows],
            "pop_t": pop[tgt_rows], "chrs": chrs, "pos": pos,
            "ref_map": ref_map}


def slice6_store(bp, torch, dev, s6, stage):
    """The target's packed bytes through the .gpk store and back."""
    target = s6["target"]
    nbytes = target.packed.nbytes
    with tempfile.TemporaryDirectory() as tmp:
        bare = bp.GenoPack(packed=target.packed, n=target.n)
        path, t_save = stage("store: save",
                             lambda: bare.save(os.path.join(tmp, "target")))
        att, t_load = stage("store: attach",
                            lambda: bp.snp_attach(path, mmap=False))
        same = np.array_equal(att.packed, target.packed)
        c0 = bp.snp_counts(att, device=dev)
        c1 = bp.snp_counts(target, device=dev)
        counts = np.array_equal(c0, c1)
        files = sorted(os.listdir(path))
    log(f"  store: {nbytes / 1e9:.3f} GB saved at "
        f"{nbytes / t_save / 1e9:.2f} GB/s, attached (read whole, "
        f"mmap=False) at {nbytes / t_load / 1e9:.2f} GB/s; files {files}; "
        f"bytes equal {same}, snp_counts equal {counts}")
    if not (same and counts) or files != ["meta.json", "packed.bin"]:
        fail("the .gpk store does not give back the target's bytes")


def slice6_match(bp, s6, args, rng, stage):
    """snp_match of --n-sumstats rows (the target's map, betas signed by
    its alleles, and rows at positions absent from the reference) against
    the reference map: the planted matches, flips, reversals and removals,
    every beta's sign."""
    kept, rev, flip, amb = s6["kept"], s6["rev"], s6["flip"], s6["amb"]
    ref_map, t_map = s6["ref_map"], s6["t_rev"].map
    m = len(ref_map["chromosome"])
    beta_true = rng.standard_normal(m)
    n_fill = max(0, args.n_sumstats - len(kept))
    fc = rng.integers(1, 23, n_fill)
    top = np.zeros(23, np.int64)
    np.maximum.at(top, ref_map["chromosome"], ref_map["physical.pos"])
    fpos = top[fc] + 1 + rng.permutation(n_fill)
    fal = PAIRS[rng.integers(0, len(PAIRS), n_fill)]
    perm = rng.permutation(len(kept) + n_fill)
    ss = {"chr": np.r_[t_map["chromosome"], fc][perm],
          "pos": np.r_[t_map["physical.pos"], fpos][perm],
          "a0": np.r_[t_map["allele2"], fal[:, 1]][perm],
          "a1": np.r_[t_map["allele1"], fal[:, 0]][perm],
          "beta": np.r_[np.where(rev, -1, 1) * beta_true[kept],
                        rng.standard_normal(n_fill)][perm]}
    info = {"chr": ref_map["chromosome"], "pos": ref_map["physical.pos"],
            "a0": ref_map["allele2"], "a1": ref_map["allele1"],
            "rsid": ref_map["marker.ID"]}
    out, _ = stage("snp_match", lambda: bp.snp_match(
        ss, info, return_flip_and_rev=True, verbose=False))
    ok = ~amb[kept]
    want = (int(ok.sum()), int(flip.sum()), int((rev & ok).sum()))
    got = (len(out["beta"]), int(out["_FLIP_"].sum()),
           int(out["_REV_"].sum()))
    signs = np.array_equal(out["beta"], beta_true[out["_NUM_ID_"] - 1])
    flips = np.array_equal(np.sort(out["_NUM_ID_"][out["_FLIP_"]] - 1),
                           kept[flip])
    log(f"  snp_match: {len(perm)} sumstats rows ({n_fill} at positions "
        f"absent from the reference) against the reference's {m}: matched "
        f"/ flipped / reversed {got}, planted {want}; removed "
        f"{len(perm) - got[0]} (planted {len(perm) - want[0]}); every "
        f"beta's sign right {signs}, the flipped variants the planted ones "
        f"{flips}")
    if got != want or not (signs and flips):
        fail("snp_match does not recover what was planted")


def slice6_project(bp, gk, torch, dev, s6, stage):
    """bed_projectPCA(reference, reversed target, k=10) on K1 / K2, held
    against the projection of the unreversed target on the same SVD."""
    from bigsnpr_tpu_torch.pca.project import (pca_OADP_proj,
                                               prod_and_row_sums_sq)

    gk.reset_launches()
    with bp.config.options(pallas_mxu="highest"):
        res, _ = stage("bed_projectPCA", lambda: bp.bed_projectPCA(
            s6["ref"], s6["t_rev"], k=10, device=dev))
    used = {k: gk.launches[k] for k in ("cprod", "prod")}
    obj = res["obj.svd.ref"]
    at = np.full(s6["ref"].m, -1)
    at[s6["kept"]] = np.arange(len(s6["kept"]))
    cols = at[obj.subset]
    XV, Xn = prod_and_row_sums_sq(s6["target"], obj.v, obj.center,
                                  obj.scale, ind_col=cols, device=dev)
    oadp0 = pca_OADP_proj(XV, Xn, obj.d)
    rel = float(np.abs(res["OADP_proj"] - oadp0).max()
                / np.abs(oadp0).max())
    r2 = pop_r2(res["OADP_proj"][:, :2], s6["pop_t"])
    log(f"  bed_projectPCA: autoSVD of the reference kept {len(obj.subset)} "
        f"variants (K1 / K2 launches {used}); OADP projection of the "
        f"reversed target vs the unreversed one on the same SVD: rel max "
        f"err {rel:.2e} (limit 1e-3); population r2 of PC1-2 on the target "
        f"{r2:.3f} (floor 0.9)")
    if dev.type == "cuda" and min(used.values()) == 0:
        fail(f"bed_projectPCA's autoSVD did not launch K1 and K2: {used}")
    if rel > 1e-3 or not np.isfinite(res["OADP_proj"]).all():
        fail("bed_projectPCA's projection of the reversed target is off")
    if dev.type == "cuda" and not r2 > 0.9:
        fail("the projected target's PCs do not separate the populations")
    return obj, cols


def slice6_grm(bp, torch, dev, s6, args, rng, stage):
    """bed_GRM on --n-grm target samples over every variant: 64 rows
    against float64, symmetry, and its time against 2 n^2 m over the f32
    peak."""
    from bigsnpr_tpu_torch.ops.blocks import pick_block
    from bigsnpr_tpu_torch.ops.grm import grm_blocked

    n_g = min(args.n_grm, s6["target"].n)
    tgt = s6["target"].subset(ind_row=np.arange(n_g), device=dev)
    m = tgt.m
    G, t_grm = stage("bed_GRM", lambda: bp.bed_GRM(tgt, device=dev))
    sc = bp.bed_scaleBinom(tgt, device=dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    c, s = f32(sc["center"]), f32(np.where(sc["scale"] > 0, sc["scale"], 1))
    P = tgt.device_packed(dev)
    timer = Timer(torch, dev)
    gemm_ms = timer(lambda: grm_blocked(P, n_g, c, s, pick_block(n_g)),
                    reps=1, warmup=0)
    pick = np.sort(rng.choice(n_g, min(64, n_g), replace=False))
    acc = torch.zeros((len(pick), n_g), dtype=torch.float64, device=dev)
    inv = 1.0 / s
    for j0 in range(0, m, 4096):
        X = dense64(torch, P[j0:j0 + 4096], n_g, c[j0:j0 + 4096],
                    inv[j0:j0 + 4096])
        acc += X[:, pick].T @ X
    ref = acc.cpu().numpy() / m
    rel = float(np.abs(G[pick] - ref).max() / np.abs(ref).max())
    asym = float(np.abs(G - G.T).max() / np.abs(G).max())
    bound = 2.0 * n_g * n_g * m / PEAK_F32_FLOP_PER_S
    log(f"  bed_GRM: {n_g} x {n_g} over {m} variants in {t_grm:.3f} s (the "
        f"accumulation on the device {gemm_ms / 1e3:.3f} s; 2 n^2 m = "
        f"{2.0 * n_g * n_g * m / 1e12:.2f} TFLOP over 67 TFLOP/s f32 = "
        f"{bound:.3f} s); 64 rows vs float64: rel max err {rel:.2e} (limit "
        f"1e-5); max |G - G^T| / max |G| {asym:.1e} (bit-symmetric "
        f"{asym == 0.0})")
    if rel > 1e-5 or asym > 1e-6 or not np.isfinite(G).all():
        fail("bed_GRM is off the float64 product or not symmetric")


def slice6_stats(bp, torch, dev, s6, obj, cols, rng, stage):
    """snp_MAX3 on a planted case/control split, snp_fst over the three
    populations, snp_ancestry_summary of a 60/30/10 mix, and
    snp_asGeneticPos on a synthetic genetic map."""
    import warnings

    from bigsnpr_tpu_torch.core.unpack import np_unpack_codes

    target, pop_t, pop_r = s6["target"], s6["pop_t"], s6["pop_ref"]
    t0 = time.perf_counter()
    maf = bp.bed_MAF(target, device=dev)
    good = np.flatnonzero((maf["maf"] > 0.3) & (maf["N"] == target.n))
    j = int(good[rng.integers(0, len(good))])
    codes = np_unpack_codes(np.asarray(target.packed[j:j + 1]), target.n)[0]
    d = 2.0 - ((codes.astype(np.int64) + 1) >> 1)
    y01 = (rng.random(target.n) < 1 / (1 + np.exp(-(d - d.mean())))).astype(
        int)
    res = bp.snp_MAX3(target, y01, device=dev)
    top = int(np.argmax(res.score))
    tabs = [bp.bed_MAF(target, ind_row=np.flatnonzero(pop_t == k),
                       device=dev) for k in range(3)]
    fst = bp.snp_fst(tabs, overall=True)
    w = np.array([0.6, 0.3, 0.1])
    X0 = np.column_stack([bp.bed_MAF(s6["ref"], ind_row=np.flatnonzero(
        pop_r == k), device=dev)["af"][obj.subset] for k in range(3)])
    freq = np.column_stack([t["af"][cols] for t in tabs]) @ w
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol, info = bp.snp_ancestry_summary(freq, X0, obj.v,
                                            np.ones(obj.v.shape[1]))
    rng_map = np.random.default_rng(7)
    chrs, pos = s6["chrs"], s6["pos"]
    gmap = {"chr": [], "pos": [], "pos_cM": []}
    for c in range(1, 23):
        top_c = int(pos[chrs == c].max()) + 10 ** 5
        gp = np.sort(rng_map.choice(top_c, 2000, replace=False))
        gmap["chr"].append(np.full(2000, c))
        gmap["pos"].append(gp)
        gmap["pos_cM"].append(np.cumsum(rng_map.uniform(0, 0.05, 2000)))
    gmap = {k: np.concatenate(v) for k, v in gmap.items()}
    cm = bp.snp_asGeneticPos(chrs, pos, gmap)
    cm2 = bp.snp_asGeneticPos2(chrs, pos, gmap)
    mono = all((np.diff(x[chrs == c]) >= 0).all() for x in (cm, cm2)
               for c in range(1, 23))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  statistics in {time.perf_counter() - t0:.3f} s: snp_MAX3 on "
        f"{int(y01.sum())} cases / {int((1 - y01).sum())} controls, the "
        f"planted variant {j} ranks {int((res.score > res.score[j]).sum()) + 1}"
        f" (top {top}); snp_fst over 3 populations {fst:.4f} (generator "
        f"{FST}); snp_ancestry_summary of a 60/30/10 mix "
        f"{np.round(sol, 4).tolist()} (cor_pred {info['cor_pred']:.4f}; "
        f"limit 0.05 a population); snp_asGeneticPos (nn and linear) "
        f"monotone on every chromosome {mono}")
    if dev.type == "cuda":
        if top != j:
            fail("snp_MAX3 does not rank the planted variant first")
        if not (fst > 0 and abs(fst / FST - 1) < 0.25):
            fail(f"snp_fst {fst:.4f} is not near the generator's {FST}")
        if np.abs(sol - w).max() > 0.05:
            fail(f"snp_ancestry_summary {sol} is not the 60/30/10 mix")
    if not mono:
        fail("snp_asGeneticPos is not monotone on a chromosome")


def phase_slice6(bp, gk, torch, dev, args):
    """[18] slice 6: the store, matching, projection, the GRM and the
    small statistics, each stage timed on the host clock to a
    torch.cuda.synchronize()."""
    log(f"[18] slice 6 at {args.n6} target + {args.n6_ref} reference "
        f"samples x {args.m6} variants")
    t_all = time.perf_counter()
    rng = np.random.default_rng(args.seed + 62)
    times = {}

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out, times[name]

    s6, _ = stage("cohort", lambda: make_slice6(bp, torch, dev, args))
    slice6_store(bp, torch, dev, s6, stage)
    slice6_match(bp, s6, args, rng, stage)
    obj, cols = slice6_project(bp, gk, torch, dev, s6, stage)
    slice6_grm(bp, torch, dev, s6, args, rng, stage)
    slice6_stats(bp, torch, dev, s6, obj, cols, rng, stage)
    log("  stage times (s, host clock to a synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; [18] in all {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# slice 6c: imputed dosages from BGEN -> QC, PCA, LD, LDpred2, C+T, scoring
# ---------------------------------------------------------------------------

BGEN_FLAGS = 1 | (2 << 2)      # zlib-compressed, layout 2, no sample ids
BGI_SCHEMA = (
    "CREATE TABLE Variant (chromosome TEXT NOT NULL, position INT NOT NULL,"
    " rsid TEXT NOT NULL, number_of_alleles INT NOT NULL, allele1 TEXT NOT"
    " NULL, allele2 TEXT NULL, file_start_position INT NOT NULL,"
    " size_in_bytes INT NOT NULL, PRIMARY KEY (chromosome, position, rsid,"
    " allele1, allele2, file_start_position)) WITHOUT ROWID")


def bgen_blocks(torch, p0, p1, miss):
    """(k, N) 8-bit probabilities of genotypes 0 and 1 (uint8 tensors) and
    the missing mask -> (k, 10 + 3 N) uint8 uncompressed layout-2
    probability blocks on their device: N, 2 alleles, ploidy 2..2, a
    ploidy byte a sample (0x80 set when missing), unphased, 8 bits, then
    the pairs (0 where missing)."""
    k, N = p0.shape
    dev = p0.device
    head = torch.tensor(list(struct.pack("<IHBB", N, 2, 2, 2)),
                        dtype=torch.uint8, device=dev)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    ploidy = torch.where(miss, torch.full((), 0x82, dtype=torch.uint8,
                                          device=dev),
                         torch.full((), 2, dtype=torch.uint8, device=dev))
    flags = torch.tensor([0, 8], dtype=torch.uint8, device=dev)
    pairs = torch.stack([torch.where(miss, zero, p0),
                         torch.where(miss, zero, p1)], dim=2).reshape(k, -1)
    return torch.cat([head.expand(k, 8), ploidy, flags.expand(k, 2), pairs],
                     dim=1)


def _string(s, lenbytes=2):
    b = s.encode()
    return struct.pack("<I" if lenbytes == 4 else "<H", len(b)) + b


def write_bgen(path, variants, N, chunks, level=1, workers=None):
    """Write a BGEN v1.2 file (layout 2, zlib, 8-bit probabilities) and
    its bgenix-style .bgi index (SQLite, the `Variant` table) beside it.

    variants: dict of columns chromosome (str), position, rsid, varid,
    allele1, allele2, one row a variant; chunks: an iterable of (k, 10 +
    3 N) uint8 uncompressed probability blocks (`bgen_blocks`) of
    successive variants. The blocks of a chunk are compressed in a thread
    pool (zlib releases the GIL). Returns (bytes before compression, bytes
    written)."""
    m = len(variants["position"])
    raw = 0
    rows = []
    with open(path, "wb") as f, \
            ThreadPoolExecutor(workers or os.cpu_count() or 1) as pool:
        f.write(struct.pack("<IIII4sI", 20, 20, m, N, b"bgen", BGEN_FLAGS))
        j = 0
        for blocks in chunks:
            blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
            if blocks.shape[1] != 10 + 3 * N:
                raise ValueError("write_bgen: a block is not 10 + 3 N bytes")
            raw += blocks.nbytes
            comp = list(pool.map(lambda r: zlib.compress(r, level),
                                 list(blocks)))
            for c in comp:
                head = (_string(str(variants["varid"][j]))
                        + _string(str(variants["rsid"][j]))
                        + _string(str(variants["chromosome"][j]))
                        + struct.pack("<IH", int(variants["position"][j]), 2)
                        + _string(str(variants["allele1"][j]), 4)
                        + _string(str(variants["allele2"][j]), 4)
                        + struct.pack("<II", len(c) + 4, blocks.shape[1]))
                start = f.tell()
                f.write(head)
                f.write(c)
                rows.append((str(variants["chromosome"][j]),
                             int(variants["position"][j]),
                             str(variants["rsid"][j]), 2,
                             str(variants["allele1"][j]),
                             str(variants["allele2"][j]), start,
                             len(head) + len(c)))
                j += 1
        written = f.tell()
    if j != m:
        raise ValueError(f"write_bgen: {j} variants written, {m} declared")
    bgi = f"{path}.bgi"
    if os.path.exists(bgi):
        os.unlink(bgi)
    con = sqlite3.connect(bgi)
    try:
        con.execute(BGI_SCHEMA)
        con.executemany("INSERT INTO Variant VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                        rows)
        con.commit()
    finally:
        con.close()
    return raw, written


def bgen_cohort(torch, dev, args, path):
    """[19]'s cohort: slice 2's generator (AR(1) LD blocks, 1% NA on 5% of
    the variants) at --n7 x --m7, turned into imputation-like 8-bit
    probability pairs and written as a BGEN file with its .bgi. 70% of the
    variants are certain (the genotype's probability 255); on the rest
    each genotype's probabilities are mixed with the HWE prior of the
    variant's frequency at a weight w ~ U(0.2, 0.95) (the INFO spread).
    Returns the variant table, their IDs, the certain mask and the write
    time."""
    from bigsnpr_tpu_torch.core.unpack import unpack_dosage

    n, m = args.n7, args.m7
    t0 = time.perf_counter()
    packed, sizes, _ = make_ld_cohort(torch, dev, n, m, args.seed + 70,
                                      args.bmin, args.bmax)
    rng = np.random.default_rng(args.seed + 71)
    certain = rng.random(m) < 0.7
    w_all = torch.as_tensor(np.where(certain, 1.0,
                                     rng.uniform(0.2, 0.95, m)),
                            dtype=torch.float32, device=dev)
    pos = 10_000 + np.cumsum(1 + rng.integers(0, 2_000, m))
    al = PAIRS[rng.integers(0, len(PAIRS), m)]
    variants = {"chromosome": np.full(m, "01"), "position": pos,
                "rsid": np.array([f"rs{j}" for j in range(m)]),
                "varid": np.array([f"snp{j}" for j in range(m)]),
                "allele1": al[:, 0], "allele2": al[:, 1]}
    ids = [f"1_{p}_{a}_{b}" for p, a, b in zip(pos, al[:, 0], al[:, 1])]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_cohort = time.perf_counter() - t0

    def chunks(step=2048):
        for j0 in range(0, m, step):
            x, na = unpack_dosage(packed[j0:j0 + step], n)
            ok = (~na).float()
            f = (x * ok).sum(1) / (2 * ok.sum(1)).clamp(min=1)
            w = w_all[j0:j0 + step, None]
            P0 = w * (x == 0) + (1 - w) * ((1 - f) ** 2)[:, None]
            P1 = w * (x == 1) + (1 - w) * (2 * f * (1 - f))[:, None]
            p0 = torch.round(255 * P0)
            p1 = torch.minimum(torch.round(255 * P1), 255 - p0)
            yield bgen_blocks(torch, p0.to(torch.uint8), p1.to(torch.uint8),
                              na).cpu().numpy()

    t0 = time.perf_counter()
    raw, written = write_bgen(path, variants, n, chunks())
    t_write = time.perf_counter() - t0
    del packed
    log(f"  cohort made on the {dev.type} in {t_cohort:.1f} s: {len(sizes)} "
        f"LD blocks of {sizes.min()}-{sizes.max()} variants; BGEN written "
        f"in {t_write:.1f} s: {raw / 1e9:.3f} GB of probability blocks, "
        f"{written / 1e9:.3f} GB compressed (zlib level 1, "
        f"{os.cpu_count()} threads), {int(certain.sum())} certain variants")
    return variants, ids, certain, t_write, raw, written


def check_plain_decode(bp, pack, path, ids, k=1000):
    """The native decode against the per-variant Python decode (the JAX
    package's algorithm) on a slab of k variants: codes bit-equal, info
    and freq within 1e-12."""
    import mmap as mmap_mod

    from bigsnpr_tpu_torch.io import bgen as pbgen

    k = min(k, pack.m)
    j0 = (pack.m - k) // 2
    info = bp.snp_readBGI(path + ".bgi", ids[j0:j0 + k])
    N = pbgen.check_bgen_format(path)
    rows = np.arange(N)
    bad, e_info, e_freq = 0, 0.0, 0.0
    with open(path, "rb") as f:
        buf = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        try:
            for i, st in enumerate(info["file_start_position"]):
                _, goff, csize = pbgen._parse_variant_header(buf, int(st), N)
                codes, inf, frq = pbgen.read_variant_plain(
                    buf, goff, csize, rows, True, N, None)
                bad += int((codes != pack.codes[j0 + i]).sum())
                e_info = max(e_info, abs(inf - pack.map["info"][j0 + i]))
                e_freq = max(e_freq, abs(frq - pack.map["freq"][j0 + i]))
        finally:
            buf.close()
    log(f"    native decode vs the per-variant Python decode on {k} "
        f"variants: {bad} codes differ (limit 0), info max |d| {e_info:.2e},"
        f" freq {e_freq:.2e} (limit 1e-12)")
    if bad or e_info > 1e-12 or e_freq > 1e-12:
        fail("the native BGEN decode disagrees with the plain decode")


def check_random_calls(bp, torch, dev, pack, path, ids, certain, seed, stage,
                       k=2000):
    """read_as="random" on a slab of k variants: where a genotype's
    probability is certain (every genotype of a certain variant) the hard
    call equals the dosage. (A dosage of 0 or 2 is not enough: e = 509 or
    1 rounds to it.)"""
    k = min(k, pack.m)
    rnd = stage("snp_readBGEN(random)", lambda: bp.snp_readBGEN(
        path, [ids[:k]], read_as="random", seed=seed))[0]
    hard = rnd.to_dosage()                       # (n, k)
    dos = pack.code256[pack.codes[:k]].T
    sure = certain[None, :k] & ~np.isnan(dos)
    bad = int((hard[sure] != dos[sure]).sum())
    na = bool(np.array_equal(np.isnan(hard), np.isnan(dos)))
    share = float(np.mean(hard[~np.isnan(hard)] == np.rint(
        dos[~np.isnan(hard)])))
    log(f"    read_as='random' on {k} variants: {bad} of {int(sure.sum())} "
        f"certain genotypes differ from the dosage (limit 0), NA the same "
        f"{na}; {share:.4f} of all hard calls equal the rounded dosage")
    if bad or not na:
        fail("random hard calls disagree with certain dosages")


def check_dosage_r(torch, dev, pack, corr, train, size, k=1000):
    """snp_cor's r on a slab of k variants against float64 pairwise-
    complete r of the decoded dosages (training rows)."""
    k = min(k, pack.m)
    codes = torch.as_tensor(np.ascontiguousarray(pack.codes[:k][:, train]),
                            device=dev)
    table = torch.as_tensor(pack.code256, dtype=torch.float64, device=dev)
    d = table[codes.long()]
    mk = (~torch.isnan(d)).double()
    x = torch.nan_to_num(d)
    A = torch.cat([x, x * x, mk])
    G = A @ A.T
    Sxy, Sx, Sy = G[:k, :k], G[:k, 2 * k:], G[2 * k:, :k]
    Sxx, Syy, Np = G[k:2 * k, 2 * k:], G[2 * k:, k:2 * k], G[2 * k:, 2 * k:]
    r = ((Sxy - Sx * Sy / Np) / torch.sqrt((Sxx - Sx * Sx / Np)
                                           * (Syy - Sy * Sy / Np)))
    r = r.cpu().numpy()
    D = corr.upper[:k, :k].toarray()
    ii, jj = np.nonzero(np.triu(D, 1))
    err = float(np.abs(D[ii, jj] - np.clip(r[ii, jj], -1, 1)).max()) \
        if len(ii) else 0.0
    log(f"    snp_cor on the byte path vs float64 on the decoded dosages, "
        f"{len(ii)} kept pairs of a {k}-variant slab: max |d r| {err:.2e} "
        f"(limit 1e-5)")
    if err > 1e-5:
        fail("dosage LD disagrees with float64")


def byte_path_timed(bp, torch, dev, pack, timer, l=20):
    """snp_cprodVec / snp_prodVec's byte path at l = 20 over the whole pack
    (device operands), beside its bound and one torch.matmul on a
    pre-decoded float32 block scaled to the whole."""
    from bigsnpr_tpu_torch.ops import blocks as pbl
    from bigsnpr_tpu_torch.ops import matvec as pmv

    sc = bp.snp_scaleBinom()(pack)
    op = pmv.DosageOperator(pack, sc["center"],
                            np.where(sc["scale"] > 0, sc["scale"], 1.0))
    n, m = pack.n, pack.m
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    V = torch.randn((n, l), generator=g, device=dev)
    U = torch.randn((m, l), generator=g, device=dev)
    blk = pbl.byte_rows(n)
    X = pbl.decode_bytes(op.codes[:blk], op.table, op.center[:blk],
                         op.scale[:blk])
    t_mm_c = timer(lambda: X @ V, reps=5) * m / X.shape[0]
    t_mm_p = timer(lambda: X.T @ U[:blk], reps=5) * m / X.shape[0]
    del X
    rows = []
    for name, fn, t_mm, out_bytes in (
            ("snp_cprodVec", lambda: op.cprod_dev(V), t_mm_c, m * l * 4),
            ("snp_prodVec", lambda: op.prod_dev(U), t_mm_p, n * l * 4)):
        ms = timer(fn, reps=3)
        nbytes = m * n + (n if name == "snp_cprodVec" else m) * l * 4 \
            + out_bytes + 2 * m * 4 + 256 * 4
        bound = max(nbytes / PEAK_BYTES_PER_S,
                    2.0 * n * m * l / PEAK_F32_FLOP_PER_S) * 1e3
        by = ("bytes" if nbytes / PEAK_BYTES_PER_S
              > 2.0 * n * m * l / PEAK_F32_FLOP_PER_S else "operations")
        log(f"    {name} byte path, {n} x {m} codes ({m * n / 1e9:.3f} GB), "
            f"l = {l}: {ms:.3f} ms; bound {bound:.3f} ms ({by}); "
            f"torch.matmul on a pre-decoded f32 block of {blk} variants, "
            f"scaled to the whole: {t_mm:.3f} ms")
        rows.append({"name": name, "ms": ms, "bound_ms": bound,
                     "matmul_ms": t_mm})
    return rows


def marginal_stats(bp, pack, y, train):
    """Marginal regression of y on each standardized variant over the
    training rows, through snp_cprodVec: (beta, se) on the allele scale and
    z."""
    sub = pack.subset(ind_row=train)
    st = bp.snp_colstats(sub)
    nona = np.maximum(st["nona"], 1)
    center = st["sumX"] / nona
    scale = np.sqrt(st["denoX"] / nona)
    scale = np.where(scale > 0, scale, 1.0)
    yc = y[train] - y[train].mean()
    xty = np.asarray(bp.snp_cprodVec(sub, yc, center, scale), np.float64)
    xtx = st["denoX"] / scale ** 2
    b_std = xty / xtx
    se_std = np.sqrt(np.var(yc) / xtx)
    return b_std / scale, se_std / scale, b_std / se_std


def phase_slice6c(bp, gk, gsk, torch, dev, args, timer):
    """[19] slice 6c: imputed dosages from a BGEN file through QC, PCA,
    LD, LDpred2-grid, C+T and scoring, each stage timed on the host clock
    to a torch.cuda.synchronize(); then the byte path against its bound
    and the warmup."""
    from scipy.stats import norm

    from bigsnpr_tpu_torch.ops.matvec import DosageOperator

    n, m = args.n7, args.m7
    log(f"[19] slice 6c at {n} samples x {m} variants (BGEN v1.2, 8-bit)")
    t_all = time.perf_counter()
    rng = np.random.default_rng(args.seed + 72)
    times = {}

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out, times[name]

    tmp = tempfile.mkdtemp(prefix="slice6c_")
    try:
        path = os.path.join(tmp, "cohort.bgen")
        variants, ids, certain, t_write, raw, written = bgen_cohort(
            torch, dev, args, path)
        times["BGEN write"] = t_write
        gk.reset_launches()
        gsk.reset_launches()
        info, _ = stage("snp_readBGI", lambda: bp.snp_readBGI(path + ".bgi"))
        if len(info["position"]) != m:
            fail("snp_readBGI does not list every variant")
        pack, t_read = stage("snp_readBGEN", lambda: bp.snp_readBGEN(
            path, [ids]))
        log(f"  snp_readBGEN: {pack.m} x {pack.n} codes "
            f"({pack.codes.nbytes / 1e9:.3f} GB) from {raw / 1e9:.3f} GB of "
            f"probability blocks in {t_read:.3f} s: {raw / t_read / 1e9:.2f} "
            f"GB/s decoded ({written / t_read / 1e9:.2f} GB/s of file); "
            f"write + read {t_write + t_read:.1f} s")
        log("  checks:")
        check_plain_decode(bp, pack, path, ids)
        check_random_calls(bp, torch, dev, pack, path, ids, certain,
                           args.seed, stage)

        maf, _ = stage("snp_MAF", lambda: bp.snp_MAF(pack))
        keep = np.flatnonzero((maf > 0.01) & (pack.map["info"] > 0.3))
        packq, _ = stage("QC subset", lambda: pack.subset(ind_col=keep,
                                                          device=dev))
        mq = packq.m
        log(f"    QC (MAF > 0.01, INFO > 0.3) keeps {mq} of {m}; INFO "
            f"quantiles 1/50/99%: "
            f"{np.round(np.quantile(pack.map['info'], [.01, .5, .99]), 3)}")
        sc, _ = stage("snp_scaleBinom", lambda: bp.snp_scaleBinom()(packq))
        svd, _ = stage("snp_randomSVD", lambda: bp.snp_randomSVD(
            packq, fun_scaling=sc, k=10))
        op = DosageOperator(packq, sc["center"], sc["scale"])
        U = torch.as_tensor(svd.u, dtype=torch.float32, device=dev)
        Vv = torch.as_tensor(svd.v, dtype=torch.float32, device=dev)
        d = torch.as_tensor(svd.d, dtype=torch.float32, device=dev)
        res_v = float(((op.cprod_dev(U) - Vv * d).norm(dim=0) / d).max())
        log(f"    PCA on the byte path: d = {np.round(svd.d, 3).tolist()}, "
            f"{svd.niter} depths; |X~'u - d v|/d max {res_v:.2e} (limit "
            f"1e-3)")
        if not np.isfinite(svd.d).all() or res_v > 1e-3:
            fail("randomSVD on the byte path: residual above 1e-3")

        # phenotype y = X~ beta + e, h2 0.4 over 1,000 causal variants
        causal = rng.choice(mq, min(1000, mq // 10), replace=False)
        beta = np.zeros(mq)
        beta[causal] = rng.standard_normal(len(causal))
        g, _ = stage("phenotype (snp_prodVec)", lambda: np.asarray(
            bp.snp_prodVec(packq, beta, sc["center"], sc["scale"]),
            np.float64))
        g *= np.sqrt(0.4 / g.var())
        y = g + rng.normal(0, np.sqrt(0.6), n)
        perm = rng.permutation(n)
        n_train = n * 3 // 4
        train, test = np.sort(perm[:n_train]), np.sort(perm[n_train:])
        (b, se, z), _ = stage("marginal stats (snp_cprodVec)",
                              lambda: marginal_stats(bp, packq, y, train))
        df_beta = {"beta": b, "beta_se": se,
                   "n_eff": np.full(mq, float(n_train))}
        corr, _ = stage("snp_cor", lambda: bp.snp_cor(
            packq, ind_row=train, size=500, thr_r2=0.01))
        check_dosage_r(torch, dev, packq, corr, train, 500)
        ldsc, _ = stage("snp_ldsc2", lambda: bp.snp_ldsc2(corr, df_beta))
        h2 = max(float(ldsc["h2"]), 1e-3)
        bb, _ = stage("auto_blocks + bands", lambda: bp.build_block_bands(
            corr, bp.auto_blocks(corr)))
        h2s = np.asarray([0.7, 1.0, 1.4]) * h2
        grid = {"p": np.repeat([1e-3, 1e-2, 1e-1], 3), "h2": np.tile(h2s, 3),
                "sparse": np.zeros(GRID_CELLS, bool)}
        sweeps0 = gsk.launches["sweep"]
        beta_grid, _ = stage("snp_ldpred2_grid", lambda: bp.snp_ldpred2_grid(
            corr, df_beta, grid, burn_in=min(50, args.burn_in),
            num_iter=min(100, args.num_iter), blocks=bb))
        sweeps = gsk.launches["sweep"] - sweeps0
        cell = 4                                   # p 1e-2, h2 the LDSC h2
        b_cell = np.nan_to_num(beta_grid[:, cell])
        prs, _ = stage("snp_PRS (grid cell)", lambda: bp.snp_PRS(
            packq, b_cell, ind_test=test))
        r_grid = float(np.corrcoef(prs[:, 0], y[test])[0, 1])
        log(f"    LDSC h2 {h2:.4f}; grid cells finite "
            f"{int(np.isfinite(beta_grid).all(0).sum())}/9 ({sweeps} sweep "
            f"launches); r(PRS, y_test) of the cell p 0.01, h2 {h2:.3f}: "
            f"{r_grid:.4f} (floor 0.1)")

        lpS = -(np.log(2) + norm.logsf(np.abs(z))) / np.log(10)
        kept, _ = stage("snp_clumping", lambda: bp.snp_clumping(
            packq, ind_row=train, S=np.abs(z), thr_r2=0.2))
        thr = np.linspace(0, np.quantile(lpS[kept], 0.999), 50)
        prs_ct, _ = stage("snp_PRS (C+T, 50 thresholds)", lambda: bp.snp_PRS(
            packq, b[kept], ind_test=test, ind_keep=kept,
            lpS_keep=lpS[kept], thr_list=thr))
        r_ct = np.array([np.corrcoef(prs_ct[:, i], y[test])[0, 1]
                         if prs_ct[:, i].std() > 0 else 0.0
                         for i in range(50)])
        ld, _ = stage("snp_ld_scores", lambda: bp.snp_ld_scores(
            packq, ind_row=train))
        log(f"    clumping keeps {len(kept)} of {mq}; C+T best r "
            f"{np.nanmax(r_ct):.4f} at threshold "
            f"{thr[int(np.nanargmax(r_ct))]:.2f}; LD scores finite "
            f"{bool(np.isfinite(ld).all())}, min {ld.min():.3f} (floor 1), "
            f"median {np.median(ld):.2f}")

        # snp_prodBGEN on the NA-free QC'd variants
        nafree = keep[np.flatnonzero(np.asarray(
            bp.snp_colstats(packq)["nona"]) == n)]
        beta_pb = np.nan_to_num(beta_grid[np.searchsorted(keep, nafree),
                                          cell])
        ids_pb = [ids[j] for j in nafree]
        pb_dev, _ = stage("snp_prodBGEN (device)", lambda: bp.snp_prodBGEN(
            path, beta_pb, ids_pb, engine="device"))
        pb_host, _ = stage("snp_prodBGEN (host)", lambda: bp.snp_prodBGEN(
            path, beta_pb, ids_pb, engine="host"))
        e_pb = float(np.abs(pb_dev - pb_host).max()
                     / np.abs(pb_host).max())
        pv = np.asarray(bp.snp_prodVec(pack.subset(ind_col=nafree,
                                                   device=dev), beta_pb),
                        np.float64)
        r_pv = float(np.corrcoef(pv, pb_host)[0, 1])
        log(f"    snp_prodBGEN over {len(nafree)} NA-free variants: device "
            f"engine vs host engine max |d| / max |host| {e_pb:.2e} (limit "
            f"5e-6); vs the pack's dosage-scale snp_prodVec (dosages "
            f"rounded to 0.01): r {r_pv:.7f} (floor 0.9999), largest gap "
            f"{np.abs(pv - pb_host).max():.4f} of max |score| "
            f"{np.abs(pb_host).max():.3f}")

        hard, _ = stage("round_to_hardcalls", lambda: packq.round_to_hardcalls())
        prs_hard, _ = stage("snp_PRS (hard calls, K2)", lambda: bp.snp_PRS(
            hard, b_cell, ind_test=test))
        r_hard = float(np.corrcoef(prs_hard[:, 0], prs[:, 0])[0, 1])
        log(f"    r(PRS on hard calls, PRS on dosages) {r_hard:.5f} (floor "
            f"0.99)")
        launches = {"sweep": gsk.launches["sweep"], **gk.launches}

        bare = bp.DosagePack(codes=pack.codes, n=pack.n)
        (store, _), _ = stage("DosagePack.save", lambda: (bare.save(
            os.path.join(tmp, "cohort")), None))
        back, t_load = stage("DosagePack.load", lambda: bp.DosagePack.load(
            store, mmap=False))
        same = np.array_equal(back.codes, pack.codes)
        log(f"    .dpk store: {pack.codes.nbytes / 1e9:.3f} GB saved in "
            f"{times['DosagePack.save']:.3f} s, loaded in {t_load:.3f} s; "
            f"codes equal {same}, files {sorted(os.listdir(store))}")
        del back, bare

        enforce = dev.type == "cuda"
        bad = [what for what, ok in (
            ("sweep kernel launched", launches["sweep"] > 0),
            ("K2 launched", launches["prod"] > 0),
            ("r(PRS grid, y)", r_grid > 0.1),
            ("C+T r", np.nanmax(r_ct) > 0.1),
            ("LD scores", np.isfinite(ld).all() and ld.min() >= 1 - 1e-6),
            ("prodBGEN engines", e_pb <= 5e-6),
            ("prodBGEN vs prodVec", r_pv > 0.9999),
            ("hard-call PRS", r_hard > 0.99),
            ("the .dpk store", same)) if not ok]
        log(f"  launches on the path {launches}")
        if enforce and bad:
            fail(f"slice 6c checks failed: {bad}")
        if not enforce and bad:
            log(f"  (rehearsal: not enforced: {bad})")

        log("  the byte path against its bound:")
        byte_path_timed(bp, torch, dev, pack, timer)
        del pack, packq, hard, op
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        gk.reset_launches()
        gsk.reset_launches()
        # small shapes: four blocks of the sampler's (the blocked "sweep"
        # launch, not the one-band one)
        gm = min(16_384, m)
        secs = bp.warmup(m=min(4096, m), n=min(2048, n), k=10, gibbs_m=gm,
                         gibbs_block=gm // 4, gibbs_W=250, chains=N_CHAINS,
                         grid_cells=0, verbose=False)
        moved = {"cprod": gk.launches["cprod"], "prod": gk.launches["prod"],
                 "sweep": gsk.launches["sweep"]}
        log(f"  warmup sections (s) {secs}; launches {moved} (each 1)")
        if (sorted(secs) != ["build", "gibbs", "svd"]
                or not all(v >= 0 for v in secs.values())
                or (enforce and any(v != 1 for v in moved.values()))):
            fail("warmup did not launch each kernel once")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log("  stage times (s, host clock to a synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; [19] in all {time.perf_counter() - t_all:.1f} s")


def arg_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n2", type=int, default=20_000)
    ap.add_argument("--m2", type=int, default=100_000)
    ap.add_argument("--bmin", type=int, default=200)
    ap.add_argument("--bmax", type=int, default=3000)
    ap.add_argument("--burn-in", type=int, default=500)
    ap.add_argument("--num-iter", type=int, default=200)
    ap.add_argument("--n3", type=int, default=50_000)
    ap.add_argument("--m3", type=int, default=100_000)
    ap.add_argument("--region", type=int, default=5_000)
    ap.add_argument("--n4", type=int, default=20_000)
    ap.add_argument("--m4", type=int, default=100_000)
    ap.add_argument("--n-stack", type=int, default=1_000,
                    help="training samples that the stacking of slice 4 "
                    "runs on")
    ap.add_argument("--n5", type=int, default=20_000)
    ap.add_argument("--m5", type=int, default=100_000)
    ap.add_argument("--burn-in5", type=int, default=300,
                    help="burn-in sweeps of slice 5's LDpred2-auto")
    ap.add_argument("--num-iter5", type=int, default=200,
                    help="kept sweeps of slice 5's LDpred2-auto")
    ap.add_argument("--gdp-rows", type=int, default=29_100,
                    help="rows of [15]'s float64 band, past the shared "
                    "memory of one block")
    ap.add_argument("--n6", type=int, default=20_000,
                    help="target samples of slice 6")
    ap.add_argument("--n6-ref", type=int, default=2_504,
                    help="reference samples of slice 6 (the 1000G panel's)")
    ap.add_argument("--m6", type=int, default=200_000)
    ap.add_argument("--n-sumstats", type=int, default=1_000_000,
                    help="rows of slice 6's summary statistics")
    ap.add_argument("--n-grm", type=int, default=10_000,
                    help="target samples of slice 6's GRM")
    ap.add_argument("--n7", type=int, default=20_000,
                    help="samples of slice 6c's BGEN cohort")
    ap.add_argument("--m7", type=int, default=100_000,
                    help="variants of slice 6c's BGEN cohort")
    # cut only by a CPU rehearsal, whose twins are slow
    ap.add_argument("--n-thr", type=int, default=50)
    ap.add_argument("--nlambda", type=int, default=30)
    ap.add_argument("--lasso-maxiter", type=int, default=1000)
    ap.add_argument("--lasso-points", type=int, default=120,
                    help="grid points (a multiple of 4) of the lassosum "
                    "mode held against its twin in [14] and [15]")
    ap.add_argument("--rehearse-cpu", action="store_true")
    return ap


def main(argv=None):
    args = arg_parser().parse_args(argv)

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
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

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
        log("[2] build (one nvcc a source, in parallel)")
        t0 = time.perf_counter()
        # K6 and K8 share geno_i8.cu; K1, K2 and K7 geno_split.cu
        with ThreadPoolExecutor(3) as pool:
            libs = list(pool.map(lambda b: b(verbose=True),
                                 (gk.build_i8, gk.build_split, gsk.build)))
        log(f"  built {', '.join(os.path.relpath(p, here) for p in libs)} "
            f"in {time.perf_counter() - t0:.1f} s")
        i8_ptxas_summary(libs[0])
        plane_ptxas_summary(libs[1])
        sweep_ptxas_summary(libs[2])

    rng = np.random.default_rng(args.seed)
    timer = Timer(torch, dev)
    phase_small_shapes(gk, torch, dev, rng)

    t0 = time.perf_counter()
    packed_np, pop = make_cohort(torch, dev, args.n, args.m, args.seed)
    log(f"  cohort made on the {dev.type} in {time.perf_counter() - t0:.1f} s")
    phase_slice(gk, torch, dev, packed_np, args.n, rng, timer,
                k=min(4096, args.m))

    with tempfile.TemporaryDirectory() as tmp:
        gsk.reset_launches()
        pack, sc, launches = phase_main_path(bp, gk, torch, dev, packed_np,
                                             pop, args.n, args.m, args.seed,
                                             tmp)
        if gsk.launches["sweep"]:
            fail("slice 1 launched the sweep kernel")
        rows = kernel_rows(gk, torch, dev, pack, sc, launches,
                           n_test=args.n - args.n * 4 // 5)
        del pack, packed_np
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    bb, launches2, run_auto = phase_slice2(bp, gsk, gk, torch, dev, args)
    rows += phase_sweep_kernels(bp, gsk, torch, dev, bb, launches2, timer,
                                args.seed)
    phase_profile(torch, dev, run_auto, sweep_kernel="gibbs_ring_kernel")
    del bb, run_auto
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phase_i8_small(bp, gk, torch, dev, rng)
    pack3, svd3, train3, path3 = phase_slice3(bp, gk, torch, dev, args)
    rows += phase_i8_timed(bp, gk, torch, dev, pack3, svd3, train3, path3,
                           args)
    del pack3, svd3
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phase_split_small(bp, gk, torch, dev, rng)
    s4 = phase_slice4(bp, gk, gsk, torch, dev, args)
    rows += phase_split_timed(bp, gk, torch, dev, s4, args)
    del s4
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phase_i8m_small(bp, gk, torch, dev, rng)
    phase_gdp_small(bp, gsk, torch, dev, args)
    s5 = phase_slice5(bp, gk, gsk, torch, dev, args)
    for r in rows:        # K8 with NA: launches on the slice-5 path
        key = r["name"].split()[0][len("geno_"):]
        if key in ("cprod_i8m", "prod_i8m"):
            r["launches"] = s5["svd_path"][key]
    rows += phase_gdp_timed(bp, gsk, torch, dev, s5, args)
    del s5
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    phase_slice6(bp, gk, torch, dev, args)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase_slice6c(bp, gk, gsk, torch, dev, args, timer)
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
