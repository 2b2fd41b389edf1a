"""The yardstick: one NVIDIA H100's published peaks and the least time of
each measured kernel's work, counted from the algorithm and the shapes
the benchmark hands in, never from how a kernel implements it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 1,979
TOP/s (int8 / fp8, the card's highest dense rate), 67 TFLOP/s float32 off
the tensor cores, 3.35 TB/s of HBM3. A kernel's roofline share is its
least time over its device time; the least time is the larger of its
operations over the peak rate and its bytes, each input read once and
each output written once, over the HBM rate.
"""

from __future__ import annotations

PEAK_DENSE_OPS = 1.979e15    # op/s: the highest dense rate, so no scheme
                             # of a genotype product can read above 100%
PEAK_F32_FLOPS = 67e12       # flop/s, float32 off the tensor cores
PEAK_HBM_BYTES = 3.35e12     # byte/s


def _least(ops: float, nbytes: float, peak_ops: float):
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def geno_product(n: int, m: int, l: int):
    """One genotype product, K1 (X~^T V) or K2 (X~ U), at n samples, m
    variants and l columns: the algorithm's 2 n m l operations at the
    card's highest dense rate, whatever number format or bit-plane scheme
    computes it; bytes: the 2-bit pack once (m ceil(n / 4)) and the
    float32 operand and result once each (4 (n + m) l). Returns (least
    seconds, "operations" or "bytes")."""
    ops = 2.0 * n * m * l
    nbytes = m * -(-n // 4) + 4.0 * (n + m) * l
    return _least(ops, nbytes, PEAK_DENSE_OPS)


SWEEP_WORD = 4         # bytes: the samplers run in float32
SWEEP_STEP_FLOPS = 20  # a chain and variant's update, besides its dot product


def gibbs_sweep(band_entries: int, m: int, chains: int, variant_words: int,
                chain_words: int, chain_bytes: int):
    """One Gibbs sweep over every LD block for `chains` chains: bytes are
    the in-block LD entries once (`band_entries`, the upper triangle with
    its diagonal), the per-variant inputs once (`variant_words`:
    beta_hat, n_eff, log_var), and per chain and variant the current beta
    read, the new one written and the outputs the sampler consumes
    (`chain_words`, `chain_bytes`). Random draws are not counted: an
    implementation may make them where they are used. Operations: the
    update of each chain and variant in float32; the band's dot products
    are left out, since their count depends on how many effects are
    non-zero. Returns (least seconds, which bound)."""
    w = SWEEP_WORD
    nbytes = (w * band_entries + w * variant_words * m
              + chains * m * (w * chain_words + chain_bytes))
    ops = float(chains) * m * SWEEP_STEP_FLOPS
    return _least(ops, nbytes, PEAK_F32_FLOPS)
