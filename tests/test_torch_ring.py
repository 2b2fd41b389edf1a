"""The sweep kernel on the CPU: its launch plan, and a plain torch
emulation of its schedule held bit-equal to the twins.

The kernel (`gibbs_ring_kernel` in csrc/gibbs_sweep.cu) runs every band,
cut into LD blocks or one block over every variant. A CTA runs one
block's chain tile (the plan's chains a CTA; the chain tile is the
fastest-varying CTA index, the blocks come longest first); the lassosum
mode's frozen grid points are skipped. Each chain keeps its live dp
entries in a ring of `ring_len` slots (entry e in slot e mod ring_len);
rows go in tiles of 32. A chain's row warp holds entries j0 + W .. j0 + W
+ 31 of tile j0 (lane k: j0 + W + k), runs the tile's rows one a lane and
applies each row's diff to its entries; at the tile's end it writes them
back, loads the next tile's 32 entries (once the update threads have
finished the previous tile) and applies this tile's diffs to them. The
update threads, one tile behind, apply the tile's diffs to the rest of
the window (entries j0 .. j0 + 2W + 31 but the row warp's two tiles),
write back the entries j0 - 32 .. j0 - 1 and stream in entries j0 + A ..
j0 + A + 31, A = W + 32 + max(W, 32). `ring_sweep` below does the same
index arithmetic on the CPU, with the update steps as late as the
kernel's barriers allow (step t - 1 just before the row warp's load at
the end of tile t), the row warps' band values read from a strip and the
update threads' from band stages or in place, each laid out as the
kernel's bulk copies write them, and the chains each CTA of the plan's
grid runs (`cta_grid`); its per-row steps are the twins' own
(`sweep_step`, `lasso_step`), so any difference from the twin is in the
schedule. Chains are independent, so the emulation runs a block's chains
together, whichever CTA holds them. No card and no JAX are needed here;
the card tests (tests/test_torch_cuda.py) hold the kernel itself against
the twin."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import gibbs_kernels as gk
from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb
from bigsnpr_tpu_torch.pgs.band import one_block_bands

torch.set_num_threads(2)
H100_SMEM = 232_448     # shared memory a block may use on an H100 (opt-in)
K = gk.RING_ROWS


def banded_corr(m, W, seed):
    """A one-block banded LD matrix of half-width W (no stored zeros)."""
    rng = np.random.default_rng(seed)
    diags = [np.ones(m)] + [0.9 ** d * rng.uniform(0.5, 1.0, m - d)
                            for d in range(1, W + 1)]
    up = sp.diags(diags, list(range(W + 1)), format="csc").tocsc()
    return interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)


def one_block(m, W, seed, dtype, pad=0):
    """The unblocked samplers' one-block bands; `pad` trailing pad slots
    (gidx -1, zero band rows) after the m variants."""
    bb = one_block_bands(banded_corr(m, W, seed), dtype=dtype)
    band, gidx = bb.buckets[0]
    if pad:
        band = np.concatenate([band, np.zeros((1, pad, band.shape[2]),
                                              band.dtype)], axis=1)
        gidx = np.concatenate([gidx, np.full((1, pad), -1, gidx.dtype)],
                              axis=1)
    return gk.SweepBands([(band, gidx)], m, "cpu",
                         torch.float64 if dtype == np.float64
                         else torch.float32)


def block_diag(sizes, seed, dtype):
    """Ragged dense blocks bucketed by `build_block_bands` (pad slots,
    buckets of different W)."""
    rng = np.random.default_rng(seed)
    mats = []
    for sz in sizes:
        A = rng.normal(size=(sz, 4 * sz))
        mats.append(sp.coo_matrix(np.corrcoef(0.6 * A
                                              + 0.4 * np.roll(A, 1, axis=0))))
    up = sp.triu(sp.block_diag(mats).tocsc()).tocsc()
    corr = interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)
    return pgb.build_block_bands(corr, sizes).device_put(
        "cpu", dtype=dtype)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class _Shape:
    """What `plan` reads of a SweepBands."""

    def __init__(self, W, rows, dtype, nblk=1):
        self.wkmax, self.dtype, self.nblk = 2 * W + 1, dtype, nblk


@pytest.mark.parametrize("W,rows", [(458, 100_000), (458, 29_100), (5, 700),
                                    (0, 100), (31, 1001), (32, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("NC", [30, 120])
def test_ring_plan_fits_and_covers_the_window(W, rows, dtype, NC):
    """Slice 5's band (917 wide), W < 32, W = 0 and rows % 32 != 0, one
    block, at LDpred2-auto's 30 chains and lassosum2's 120 grid points: the
    ring holds the live window (A + 64 entries) in a power of two of at
    least 256 slots, the shared memory fits the H100's 227 KB, the threads
    are as `ring_threads` lays them out, and chains a CTA follow ceil(NC x
    nblk / RING_CTAS): one at 30 and at 120."""
    sb = _Shape(W, rows, dtype)
    pl = gk.plan(sb, NC, H100_SMEM)
    S = pl.ring_len
    assert S >= 256 and S & (S - 1) == 0
    assert S >= W + K + max(W, K) + 2 * K
    assert S < 2 * max(256, W + K + max(W, K) + 2 * K)
    assert pl.nct == -(-NC // gk.RING_CTAS) == 1
    assert pl.threads == gk.ring_threads(pl.nct) <= 1024
    elem = 8 if dtype == torch.float64 else 4
    assert pl.smem == gk.ring_smem_bytes(pl.nct, S, elem, pl.stage) \
        <= H100_SMEM
    # the band comes through stages where they fit: a row of 2W + 1 values
    # from the 16-byte chunk of its start, and a tile's 2W + 32 entries at
    # most RING_ENTRIES an update thread
    V = 16 // elem
    srw = -(-(2 * W + V) // V) * V
    assert srw % V == 0 and srw >= 2 * W + 1 + V - 1
    fits = (2 * W + K <= gk.RING_ENTRIES * gk.RING_UPDATE
            and gk.ring_smem_bytes(pl.nct, S, elem, srw) <= H100_SMEM)
    assert pl.stage == (srw if fits else 0)
    assert fits == (W == 458 and elem == 4 or W < 458)


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4),
                                        (torch.float64, 8)])
def test_ring_plan_raises_past_the_shared_memory(dtype, elem):
    """The widest band the plan takes has a ring of the largest power of
    two that fits beside the strips; one more slot of half-width needs a
    ring twice as long, and the plan raises instead of falling back. Chains
    a CTA shrink to what fits first."""
    fixed = gk.ring_smem_bytes(1, 0, elem)
    S = 1 << ((H100_SMEM - fixed) // elem).bit_length() - 1
    W_max = (S - 3 * K) // 2           # A + 2K = 2W + 3K for W >= 32
    pl = gk.plan(_Shape(W_max, 10 * W_max, dtype), 120, H100_SMEM)
    assert pl.ring_len == S and pl.nct == 1
    with pytest.raises(ValueError, match="more than the"):
        gk.plan(_Shape(W_max + 1, 10 * W_max, dtype), 30, H100_SMEM)
    # 256 chains ask for two chains a CTA: the widest ring holds one, a
    # ring half as long both
    assert gk.plan(_Shape(W_max, 10 * W_max, dtype), 256, H100_SMEM).nct == 1
    pl2 = gk.plan(_Shape((S // 2 - 3 * K) // 2, 10 * W_max, dtype), 256,
                  H100_SMEM)
    assert pl2.ring_len == S // 2 and pl2.nct == 2


# (W, longest block's rows, blocks, chains, dtype, chains a CTA, staged):
# slice 2's bands (67 blocks, 204-2,926 rows, up to 1,023 wide) at
# LDpred2-auto's 30 chains, the grid's 9 cells and the float64 check's 4
# chains; slice 4's (42 blocks, up to 3,999 rows and 511 wide) at
# lassosum2's 120 grid points (the lassosum mode: RING_NARROW a CTA at
# most); a narrow bucket (K4's shape)
BLOCKED = {
    "slice2_auto": (511, 2926, 67, 30, torch.float32, 6, False),
    "slice2_grid": (511, 2926, 67, 9, torch.float32, 5, False),
    "slice2_f64": (511, 2926, 67, 4, torch.float64, 2, False),
    "slice4_lasso": (255, 3999, 42, 120, torch.float32, 3, True),
    "narrow": (15, 128, 24, 9, torch.float32, 2, True),
}


@pytest.mark.parametrize("case", list(BLOCKED))
def test_ring_plan_at_blocked_shapes(case):
    """The blocked samplers' launches: several chains a CTA (spread evenly
    over the chain tiles, about RING_CTAS CTAs a launch), within the
    H100's 227 KB of shared memory and one CTA's threads an SM at the
    register budget that the instantiation's launch bound sets (at least
    128 registers a thread; ptxas' report, chip_smoke.py [2], shows what
    the kernel takes); band stages where a tile's entries fit the update
    threads and the shared memory (slice 4's, the narrow bucket's), else
    in place (slice 2's, whose 2W + 32 = 1,054 entries exceed them)."""
    W, rows, nblk, NC, dtype, nct, staged = BLOCKED[case]
    lasso = case.endswith("lasso")
    pl = gk.plan(_Shape(W, rows, dtype, nblk), NC, H100_SMEM, lasso)
    assert pl.nct == nct
    tiles = -(-NC // nct)
    assert -(-NC // tiles) == nct                    # evenly spread
    cap = gk.RING_NARROW if lasso else gk.RING_MAX_CHAINS
    want = min(NC, cap, -(-NC * nblk // gk.RING_CTAS))
    assert tiles == -(-NC // want)                   # about RING_CTAS CTAs
    assert pl.smem <= H100_SMEM and pl.threads == gk.ring_threads(nct)
    inst = gk.ring_capacity(nct)                    # the instantiation
    assert nct <= inst and gk.ring_threads(inst) <= 1024
    warps = gk.ring_threads(inst) // 32
    assert -(-warps // 4) * 32 * gk.ring_regs(nct) <= gk.SCHED_REGS
    assert gk.ring_regs(nct) >= 128
    assert (pl.stage > 0) == staged
    elem = 8 if dtype == torch.float64 else 4
    assert pl.smem == gk.ring_smem_bytes(nct, pl.ring_len, elem, pl.stage)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _strip(band, band_len, f0, W2, elem):
    """The 32 x (64 + V) strip of a tile as the producer's bulk copies lay
    it out (csrc/gibbs_sweep.cu's issue_strip): row i holds the 16-byte
    chunks from the one that holds band[j0 + i, W - i] (flat index f0 + i
    W2)."""
    V = 16 // elem
    out = torch.zeros((K, 2 * K + V), dtype=band.dtype)
    for i in range(K):
        fa = (f0 + i * W2) & ~(V - 1)
        idx = torch.arange(fa, fa + 2 * K + V)
        ok = idx < band_len
        out[i, ok] = band[idx[ok]]
    return out


def _stage_line(band, f, wk, srw, elem):
    """A band stage's line as the producer's bulk copy writes it: the row
    whose band[., 0] is at flat index f, from the 16-byte chunk that holds
    it, whole chunks (the arena's padding covers the last)."""
    V = 16 // elem
    src = f & ~(V - 1)
    n = -(-(f + wk - src) // V) * V
    assert n <= srw and src + n <= band.numel()
    out = torch.zeros(srw, dtype=band.dtype)
    out[:n] = band[src:src + n]
    return out


def cta_grid(sb, pl, NC, live):
    """The kernel's CTAs in launch order, each (block, its chains that
    run): CTA x is chain tile x mod ceil(NC / nct) of block order[x //
    ceil(NC / nct)], the tile's frozen chains (`live` False) skipped.
    Checks that the blocks come longest first, a block's tiles side by
    side, and that every (block, live chain) runs exactly once; returns the
    (nblk, NC) mask of the chains that run."""
    ntc = -(-NC // pl.nct)
    rows = sb.blk_rows.tolist()
    order = sb.order.tolist()
    assert sorted(order) == list(range(sb.nblk))
    assert order == sorted(range(sb.nblk), key=lambda b: -rows[b])
    runs = torch.zeros((sb.nblk, NC), dtype=torch.bool)
    for x in range(sb.nblk * ntc):
        pos, ct = divmod(x, ntc)
        b, c0 = order[pos], ct * pl.nct
        chains = [c for c in range(c0, min(c0 + pl.nct, NC)) if live[c]]
        assert not runs[b, chains].any()
        runs[b, chains] = True
    assert torch.equal(runs, live[None].expand(sb.nblk, NC))
    return runs


def ring_sweep(sb, pl, dp, step, fold, acc, madd, live=None):
    """The kernel's schedule over every block, blocks in lockstep by row:
    step(j, dot, run) -> (diff, c1, c2), each (NC, nblk), for row j of
    every block from dot = dp[j + W] (`run` marks the blocks that have a
    row j); fold(acc_b, diff, c1, c2) sums a row into block b's partials;
    madd(d, b, x) = x + d b as the kernel rounds it; `live` (NC,) the chains
    that run (all by default; the lassosum mode skips its frozen grid
    points, whose dp the kernel leaves as it is). Updates dp in place;
    returns the per-block partials."""
    NC = dp.shape[0]
    if live is None:
        live = torch.ones(NC, dtype=torch.bool)
    runs = cta_grid(sb, pl, NC, live)
    S = pl.ring_len
    S1 = S - 1
    elem = sb.band.element_size()
    V = 16 // elem
    band, band_len = sb.band, sb.band.numel()
    rows_b = sb.blk_rows.tolist()
    W_b = sb.blk_W.tolist()
    bb_b = sb.blk_band.tolist()
    dpo_b = sb.blk_dp.tolist()
    nblk = sb.nblk
    lanes = torch.arange(K)
    blk = []
    for b in range(nblk):
        rows, W = rows_b[b], W_b[b]
        Lp = rows + 2 * W if rows else 0
        A = W + K + max(W, K)
        assert A + 2 * K <= S
        ring = torch.zeros((NC, S), dtype=dp.dtype)
        n0 = min(A, Lp)
        ring[:, :n0] = dp[:, dpo_b[b]:dpo_b[b] + n0]
        e = W + lanes
        cur = torch.where(e < Lp, ring[:, e & S1], torch.zeros(()))
        blk.append(dict(rows=rows, W=W, Lp=Lp, A=A, ring=ring, cur=cur,
                        ntile=-(-rows // K), sd={}, acc=acc(),
                        f00=bb_b[b] + W))

    def update_step(b, t):
        B = blk[b]
        W, Lp, ring = B["W"], B["Lp"], B["ring"]
        W2, wk = 2 * W, 2 * W + 1
        j0 = K * t
        nrow = min(K, B["rows"] - j0)
        d, c1, c2 = B["sd"].pop(t)
        for i in range(nrow):                          # partials, row order
            B["acc"] = fold(B["acc"], d[:, i], c1[:, i], c2[:, i])
        q = torch.arange(W2 + K)
        q = q[((q < W) | (q >= W + 2 * K)) & (j0 + q < Lp)]
        slots = (j0 + q) & S1
        x = ring[:, slots]
        f0m, wkm = (bb_b[b] + j0 * wk) & (V - 1), wk & (V - 1)
        for i in range(nrow):                 # each entry's rows in order
            col = q - i
            ok = (col >= 0) & (col <= W2)
            if pl.stage:       # the producer's copy of band row j0 + i
                line = _stage_line(band, bb_b[b] + (j0 + i) * wk, wk,
                                   pl.stage, elem)
                bv = line[((f0m + i * wkm) & (V - 1)) + col[ok]]
            else:
                bv = band[bb_b[b] + (j0 + i) * wk + col[ok]]
            x[:, ok] = madd(d[:, i, None], bv, x[:, ok])
        ring[:, slots] = x
        if t >= 1:                                     # final entries out
            e = torch.arange(j0 - K, j0)
            e = e[e < Lp]
            put(b, e, ring[:, e & S1])
        e = torch.arange(j0 + B["A"], j0 + B["A"] + K)  # next entries in
        e = e[e < Lp]
        ring[:, e & S1] = dp[:, dpo_b[b] + e]

    def put(b, e, vals):          # dp entries e of block b, chains that run
        r = runs[b]
        dp[r.nonzero()[:, 0][:, None], (dpo_b[b] + e)[None]] = vals[r]

    ntile = max((B["ntile"] for B in blk), default=0)
    for t in range(ntile):
        j0 = K * t
        live = [b for b in range(nblk) if t < blk[b]["ntile"]]
        strips = {b: _strip(band, band_len, blk[b]["f00"]
                            + j0 * (2 * blk[b]["W"] + 1), 2 * blk[b]["W"],
                            elem) for b in live}
        diffs = {b: [torch.zeros((NC, K), dtype=dp.dtype) for _ in range(3)]
                 for b in live}
        for i in range(K):                             # the row warps
            j = j0 + i
            run = torch.tensor([j < B["rows"] for B in blk])
            if not run.any():
                break
            dot = torch.stack([B["cur"][:, i] for B in blk], dim=1)
            d, c1, c2 = step(j, dot.contiguous(), run)
            for b in live:
                if not run[b]:
                    continue
                B = blk[b]
                for buf, v in zip(diffs[b], (d, c1, c2)):
                    buf[:, i] = v[:, b]
                W2 = 2 * B["W"]
                col = B["W"] + lanes - i
                ok = (col >= 0) & (col <= W2)
                off = (B["f00"] + j0 * (W2 + 1) + i * W2) & (V - 1)
                bv = strips[b][i, off + lanes]
                B["cur"][:, ok] = madd(d[:, b, None], bv[ok],
                                       B["cur"][:, ok])
        for b in live:                                 # end of tile t
            B = blk[b]
            W, W2, Lp, ring = B["W"], 2 * B["W"], B["Lp"], B["ring"]
            nrow = min(K, B["rows"] - j0)
            e = j0 + W + lanes
            ring[:, e[e < Lp] & S1] = B["cur"][:, e < Lp]
            B["sd"][t] = diffs[b]
            if t >= 1:
                update_step(b, t - 1)
            en = j0 + K + W + lanes
            nx = torch.where(en < Lp, ring[:, en & S1], torch.zeros(()))
            off0 = B["f00"] + j0 * (W2 + 1)
            for i in range(nrow):
                ok = lanes - i <= W - K
                off = (off0 + i * W2) & (V - 1)
                bv = strips[b][i, off + K + lanes]
                nx[:, ok] = madd(diffs[b][0][:, i, None], bv[ok], nx[:, ok])
            if t + 1 == B["ntile"]:
                ring[:, en[en < Lp] & S1] = nx[:, en < Lp]
            B["cur"] = nx
    for b, B in enumerate(blk):                        # the last step, flush
        if B["ntile"]:
            update_step(b, B["ntile"] - 1)
            e = torch.arange(K * (B["ntile"] - 1), B["Lp"])
            put(b, e, B["ring"][:, e & S1])
    return [B["acc"] for B in blk]


def sweep_ring(sb, pl, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p, sparse,
               shrink, no_jump):
    """The LDpred2 sweep on the ring schedule: `sweep_plain`'s outputs."""
    NC, m = cb.shape
    dt = sb.dtype
    bands, g, Wm, Lm, src, dst = sb.merged()
    sc = gk._scatter_b
    sh = torch.tensor(float(shrink), dtype=dt)
    one_m_sh = 1 - sh
    iop, pc, spc = inv_odd_p[:, None], p[:, None], sparse[:, None]
    bh_s, c2_s = sc(bh, g), sc(C2, g)
    c4_s, s1_s, u_s = sc(C4, g, 1.0), sc(s1, g, 1.0), sc(u, g, 2.0)
    zs_s = sc(z, g) * torch.sqrt(c4_s)
    cb_s = sc(cb, g)
    ys = torch.zeros((5, NC, sb.nblk, g.shape[1]), dtype=dt)

    def step(j, dot, run):
        cbj = cb_s[:, :, j]
        diff, new_beta, sampled, skip, postp, C3, dps, samp = gk.sweep_step(
            dot, cbj, bh_s[:, j], c2_s[:, :, j], c4_s[:, :, j],
            s1_s[:, :, j], u_s[:, :, j], zs_s[:, :, j], iop, pc, spc, sh,
            one_m_sh, no_jump)
        for k, y in enumerate((new_beta, sampled.to(dt),
                               torch.where(skip, 0.0, postp),
                               torch.where(skip, 0.0, C3 * postp), dps)):
            ys[k, :, :, j] = torch.where(run, y, ys[k, :, :, j])
        return (diff, diff * (2 * dps + diff),
                torch.where(sampled, samp * samp, 0.0))

    def fold(acc, d, c1, c2):
        return acc[0] + c1, acc[1] + c2

    zero = lambda: (torch.zeros(NC, dtype=dt), torch.zeros(NC, dtype=dt))  # noqa: E731
    accs = ring_sweep(sb, pl, dp, step, fold, zero,
                      lambda d, b, x: x + d * b)
    outs = gk._outputs(NC, m, dt, sb.device, 0)[:5]
    for out, y in zip((outs[0], outs[2], outs[3], outs[4]), ys[[0, 2, 3, 4]]):
        gk._gather_set(out, y, g)
    gk._gather_set(outs[1], ys[1] != 0, g)
    h2 = torch.stack([a[0] for a in accs], 1).sum(1)
    gap = torch.stack([a[1] for a in accs], 1).sum(1)
    return outs + (h2, gap)


def lassosum_ring(sb, pl, dp, beta, bh, pf, lam, delta, active):
    """The lassosum sweep on the ring schedule: `lassosum_sweep_plain`'s
    outputs, beta updated in place."""
    NG, m = beta.shape
    dt = sb.dtype
    bands, g, Wm, Lm, src, dst = sb.merged()
    valid = g >= 0
    one = torch.ones((), dtype=dt)
    bh_s, pf_s = gk._scatter_b(bh, g), gk._scatter_b(pf, g)
    lam_s = torch.where(valid, pf_s[None] * lam[:, None, None], one)
    dp1_s = torch.where(valid, pf_s[None] * delta[:, None, None] + one, one)
    cb_s = gk._scatter_b(beta, g)
    new_s = cb_s.clone()
    act = active[:, None]

    def step(j, dot, run):
        cbj = cb_s[:, :, j]
        nb = gk.lasso_step(dot, cbj, bh_s[:, j], lam_s[:, :, j],
                           dp1_s[:, :, j])
        on = act & run
        new_s[:, :, j] = torch.where(on, nb, new_s[:, :, j])
        return (torch.where(act, nb - cbj, 0.0), torch.where(act, nb, 0.0),
                torch.zeros_like(nb))

    def fold(acc, d, nb, _):
        gap, df, ms = acc
        nz = (nb != 0) & active
        ad = d.abs()
        ms = torch.where(active & ((ad > ms) | torch.isnan(ad)), ad, ms)
        return gap + torch.where(nz, nb * nb, 0.0), df + nz, ms

    zero = lambda: (torch.zeros(NG, dtype=dt),  # noqa: E731
                    torch.zeros(NG, dtype=torch.int32),
                    torch.zeros(NG, dtype=dt))
    accs = ring_sweep(sb, pl, dp, step, fold, zero, gk._mul_add, active)
    gk._gather_set(beta, new_s, g)
    return (torch.stack([a[0] for a in accs], 1).sum(1),
            torch.stack([a[1] for a in accs], 1).sum(1, dtype=torch.int32),
            torch.stack([a[2] for a in accs], 1).amax(1))


def differ(a, b):
    """What torch.equal saw when it failed: how many entries differ, how
    many are NaN on either side (NaN never equals itself), the largest
    difference."""
    ne = a != b
    return (f"{int(ne.sum())} of {a.numel()} entries differ, NaN "
            f"{int(torch.isnan(a).sum())} / {int(torch.isnan(b).sum())}, "
            f"max |diff| {float((a.double() - b.double()).abs().max())}")


def sweep_state(sb, NC, seed):
    rng = np.random.default_rng(seed)
    m, dt = sb.m, sb.dtype
    f = lambda a: torch.as_tensor(a, dtype=dt)  # noqa: E731
    return dict(bh=f(rng.normal(0, 0.05, m)),
                C2=f(rng.uniform(0.1, 0.9, (NC, m))),
                C4=f(rng.uniform(0.1, 0.9, (NC, m))),
                s1=f(rng.uniform(1.0, 2.0, (NC, m))),
                u=f(rng.uniform(0, 1, (NC, m))),
                z=f(rng.normal(0, 1, (NC, m))),
                cb=f(rng.normal(0, 0.05, (NC, m))
                     * (rng.random((NC, m)) < 0.5)),
                inv_odd_p=f(rng.uniform(1, 50, NC)),
                p=f(rng.uniform(0.05, 0.5, NC)),
                sparse=torch.as_tensor(np.arange(NC) % 3 == 1),
                dp=f(rng.normal(0, 0.05, (NC, sb.dp_len))))


CASES = {   # bands: slice 5's width at a short length, W < 32, W = 0,
    # trailing pad slots, ragged dense blocks in buckets of other widths;
    # blocks in a bucket of half-width 447 among short ones (stages at W >=
    # 256 in float32, in place in float64), in one of slice 2's widest
    # (511: in place); 36 blocks of 5-130 rows, most shorter than a tile
    # or padded in their buckets
    "w458": lambda dt: one_block(700, 458, 1, dt),
    "w5": lambda dt: one_block(333, 5, 2, dt),
    "w0": lambda dt: one_block(77, 0, 3, dt),
    "w40_pad": lambda dt: one_block(300, 40, 4, dt, pad=45),
    "blocks": lambda dt: block_diag([300, 41, 7], 5, dt),
    "blocks_wide": lambda dt: block_diag([31, 420, 5, 300], 6, dt),
    "blocks_511": lambda dt: block_diag([460, 9], 8, dt),
    "blocks_many": lambda dt: block_diag(
        np.random.default_rng(7).integers(5, 131, 36).tolist(), 7, dt),
}
# chains (grid points) a case runs: LDpred2-auto's 30 (and 120 points)
# where the plan then takes several chains a CTA
NCHAINS = {"w458": (30, 120), "blocks_wide": (70, 120),
           "blocks_511": (70, 64), "blocks_many": (30, 64)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ring_schedule_matches_sweep_twin(case, dtype):
    """The LDpred2 sweep on the kernel's schedule is bit-equal to
    `sweep_plain`: dp, the five outputs, h2 and gap (30 chains on slice
    5's width in float32 and on the many blocks, 6 chains a CTA there; 70
    on the wide blocks, 3 a CTA, and the widest, 2; 4 on the others)."""
    sb = CASES[case](dtype)
    NC = NCHAINS[case][0] if case in NCHAINS and (
        case != "w458" or dtype == np.float32) else 4
    st = sweep_state(sb, NC, 7)
    pl = gk.plan(sb, NC, H100_SMEM)
    args = [st[k] for k in ("cb", "bh", "C2", "C4", "s1", "u", "z",
                            "inv_odd_p", "p", "sparse")] + [0.95, True]
    dp_ref, dp_ring = st["dp"].clone(), st["dp"].clone()
    ref = gk.sweep_plain(sb, dp_ref, *args)
    got = sweep_ring(sb, pl, dp_ring, *args)
    assert torch.equal(dp_ring, dp_ref), differ(dp_ring, dp_ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b), differ(a, b)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ring_schedule_matches_lassosum_twin(case, dtype):
    """The lassosum sweep on the kernel's schedule is bit-equal to
    `lassosum_sweep_plain` from the state after two sweeps, one grid point
    in five frozen: dp, betas, gap, df and maxshift (120 grid points on
    slice 5's width in float32 and on the wide blocks, 3 a CTA there, the
    most the mode takes; 64 on the many blocks, 3 a CTA, and the widest,
    1; 7 on the others)."""
    sb = CASES[case](dtype)
    NG = NCHAINS[case][1] if case in NCHAINS and (
        case != "w458" or dtype == np.float32) else 7
    rng = np.random.default_rng(8)
    f = lambda a: torch.as_tensor(a, dtype=sb.dtype)  # noqa: E731
    m = sb.m
    bh, pf = f(rng.normal(0, 0.05, m)), f(rng.uniform(0.8, 1.5, m))
    lam = f(np.geomspace(0.05, 5e-4, NG))
    delta = f(np.repeat([0.001, 0.01, 0.1, 1.0], -(-NG // 4))[:NG])
    dp, beta = sb.dp0(NG), torch.zeros((NG, m), dtype=sb.dtype)
    for _ in range(2):
        gk.lassosum_sweep_plain(sb, dp, beta, bh, pf, lam, delta,
                                torch.ones(NG, dtype=torch.bool))
    active = torch.as_tensor(np.arange(NG) % 5 != 3)
    pl = gk.plan(sb, NG, H100_SMEM, lasso=True)
    d_ref, b_ref = dp.clone(), beta.clone()
    ref = gk.lassosum_sweep_plain(sb, d_ref, b_ref, bh, pf, lam, delta,
                                  active)
    d_got, b_got = dp.clone(), beta.clone()
    got = lassosum_ring(sb, pl, d_got, b_got, bh, pf, lam, delta, active)
    assert torch.equal(d_got, d_ref) and torch.equal(b_got, b_ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
