"""The blocked Gibbs sweep: the CUDA kernel that replaces K3, K4 and K5,
its plain-torch twin, and the banded LD operand they share.

Counterpart of `bigsnpr_tpu/pgs/gibbs_pallas.py` (`sweep_bucket_pallas`,
`sweep_bucket_pallas_mc`, `sweep_bucket_pallas_v3`) and of the XLA twin
`gibbs_blocked._sweep_gibbs_batched`: one lockstep LDpred2 Gibbs sweep
over every LD block for NC chains. The kernel is `csrc/gibbs_sweep.cu`,
built with nvcc at first use into `_build/` and loaded with ctypes
(`ops/cuda_build.py`). `sweep` launches it for CUDA tensors and counts the
launch in `launches["sweep"]`; for CPU tensors it runs `sweep_plain`.
There is no fallback from a CUDA tensor to the twin.

When one chain's dp does not fit in shared memory (a block of about
28,000 rows or more in float64, twice that in float32: the unblocked
samplers' one block over every variant), `plan` picks the kernel's
global-dp mode, which keeps dp in place in device memory, one chain a
CTA; its launches count in `launches["sweep_global"]` (and
`"lassosum_global"`).

The kernel's lassosum mode (`lassosum_sweep`, twin `lassosum_sweep_plain`,
count `launches["lassosum"]`) runs one deterministic lassosum2
coordinate-descent sweep with the same skeleton, a grid point in place of
a chain: the port of the JAX package's XLA `lassosum_cd_blocked` sweep.

Bound: a chain tile reads each block's band once (bytes: band x chain
tiles plus the per-row inputs and outputs), but the rows of a block are a
chain of dependent steps, so at these sizes the longest block's rows x
one step's latency bounds a sweep.

Layout: the bands keep their natural per-block shape (rows, 2W + 1),
bucketed as `BlockBands` builds them; `SweepBands` lays every bucket into
one flat arena with per-block offset tables, so one launch covers all
blocks. The TPU's j % 8 row pre-shift and lane padding are gone. A chain's
dp for block b holds mbk + 2W values (dp[j + W] is row j's centre), with
the blocks of all buckets end to end in one (NC, dp_len) tensor.
Per-variant inputs and outputs are global (NC, m) vectors, read and
written through the slot -> variant table; a pad slot is inert (u = 2,
C4 = sqrt1pC1 = 1, everything else 0), as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bigsnpr_tpu_torch.ops import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "gibbs_sweep.cu"
EXTRA_FLAGS = ("--fmad=false",)
KMAX = 8                 # band columns a thread holds per row (gibbs_sweep.cu)
SMEM_TARGET = 100 << 10  # shared memory per CTA aimed at: two CTAs an SM

# kernel launches made by the wrapper
launches = {"sweep": 0, "lassosum": 0, "sweep_global": 0,
            "lassosum_global": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(verbose: bool = False):
    """Compile `csrc/gibbs_sweep.cu` at first use; returns its path."""
    return cuda_build.build(SOURCE, verbose=verbose, extra=EXTRA_FLAGS)


def _bind(lib):
    p, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_double)
    for fn in (lib.gibbs_sweep_f32, lib.gibbs_sweep_f64):
        fn.argtypes = ([p] * 7 + [i32, p, p, i64] + [p] * 7 + [i64]
                       + [p] * 3 + [f64, i32] + [p] * 7
                       + [i32, i32, i32, i32, i32, p])
        fn.restype = i32
    for fn in (lib.lassosum_sweep_f32, lib.lassosum_sweep_f64):
        fn.argtypes = ([p] * 7 + [i32, p, p, i64] + [p] * 3 + [i64]
                       + [p] * 6 + [i32, i32, i32, i32, i32, p])
        fn.restype = i32
    lib.gibbs_sweep_max_smem.argtypes = [i32]
    lib.gibbs_sweep_max_smem.restype = i32


def _load():
    return cuda_build.load(SOURCE, _bind, extra=EXTRA_FLAGS)


class SweepBands:
    """Every bucket of a `BlockBands` on one device: a flat band arena
    with per-block offset tables (the kernel's operand) and per-bucket
    views (the twin's).

    buckets: list of host (bands (Bk, mbk, 2W+1), gidx (Bk, mbk)) with
    gidx the global variant of each slot (-1 at padding, valid slots a
    prefix of each block)."""

    def __init__(self, buckets, m, device, dtype=torch.float32):
        self.m = int(m)
        self.device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        self.dtype = dtype
        band_parts, gidx_parts, self.views = [], [], []
        blk_band, blk_dp, blk_gidx, blk_rows, blk_W, blk_L = ([] for _ in
                                                              range(6))
        band_off = dp_off = g_off = nblk = 0
        for bands, gidx in buckets:
            Bk, mbk, wk = bands.shape
            W = (wk - 1) // 2
            L = mbk + 2 * W
            gidx = np.asarray(gidx)
            rows = (gidx >= 0).sum(axis=1)
            for b in range(Bk):
                blk_band.append(band_off + b * mbk * wk)
                blk_dp.append(dp_off + b * L)
                blk_gidx.append(g_off + b * mbk)
                blk_rows.append(int(rows[b]))
                blk_W.append(W)
                blk_L.append(L)
            band_parts.append(torch.as_tensor(
                np.ascontiguousarray(bands), dtype=dtype,
                device=self.device).reshape(-1))
            gidx_parts.append(torch.as_tensor(
                gidx.astype(np.int32), device=self.device).reshape(-1))
            self.views.append(dict(Bk=Bk, mbk=mbk, W=W, L=L, dp_off=dp_off,
                                   blk0=nblk))
            band_off += Bk * mbk * wk
            dp_off += Bk * L
            g_off += Bk * mbk
            nblk += Bk
        dev = self.device
        self.band = (torch.cat(band_parts) if band_parts
                     else torch.zeros(0, dtype=dtype, device=dev))
        self.gidx = (torch.cat(gidx_parts) if gidx_parts
                     else torch.zeros(0, dtype=torch.int32, device=dev))
        i64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
        i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        self.blk_band, self.blk_dp, self.blk_gidx = (i64(blk_band),
                                                     i64(blk_dp),
                                                     i64(blk_gidx))
        self.blk_rows, self.blk_W, self.blk_L = (i32(blk_rows), i32(blk_W),
                                                 i32(blk_L))
        self.nblk = nblk
        self.dp_len = dp_off
        self.Lmax = max(blk_L, default=1)
        self.wkmax = max((2 * w + 1 for w in blk_W), default=1)
        self.max_rows = max(blk_rows, default=0)
        self.plans = {}  # NC -> (chains per CTA, threads, global dp)
        self._host = buckets
        self._merged = None

    def merged(self):
        """The twin's layout, built at first use: every block's band
        zero-padded to the widest half-width Wm and the longest block's R
        rows, (nblk, R, 2Wm + 1), its slot table (nblk, R), and the index
        pairs that move dp between the arena and (NC, nblk, R + 2Wm)."""
        if self._merged is None:
            Wm = max((v["W"] for v in self.views), default=0)
            R = max(self.max_rows, 1)
            Lm = R + 2 * Wm
            nblk = self.nblk
            bands_m = np.zeros((nblk, R, 2 * Wm + 1),
                               self._host[0][0].dtype if self._host
                               else np.float32)
            gidx_m = np.full((nblk, R), -1, np.int64)
            src, dst = [], []
            for (bands, gidx), v in zip(self._host, self.views):
                b0, Bk, W, L = v["blk0"], v["Bk"], v["W"], v["L"]
                r = min(v["mbk"], R)
                bands_m[b0:b0 + Bk, :r, Wm - W:Wm + W + 1] = bands[:, :r]
                gidx_m[b0:b0 + Bk, :r] = gidx[:, :r]
                i = np.arange(min(L, R + 2 * W))
                blk = np.arange(Bk)[:, None]
                src.append((v["dp_off"] + blk * L + i).ravel())
                dst.append(((b0 + blk) * Lm + Wm - W + i).ravel())
            dev = self.device
            cat = lambda a: torch.as_tensor(  # noqa: E731
                np.concatenate(a) if a else np.zeros(0, np.int64),
                device=dev)
            self._merged = (
                torch.as_tensor(bands_m, dtype=self.dtype, device=dev),
                torch.as_tensor(gidx_m, device=dev), Wm, Lm, cat(src),
                cat(dst))
        return self._merged

    def dp0(self, NC: int) -> torch.Tensor:
        """Zero dp state for NC chains."""
        return torch.zeros((NC, self.dp_len), dtype=self.dtype,
                           device=self.device)


def _scatter_b(vals, gidx, fill=0.0):
    """(..., m) global -> (..., B, rows) slots; `fill` at padding."""
    valid = gidx >= 0
    out = vals[..., gidx.clamp(min=0)]
    return torch.where(valid, out, torch.as_tensor(fill, dtype=out.dtype,
                                                   device=out.device))


def _gather_set(out, vals, gidx):
    """Write slot values (..., B, rows) into global (..., m) at the valid
    slots; returns out."""
    valid = gidx >= 0
    out[..., gidx[valid]] = vals[..., valid]
    return out


def _outputs(NC, m, dtype, device, nblk):
    e = lambda dt=dtype: torch.empty((NC, m), dtype=dt, device=device)  # noqa: E731
    return (e(), e(torch.bool), e(), e(), e(),
            torch.empty((NC, nblk), dtype=dtype, device=device),
            torch.empty((NC, nblk), dtype=dtype, device=device))


def _check(sb, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p, sparse):
    NC, m = cb.shape
    if m != sb.m:
        raise ValueError(f"per-variant inputs have m={m}, bands {sb.m}")
    for name, t, shape in (("dp", dp, (NC, sb.dp_len)), ("bh", bh, (m,)),
                           ("C2", C2, (NC, m)), ("C4", C4, (NC, m)),
                           ("s1", s1, (NC, m)), ("u", u, (NC, m)),
                           ("z", z, (NC, m)), ("inv_odd_p", inv_odd_p, (NC,)),
                           ("p", p, (NC,))):
        if tuple(t.shape) != shape or t.dtype != sb.dtype:
            raise ValueError(f"{name} must be {sb.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p, sparse):
        if t.device != sb.device:
            raise ValueError("every operand must be on the bands' device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if cb.dtype != sb.dtype or sparse.dtype != torch.bool or \
            tuple(sparse.shape) != (NC,):
        raise ValueError("cb must match the bands' dtype, sparse be bool (NC,)")


# ---------------------------------------------------------------------------
# plain twin (CPU; the reference the kernel is held to on the card)
# ---------------------------------------------------------------------------

def sweep_plain(sb: SweepBands, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p,
                sparse, shrink, no_jump):
    """The kernel's function in torch ops: a loop over rows vectorised
    over every block and chain (the JAX package's `_sweep_gibbs_batched`,
    with all buckets zero-padded to one width), the same operations in
    the same order as the kernel. Updates dp in place; returns (new_beta,
    causal, postp_inc, beta_inc, dps) as (NC, m) and (h2_inc, gap) as
    (NC,)."""
    NC, m = cb.shape
    dt, dev = sb.dtype, sb.device
    beta, causal, postp_o, binc, dps_o, _, _ = _outputs(NC, m, dt, dev, 0)
    bands, g, Wm, Lm, src, dst = sb.merged()
    nblk, R, wk = bands.shape
    sh = torch.tensor(float(shrink), dtype=dt, device=dev)
    one_m_sh = 1 - sh
    iop, pc, spc = inv_odd_p[:, None], p[:, None], sparse[:, None]
    bh_s = _scatter_b(bh, g)
    c2_s, c4_s, s1_s = (_scatter_b(C2, g), _scatter_b(C4, g, 1.0),
                        _scatter_b(s1, g, 1.0))
    u_s, z_s, cb_s = (_scatter_b(u, g, 2.0), _scatter_b(z, g),
                      _scatter_b(cb, g))
    sc4 = torch.sqrt(c4_s)
    dpm = torch.zeros((NC, nblk * Lm), dtype=dt, device=dev)
    dpm[:, dst] = dp[:, src]
    dpm = dpm.view(NC, nblk, Lm)
    ys = torch.zeros((5, NC, nblk, R), dtype=dt, device=dev)
    h2 = torch.zeros((NC, nblk), dtype=dt, device=dev)
    gap = torch.zeros((NC, nblk), dtype=dt, device=dev)
    for j in range(sb.max_rows):
        dot = dpm[:, :, j + Wm]
        cbj = cb_s[:, :, j]
        res = bh_s[:, j] - sh * (dot - cbj)
        C3 = c2_s[:, :, j] * res
        postp = 1 / (1 + iop * s1_s[:, :, j]
                     * torch.exp(-C3 * C3 / c4_s[:, :, j] * 0.5))
        samp = C3 + z_s[:, :, j] * sc4[:, :, j]
        skip = spc & (postp < pc)
        jump = (samp * cbj < 0) if no_jump else torch.zeros_like(skip)
        sampled = (postp > u_s[:, :, j]) & ~skip & ~jump
        new_beta = torch.where(sampled, samp, 0.0)
        dps = sh * dot + one_m_sh * cbj
        diff = new_beta - cbj
        dpm[:, :, j:j + wk] += diff[:, :, None] * bands[None, :, j, :]
        h2 = h2 + diff * (2 * dps + diff)
        gap = gap + torch.where(sampled, samp * samp, 0.0)
        ys[0, :, :, j] = new_beta
        ys[1, :, :, j] = sampled.to(dt)
        ys[2, :, :, j] = torch.where(skip, 0.0, postp)
        ys[3, :, :, j] = torch.where(skip, 0.0, C3 * postp)
        ys[4, :, :, j] = dps
    dp[:, src] = dpm.reshape(NC, -1)[:, dst]
    for out, y in zip((beta, postp_o, binc, dps_o), ys[[0, 2, 3, 4]]):
        _gather_set(out, y, g)
    _gather_set(causal, ys[1] != 0, g)
    return beta, causal, postp_o, binc, dps_o, h2.sum(1), gap.sum(1)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def plan(sb: SweepBands, NC: int, max_smem: int):
    """(chains per CTA, threads per CTA, global dp) for a launch: as many
    chains as fit SMEM_TARGET bytes of dp (at least one, within the
    device's limit), and enough threads for one per chain and KMAX band
    columns each. A chain whose dp does not fit in `max_smem` bytes takes
    the global-dp mode, one chain a CTA."""
    sz = torch.empty((), dtype=sb.dtype).element_size()
    per_chain = (sb.Lmax + 1) * sz
    gdp = per_chain > max_smem
    nct = 1 if gdp else max(1, min(NC, max(SMEM_TARGET, per_chain)
                                   // per_chain, max_smem // per_chain, 1024))
    need = -(-sb.wkmax // KMAX)
    threads = max(-(-nct // 32) * 32, -(-need // 32) * 32, 32)
    if threads > 1024:
        raise ValueError(f"band width {sb.wkmax} exceeds the kernel's "
                         f"{1024 * KMAX} columns")
    return nct, threads, gdp


def _plan_for(sb, lib, NC):
    if NC not in sb.plans:
        dev_index = sb.device.index if sb.device.index is not None else \
            torch.cuda.current_device()
        sb.plans[NC] = plan(sb, NC, lib.gibbs_sweep_max_smem(dev_index))
    return sb.plans[NC]


def sweep(sb: SweepBands, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p,
          sparse, shrink, no_jump):
    """One Gibbs sweep over every block for NC chains (see `sweep_plain`
    for the outputs). CUDA tensors launch `gibbs_sweep_kernel`; CPU
    tensors take `sweep_plain`."""
    _check(sb, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p, sparse)
    if sb.device.type == "cpu":
        return sweep_plain(sb, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p,
                           sparse, shrink, no_jump)
    if sb.device.type != "cuda":
        raise ValueError(f"unsupported device {sb.device}")
    lib = _load()
    NC, m = cb.shape
    outs = _outputs(NC, m, sb.dtype, sb.device, sb.nblk)
    if sb.nblk == 0 or NC == 0:
        return outs[:5] + (outs[5].sum(1), outs[6].sum(1))
    nct, threads, gdp = _plan_for(sb, lib, NC)
    fn = lib.gibbs_sweep_f64 if sb.dtype == torch.float64 else \
        lib.gibbs_sweep_f32
    ptr = lambda t: t.data_ptr()  # noqa: E731
    rc = fn(ptr(sb.band), ptr(sb.blk_band), ptr(sb.blk_dp), ptr(sb.blk_gidx),
            ptr(sb.blk_rows), ptr(sb.blk_W), ptr(sb.blk_L), sb.nblk,
            ptr(sb.gidx), ptr(dp), sb.dp_len, ptr(cb), ptr(bh), ptr(C2),
            ptr(C4), ptr(s1), ptr(u), ptr(z), m, ptr(inv_odd_p), ptr(p),
            ptr(sparse), float(shrink), int(bool(no_jump)),
            *(ptr(t) for t in outs), NC, nct, sb.Lmax, threads, int(gdp),
            torch.cuda.current_stream(sb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gibbs_sweep launch failed: CUDA error {rc}")
    launches["sweep_global" if gdp else "sweep"] += 1
    return outs[:5] + (outs[5].sum(1), outs[6].sum(1))


# ---------------------------------------------------------------------------
# the lassosum mode
# ---------------------------------------------------------------------------

def _check_lasso(sb, dp, beta, bh, pf, lam, delta, active):
    NG, m = beta.shape
    if m != sb.m:
        raise ValueError(f"per-variant inputs have m={m}, bands {sb.m}")
    for name, t, shape in (("dp", dp, (NG, sb.dp_len)), ("beta", beta, None),
                           ("bh", bh, (m,)), ("pf", pf, (m,)),
                           ("lam", lam, (NG,)), ("delta", delta, (NG,))):
        if (shape is not None and tuple(t.shape) != shape) or \
                t.dtype != sb.dtype:
            raise ValueError(f"{name} must be {sb.dtype} {shape or (NG, m)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if active.dtype != torch.bool or tuple(active.shape) != (NG,):
        raise ValueError("active must be bool (NG,)")
    for t in (dp, beta, bh, pf, lam, delta, active):
        if t.device != sb.device:
            raise ValueError("every operand must be on the bands' device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def fma32(a, b, c):
    """Correctly rounded float32 a * b + c, one rounding as a fused
    multiply-add gives it, computed in float64: the product of two float32
    values is exact there, the sum is rounded to odd (its TwoSum error
    picks the odd neighbour when inexact; Boldo and Melquiond), and the
    final rounding to float32 is then the fused one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(e > 0, torch.inf, -torch.inf)
                           .to(torch.float64))
    return torch.where((e != 0) & even, away, s).to(torch.float32)


def _mul_add(a, b, c):
    """a * b + c as the lassosum mode rounds it: fused in float32 (the
    rounding of the JAX package's CPU programs, which contract these
    multiply-adds), two roundings in float64."""
    if c.dtype == torch.float32:
        return fma32(a, b, c)
    return c + a * b


def lassosum_sweep_plain(sb: SweepBands, dp, beta, bh, pf, lam, delta,
                         active):
    """The lassosum mode's function in torch ops: one coordinate-descent
    sweep of `lassosum_cd_blocked` (the JAX package's `sweep_bucket` step)
    for NG grid points, a loop over rows vectorised over every block and
    grid point, the same operations in the same order as the kernel. Per
    row j, with lam_j = pf_j lam and dp1_j = pf_j delta + 1 (two
    roundings, as the JAX package computes it outside its scan): u = bh -
    (dp[j + W] - cb); the soft threshold; shift = new - cb; dp[j..j + 2W]
    += shift * band row, a fused multiply-add in float32 (`_mul_add`).
    Grid points not `active` are left as they are. Updates dp and beta
    (NG, m) in place; returns gap (sum of new^2 over the non-zeros), df
    (int32 count of non-zeros) and maxshift, each (NG,), summed per block
    in row order and then over the blocks."""
    NG, m = beta.shape
    dt, dev = sb.dtype, sb.device
    bands, g, Wm, Lm, src, dst = sb.merged()
    nblk, R, wk = bands.shape
    valid = g >= 0
    one = torch.ones((), dtype=dt, device=dev)
    bh_s = _scatter_b(bh, g)
    pf_s = _scatter_b(pf, g)
    lam_s = torch.where(valid, pf_s[None] * lam[:, None, None], one)
    dp1_s = torch.where(valid, pf_s[None] * delta[:, None, None] + one, one)
    cb_s = _scatter_b(beta, g)
    act = active[:, None]
    dpm = torch.zeros((NG, nblk * Lm), dtype=dt, device=dev)
    dpm[:, dst] = dp[:, src]
    dpm = dpm.view(NG, nblk, Lm)
    new_s = torch.empty_like(cb_s)
    gap = torch.zeros((NG, nblk), dtype=dt, device=dev)
    df = torch.zeros((NG, nblk), dtype=torch.int32, device=dev)
    ms = torch.zeros((NG, nblk), dtype=dt, device=dev)
    for j in range(sb.max_rows):
        dot = dpm[:, :, j + Wm]
        cbj = cb_s[:, :, j]
        lamj = lam_s[:, :, j]
        u = bh_s[:, j] - (dot - cbj)
        nm = torch.where(u > 0, u - lamj, u + lamj)
        nb = torch.where(u * nm > 0, nm / dp1_s[:, :, j], 0.0)
        nb = torch.where(u.abs() > lamj, nb, 0.0)
        nb = torch.where(act, nb, cbj)
        shift = nb - cbj
        dpm[:, :, j:j + wk] = _mul_add(shift[:, :, None], bands[None, :, j, :],
                                       dpm[:, :, j:j + wk])
        nz = (nb != 0) & act
        gap = gap + torch.where(nz, nb * nb, 0.0)
        df = df + nz
        ms = torch.maximum(ms, shift.abs())
        new_s[:, :, j] = nb
    dp[:, src] = dpm.reshape(NG, -1)[:, dst]
    _gather_set(beta, new_s, g)
    return gap.sum(1), df.sum(1, dtype=torch.int32), ms.amax(1)


def lassosum_sweep(sb: SweepBands, dp, beta, bh, pf, lam, delta, active):
    """One lassosum2 sweep over every block for NG grid points (see
    `lassosum_sweep_plain` for the arguments and outputs). CUDA tensors
    launch `gibbs_sweep_kernel`'s lassosum mode; CPU tensors take
    `lassosum_sweep_plain`."""
    _check_lasso(sb, dp, beta, bh, pf, lam, delta, active)
    if sb.device.type == "cpu":
        return lassosum_sweep_plain(sb, dp, beta, bh, pf, lam, delta, active)
    if sb.device.type != "cuda":
        raise ValueError(f"unsupported device {sb.device}")
    lib = _load()
    NG, m = beta.shape
    dev = sb.device
    gap = torch.zeros((NG, sb.nblk), dtype=sb.dtype, device=dev)
    df = torch.zeros((NG, sb.nblk), dtype=torch.int32, device=dev)
    ms = torch.zeros((NG, sb.nblk), dtype=sb.dtype, device=dev)
    if sb.nblk == 0 or NG == 0:
        return gap.sum(1), df.sum(1, dtype=torch.int32), ms.amax(1)
    nct, threads, gdp = _plan_for(sb, lib, NG)
    fn = lib.lassosum_sweep_f64 if sb.dtype == torch.float64 else \
        lib.lassosum_sweep_f32
    ptr = lambda t: t.data_ptr()  # noqa: E731
    rc = fn(ptr(sb.band), ptr(sb.blk_band), ptr(sb.blk_dp), ptr(sb.blk_gidx),
            ptr(sb.blk_rows), ptr(sb.blk_W), ptr(sb.blk_L), sb.nblk,
            ptr(sb.gidx), ptr(dp), sb.dp_len, ptr(beta), ptr(bh), ptr(pf), m,
            ptr(lam), ptr(delta), ptr(active), ptr(gap), ptr(df), ptr(ms),
            NG, nct, sb.Lmax, threads, int(gdp),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lassosum_sweep launch failed: CUDA error {rc}")
    launches["lassosum_global" if gdp else "lassosum"] += 1
    return gap.sum(1), df.sum(1, dtype=torch.int32), ms.amax(1)
