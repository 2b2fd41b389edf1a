"""The Gibbs sweep: the CUDA kernel that replaces K3, K4, K5 and the
JAX package's XLA sweeps, its plain-torch twin, and the banded LD operand
they share.

Counterpart of `bigsnpr_tpu/pgs/gibbs_pallas.py` (`sweep_bucket_pallas`,
`sweep_bucket_pallas_mc`, `sweep_bucket_pallas_v3`), of the XLA twin
`gibbs_blocked._sweep_gibbs_batched` and of the unblocked samplers'
`_sweep_gibbs`: one lockstep LDpred2 Gibbs sweep over every LD block for
NC chains. The kernel is `gibbs_ring_kernel` in `csrc/gibbs_sweep.cu`,
built with nvcc at first use into `_build/` and loaded with ctypes
(`ops/cuda_build.py`). `sweep` launches it for CUDA tensors and counts
the launch in `launches["sweep"]`, or in `launches["sweep_global"]` on a
band of one block (the unblocked samplers' band over every variant); for
CPU tensors it runs `sweep_plain`. There is no fallback from a CUDA
tensor to the twin.

One kernel serves every band. Each chain keeps only its 2W + 1 live dp
entries, in a ring in shared memory (dp itself stays in device memory),
with one warp a chain running the rows 32 at a time and 256 threads
applying each tile's diffs to the rest of the window one tile behind,
each band value they load applied to every chain of the CTA. A CTA runs
one block's chain tile; `plan` picks the chains a CTA (a launch fills
about RING_CTAS CTAs, at most RING_MAX_CHAINS chains each, RING_NARROW in
the lassosum mode), the ring, the
band stages, and `SweepBands` the block order (longest first, a block's
chain tiles side by side).

The kernel's lassosum mode (`lassosum_sweep`, twin `lassosum_sweep_plain`,
counts `launches["lassosum"]` and `"lassosum_global"`) runs one
deterministic lassosum2 coordinate-descent sweep with the same skeleton, a
grid point in place of a chain: the port of the JAX package's XLA
`lassosum_cd_blocked` and `lassosum_cd` sweeps. Frozen grid points are
skipped.

Bound: a sweep reads the band once (bytes: band plus the per-row inputs
and outputs), but the rows of a block are a chain of dependent steps, so
at these sizes the longest block's rows x one row's latency (the row
floor) and the card's issue rate over every (chain, row) bound a sweep.

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
from typing import NamedTuple

import numpy as np
import torch

from bigsnpr_tpu_torch.ops import cuda_build

SOURCE = cuda_build.PKG / "csrc" / "gibbs_sweep.cu"
EXTRA_FLAGS = ("--fmad=false",)
# gibbs_sweep.cu's RK, RNU, RSTRIPS, RNARROW, RMAXC, RKE, RSR, RSTAGES
RING_ROWS = 32           # rows a tile, one a lane of a chain's row warp
RING_UPDATE = 256        # update threads a CTA
RING_STRIPS = 3          # strip buffers of the row warps' band values
RING_NARROW = 3          # chains a CTA of the narrow instantiation
RING_MAX_CHAINS = 7      # chains a CTA at most (the wide instantiation;
                         # the lassosum mode takes the narrow one only)
RING_ENTRIES = 4         # entries of a tile an update thread takes at most
RING_STAGE_ROWS = 8      # band rows a stage
RING_STAGES = 4          # band stages (a tile's rows)
BAND_PAD = 80            # zeros after the band arena: the bulk copies take
                         # whole 16-byte chunks and a strip row 64 + V values
RING_CTAS = 128          # CTAs a launch aims at (~ an H100's 132 SMs)
SCHED_REGS = 16384       # 32-bit registers of each of an SM's 4 schedulers

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
                       + [p] * 3 + [f64, i32] + [p] * 7 + [i32] * 5
                       + [i64, p])
        fn.restype = i32
    for fn in (lib.lassosum_sweep_f32, lib.lassosum_sweep_f64):
        fn.argtypes = ([p] * 7 + [i32, p, p, i64] + [p] * 3 + [i64]
                       + [p] * 6 + [i32] * 5 + [i64, p])
        fn.restype = i32
    lib.gibbs_sweep_max_smem.argtypes = [i32]
    lib.gibbs_sweep_max_smem.restype = i32


def _load():
    return cuda_build.load(SOURCE, _bind, extra=EXTRA_FLAGS)


class SweepBands:
    """Every bucket of a `BlockBands` on one device: a flat band arena
    (and BAND_PAD zeros after it) with per-block offset tables and the
    kernel's block order, longest block first (the kernel's operand), and
    per-bucket views (the twin's).

    buckets: list of host (bands (Bk, mbk, 2W+1), gidx (Bk, mbk)) with
    gidx the global variant of each slot (-1 at padding, valid slots a
    prefix of each block)."""

    def __init__(self, buckets, m, device, dtype=torch.float32):
        self.m = int(m)
        self.device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        self.dtype = dtype
        band_parts, gidx_parts, self.views = [], [], []
        blk_band, blk_dp, blk_gidx, blk_rows, blk_W = ([] for _ in range(5))
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
        self.band = torch.cat(band_parts + [torch.zeros(
            BAND_PAD, dtype=dtype, device=dev)])
        self.gidx = (torch.cat(gidx_parts) if gidx_parts
                     else torch.zeros(0, dtype=torch.int32, device=dev))
        i64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
        i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        self.blk_band, self.blk_dp, self.blk_gidx = (i64(blk_band),
                                                     i64(blk_dp),
                                                     i64(blk_gidx))
        self.blk_rows, self.blk_W = i32(blk_rows), i32(blk_W)
        # longest first, so that the longest blocks' chains start first
        self.order = np.argsort(-np.asarray(blk_rows, np.int64),
                                kind="stable").astype(np.int32)
        self.blk_order = i32(self.order)
        self.nblk = nblk
        self.dp_len = dp_off
        self.wkmax = max((2 * w + 1 for w in blk_W), default=1)
        self.max_rows = max(blk_rows, default=0)
        self.plans = {}  # plan_key(NC, lasso) -> SweepPlan
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

def sweep_step(dot, cbj, bhj, c2j, c4j, s1j, uj, zsj, iop, pc, spc, sh,
               one_m_sh, no_jump):
    """One row's scalar step for every chain (and block), from its dp entry
    `dot` = dp[j + W]: the kernel's operations in its order. zsj = z
    sqrt(C4); iop, pc, spc the chains' inv_odd_p, p and sparse flags, shaped
    to broadcast. Returns (diff, new_beta, sampled, sparse skip, postp, C3,
    dps, samp)."""
    res = bhj - sh * (dot - cbj)
    C3 = c2j * res
    postp = 1 / (1 + iop * s1j * torch.exp(-C3 * C3 / c4j * 0.5))
    samp = C3 + zsj
    skip = spc & (postp < pc)
    jump = (samp * cbj < 0) if no_jump else torch.zeros_like(skip)
    sampled = (postp > uj) & ~skip & ~jump
    new_beta = torch.where(sampled, samp, 0.0)
    dps = sh * dot + one_m_sh * cbj
    return new_beta - cbj, new_beta, sampled, skip, postp, C3, dps, samp


def sweep_plain(sb: SweepBands, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p,
                sparse, shrink, no_jump, per_block=False):
    """The kernel's function in torch ops: a loop over rows vectorised
    over every block and chain (the JAX package's `_sweep_gibbs_batched`,
    with all buckets zero-padded to one width), the same operations in
    the same order as the kernel. Updates dp in place; returns (new_beta,
    causal, postp_inc, beta_inc, dps) as (NC, m) and (h2_inc, gap) as
    (NC,), or with per_block as (NC, nblk), a value a block."""
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
        cbj = cb_s[:, :, j]
        diff, new_beta, sampled, skip, postp, C3, dps, samp = sweep_step(
            dpm[:, :, j + Wm], cbj, bh_s[:, j], c2_s[:, :, j],
            c4_s[:, :, j], s1_s[:, :, j], u_s[:, :, j],
            z_s[:, :, j] * sc4[:, :, j], iop, pc, spc, sh, one_m_sh, no_jump)
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
    if per_block:
        return beta, causal, postp_o, binc, dps_o, h2, gap
    return beta, causal, postp_o, binc, dps_o, h2.sum(1), gap.sum(1)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

class SweepPlan(NamedTuple):
    """A launch of `gibbs_ring_kernel`: chains a CTA, threads a CTA, the
    ring's slots a chain, the values a row of a band stage holds (0: the
    update threads read the band in place) and the dynamic shared memory
    in bytes."""
    nct: int
    threads: int
    ring_len: int
    stage: int
    smem: int


def ring_smem_bytes(nct: int, ring_len: int, elem: int, stage: int = 0
                    ) -> int:
    """The kernel's dynamic shared memory (gibbs_sweep.cu's
    `ring_smem_bytes`): 128 B of mbarriers, nct rings of `ring_len`
    values, RING_STRIPS strips of 32 rows x (64 + V) values (V a 16-byte
    chunk), two tiles of diffs and partial terms a chain, and with `stage`
    values a row, RING_STAGES band stages of RING_STAGE_ROWS rows and 32
    values of slack."""
    V = 16 // elem
    return (128 + nct * ring_len * elem
            + RING_STRIPS * RING_ROWS * (2 * RING_ROWS + V) * elem
            + 6 * nct * RING_ROWS * elem
            + ((RING_STAGES * RING_STAGE_ROWS * stage + RING_ROWS) * elem
               if stage else 0))


def ring_capacity(nct: int) -> int:
    """The chains a CTA of the instantiation that runs nct chains a CTA:
    RING_NARROW up to that many, else RING_MAX_CHAINS."""
    return RING_NARROW if nct <= RING_NARROW else RING_MAX_CHAINS


def ring_threads(nct: int) -> int:
    """Threads of a CTA: a row warp a chain, RING_UPDATE update threads and
    a producer warp."""
    return 32 * nct + RING_UPDATE + 32


def ring_regs(nct: int) -> int:
    """The registers a thread may use under the launch bound of nct's
    instantiation, one CTA of its full thread count an SM: its warps go
    to the SM's 4 schedulers in turn, each with SCHED_REGS registers, in
    ptxas' steps of 8: 168 for the narrow one (12 warps), 128 for the
    wide one (16)."""
    warps = ring_threads(ring_capacity(nct)) // 32
    return SCHED_REGS // (32 * -(-warps // 4)) // 8 * 8


def ring_len_for(W: int) -> int:
    """Ring slots a chain for half-width W: a power of two (at least
    RING_UPDATE, so that entry e keeps update thread e mod 256 and slot e
    mod len) holding A + 64 entries, A = W + 32 + max(W, 32): tile t reads
    and writes entries below 32 t + A, and the entries 32 t - 64 .. 32 t
    - 1 may not be written back yet."""
    K = RING_ROWS
    need = W + K + max(W, K) + 2 * K
    return max(RING_UPDATE, 1 << (need - 1).bit_length())


def plan(sb: SweepBands, NC: int, max_smem: int, lasso: bool = False
         ) -> SweepPlan:
    """The launch for NC chains on `sb` (its widest band and its number of
    blocks), given the device's `max_smem` bytes of shared memory a block.
    Chains a CTA: enough that the launch's nblk x NC (block, chain) pairs
    make about RING_CTAS CTAs, at least one and at most RING_MAX_CHAINS
    (RING_NARROW for the lassosum mode, `lasso`: its float32 code spills
    at the wide instantiation's registers) (more chains a CTA share each
    band value the update threads load, and
    keep more row warps an SM; fewer give the update threads less to do a
    tile: slice 5's one band at LDpred2-auto's 30 chains and lassosum2's
    120 grid points takes one a CTA, slice 2's 67 blocks at 30 chains
    six, slice 4's 42 at 120 points three), spread evenly over the chain
    tiles, fewer if the shared memory
    runs out. The band comes through RING_STAGES stages of RING_STAGE_ROWS
    rows (each row from the 16-byte chunk of its start: 2W + V values
    rounded up to V) where they still fit and a tile's 2W + 32 entries are
    at most RING_ENTRIES an update thread, else the update threads read it
    in place. Raises ValueError on a band whose ring does not fit with one
    chain."""
    sz = torch.empty((), dtype=sb.dtype).element_size()
    W = (sb.wkmax - 1) // 2
    S = ring_len_for(W)
    cap = RING_NARROW if lasso else RING_MAX_CHAINS
    nct = max(1, min(NC, cap, -(-NC * sb.nblk // RING_CTAS)))
    nct = -(-NC // -(-NC // nct))      # the same tiles, chains spread evenly
    while nct > 1 and ring_smem_bytes(nct, S, sz) > max_smem:
        nct -= 1
    smem = ring_smem_bytes(nct, S, sz)
    if smem > max_smem:
        raise ValueError(
            f"band half-width {W} needs a ring of {S} slots a chain, "
            f"{smem} B of shared memory with one chain a CTA: more than the "
            f"{max_smem} B a block may use")
    V = 16 // sz
    stage = -(-(2 * W + V) // V) * V
    if 2 * W + RING_ROWS > RING_ENTRIES * RING_UPDATE or \
            ring_smem_bytes(nct, S, sz, stage) > max_smem:
        stage = 0
    return SweepPlan(nct, ring_threads(nct), S, stage,
                     ring_smem_bytes(nct, S, sz, stage))


def max_smem(device) -> int:
    """The shared memory a block may use on `device` (bytes)."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _load().gibbs_sweep_max_smem(index)


def plan_key(NC: int, lasso: bool = False):
    """The key of a launch's plan in `SweepBands.plans`: NC for the
    LDpred2 sweep, ("lassosum", NC) for the lassosum mode."""
    return ("lassosum", NC) if lasso else NC


def _plan_for(sb, NC, lasso=False):
    key = plan_key(NC, lasso)
    if key not in sb.plans:
        sb.plans[key] = plan(sb, NC, max_smem(sb.device), lasso)
    return sb.plans[key]


def sweep(sb: SweepBands, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p,
          sparse, shrink, no_jump, per_block=False):
    """One Gibbs sweep over every block for NC chains (see `sweep_plain`
    for the outputs). CUDA tensors launch `gibbs_ring_kernel`; CPU
    tensors take `sweep_plain`."""
    _check(sb, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p, sparse)
    if sb.device.type == "cpu":
        return sweep_plain(sb, dp, cb, bh, C2, C4, s1, u, z, inv_odd_p, p,
                           sparse, shrink, no_jump, per_block)
    if sb.device.type != "cuda":
        raise ValueError(f"unsupported device {sb.device}")
    lib = _load()
    NC, m = cb.shape
    outs = _outputs(NC, m, sb.dtype, sb.device, sb.nblk)
    if sb.nblk == 0 or NC == 0:
        return outs[:5] + ((outs[5], outs[6]) if per_block
                           else (outs[5].sum(1), outs[6].sum(1)))
    pl = _plan_for(sb, NC)
    fn = lib.gibbs_sweep_f64 if sb.dtype == torch.float64 else \
        lib.gibbs_sweep_f32
    ptr = lambda t: t.data_ptr()  # noqa: E731
    with torch.cuda.device(sb.device):  # the launch goes to the current card
        rc = fn(ptr(sb.band), ptr(sb.blk_band), ptr(sb.blk_dp),
                ptr(sb.blk_gidx), ptr(sb.blk_rows), ptr(sb.blk_W),
                ptr(sb.blk_order), sb.nblk, ptr(sb.gidx), ptr(dp), sb.dp_len,
                ptr(cb), ptr(bh), ptr(C2), ptr(C4), ptr(s1), ptr(u), ptr(z),
                m, ptr(inv_odd_p), ptr(p), ptr(sparse), float(shrink),
                int(bool(no_jump)), *(ptr(t) for t in outs), NC, pl.nct,
                pl.threads, pl.ring_len, pl.stage, sb.band.numel(),
                torch.cuda.current_stream(sb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gibbs_sweep launch failed: CUDA error {rc}")
    launches["sweep_global" if sb.nblk == 1 else "sweep"] += 1
    if per_block:
        return outs
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


def lasso_step(dot, cbj, bhj, lamj, dp1j):
    """One row's coordinate-descent step of the lassosum mode for every
    grid point (and block), from dp[j + W] = `dot`: the soft-thresholded
    new beta, the kernel's operations in its order."""
    u = bhj - (dot - cbj)
    nm = torch.where(u > 0, u - lamj, u + lamj)
    nb = torch.where(u * nm > 0, nm / dp1j, 0.0)
    return torch.where(u.abs() > lamj, nb, 0.0)


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
        cbj = cb_s[:, :, j]
        nb = lasso_step(dpm[:, :, j + Wm], cbj, bh_s[:, j], lam_s[:, :, j],
                        dp1_s[:, :, j])
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
    launch `gibbs_ring_kernel`'s lassosum mode; CPU tensors take
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
    pl = _plan_for(sb, NG, lasso=True)
    fn = lib.lassosum_sweep_f64 if sb.dtype == torch.float64 else \
        lib.lassosum_sweep_f32
    ptr = lambda t: t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):        # the launch goes to the current card
        rc = fn(ptr(sb.band), ptr(sb.blk_band), ptr(sb.blk_dp),
                ptr(sb.blk_gidx), ptr(sb.blk_rows), ptr(sb.blk_W),
                ptr(sb.blk_order), sb.nblk, ptr(sb.gidx), ptr(dp), sb.dp_len,
                ptr(beta), ptr(bh), ptr(pf), m, ptr(lam), ptr(delta),
                ptr(active), ptr(gap), ptr(df), ptr(ms), NG, pl.nct,
                pl.threads, pl.ring_len, pl.stage, sb.band.numel(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lassosum_sweep launch failed: CUDA error {rc}")
    launches["lassosum_global" if sb.nblk == 1 else "lassosum"] += 1
    return gap.sum(1), df.sum(1, dtype=torch.int32), ms.amax(1)
