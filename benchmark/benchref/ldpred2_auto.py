"""Plain reference for the LDpred2-auto cell (torch, numpy and scipy only).

It builds on `benchref.ldpred2`: the set-up worked out again from the
benchmark's bytes (`derive`), the lanes and bands, the chains' Philox
generators and draws, and the row sweep (`Sweeper`). To that it adds
LDpred2-auto, following src/ldpred2-auto.cpp as the port cites it:

- the sweep with `shrink_corr` (the LD's off-diagonal entries times it)
  and, without `allow_jump_sign`, no sampled effect of the other sign
  than the current one;
- the h2 estimate: a running sum of each sweep's increment,
  sum_j diff_j (2 dps_j + diff_j), dps_j the shrunk LD product at row j,
  floored at 1e-3 where it is reported;
- p ~ Beta(1 + nb / mean_ld, 1 + (m - nb) / mean_ld), nb the sampled
  (causal) variants, clipped to p_bounds;
- Poisson(1) weights on the causal variants (the bootstrap of the MLE);
- the MLE of (alpha + 1, sigma2) on the weighted causal set, alpha + 1
  in alpha_bounds + 1 and sigma2 in [sigma2 / 2, 2 sigma2] around the
  last sigma2; the next sweep's prior variance is
  sigma2 exp((alpha + 1) log_var);
- the divergence rule: a chain whose sampled effects' squares sum past
  2 sum(beta_hat^2) in a sweep has diverged; it stops updating, its
  averages stop, and its results are NaN;
- averages over the num_iter sweeps after the burn-in only;
- the vignette's chain QC (corr_est's range over 0.95 times the 0.95
  quantile of the ranges) and the mean of the kept chains.

Departures, each where the port departs from R, followed here so that
the reference and the program draw the same numbers:

- a sweep draws, per chain, m + 16 + m uniforms then m + 2 normals: the
  sweep's m and m, 16 uniforms and 2 normals for p, m uniforms for the
  weights;
- p's Beta draw is G1 / (G1 + G2), each Gamma by Wilson-Hilferty at shape
  a + 8 with the shape boost U^(1 / (a + i)), i < 8, in place of rbeta;
- Poisson(1) by the inverse CDF of a uniform, the CDF rounded to float32,
  the uniforms' precision;
- the MLE: R runs L-BFGS-B on (alpha + 1, sigma2) in their box. For a
  fixed alpha + 1 the best sigma2 is closed-form (clipped to its box), and
  the profile over alpha + 1 is convex (f is convex in alpha + 1 and
  log sigma2 jointly, and a partial minimum over a convex set keeps it
  convex), so its minimum in the box is found by a golden-section search
  to ~1e-12. The port searches a grid instead. With no weighted causal
  variant the profile is flat and alpha is not compared.

`judge` replays a program's run from what it returns with
`state_sweeps` (`kept_sweeps`): every sweep of every chain, on the
program's draws, with the program's p, sigma2 and alpha of the sweep
before fed in, each segment between kept sweeps restarted from the
program's kept state. `run_auto` runs LDpred2-auto whole, each sweep's
update its own: with `dtype=torch.bfloat16` it is the control, the
reference one precision below the program's float32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchref.ldpred2 import Sweeper, chain_generators, draw

MIN_H2 = 1e-3
# the Poisson(1) CDF to 16, in float32
POIS1_CDF = np.cumsum(np.exp(-1) / np.cumprod(
    np.r_[1.0, np.arange(1.0, 17.0)])).astype(np.float32)
GOLDEN = (np.sqrt(5.0) - 1) / 2
MLE_ITERS = 60

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def kept_sweeps(total: int, segment: int) -> list:
    """The sweeps whose states a checked run keeps: 0, then k S - 1 and
    k S for k >= 1, and the last, within [0, total). Each pair (k - 1, k)
    gives the program's exact state before and after sweep k."""
    ks = {0, total - 1}
    for k in range(segment, total, segment):
        ks |= {k - 1, k}
    return sorted(k for k in ks if 0 <= k < total)


def segments(kept, total: int) -> list:
    """(first, last) sweeps of the replay's segments: from 0, and from
    after each kept sweep, to the next kept sweep."""
    out, a = [], 0
    for b in kept:
        if b >= a:
            out.append((a, b))
            a = b + 1
    if a < total:
        raise ValueError("the last sweep must be kept")
    return out


def ld_product(lanes, band, x):
    """R x for each chain's (NC, m) x in float64, R the in-block LD with
    its unit diagonal."""
    W = (band.shape[-1] - 1) // 2
    wk = 2 * W + 1
    xs = lanes.scatter(x)                                     # (R, NC, B)
    acc = torch.zeros((x.shape[0], lanes.B, lanes.R + 2 * W),
                      dtype=torch.float64, device=x.device)
    for j in range(lanes.R):
        acc[:, :, j:j + wk].addcmul_(xs[j].unsqueeze(-1),
                                     band[:, j].unsqueeze(0))
    return lanes.gather(acc[:, :, W:W + lanes.R].permute(2, 0, 1))


class AutoSweeper(Sweeper):
    """`Sweeper` with the no-jump rule, and each row's LD product kept
    (`D`) for the h2 increment."""

    def __init__(self, lanes, band, NC, dtype=torch.float64, no_jump=False):
        super().__init__(lanes, band, NC, dtype)
        self.D = torch.zeros_like(self.A)
        self.no_jump = bool(no_jump)

    def _rows(self):
        W, wk, band, dp = self.W, 2 * self.W + 1, self.band, self.dp
        for j in range(self.L.R):
            dot = dp[:, :, j + W]
            self.D[j].copy_(dot)
            torch.addcmul(self.A[j], self.Bc[j], dot, out=self.C3[j])
            torch.add(self.C3[j], self.zs[j], out=self.S[j])
            torch.gt(self.C3[j] * self.C3[j], self.T[j], out=self.OK[j])
            if self.no_jump:
                self.OK[j] &= self.S[j] * self.cb[j] >= 0
            torch.mul(self.S[j], self.OK[j], out=self.NB[j])
            diff = self.NB[j] - self.cb[j]
            dp[:, :, j:j + wk].addcmul_(diff.unsqueeze(-1),
                                        band[:, j].unsqueeze(0))

    def load(self, curr):
        """dp for the chains' current effects (NC, m)."""
        W, R = self.W, self.L.R
        self.dp.zero_()
        rx = ld_product(self.L, self.band.double(), curr)
        self.dp[:, :, W:W + R] = self.L.scatter(rx).permute(1, 2, 0).to(
            self.dt)

    def sweep_auto(self, cb, bh, C2, C4, s1, u, z, iop, shrink):
        """One sweep of every chain from the effects cb (NC, m): the new
        effects `nb`, `causal`, and per variant `postp`, `binc` (C3 postp)
        and `dps`; per chain `h2_inc` and the divergence `gap`. Float64
        out, whatever the sweep's dtype."""
        L, dt = self.L, self.dt
        sh = float(shrink)
        K = iop[:, None] * s1
        T = 2 * C4 * torch.log(K / (1 / u - 1))
        self.A.copy_(L.scatter(C2 * (bh[None] + sh * cb)).to(dt))
        self.Bc.copy_(L.scatter(-sh * C2).to(dt))
        self.T.copy_(L.scatter(T, float("nan")).to(dt))
        self.zs.copy_(L.scatter(z * torch.sqrt(C4)).to(dt))
        self.cb.copy_(L.scatter(cb).to(dt))
        self._run_rows()
        g = lambda y: L.gather(y.double())  # noqa: E731
        C3, nb, samp, dot, cbr = (g(self.C3), g(self.NB), g(self.S),
                                  g(self.D), g(self.cb))
        ok = L.gather(self.OK)
        postp = 1 / (1 + K * torch.exp(-C3 * C3 / C4 * 0.5))
        dps = sh * dot + (1 - sh) * cbr
        diff = nb - cbr
        return {"nb": nb, "causal": ok, "postp": postp, "binc": C3 * postp,
                "dps": dps, "h2_inc": (diff * (2 * dps + diff)).sum(1),
                "gap": torch.where(ok, samp * samp, 0.0).sum(1)}


# --------------------------------------------------------------------------
# the chain-wide update
# --------------------------------------------------------------------------

def gamma_wh(z, boost_u, a):
    """Gamma(a): Wilson-Hilferty at a + 8, then U^(1 / (a + i))."""
    ab = a + 8.0
    c = 1.0 / (9.0 * ab)
    g = torch.clamp(ab * (1.0 - c + z * torch.sqrt(c)) ** 3, min=1e-30)
    for i in range(8):
        g = g * boost_u[:, i] ** (1.0 / (a + i))
    return g


def beta_draw(z2, u1, u2, a, b):
    g1, g2 = gamma_wh(z2[:, 0], u1, a), gamma_wh(z2[:, 1], u2, b)
    return g1 / (g1 + g2)


def poisson1(u):
    """Poisson(1) by the inverse CDF: the CDF's entries below u."""
    cdf = torch.as_tensor(POIS1_CDF.astype(np.float64), device=u.device)
    k = torch.zeros_like(u)
    for c in cdf:
        k += (u > c).to(u.dtype)
    return k


def mle(s_prev, wts, lv, beta2, bounds, iters=MLE_ITERS):
    """(alpha + 1, sigma2) minimizing f(a, s) = a sum_a + nb log s +
    sum_c(a) / s, sum_a = sum w lv, sum_c(a) = sum w beta^2 exp(-a lv),
    nb = sum w, over a in `bounds` and s in [s_prev / 2, 2 s_prev]: the
    closed-form s at each a, and a by golden section on the convex
    profile. Every chain at once, in the inputs' dtype."""
    nb = wts.sum(1)
    sum_a = (wts * lv).sum(1)
    wb = wts * beta2
    s_lo, s_hi = s_prev / 2, s_prev * 2

    def prof(a):
        sum_c = (wb * torch.exp(-a[:, None] * lv)).sum(1)
        s = torch.minimum(torch.maximum(sum_c / torch.clamp(nb, min=1.0),
                                        s_lo), s_hi)
        return a * sum_a + nb * torch.log(s) + sum_c / s, s

    lo = torch.full_like(nb, float(bounds[0]))
    hi = torch.full_like(nb, float(bounds[1]))
    x1, x2 = hi - GOLDEN * (hi - lo), lo + GOLDEN * (hi - lo)
    f1, f2 = prof(x1)[0], prof(x2)[0]
    for _ in range(iters):
        left = f1 < f2                  # the minimum lies in [lo, x2]
        lo, hi = torch.where(left, lo, x1), torch.where(left, x2, hi)
        xn = torch.where(left, hi - GOLDEN * (hi - lo),
                         lo + GOLDEN * (hi - lo))
        fn = prof(xn)[0]
        x1, x2 = torch.where(left, xn, x2), torch.where(left, x1, xn)
        f1, f2 = torch.where(left, fn, f2), torch.where(left, f1, fn)
    a = 0.5 * (lo + hi)
    return a, prof(a)[1]


class Consts:
    """A run's fixed inputs on the bands' device, float64: beta_hat,
    n_eff, log_var, the divergence threshold, mean_ld, the settings."""

    def __init__(self, R, shrink, no_jump, p_bounds, alpha_bounds):
        dev = R["band"].device
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
        self.dev, self.m = dev, R["lanes"].m
        self.bh, self.nv, self.lv = (t(R["beta_hat"]), t(R["n_eff"]),
                                     t(R["log_var"]))
        self.scale = t(R["scale"])
        self.gap0 = 2 * (self.bh * self.bh).sum()
        self.mean_ld = float(R["mean_ld"])
        self.shrink, self.no_jump = float(shrink), bool(no_jump)
        self.p_bounds = tuple(float(b) for b in p_bounds)
        self.a_bounds = tuple(float(b) + 1 for b in alpha_bounds)

    def start(self, p_init, h2_init):
        """The parameters of sweep 0: p, sigma2 and alpha + 1."""
        p = torch.clamp(torch.as_tensor(np.asarray(p_init, np.float64),
                                        device=self.dev), *self.p_bounds)
        return p, max(float(h2_init), MIN_H2) / (self.m * p), \
            torch.zeros_like(p)

    def sweep(self, sw, curr, p, s, a1, U, Z):
        m = self.m
        C1 = torch.exp(a1[:, None] * self.lv[None]) * (s[:, None]
                                                        * self.nv[None])
        C2 = 1 / (1 + 1 / C1)
        C4, s1 = C2 / self.nv[None], torch.sqrt(1 + C1)
        return sw.sweep_auto(curr, self.bh, C2, C4, s1, U[:, :m], Z[:, :m],
                             (1 - p) / p, self.shrink)

    def update(self, nb, causal, h2_inc, h2_run, s_prev, U, Z, dtype):
        """The chain-wide step after a sweep, from its new effects nb,
        causal set and h2 increment: (p, the running h2, h2, alpha + 1,
        sigma2), computed in `dtype`, returned in float64."""
        m = self.m
        c = lambda x: x.to(dtype)  # noqa: E731
        U, Z = c(U), c(Z)
        nbc = c(causal.sum(1).double())
        p = beta_draw(Z[:, m:m + 2], U[:, m:m + 8], U[:, m + 8:m + 16],
                      1 + nbc / self.mean_ld, 1 + (m - nbc) / self.mean_ld)
        p = torch.clamp(p, *self.p_bounds)
        h2_run = c(h2_run) + c(h2_inc)
        h2 = torch.clamp(h2_run, min=MIN_H2)
        wts = poisson1(U[:, m + 16:]) * c(causal.double())
        a1, s = mle(c(s_prev), wts, c(self.lv), c(nb) * c(nb),
                    self.a_bounds)
        return tuple(x.double() for x in (p, h2_run, h2, a1, s))


# --------------------------------------------------------------------------
# the whole run (the control), and the replay of a program's run
# --------------------------------------------------------------------------

def run_auto(R, p_init, h2_init, seed, burn_in, num_iter, shrink, no_jump,
             p_bounds, alpha_bounds, kept, dtype=torch.bfloat16):
    """LDpred2-auto whole, each sweep's update its own, with the
    program's draws of job seed `seed`: the sweep and the update in
    `dtype`, the sums in float64. Returns what `judge` reads of a
    program's run: a dict of numpy arrays over the chains."""
    C = Consts(R, shrink, no_jump, p_bounds, alpha_bounds)
    NC, m, T = len(p_init), C.m, burn_in + num_iter
    dev = C.dev
    sw = AutoSweeper(R["lanes"], R["band"], NC, dtype, no_jump)
    gens = chain_generators(seed, NC, dev)
    p, s, a1 = C.start(p_init, h2_init)
    h2_run = torch.zeros(NC, dtype=torch.float64, device=dev)
    curr = torch.zeros((NC, m), dtype=torch.float64, device=dev)
    sums = torch.zeros((3, NC, m), dtype=torch.float64, device=dev)
    div = torch.zeros(NC, dtype=torch.bool, device=dev)
    paths = torch.full((4, NC, T), torch.nan, dtype=torch.float64,
                       device=dev)
    slot = {k: i for i, k in enumerate(kept)}
    states = torch.zeros((NC, len(kept), 4, m), dtype=torch.float64,
                         device=dev)
    st_h2 = torch.zeros((NC, len(kept)), dtype=torch.float64, device=dev)
    for k in range(T):
        U, Z = draw(gens, 2 * m + 16, m + 2, dev)
        out = C.sweep(sw, curr, p, s, a1, U, Z)
        if k >= burn_in:
            sums += torch.where(~div[:, None], torch.stack(
                [out["binc"], out["postp"], out["dps"]]), 0.0)
        div2 = div | (out["gap"] > C.gap0)
        p2, h2r2, h2, a12, s2 = C.update(out["nb"], out["causal"],
                                         out["h2_inc"], h2_run, s, U, Z,
                                         dtype)
        ok = ~div
        p, h2_run = torch.where(ok, p2, p), torch.where(ok, h2r2, h2_run)
        a1, s = torch.where(ok, a12, a1), torch.where(ok, s2, s)
        paths[:, :, k] = torch.where(div2[None], torch.nan,
                                     torch.stack([p2, h2, a12 - 1, s2]))
        curr, div = out["nb"], div2
        if k in slot:
            states[:, slot[k]] = torch.stack([curr, *sums], dim=1)
            st_h2[:, slot[k]] = h2_run
    nan = torch.where(div[:, None], torch.nan, 0.0)
    res = {"path_p_est": paths[0], "path_h2_est": paths[1],
           "path_alpha_est": paths[2], "path_sigma2_est": paths[3],
           "state_beta": states[:, :, 0], "state_sum_beta": states[:, :, 1],
           "state_sum_postp": states[:, :, 2],
           "state_sum_corr": states[:, :, 3], "state_h2": st_h2,
           "beta_est": (sums[0] / num_iter + nan) * C.scale[None],
           "postp_est": sums[1] / num_iter + nan,
           "corr_est": sums[2] / num_iter + nan}
    res = {k: v.cpu().numpy() for k, v in res.items()}
    res["p_init"] = np.asarray(p_init, np.float64)
    res["h2_init"] = float(h2_init)
    res["kept"] = list(kept)
    return res


def qc_ranges(corr_est, quantile=0.95):
    """The vignette's chain QC's numbers over (NC, m) corr_est, NaN rows
    for diverged chains: each chain's range of corr_est (NaN where it
    diverged) and the threshold, 0.95 times the `quantile` quantile of
    the ranges (NaN without a live chain)."""
    c = np.asarray(corr_est, np.float64)
    live = np.isfinite(c).all(1)
    ranges = np.full(len(c), np.nan)
    ranges[live] = c[live].max(1) - c[live].min(1)
    if not live.any():
        return ranges, np.nan
    return ranges, 0.95 * np.nanquantile(ranges, quantile)


def chain_qc(corr_est, quantile=0.95):
    """The vignette's chain QC: the chains whose range of corr_est
    exceeds the threshold (`qc_ranges`)."""
    ranges, thr = qc_ranges(corr_est, quantile)
    if not np.isfinite(thr):
        return np.zeros(len(ranges), bool)
    return ranges > thr


def parted(x, ref, blk, nblk, tol):
    """(NC, nblk): the LD blocks in which x parts from ref by more than
    `tol` of ref's norm there; x, ref (NC, m), blk (m,) each variant's
    block."""
    NC = x.shape[0]
    z = torch.zeros((NC, nblk), dtype=torch.float64, device=x.device)
    d = z.index_add(1, blk, (x - ref) ** 2).sqrt()
    r = z.index_add(1, blk, ref ** 2).sqrt()
    return d > tol * r


def judge(R, prog, seed, burn_in, num_iter, shrink, no_jump, p_bounds,
          alpha_bounds, lane_tol, log=None):
    """Replays a program's LDpred2-auto run of job seed `seed` and returns
    its numbers, each the worst over the chains:

    - `p_gap`, `h2_gap`, `sigma2_gap` (relative) and `alpha_gap`
      (absolute): at each sweep k whose state before and after the
      program kept (k = 0 from the zero state), the chain-wide update
      worked out from those exact states and the program's parameters of
      sweep k, against the program's paths at k;
    - `lane_mismatch`: at the end of each segment between kept sweeps,
      replayed from the program's state at its start with the program's
      p, sigma2 and alpha of each sweep before fed in, the share of LD
      blocks whose current effects part from the program's kept state by
      more than `lane_tol` of their norm; 1 for a chain that diverged at
      another sweep on one side;
    - `window_mismatch`: the same share for the increments over the
      segment of the three running sums (the averages' window), the last
      segment's taken from the returned averages;
    - `qc_mismatch`: chains whose QC verdict, from the reference's own
      corr_est, differs from the program's (`prog["keep"]`), but for a
      chain that the blocks whose corr_est parted (those `window_mismatch`
      counts) move across the threshold: with the program's values in
      those blocks its verdict would be the program's. A parted block is
      another Monte Carlo path, and the range that the QC reads moves with
      its extreme variant's (one chain of 30, on one seed of 18, crossed
      the threshold so). Such a chain is not counted; the log names it
      with the margin of its range over the reference's threshold.

    `prog`: numpy arrays over the chains as `snp_ldpred2_auto(...,
    state_sweeps=kept)` returns them (path_*, state_*, beta_est,
    postp_est, corr_est; (NC, ...)), p_init, h2_init, `kept` and `keep`."""
    say = log or (lambda *a: None)
    C = Consts(R, shrink, no_jump, p_bounds, alpha_bounds)
    L, dev, m = R["lanes"], C.dev, C.m
    T, kept = burn_in + num_iter, list(prog["kept"])
    slot = {k: i for i, k in enumerate(kept)}
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
    path = {k: t(prog[f"path_{k}_est"]) for k in ("p", "h2", "alpha",
                                                  "sigma2")}
    NC = path["p"].shape[0]
    gone = torch.isnan(path["p"])                    # (NC, T): diverged by k
    blk = torch.as_tensor(np.repeat(np.arange(L.B), R["sizes"]), device=dev)

    def state(k):
        i = slot[k]
        return (t(prog["state_beta"][:, i]),
                torch.stack([t(prog[f"state_sum_{n}"][:, i])
                             for n in ("beta", "postp", "corr")]),
                t(prog["state_h2"][:, i]))

    def final_sums():
        sd = 1 / C.scale
        return torch.stack([t(prog["beta_est"]) * sd[None],
                            t(prog["postp_est"]), t(prog["corr_est"])]) \
            * num_iter

    p0, s0, a10 = C.start(prog["p_init"], prog["h2_init"])

    def fed(k):
        if k == 0:
            return p0, s0, a10
        return path["p"][:, k - 1], path["sigma2"][:, k - 1], \
            path["alpha"][:, k - 1] + 1

    def quad(x):
        """x' R_s x, R_s the LD with its off-diagonal entries shrunk."""
        rx = ld_product(L, R["band"], x)
        return (x * (C.shrink * (rx - x) + x)).sum(1)

    out = dict.fromkeys(("p_gap", "h2_gap", "alpha_gap", "sigma2_gap",
                         "lane_mismatch", "window_mismatch"), 0.0)
    sw = AutoSweeper(L, R["band"], NC, torch.float64, no_jump)
    gens = chain_generators(seed, NC, dev)
    zeros = torch.zeros((NC, m), dtype=torch.float64, device=dev)
    corr_own = corr_near = None
    for a, b in segments(kept, T):
        if a == 0:
            curr, base = zeros, torch.zeros((3, NC, m), dtype=torch.float64,
                                            device=dev)
            h2_old = torch.zeros(NC, dtype=torch.float64, device=dev)
            div = torch.zeros(NC, dtype=torch.bool, device=dev)
        else:
            curr, base, h2_old = state(a - 1)
            div = gone[:, a - 1].clone()
        sw.load(curr)
        inc = torch.zeros_like(base)
        odd = torch.zeros(NC, dtype=torch.bool, device=dev)
        for k in range(a, b + 1):
            U, Z = draw(gens, 2 * m + 16, m + 2, dev)
            p, s, a1 = fed(k)
            res = C.sweep(sw, curr, p, s, a1, U, Z)
            if k >= burn_in:
                inc += torch.where(~div[:, None], torch.stack(
                    [res["binc"], res["postp"], res["dps"]]), 0.0)
            div2 = div | (res["gap"] > C.gap0)
            odd |= div2 != gone[:, k]
            if k == a and k in slot:
                gaps = _update_gaps(C, quad, curr, state(k)[0], h2_old, p, s,
                                    a1, U, Z, {n: v[:, k] for n, v in
                                               path.items()}, div, div2)
                for n, v in gaps.items():
                    out[n] = max(out[n], v)
            curr, div = res["nb"], div2
        live = ~(div | gone[:, b])
        prog_sums = final_sums() if b == T - 1 else state(b)[1]
        lane = parted(curr, state(b)[0], blk, L.B, lane_tol).double().mean(1)
        apart = torch.stack([parted(prog_sums[i] - base[i], inc[i], blk, L.B,
                                    lane_tol) for i in range(3)])
        win = apart.double().mean(2).max(0).values
        lane = torch.where(odd, 1.0, torch.where(live, lane, 0.0))
        win = torch.where(odd, 1.0, torch.where(live, win, 0.0))
        out["lane_mismatch"] = max(out["lane_mismatch"], float(lane.max()))
        out["window_mismatch"] = max(out["window_mismatch"], float(win.max()))
        say(f"sweeps {a}-{b}: lane {float(lane.max()):.4f}, window "
            f"{float(win.max()):.4f}, {int(div.sum())} diverged")
        if b == T - 1:
            own = base[2] + inc[2]
            near = torch.where(apart[2][:, blk], prog_sums[2], own)
            corr_own, corr_near = (torch.where(div[:, None], torch.nan,
                                               x / num_iter).cpu().numpy()
                                   for x in (own, near))
    keep = np.asarray(prog["keep"])
    keep_own, keep_near = chain_qc(corr_own), chain_qc(corr_near)
    out["qc_mismatch"] = float(((keep_own != keep) & (keep_near != keep))
                               .sum())
    moved = np.nonzero((keep_own != keep) & (keep_near == keep))[0]
    if len(moved):
        ranges, thr = qc_ranges(corr_own)
        say("QC: parted blocks move chains " + ", ".join(
            f"{c} (range {ranges[c]:.6g}, {100 * (ranges[c] / thr - 1):+.3f}% "
            f"of the threshold {thr:.6g})" for c in moved)
            + " across it: not counted")
    return out


def _update_gaps(C, quad, old, new, h2_old, p, s, a1, U, Z, got, div,
                 div2):
    """The chain-wide update of one sweep from the program's exact states
    before (`old`) and after (`new`) it, against the program's paths at
    that sweep (`got`): the largest gaps over the chains alive on both
    sides; inf where one side diverged there and the other did not."""
    causal = new != 0
    h2_inc = quad(new) - quad(old)
    p2, _, h2, a12, s2 = C.update(new, causal, h2_inc, h2_old, s, U, Z,
                                  torch.float64)
    gap = torch.where(causal, new * new, 0.0).sum(1)
    ref_dead = div | (gap > C.gap0)
    prog_dead = torch.isnan(got["p"])
    if bool((ref_dead != prog_dead).any()):
        return dict.fromkeys(("p_gap", "h2_gap", "alpha_gap", "sigma2_gap"),
                             float("inf"))
    live = ~ref_dead
    if not bool(live.any()):
        return {}
    rel = lambda x, y: float(((x - y).abs() / y.abs())[live].max())  # noqa: E731
    weighted = poisson1(U[:, C.m + 16:]) * causal
    has = live & (weighted.sum(1) > 0)
    alpha = (float((a12 - 1 - got["alpha"]).abs()[has].max())
             if bool(has.any()) else 0.0)
    vals = {"p_gap": rel(got["p"], p2), "h2_gap": rel(got["h2"], h2),
            "alpha_gap": alpha, "sigma2_gap": rel(got["sigma2"], s2)}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in
            vals.items()}
