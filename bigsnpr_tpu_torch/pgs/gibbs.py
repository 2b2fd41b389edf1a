"""The LDpred2 and lassosum2 samplers over all variants, and the sampler
pieces they share with the blocked ones (port of `bigsnpr_tpu/pgs/
gibbs.py`).

The JAX package draws from threefry keys split per chain and `vmap`s the
hyper-parameter draws; here every chain has its own torch Philox
generator (`chain_generators`) and the draws are batched over a leading
chain axis. The two packages agree at Monte-Carlo level, as the reference
does with itself (its tests are statistical).

The unblocked samplers (`gibbs_one`, `gibbs_one_sampling`, `gibbs_auto`,
`lassosum_cd`, the JAX package's names) walk one band over every variant
(`band.one_block_bands`): they are the drivers of `gibbs_blocked.py` on
that one block, every chain or grid point of a call in one launch a
sweep, where the JAX package `vmap`s its `lax.scan`s. On a card the sweep
kernel (`ops/gibbs_kernels.py`) runs that one block as it runs the blocked
bands; its launches count as "global" ones.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch.utils.profiling import count, recording

MIN_H2 = 1e-3  # reference src/ldpred2-auto.cpp:11

# Poisson(1) CDF, P(K > 16) < 1e-14
_POIS1_CDF = np.cumsum(np.exp(-1) / np.cumprod(np.r_[1.0, np.arange(1.0, 17.0)]))

# elements of one (chains x grid x variants) slab of the MLE profile
_MLE_SLAB = 1 << 24


def chain_generators(seed: int, n: int, device, salt=()) -> list:
    """One Philox generator per chain, seeded from (seed, *salt, chain)
    through numpy's SeedSequence: chain c's stream does not depend on how
    many chains run beside it."""
    gens = []
    for child in np.random.SeedSequence([int(seed), *salt]).spawn(n):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0]))
        gens.append(g)
    return gens


def draw(gens, n_unif: int, n_norm: int, dtype, device):
    """(U (NC, n_unif) uniform on [0, 1), Z (NC, n_norm) standard
    normal): two launches per chain, row c from generator c."""
    NC = len(gens)
    U = torch.empty((NC, n_unif), dtype=dtype, device=device)
    Z = torch.empty((NC, n_norm), dtype=dtype, device=device)
    for c, g in enumerate(gens):
        if n_unif:
            torch.rand(n_unif, generator=g, dtype=dtype, device=device,
                       out=U[c])
        if n_norm:
            torch.randn(n_norm, generator=g, dtype=dtype, device=device,
                        out=Z[c])
    return U, Z


def poisson1_cdf(dtype, device) -> torch.Tensor:
    """The Poisson(1) CDF table on `device`: made once per run, since a
    copy from the host inside a sweep loop would wait for the device."""
    return torch.as_tensor(_POIS1_CDF, dtype=dtype, device=device)


def _poisson1(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Poisson(lam=1) from uniforms by the inverse CDF: k = #thresholds
    below u (the JAX package's fixed-op-count draw)."""
    return torch.searchsorted(cdf, u.contiguous()).to(u.dtype)


def _gamma_wh(z, boost_u, a):
    """Gamma(a) via Wilson-Hilferty on a+8 plus the exact shape-boost
    recursion Gamma(a) = Gamma(a+1) * U^(1/a). z (NC,), boost_u (NC, 8),
    a (NC,)."""
    ab = a + 8.0
    c = 1.0 / (9.0 * ab)
    g = ab * (1.0 - c + z * torch.sqrt(c)) ** 3
    g = torch.clamp(g, min=1e-30)
    for i in range(8):
        g = g * boost_u[:, i] ** (1.0 / (a + i))
    return g


def _beta_draw(z2, u1, u2, a, b):
    """Beta(a, b) = G1 / (G1 + G2) per chain: z2 (NC, 2) normals, u1 and
    u2 (NC, 8) uniforms, a and b (NC,)."""
    g1 = _gamma_wh(z2[:, 0], u1, a)
    g2 = _gamma_wh(z2[:, 1], u2, b)
    return g1 / (g1 + g2)


def _pad_rows(x, rows):
    """x (NC, ...) zero-padded to `rows` rows."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])


def _pad(x, rows):
    """x (NC, k) zero-padded to `rows` rows and to a multiple of 4 columns,
    so that every row starts 16-byte aligned."""
    if x.shape[-1] % 4:
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 4))
    return _pad_rows(x, rows)


def row_sums(x, rows=None):
    """x (NC, k) -> (NC,) row sums, reduced as `rows` rows (None: NC) of
    a multiple of 4 columns (x zero-padded). On the card a reduction's
    order changes with the number of rows, and with a row's alignment,
    not with its place: so the chains of a `shard_chains` shard, reduced
    as the whole run's chain count, get the bits of the unsharded run."""
    return _pad(x, rows or x.shape[0]).sum(1)[:x.shape[0]]


def _profile(a, sum_a, nb, wb, log_var, s_lo, s_hi, rows=None):
    """The MLE profile f(a) and its sigma2 at a (NC, G) grid of alpha+1,
    summed over variants in slabs so the (NC, G, m) exponentials never
    materialize whole; the slabs and the batched products are those of
    `rows` chains over a multiple of 4 variants (zeros pad them, as in
    `row_sums`). Counts each slab's exponentials in `auto.mle_exps`."""
    NC, G = a.shape
    rows = rows or NC
    a_r, wb_r = _pad_rows(a, rows), _pad(wb, rows)
    lv = torch.nn.functional.pad(log_var, (0, wb_r.shape[1] - len(log_var)))
    m4 = lv.shape[0]
    step = max(4, _MLE_SLAB // max(1, rows * G) // 4 * 4)
    sum_c = torch.zeros((rows, G), dtype=a.dtype, device=a.device)
    for j0 in range(0, m4, step):
        E = torch.exp(-a_r[:, :, None] * lv[None, None, j0:j0 + step])
        count("auto.mle_exps", E.numel())
        sum_c += torch.bmm(E, wb_r[:, j0:j0 + step, None])[:, :, 0]
    sum_c = sum_c[:NC]
    s = torch.minimum(torch.maximum(sum_c / torch.clamp(nb, min=1.0)[:, None],
                                    s_lo[:, None]), s_hi[:, None])
    return a * sum_a[:, None] + nb[:, None] * torch.log(s) + sum_c / s, s


def _mle_alpha_profile(par_sigma2, wts, log_var, beta2, alpha_bounds,
                       n_grid=64, n_refine=3, rows=None):
    """Box-constrained MLE of (alpha+1, sigma2) on the weighted causal set,
    per chain: par_sigma2 (NC,), wts and beta2 (NC, m), log_var (m,); its
    sums over variants reduced as `rows` chains (`row_sums`).

    The reference minimizes f(a, s) = a*sum_a + nb*log(s) + sum_c(a)/s with
    L-BFGS-B (src/optim-MLE-alpha.h:38-65); for fixed a the minimum over s
    is closed-form (clipped to [par_sigma2/2, 2*par_sigma2]), so the 1-D
    profile is minimized on a grid of n_grid points refined n_refine
    times, as in the JAX package (which also takes the current alpha; the
    profile does not start from it)."""
    nb = wts.sum(1)           # integers: exact in any order
    sum_a = row_sums(wts * log_var, rows)
    wb = wts * beta2
    s_lo, s_hi = par_sigma2 / 2, par_sigma2 * 2
    NC = wts.shape[0]
    lo = torch.full((NC,), float(alpha_bounds[0]), dtype=wts.dtype,
                    device=wts.device)
    hi = torch.full_like(lo, float(alpha_bounds[1]))
    frac = torch.arange(n_grid, dtype=wts.dtype, device=wts.device) \
        / (n_grid - 1)
    for _ in range(n_refine):
        grid = lo[:, None] + (hi - lo)[:, None] * frac[None, :]
        vals, _ = _profile(grid, sum_a, nb, wb, log_var, s_lo, s_hi, rows)
        best = grid.gather(1, vals.argmin(1, keepdim=True))[:, 0]
        stepw = (hi - lo) / (n_grid - 1)
        lo, hi = torch.maximum(best - stepw, lo), torch.minimum(best + stepw,
                                                                hi)
    a_best = 0.5 * (lo + hi)
    _, s_best = _profile(a_best[:, None], sum_a, nb, wb, log_var, s_lo, s_hi,
                         rows)
    return a_best, s_best[:, 0]


# a side stream a card for the MLE graphs' first calls and captures: one
# a process, so that the blocks its first calls leave in the allocator's
# cache are the next run's to reuse
_SIDE: dict = {}


class MleGraph:
    """`_mle_alpha_profile` at one run's alpha bounds and row count, as
    LDpred2-auto's sampler calls it each sweep; the run owns it, so what
    it holds goes with the run. On a card the first call runs it on a side
    stream of the inputs' card and captures it there as a CUDA graph; each
    later call copies its inputs into the graph's and replays it: the same
    kernels on the same shapes, so the same result bit for bit, at one
    launch in place of ~280 (the host paces the sweeps). A replay counts
    in `auto.mle_exps` the exponentials the captured call counted."""

    def __init__(self, alpha_bounds, rows):
        self.alpha_bounds, self.rows = alpha_bounds, rows
        self.graph = None

    def _direct(self, *args):
        return _mle_alpha_profile(*args, self.alpha_bounds, rows=self.rows)

    def __call__(self, par_sigma2, wts, log_var, beta2):
        args = (par_sigma2, wts, log_var, beta2)
        if wts.device.type != "cuda":
            return self._direct(*args)
        if self.graph is None:
            return self._capture(args)
        for dst, src in zip(self.ins, args):
            dst.copy_(src)
        self.graph.replay()
        count("auto.mle_exps", self.exps)
        return tuple(x.clone() for x in self.outs)

    def _capture(self, args):
        """The first call, run eagerly on the side stream (the warm-up a
        capture asks for), then the capture on that stream into a pool of
        the graph's own. Both under the inputs' card as the current
        device, so that a run on another card than the current one
        captures its own launches; and without `torch.cuda.graph`'s
        synchronize and emptied cache, which would reach past the run."""
        dev = args[1].device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream()
            self.ins = [x.clone() for x in args]
            side = _SIDE.get(dev.index)
            if side is None:
                side = _SIDE[dev.index] = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                first = self._direct(*self.ins)
                graph = torch.cuda.CUDAGraph()
                with recording() as rec:     # captured, not evaluated
                    graph.capture_begin()
                    try:
                        self.outs = self._direct(*self.ins)
                    finally:
                        graph.capture_end()
            cur.wait_stream(side)
            for x in first:
                x.record_stream(cur)
        self.graph, self.exps = graph, rec.counters.get("auto.mle_exps", 0)
        return first


# ---------------------------------------------------------------------------
# the unblocked samplers: the blocked drivers on one block of every variant
# (gibbs_blocked imports this module, hence the imports in the functions)
# ---------------------------------------------------------------------------

def gibbs_one(sb, beta_hat, n_vec, h2, p, sparse, gens, burn_in, num_iter):
    """LDpred2-grid cells (ldpred2_gibbs_one, src/ldpred2.cpp:8-69; the JAX
    package's `gibbs_one` under its vmap over the grid) on the one-block
    bands `sb`: h2, p, sparse (NC,), one generator a cell. Returns the
    (NC, m) average betas, NaN rows where a cell diverged."""
    from bigsnpr_tpu_torch.pgs.gibbs_blocked import gibbs_multi_blocked

    return gibbs_multi_blocked(sb, beta_hat, n_vec, h2, p, sparse, gens,
                               burn_in, num_iter)


def gibbs_one_sampling(sb, beta_hat, n_vec, h2, p, sparse, gen, burn_in,
                       num_iter):
    """The sampling betas of one cell (ldpred2_gibbs_one_sampling,
    src/ldpred2-sampling.cpp:9-59): (num_iter, m), all NaN if the chain
    diverged."""
    from bigsnpr_tpu_torch.pgs.gibbs_blocked import gibbs_sampling_blocked

    return gibbs_sampling_blocked(sb, beta_hat, n_vec, h2, p, sparse, gen,
                                  burn_in, num_iter)


def gibbs_auto(sb, beta_hat, n_vec, log_var, p_inits, h2_init, gens, *args,
               **kw):
    """LDpred2-auto chains (ldpred2_gibbs_auto, src/ldpred2-auto.cpp:56-202;
    the JAX package's `gibbs_auto` under its vmap over the chains) on the
    one-block bands; the arguments and result of
    `gibbs_blocked.gibbs_auto_blocked_multi`."""
    from bigsnpr_tpu_torch.pgs.gibbs_blocked import gibbs_auto_blocked_multi

    return gibbs_auto_blocked_multi(sb, beta_hat, n_vec, log_var, p_inits,
                                    h2_init, gens, *args, **kw)


def lassosum_cd(sb, beta_hat, pf, lam, delta, dfmax, tol, maxiter):
    """lassosum2 coordinate descent (src/lassosum2.cpp:21-70; the JAX
    package's `lassosum_cd` under its vmap over the grid) for NG grid
    points on the one-block bands, with its stopping rules; returns (beta
    (NG, m), NaN rows where a point diverged; num_iter (NG,))."""
    from bigsnpr_tpu_torch.pgs.gibbs_blocked import lassosum_cd_blocked

    return lassosum_cd_blocked(sb, beta_hat, pf, lam, delta, dfmax, tol,
                               maxiter)
