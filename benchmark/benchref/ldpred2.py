"""Plain reference for the LDpred2 grid cell (torch, numpy and scipy only).

From the benchmark's own genotype bytes, phenotype and split it works
out again what the program derives in set-up: the marginal GWAS (mean
imputation), the windowed LD (pairwise-complete Pearson r, kept above an
r^2 floor), its LD scores, the LDSC heritability (intercept fixed at 1),
the exact block cuts and the per-block bands. Then it replays LDpred2's
Gibbs sampler with the program's random draws: each grid
model's Philox generator is seeded as the program seeds it (numpy's
SeedSequence spawned from the job's seed) and drawn in the same sizes
and order, so the reference and the program sample the same numbers and
differ only by rounding, until a draw lies within rounding of its
threshold and the two paths part.

The sweep follows LDpred2's update row by row in each LD block, every
block and chain at once, in float64. A row is sampled when C3^2 exceeds
a threshold worked out before the sweep from its uniform (the same test
as postp > u); the posterior probabilities are formed after the sweep.
On CUDA the row loop of a sweep is one CUDA graph, replayed each sweep.

`control=True` runs the same in bfloat16: the control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchref.common import dosage


# --------------------------------------------------------------------------
# set-up, worked out again
# --------------------------------------------------------------------------

def _rows(packed, n, rows):
    """Dosage and present mask of the samples `rows` (a long tensor)."""
    d, ok = dosage(packed, n)
    return d[:, rows], ok[:, rows]


def gwas(packed, n, rows, y, block=2048):
    """Per-variant OLS of y on an intercept and the dosage, missing calls
    at the variant's mean: (beta, std.err) as float64 numpy."""
    dev = packed.device
    yt = torch.as_tensor(y, dtype=torch.float64, device=dev)
    yr = yt - yt.mean()
    nr = len(y)
    beta, se = [], []
    for j0 in range(0, packed.shape[0], block):
        d, ok = _rows(packed[j0:j0 + block], n, rows)
        mean = d.sum(1, keepdim=True) / ok.sum(1, keepdim=True).clamp(min=1)
        x = (d - mean) * ok
        b = x @ yr
        sxx = (x * x).sum(1)
        bt = b / sxx
        rss = yr @ yr - bt * b
        beta.append(bt)
        se.append(torch.sqrt(rss / (nr - 2) / sxx))
    return torch.cat(beta).cpu().numpy(), torch.cat(se).cpu().numpy()


def ld(packed, n, rows, size, thr_r2, block=512):
    """The windowed LD: r of each variant with the `size` variants left of
    it over the samples `rows`, pairwise-complete, kept where |r| >
    sqrt(thr_r2). Returns (i, j, r) numpy with i < j."""
    m = packed.shape[0]
    floor = float(np.sqrt(thr_r2))
    I, J, R = [], [], []
    for t0 in range(0, m, block):
        t1 = min(m, t0 + block)
        b0 = max(0, t0 - size)
        d, ok = _rows(packed[b0:t1], n, rows)
        mk = ok.to(torch.float64)
        x, x2 = d * mk, d * d * mk
        T = slice(t0 - b0, t1 - b0)
        N = mk[T] @ mk.T
        SX, SY = x[T] @ mk.T, mk[T] @ x.T
        SXX, SYY = x2[T] @ mk.T, mk[T] @ x2.T
        SXY = x[T] @ x.T
        r = (N * SXY - SX * SY) / torch.sqrt(
            (N * SXX - SX * SX) * (N * SYY - SY * SY))
        tgt = torch.arange(t0, t1, device=r.device)[:, None]
        nbr = torch.arange(b0, t1, device=r.device)[None, :]
        keep = (nbr < tgt) & (tgt - nbr <= size) & (r.abs() > floor)
        ti, ni = torch.nonzero(keep, as_tuple=True)
        I.append((ni + b0).cpu().numpy())
        J.append((ti + t0).cpu().numpy())
        R.append(r[ti, ni].cpu().numpy())
    return np.concatenate(I), np.concatenate(J), np.concatenate(R)


def ld_scores(i, j, r, m):
    """Sum of r^2 over each variant's column, the diagonal included."""
    ls = np.ones(m)
    np.add.at(ls, i, r * r)
    np.add.at(ls, j, r * r)
    return ls


def ldsc_h2(ls, m, chi2, n_eff):
    """LDSC's slope with the intercept fixed at 1, by its iteratively
    reweighted least squares (heteroscedasticity weights 1 / (pred^2
    max(ls, 1)))."""
    chi2 = chi2 + 1e-8
    w_ld = np.maximum(ls, 1)
    x = ls / m * n_eff
    yp = chi2 - 1.0
    pred0 = chi2
    for _ in range(100):
        w = 1.0 / (pred0 ** 2 * w_ld)
        slope = (w * x) @ yp / ((w * x) @ x)
        pred = 1.0 + x * slope
        if np.max(np.abs(pred - pred0)) < 1e-6:
            break
        pred0 = pred
    w = 1.0 / (pred0 ** 2 * w_ld)
    return float((w * x) @ yp / ((w * x) @ x))


def exact_blocks(i, j, m):
    """Block sizes cut wherever no kept entry crosses."""
    reach = np.arange(m)
    np.minimum.at(reach, j, i)
    suffix = np.minimum.accumulate(reach[::-1])[::-1]
    cut = np.r_[suffix[1:] > np.arange(m - 1), True]
    return np.diff(np.r_[0, np.nonzero(cut)[0] + 1])


class Lanes:
    """The blocks side by side: lane (chain, block), row r of each block,
    arrays laid out (rows, chains, blocks); pad rows map to variant -1."""

    def __init__(self, sizes, dev):
        self.sizes = np.asarray(sizes)
        self.starts = np.r_[0, np.cumsum(self.sizes)[:-1]]
        self.B, self.R = len(self.sizes), int(self.sizes.max())
        g = np.full((self.R, self.B), -1, np.int64)
        for b, (s, z) in enumerate(zip(self.starts, self.sizes)):
            g[:z, b] = s + np.arange(z)
        self.gidx = torch.as_tensor(g, device=dev)
        self.valid = self.gidx >= 0
        self.safe = self.gidx.clamp(min=0)
        self.m = int(self.sizes.sum())

    def scatter(self, x, fill=0.0):
        """(NC, m) or (m,) -> (R, NC, B), `fill` at pad rows."""
        if x.dim() == 1:
            x = x[None]
        y = x[:, self.safe].permute(1, 0, 2)
        return torch.where(self.valid[:, None, :], y,
                           torch.as_tensor(fill, dtype=y.dtype,
                                           device=y.device)).contiguous()

    def gather(self, y):
        """(R, NC, B) -> (NC, m)."""
        NC = y.shape[1]
        out = torch.empty((NC, self.m), dtype=y.dtype, device=y.device)
        yt = y.permute(1, 0, 2)
        out[:, self.gidx[self.valid]] = yt[:, self.valid]
        return out


def bands(lanes: Lanes, i, j, r, dev, dtype=torch.float64):
    """(B, R, 2W + 1): band[b, row, W + d] = R[row, row + d] in block b,
    W the widest in-block offset."""
    blk = np.searchsorted(lanes.starts, i, side="right") - 1
    same = blk == np.searchsorted(lanes.starts, j, side="right") - 1
    if not same.all():
        raise ValueError("an LD entry crosses a block cut")
    off = (j - i).astype(np.int64)
    W = int(off.max()) if len(off) else 0
    out = torch.zeros((lanes.B, lanes.R, 2 * W + 1), dtype=dtype, device=dev)
    bt = torch.as_tensor(blk, device=dev)
    ri = torch.as_tensor(i - lanes.starts[blk], device=dev)
    rj = torch.as_tensor(j - lanes.starts[blk], device=dev)
    o = torch.as_tensor(off, device=dev)
    v = torch.as_tensor(r, dtype=dtype, device=dev)
    out[bt, ri, W + o] = v
    out[bt, rj, W - o] = v
    rows = torch.arange(lanes.R, device=dev)
    out[:, rows, W] = lanes.valid.T.to(dtype)
    return out


def derive(packed, n, train, y_train, size, thr_r2):
    """Everything the program derives in set-up, from the bytes: a dict
    of beta_hat, n_eff, scale, log_var (m,), the LD entries, the block
    sizes, the lanes and bands, mean_ld and h2 (LDSC)."""
    dev = packed.device
    m = packed.shape[0]
    rows = torch.as_tensor(np.asarray(train), device=dev)
    beta, se = gwas(packed, n, rows, y_train)
    n_eff = np.full(m, float(len(train)))
    scale = np.sqrt(n_eff * se ** 2 + beta ** 2)
    i, j, r = ld(packed, n, rows, size, thr_r2)
    ls = ld_scores(i, j, r, m)
    sizes = exact_blocks(i, j, m)
    lanes = Lanes(sizes, dev)
    return {"beta": beta, "se": se, "beta_hat": beta / scale,
            "n_eff": n_eff, "scale": scale,
            "log_var": 2.0 * np.log(1.0 / scale), "ld": (i, j, r),
            "sizes": sizes, "lanes": lanes,
            "band": bands(lanes, i, j, r, dev), "mean_ld": float(ls.mean()),
            "h2": ldsc_h2(ls, m, (beta / se) ** 2, n_eff)}


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

def chain_generators(seed, n, dev):
    """One Philox generator a chain, seeded from (seed, chain) through
    numpy's SeedSequence, as the program seeds its chains."""
    gens = []
    for child in np.random.SeedSequence([int(seed)]).spawn(n):
        g = torch.Generator(device=dev)
        g.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0]))
        gens.append(g)
    return gens


def draw(gens, n_unif, n_norm, dev):
    """Uniforms and normals of every chain, in float32, drawn in the
    program's sizes and order; returned in float64."""
    U = torch.stack([torch.rand(n_unif, generator=g, dtype=torch.float32,
                                device=dev) for g in gens])
    Z = torch.stack([torch.randn(n_norm, generator=g, dtype=torch.float32,
                                 device=dev) for g in gens])
    return U.double(), Z.double()


class Sweeper:
    """The Gibbs sweep over every block for NC chains, dp (NC, B, R + 2W)
    kept between sweeps. dtype float64, or bfloat16 for the control."""

    def __init__(self, lanes: Lanes, band, NC, dtype=torch.float64):
        self.L, self.dt = lanes, dtype
        self.band = band.to(dtype)
        self.W = (band.shape[-1] - 1) // 2
        dev = band.device
        R, B = lanes.R, lanes.B
        e = lambda dt=dtype: torch.zeros((R, NC, B), dtype=dt, device=dev)  # noqa: E731
        self.A, self.Bc, self.T, self.zs, self.cb = e(), e(), e(), e(), e()
        self.C3, self.S, self.NB = e(), e(), e()
        self.OK = e(torch.bool)
        self.dp = torch.zeros((NC, B, R + 2 * self.W), dtype=dtype,
                              device=dev)
        self.graph = dev.type == "cuda"
        self._g = None

    def _rows(self):
        W, wk, band, dp = self.W, 2 * self.W + 1, self.band, self.dp
        for j in range(self.L.R):
            torch.addcmul(self.A[j], self.Bc[j], dp[:, :, j + W],
                          out=self.C3[j])
            torch.add(self.C3[j], self.zs[j], out=self.S[j])
            torch.gt(self.C3[j] * self.C3[j], self.T[j], out=self.OK[j])
            torch.mul(self.S[j], self.OK[j], out=self.NB[j])
            diff = self.NB[j] - self.cb[j]
            dp[:, :, j:j + wk].addcmul_(diff.unsqueeze(-1),
                                        band[:, j].unsqueeze(0))

    def _run_rows(self):
        if not self.graph:
            self._rows()
            return
        if self._g is None:
            keep = self.dp.clone()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                self._rows()
            torch.cuda.current_stream().wait_stream(s)
            self.dp.copy_(keep)
            self._g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._g):
                self._rows()
        self._g.replay()

    def sweep(self, cb, bh, C2, C4, s1, u, z, iop, p, sparse, shrink):
        """cb, C2, C4, s1, u, z (NC, m); bh (m,); iop, p (NC,); sparse
        (NC,) bool. Returns (new beta, beta_inc) as (NC, m) float64 and
        the divergence gap as (NC,)."""
        L, dt = self.L, self.dt
        sh = float(shrink)
        # postp = 1 / (1 + K exp(-C3^2 / (2 C4))): postp > u iff C3^2 > Tu,
        # and the sparse skip postp < p holds unless C3^2 >= Tp; K = 0 (p =
        # 1) makes postp 1: always sampled, never skipped
        K = iop[:, None] * s1                                 # (NC, m)
        Tu = 2 * C4 * torch.log(K / (1 / u - 1))
        Tp = torch.where(K > 0, 2 * C4 * torch.log(K / (1 / p[:, None] - 1)),
                         -torch.inf)
        T = torch.where(sparse[:, None], torch.maximum(Tu, Tp), Tu)
        self.A.copy_(L.scatter(C2 * (bh[None] + sh * cb)).to(dt))
        self.Bc.copy_(L.scatter(-sh * C2).to(dt))
        self.T.copy_(L.scatter(T, float("nan")).to(dt))
        self.zs.copy_(L.scatter(z * torch.sqrt(C4)).to(dt))
        self.cb.copy_(L.scatter(cb).to(dt))
        self._run_rows()
        g = lambda y: L.gather(y.double())  # noqa: E731
        C3, nb, ok, samp = g(self.C3), g(self.NB), L.gather(self.OK), \
            g(self.S)
        postp = 1 / (1 + K * torch.exp(-C3 * C3 / C4 * 0.5))
        skip = sparse[:, None] & (postp < p[:, None])
        gap = torch.where(ok, samp * samp, 0.0).sum(1)
        return nb, torch.where(skip, 0.0, C3 * postp), gap


def replay_grid(ref, h2, p, sparse, cells, n_cells, seed, burn_in, num_iter,
                control=False):
    """LDpred2-grid for the cells `cells` (indices into the job's
    `n_cells` cells of (h2, p, sparse)), with the program's draws of job
    seed `seed`: (len(cells), m) average effects on the allele scale,
    NaN rows where a cell diverged."""
    L, band = ref["lanes"], ref["band"]
    dev = band.device
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
    bh, nv = t(ref["beta_hat"]), t(ref["n_eff"])
    m, NC = L.m, len(cells)
    every = chain_generators(seed, n_cells, dev)
    gens = [every[c] for c in cells]
    h2c, pc = t(np.asarray(h2)[cells]), t(np.asarray(p)[cells])
    spc = torch.as_tensor(np.asarray(sparse)[cells], device=dev)
    C1 = (h2c / (m * pc))[:, None] * nv[None]
    C2 = 1 / (1 + 1 / C1)
    C4, s1 = C2 / nv[None], torch.sqrt(1 + C1)
    iop = (1 - pc) / pc
    gap0 = 2 * (bh * bh).sum()
    sw = Sweeper(L, band, NC, torch.bfloat16 if control else torch.float64)
    curr = torch.zeros((NC, m), dtype=torch.float64, device=dev)
    avg = torch.zeros_like(curr)
    div = torch.zeros(NC, dtype=torch.bool, device=dev)
    for k in range(burn_in + num_iter):
        U, Z = draw(gens, m, m, dev)
        nb, binc, gap = sw.sweep(curr, bh, C2, C4, s1, U, Z, iop, pc,
                                       spc, 1.0)
        if k >= burn_in:
            avg += torch.where(~div[:, None], binc, 0.0)
        div = div | (gap > gap0)
        curr = nb
    out = torch.where(div[:, None], torch.nan, avg / num_iter)
    return (out * t(ref["scale"])[None]).cpu().numpy()


# --------------------------------------------------------------------------
# the host steps after the sampler, and the scores
# --------------------------------------------------------------------------

def scores(packed, n, rows, B, block=4096, control=False):
    """(len(rows), l) scores G B of the samples `rows`, missing calls 0;
    float64, or bf16 operands for the control."""
    dev = packed.device
    rows = torch.as_tensor(np.asarray(rows), device=dev)
    Bt = torch.as_tensor(np.asarray(B, np.float64).reshape(len(B), -1),
                         device=dev)
    out = torch.zeros((len(rows), Bt.shape[1]), dtype=torch.float64,
                      device=dev)
    for j0 in range(0, packed.shape[0], block):
        d, _ = _rows(packed[j0:j0 + block], n, rows)
        Bj = Bt[j0:j0 + block]
        if control:
            d, Bj = d.to(torch.bfloat16).double(), Bj.to(torch.bfloat16).double()
        out += d.T @ Bj
    return out.cpu().numpy()


def rel_gap(got, ref):
    """max |got - ref| / max |ref|; inf where either holds a non-finite
    value the other does not."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.array_equal(np.isfinite(got), np.isfinite(ref)):
        return float("inf")
    f = np.isfinite(ref)
    den = np.abs(ref[f]).max() if f.any() else 0.0
    return float(np.abs(got[f] - ref[f]).max() / den) if den > 0 else 0.0

