"""Genotype cohorts made on the device from a seed, and the phenotype.

Both generators write 2-bit PLINK codes (0: two copies of the first
allele, 1: missing, 2: heterozygous, 3: none), four samples a byte, low
bits first, a variant a row. The same seed gives the same bytes.
"""

from __future__ import annotations

import numpy as np

CODE_OF_DOSAGE = (3, 2, 0)     # alternative-allele count 0, 1, 2 -> code


def populations(groups, rest, n):
    """Sample counts and Fst of each population: `groups` {name: [samples,
    fst]} as given, then `rest` {"count", "ratio", "fst"}: that many
    populations sharing the remaining samples in a geometric series of
    ratio `ratio`, largest first, each of Fst `rest["fst"]`."""
    sizes = [int(v[0]) for v in groups.values()]
    fst = [float(v[1]) for v in groups.values()]
    left = n - sum(sizes)
    w = float(rest["ratio"]) ** np.arange(int(rest["count"]))
    r = np.floor(left * w / w.sum()).astype(np.int64)
    r[0] += left - r.sum()
    return (np.r_[r, sizes].astype(np.int64),
            np.r_[np.full(len(r), float(rest["fst"])), fst])


def _pack(torch, codes, nb):
    """(rows, n) uint8 codes -> (rows, nb) packed bytes."""
    c = torch.nn.functional.pad(codes, (0, nb * 4 - codes.shape[1])).view(
        codes.shape[0], nb, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def pca_cohort(torch, dev, n, m, seed, counts, fst, maf, na_share, na_rate,
               chunk=1024):
    """(m, ceil(n/4)) packed genotypes, made on the device a chunk of
    variants at a time and gathered into host memory; and each sample's
    population. Balding-Nichols: populations of `counts` samples whose
    allele frequencies are Beta draws of Fst `fst` (one a population)
    around ancestral ones ~ U(maf); genotypes in Hardy-Weinberg
    proportions, one uniform a genotype; `na_rate` of the calls missing on
    `na_share` of the variants."""
    counts, fst = np.asarray(counts, np.int64), np.asarray(fst, np.float64)
    assert counts.sum() == n and len(fst) == len(counts)
    rng = np.random.default_rng([seed, 11])
    p_anc = rng.uniform(maf[0], maf[1], m)
    f = fst[None, :]
    a, b = p_anc[:, None] * (1 - f) / f, (1 - p_anc[:, None]) * (1 - f) / f
    P = np.clip(rng.beta(a, b), 1e-3, 1 - 1e-3).astype(np.float32)
    pop = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    na_var = rng.random(m) < na_share
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    # Hardy-Weinberg: dosage 0 below (1 - p)^2, 2 above 1 - p^2
    t0 = torch.as_tensor((1 - P) ** 2, device=dev)
    t2 = torch.as_tensor(1 - P * P, device=dev)
    pop_t = torch.as_tensor(pop, device=dev)
    nb = (n + 3) // 4
    out = np.empty((m, nb), np.uint8)
    # two pinned staging buffers: a chunk's bytes come back while the next
    # chunk is made
    cuda = dev.type == "cuda"
    stage = [torch.empty((chunk, nb), dtype=torch.uint8, pin_memory=cuda)
             for _ in range(2)]
    pending = [None, None]

    def land(k):
        if pending[k] is not None:
            ev, a, b = pending[k]
            if ev is not None:
                ev.synchronize()
            out[a:b] = stage[k][:b - a].numpy()
            pending[k] = None

    for c, j0 in enumerate(range(0, m, chunk)):
        j1 = min(m, j0 + chunk)
        u = torch.rand((j1 - j0, n), generator=gen, device=dev)
        d = ((u >= t0[j0:j1].index_select(1, pop_t)).to(torch.uint8)
             + (u >= t2[j0:j1].index_select(1, pop_t)))
        codes = 3 - d - (d >> 1)          # dosage 0, 1, 2 -> code 3, 2, 0
        rows = np.nonzero(na_var[j0:j1])[0]
        if len(rows):
            r = torch.as_tensor(rows, device=dev)
            miss = torch.rand((len(rows), n), generator=gen, device=dev) \
                < na_rate
            codes[r] = torch.where(miss, 1, codes[r]).to(torch.uint8)
        k = c % 2
        land(k)
        stage[k][:j1 - j0].copy_(_pack(torch, codes, nb), non_blocking=cuda)
        ev = torch.cuda.Event() if cuda else None
        if cuda:
            ev.record()
        pending[k] = (ev, j0, j1)
        del u, d, codes
    land(0)
    land(1)
    return out, pop


def block_sizes(rng, m, bmin, bmax):
    """Block sizes drawn uniformly in [bmin, bmax] summing to m."""
    sizes = []
    while sum(sizes) < m:
        sizes.append(int(rng.integers(bmin, bmax + 1)))
    sizes[-1] -= sum(sizes) - m
    if sizes[-1] < bmin and len(sizes) > 1:
        last = sizes.pop()
        sizes[-1] += last
    return np.asarray(sizes)


def ld_cohort(torch, dev, n, m, seed, bmin, bmax, rho, maf, na_share,
              na_rate, chunk=4096):
    """(m, ceil(n/4)) packed genotypes on the device with LD in
    independent blocks: each haplotype is a latent Gaussian AR(1) along
    its block (lag-k correlation rho^k), thresholded at the variant's
    allele frequency ~ U(maf); `na_rate` of the calls missing on
    `na_share` of the variants. All blocks advance one position a step,
    longest first. Returns the packed bytes and the block sizes."""
    from scipy.stats import norm

    rng = np.random.default_rng([seed, 12])
    sizes = block_sizes(rng, m, bmin, bmax)
    order = np.argsort(-sizes, kind="stable")
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    p_anc = rng.uniform(maf[0], maf[1], m)
    na_var = torch.as_tensor(rng.random(m) < na_share, device=dev)
    thr = torch.as_tensor(norm.isf(p_anc), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    B = len(sizes)
    start_t = torch.as_tensor(starts[order], device=dev)
    sizes_sorted = sizes[order]
    code_of = torch.tensor(CODE_OF_DOSAGE, dtype=torch.uint8, device=dev)
    codes = torch.empty((m, n), dtype=torch.uint8, device=dev)
    z = torch.randn((2, n, B), generator=gen, device=dev)
    a = float(np.sqrt(1 - rho * rho))
    for j in range(int(sizes.max())):
        if j:
            z = rho * z + a * torch.randn((2, n, B), generator=gen,
                                          device=dev)
        k = int((sizes_sorted > j).sum())
        var = start_t[:k] + j
        d = (z[:, :, :k] > thr[var][None, None, :]).sum(0)    # (n, k)
        miss = ((torch.rand((n, k), generator=gen, device=dev) < na_rate)
                & na_var[var])
        codes[var] = torch.where(miss, 1, code_of[d]).T.to(torch.uint8)
    nb = (n + 3) // 4
    packed = torch.empty((m, nb), dtype=torch.uint8, device=dev)
    for j0 in range(0, m, chunk):
        packed[j0:j0 + chunk] = _pack(torch, codes[j0:j0 + chunk], nb)
    del codes, z
    return packed, sizes


def phenotype(torch, packed, n, seed, h2, n_causal):
    """A quantitative phenotype made from the packed genotypes on their
    device: `n_causal` variants drawn from the seed, standardized (missing
    calls at the variant's mean) with N(0, 1) effects, their sum scaled
    to variance h2, plus N(0, 1 - h2) noise. Returns float64 numpy."""
    dev = packed.device
    m = packed.shape[0]
    rng = np.random.default_rng([seed, 13])
    causal = np.sort(rng.choice(m, n_causal, replace=False))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 13)
    sub = packed[torch.as_tensor(causal, device=dev)]
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    codes = ((sub[:, :, None] >> shifts) & 3).reshape(len(causal), -1)[:, :n]
    val = torch.tensor([2.0, 0.0, 1.0, 0.0], dtype=torch.float64, device=dev)
    x = val[codes.long()]
    na = codes == 1
    cnt = (~na).sum(1, keepdim=True).clamp(min=1)
    mean = x.sum(1, keepdim=True) / cnt
    x = torch.where(na, mean, x)
    sd = ((x - mean) ** 2).sum(1, keepdim=True).div(cnt).sqrt().clamp(
        min=1e-12)
    eff = torch.randn(len(causal), generator=gen, device=dev,
                      dtype=torch.float64)
    g = ((x - mean) / sd * eff[:, None]).sum(0)
    g = (g - g.mean()) / g.std() * np.sqrt(h2)
    e = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    return (g + e * np.sqrt(1 - h2)).cpu().numpy()
