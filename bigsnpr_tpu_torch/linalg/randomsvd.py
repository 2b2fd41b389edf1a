"""Randomized partial SVD of the implicit standardized genotype operator.

The reference delegates to bigstatsr::big_randomSVD (an iterative
Lanczos-style solver parameterized by a matvec pair,
reference R/autoSVD.R:205-219). Here: an adaptive randomized block-Krylov
iteration (Musco & Musco 2015) on the sample-side Gram operator. Each
depth is one power step of the operator (X̃ᵀQ then X̃·, kernels K1 -> K2
on CUDA); the basis K, the cprod blocks M and the Gram G = MᵀM stay on
the operator's device, orthonormalized by CholQR2. Only the filled
corner of G comes to the host per depth, for the Ritz values that decide
convergence; u/v are formed on the device once, after convergence.
"""

from __future__ import annotations

import hashlib
import inspect
from dataclasses import dataclass

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator
from bigsnpr_tpu_torch.ops.matvec import DosageOperator, TorchOperator
from bigsnpr_tpu_torch.ops.stats import bed_scaleBinom
from bigsnpr_tpu_torch.utils.assertions import check_args


@dataclass
class BigSVD:
    """Result container mirroring bigstatsr's big_SVD {d, u, v, center, scale}."""

    d: np.ndarray        # (k,) singular values
    u: np.ndarray        # (n, k) left vectors (samples)
    v: np.ndarray        # (m, k) right vectors (variants)
    center: np.ndarray
    scale: np.ndarray
    niter: int = 0
    # filled by snp_autoSVD
    subset: np.ndarray | None = None
    lrldr: dict | None = None

    def scores(self) -> np.ndarray:
        """PC scores = u * d (the reference's predict.big_SVD)."""
        return self.u * self.d


def call_scaling(fun_scaling, pack, ind_row, device):
    """fun_scaling(pack, ind_row=...), passing `device` when it takes one."""
    params = inspect.signature(fun_scaling).parameters
    if "device" in params or any(p.kind == inspect.Parameter.VAR_KEYWORD
                                 for p in params.values()):
        return fun_scaling(pack, ind_row=ind_row, device=device)
    return fun_scaling(pack, ind_row=ind_row)


def _cached_op(pack, ctor, c_f, s_f, ind_row, ind_col, device=None, cap=4):
    """Reuse operators across calls on the same pack, keyed by content
    (scaling + masks + device + scheme), FIFO-capped. The packed bytes stay
    shared through the pack's device cache.

    Keys include id(pack.packed), so a pack whose packed array was swapped
    does not serve operators built on stale bytes (nor a stale NA-free
    flag), and the scheme `config.pallas_mxu`, so a change of it between
    calls builds a new operator."""
    mxu = config.resolve_mxu()
    h = hashlib.md5()
    h.update(str(id(pack.packed)).encode())
    for a in (c_f, s_f):
        h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
    for idx in (ind_row, ind_col):
        h.update(b"-" if idx is None else
                 np.ascontiguousarray(np.asarray(idx, np.int64)).tobytes())
    key = (ctor.__name__, str(device), mxu, h.hexdigest())
    cache = pack._op_cache
    if cache is None:
        cache = pack._op_cache = {}
    if key not in cache:
        if len(cache) >= cap:
            cache.pop(next(iter(cache)))
        cache[key] = ctor(pack, c_f, s_f, ind_row=ind_row, ind_col=ind_col,
                          device=device, mxu=mxu)
    return cache[key]


# --- the device block-Krylov loop -------------------------------------------

def _cholqr2(Y: torch.Tensor) -> torch.Tensor:
    """Two passes of Cholesky QR; the ridge keeps the factor finite when
    directions have collapsed into the existing span."""
    for _ in range(2):
        Gs = Y.T @ Y
        eps = 1e-7 * torch.trace(Gs) / Gs.shape[0] + 1e-30
        R = torch.linalg.cholesky(
            Gs + eps * torch.eye(Gs.shape[0], dtype=Y.dtype, device=Y.device))
        Y = torch.linalg.solve_triangular(R.T, Y, upper=True, left=False)
    return Y


def _krylov_newdirs(K, Y, filled):
    """Project Y out of span(K[:, :filled]), CholQR2, re-project, and zero
    directions whose surviving norm is negligible."""
    Km = K[:, :filled]
    for _ in range(2):
        Y = Y - Km @ (Km.T @ Y)
    Q = _cholqr2(Y)
    Q = Q - Km @ (Km.T @ Q)
    norms = torch.linalg.norm(Q, dim=0)
    return torch.where(norms > 1e-4, Q / torch.clamp(norms, min=1e-30),
                       torch.zeros((), dtype=Q.dtype, device=Q.device))


def _krylov_update(K, M, G, Q, B, filled):
    """Append block (Q, B) at column `filled` and grow G = MᵀM."""
    l = Q.shape[1]
    C = M[:, :filled].T @ B
    K[:, filled:filled + l] = Q
    M[:, filled:filled + l] = B
    G[:filled, filled:filled + l] = C
    G[filled:filled + l, :filled] = C.T
    G[filled:filled + l, filled:filled + l] = B.T @ B


def _ritz_host(G, filled, k):
    Gh = G[:filled, :filled].cpu().numpy().astype(np.float64)
    d = np.sqrt(np.maximum(np.linalg.eigvalsh(Gh)[::-1][:k], 0.0))
    return np.pad(d, (0, k - len(d)))  # filled < k at shallow depth


def _device_krylov(op, n, m, k, l, tol, max_depth, seed, verbose):
    """Block-Krylov on `op.power_dev` with all state on the operator's
    device. Returns (d, u, v, niter) as float64 numpy."""
    dev = op.device
    Lmax = l * max_depth
    rng_h = np.random.default_rng(seed)
    Y = torch.as_tensor(rng_h.standard_normal((n, l)).astype(np.float32),
                        device=dev)
    Q = _cholqr2(Y)
    B, Y = op.power_dev(Q)
    K = torch.zeros((n, Lmax), dtype=torch.float32, device=dev)
    M = torch.zeros((m, Lmax), dtype=torch.float32, device=dev)
    G = torch.zeros((Lmax, Lmax), dtype=torch.float32, device=dev)
    K[:, :l] = Q
    M[:, :l] = B
    G[:l, :l] = B.T @ B
    filled = l
    d_prev = np.zeros(k)
    niter = 0
    for it in range(max_depth):
        niter = it + 1
        d_now = _ritz_host(G, filled, k)
        rel = np.max(np.abs(d_now - d_prev) / np.maximum(d_now, 1e-30))
        if verbose:
            print(f"  randomSVD[device] depth {niter}: rel {rel:.2e}")
        if rel < tol or filled + l > Lmax or filled >= min(n, m):
            break
        d_prev = d_now
        Q = _krylov_newdirs(K, Y, filled)
        B, Y = op.power_dev(Q)
        _krylov_update(K, M, G, Q, B, filled)
        filled += l

    Gh = G[:filled, :filled].cpu().numpy().astype(np.float64)
    evals, Wh = np.linalg.eigh(Gh)
    order = np.argsort(evals)[::-1][:min(k, filled)]
    d = np.pad(np.sqrt(np.maximum(evals[order], 0.0)), (0, k - len(order)))
    W = np.zeros((filled, k), np.float32)
    W[:, :len(order)] = Wh[:, order]
    W = torch.as_tensor(W, device=dev)
    u = K[:, :filled] @ W
    v = (M[:, :filled] @ W) / torch.clamp(
        torch.as_tensor(d, dtype=torch.float32, device=dev), min=1e-30)
    return (d, u.cpu().numpy().astype(np.float64),
            v.cpu().numpy().astype(np.float64), niter)


@check_args()
def snp_randomSVD(
    pack,
    fun_scaling=bed_scaleBinom,
    ind_row=None,
    ind_col=None,
    k: int = 10,
    tol: float = 1e-4,
    max_iter: int = 200,
    oversample: int = 10,
    seed: int = 1,
    verbose: bool = False,
    engine: str = "auto",
    op=None,
    device=None,
) -> BigSVD:
    """Truncated SVD of the standardized genotype matrix.

    Reference: bed_randomSVD (R/autoSVD.R:205-219): needs only
    {scaling stats, X·v, Xᵀ·v}; k=10, tol=1e-4 defaults.

    engine: "auto" runs the `GenoOperator` (kernels K1/K2, K7 under
    `config.pallas_mxu = "split2"` or K6 under "int8", on CUDA; their
    twins on the CPU);
    "torch" the plain-torch `TorchOperator`.
    op: a pre-built operator with the {device, n, m, power_dev} surface;
    pack may then be None and fun_scaling must be a {"center","scale"}
    mapping.

    The scaling is computed over all variants on the row subset and taken
    at ind_col (identical values to scaling the physical subset); the
    operator masks ind_row/ind_col on the device. A DosagePack is subset
    physically (on the device), scaled, and run on the byte path
    (`DosageOperator`), as the JAX package runs it through
    `snp_cprodVec` / `snp_prodVec` on the subset."""
    if engine not in ("auto", "torch"):
        raise ValueError(f"engine must be 'auto' or 'torch', not {engine!r}")
    if op is not None:
        sc = fun_scaling(op) if callable(fun_scaling) else fun_scaling
        center = np.asarray(sc["center"], dtype=np.float64)
        scale = np.asarray(sc["scale"], dtype=np.float64)
    elif hasattr(pack, "code256"):
        device = config.resolve_device(device)
        sub = (pack if ind_row is None and ind_col is None
               else pack.subset(ind_row=ind_row, ind_col=ind_col,
                                device=device))
        sc = (call_scaling(fun_scaling, sub, None, device)
              if callable(fun_scaling) else fun_scaling)
        center = np.asarray(sc["center"], dtype=np.float64)
        scale = np.asarray(sc["scale"], dtype=np.float64)
        op = DosageOperator(sub, center, scale, device=device)
    else:
        device = config.resolve_device(device)
        sc = (call_scaling(fun_scaling, pack, ind_row, device)
              if callable(fun_scaling) else fun_scaling)
        c_f = np.asarray(sc["center"], dtype=np.float64)
        s_f = np.asarray(sc["scale"], dtype=np.float64)
        if len(c_f) != pack.m:
            raise ValueError("scaling length mismatch with pack")
        center = c_f if ind_col is None else c_f[np.asarray(ind_col)]
        scale = s_f if ind_col is None else s_f[np.asarray(ind_col)]
        ctor = GenoOperator if engine == "auto" else TorchOperator
        op = _cached_op(pack, ctor, c_f, s_f, ind_row, ind_col, device=device)
    n, m = op.n, op.m

    l0 = min(k + oversample, min(n, m))
    max_depth = max(2, min(max_iter, -(-min(n, m) // l0), 64))
    d, u, v, niter = _device_krylov(op, n, m, k, l0, tol, max_depth, seed,
                                    verbose)
    # sign convention: largest-|loading| coordinate of each u positive
    signs = np.sign(u[np.argmax(np.abs(u), axis=0), np.arange(k)])
    signs[signs == 0] = 1
    return BigSVD(d=d, u=u * signs, v=v * signs, center=center, scale=scale,
                  niter=niter)


def bed_randomSVD(pack, fun_scaling=bed_scaleBinom, ind_row=None,
                  ind_col=None, k=10, tol=1e-4, **kw) -> BigSVD:
    return snp_randomSVD(pack, fun_scaling=fun_scaling, ind_row=ind_row,
                         ind_col=ind_col, k=k, tol=tol, **kw)
