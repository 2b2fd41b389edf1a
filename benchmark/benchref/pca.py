"""Plain reference for the randomized PCA cell (torch and numpy only).

It works the scaling out again from the bytes, and judges a returned
(d, u, v) by two numbers, both in float64 over the whole matrix, in
blocks of variants, X~ the genotypes scaled by the reference's own
binomial scaling:

- v_resid = max_k |X~' u_k - d_k v_k| / d_k. The algorithm returns
  v = X~' u / d, so this reads the precision of the products (K1), the
  Gram and the scaling, whatever the Krylov depth.
- u_resid = max_k |X~ v_k - d_k u_k| / d_k: whether (d, u, v) are
  singular triplets, so the Krylov space (K2's products) and its
  convergence.

`control_svd` is the control: a block-Krylov randomized SVD of the same
algorithm with its product operands rounded to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchref.common import round_to, standardized


def scaling(packed: torch.Tensor, n: int, block: int = 2048):
    """Binomial scaling from the bytes: center 2 af, scale
    sqrt(2 af (1 - af)), af over the calls present (float64)."""
    from benchref.common import dosage

    m = packed.shape[0]
    s = torch.empty(m, dtype=torch.float64, device=packed.device)
    c = torch.empty(m, dtype=torch.float64, device=packed.device)
    for j0 in range(0, m, block):
        d, ok = dosage(packed[j0:j0 + block], n)
        s[j0:j0 + block] = d.sum(1)
        c[j0:j0 + block] = ok.sum(1).to(torch.float64)
    af = s / (2 * c.clamp(min=1))
    return 2 * af, torch.sqrt(2 * af * (1 - af))


def _passes(packed, n, center, scale, block, fmt=None):
    """Yields (j0, X_b) over variant blocks: X_b (b, n) of X~' rows, in
    float64, or in float32 rounded to `fmt` for the control."""
    dt = torch.float64 if fmt is None else torch.float32
    for j0 in range(0, packed.shape[0], block):
        j1 = min(packed.shape[0], j0 + block)
        yield j0, standardized(packed[j0:j1], n, center[j0:j1],
                               scale[j0:j1], dt, fmt)


def judge(packed, n, d, u, v, block=1024) -> dict:
    """{v_resid, u_resid} of a returned (d (k,), u (n, k), v (m, k)), in
    one float64 pass over the matrix."""
    dev = packed.device
    center, scale = scaling(packed, n)
    d_t = torch.as_tensor(np.asarray(d, np.float64), device=dev)
    U = torch.as_tensor(np.asarray(u, np.float64), device=dev)
    V = torch.as_tensor(np.asarray(v, np.float64), device=dev)
    r2v = torch.zeros(len(d_t), dtype=torch.float64, device=dev)
    XV = torch.zeros_like(U)
    for j0, X in _passes(packed, n, center, scale, block):
        Vb = V[j0:j0 + X.shape[0]]
        r2v += ((X @ U - Vb * d_t) ** 2).sum(0)
        XV += X.T @ Vb
    r2u = ((XV - U * d_t) ** 2).sum(0)
    dd = d_t.clamp(min=1e-300)
    return {"v_resid": float((r2v.sqrt() / dd).max()),
            "u_resid": float((r2u.sqrt() / dd).max())}


def control_svd(packed, n, k, oversample=10, tol=1e-4, max_depth=64,
                seed=1, fmt="tf32", block=1024):
    """The control: the block-Krylov randomized SVD of the program's
    algorithm, in float32 with every product operand rounded to `fmt`.
    Returns (d, u, v) as float64 numpy and the Krylov depth."""
    dev = packed.device
    m = packed.shape[0]
    l = k + oversample
    center, scale = scaling(packed, n)
    center, scale = center.float(), scale.float()

    def power(Q):
        Qr = round_to(Q, fmt)
        B = torch.empty((m, l), dtype=torch.float32, device=dev)
        Y = torch.zeros((n, l), dtype=torch.float32, device=dev)
        for j0, X in _passes(packed, n, center, scale, block, fmt):
            Bj = X @ Qr
            B[j0:j0 + X.shape[0]] = Bj
            Y += X.T @ round_to(Bj, fmt)
        return B, Y

    def orth(Y, K=None):
        if K is not None:
            for _ in range(2):
                Y = Y - K @ (K.T @ Y)
        return torch.linalg.qr(Y)[0]

    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    Q = orth(torch.randn((n, l), generator=g, device=dev))
    Ks, Ms = [Q], []
    B, Y = power(Q)
    Ms.append(B)
    d_prev = np.zeros(k)
    for depth in range(1, max_depth + 1):
        M = torch.cat(Ms, 1)
        G = round_to(M, fmt).T @ round_to(M, fmt)
        ev = np.linalg.eigvalsh(G.double().cpu().numpy())[::-1][:k]
        d_now = np.sqrt(np.maximum(ev, 0))
        rel = np.max(np.abs(d_now - d_prev) / np.maximum(d_now, 1e-30))
        if rel < tol or M.shape[1] + l > min(n, m):
            break
        d_prev = d_now
        Q = orth(Y, torch.cat(Ks, 1))
        B, Y = power(Q)
        Ks.append(Q)
        Ms.append(B)
    K, M = torch.cat(Ks, 1), torch.cat(Ms, 1)
    G = (round_to(M, fmt).T @ round_to(M, fmt)).double().cpu().numpy()
    ev, W = np.linalg.eigh(G)
    order = np.argsort(ev)[::-1][:k]
    d = np.sqrt(np.maximum(ev[order], 0))
    W = torch.as_tensor(W[:, order], dtype=torch.float32, device=dev)
    u = round_to(K, fmt) @ round_to(W, fmt)
    v = (round_to(M, fmt) @ round_to(W, fmt)) / torch.as_tensor(
        d, dtype=torch.float32, device=dev)
    return d, u.double().cpu().numpy(), v.double().cpu().numpy(), depth
