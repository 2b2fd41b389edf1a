"""Port parity: the blocked Gibbs sweep (K3, K4, K5 -> `gibbs_sweep`).

On the CPU `gibbs_kernels.sweep` runs its plain twin. Here the twin gets
the same state and the same pre-drawn u / z as the JAX package's Pallas
sweep kernels run in interpret mode (K3 `sweep_bucket_pallas`, K4
`sweep_bucket_pallas_mc`, K5 `sweep_bucket_pallas_v3` on
`device_put_mc`'s layout) and its XLA twin `_sweep_gibbs_batched`, one
sweep each. Tolerances are tests/test_blocked.py's: rtol 1e-5, atol 1e-6
on dp and betas (float32 sums in other orders), `causal` equal, rtol 1e-4
on the summed h2_inc and gap. The JAX layouts pre-shift rows by j % 8 and
pad lanes; a port block's dp row i is the JAX bucket's row i + ck - W.
tests/test_torch_cuda.py holds the CUDA kernel against the twin on a
card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from bigsnpr_tpu.ops.corr import SparseLD as JaxSparseLD
from bigsnpr_tpu.pgs import gibbs_blocked as jgb
from bigsnpr_tpu.pgs import gibbs_pallas as gp
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import gibbs_kernels as gk
from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
NC = 3
SIZES = [40, 25, 60, 35, 7]   # buckets (8, 16), (32, 64), (64, 128): pads


def blockdiag_corr(sizes, seed):
    rng = np.random.default_rng(seed)
    mats = []
    for sz in sizes:
        A = rng.normal(size=(sz, 4 * sz))
        A = 0.6 * A + 0.4 * np.roll(A, 1, axis=0)
        mats.append(np.corrcoef(A))
    upper = sp.triu(sp.block_diag(mats).tocsc()).tocsc()
    return upper


@pytest.fixture(scope="module")
def case():
    upper = blockdiag_corr(SIZES, 8)
    jcorr = JaxSparseLD(upper=upper)
    pcorr = interop.sparse_ld_from_numpy(upper.data, upper.indices,
                                         upper.indptr, upper.shape)
    jbb = jgb.build_block_bands(jcorr, SIZES)
    pbb = pgb.build_block_bands(pcorr, SIZES)
    m = pbb.m
    rng = np.random.default_rng(0)
    f32 = np.float32
    st = dict(
        bh=rng.normal(0, 0.05, m).astype(f32),
        C2=rng.uniform(0.1, 0.9, (NC, m)).astype(f32),
        C4=rng.uniform(0.1, 0.9, (NC, m)).astype(f32),
        s1=rng.uniform(1.0, 2.0, (NC, m)).astype(f32),
        u=rng.uniform(0, 1, (NC, m)).astype(f32),
        z=rng.normal(0, 1, (NC, m)).astype(f32),
        cb=(rng.normal(0, 0.05, (NC, m))
            * (rng.random((NC, m)) < 0.5)).astype(f32),
        inv_odd_p=np.array([4.0, 9.0, 1.5], f32),
        p=np.array([0.2, 0.1, 0.4], f32),
        sparse=np.array([False, True, False]))
    sb = pbb.device_put("cpu")
    st["dp"] = rng.normal(0, 0.05, (NC, sb.dp_len)).astype(f32)
    return dict(jbb=jbb, pbb=pbb, sb=sb, m=m, st=st)


def run_twin(case, shrink, no_jump):
    sb, st = case["sb"], case["st"]
    t = {k: torch.as_tensor(v) for k, v in st.items()}
    dp = t["dp"].clone()
    out = gk.sweep(sb, dp, t["cb"], t["bh"], t["C2"], t["C4"], t["s1"],
                   t["u"], t["z"], t["inv_odd_p"], t["p"], t["sparse"],
                   shrink, no_jump)
    assert gk.launches["sweep"] == 0          # CPU tensors take the twin
    return dp.numpy(), [o.numpy() for o in out]


def port_dp_block(case, dp, k):
    """(NC, Bk, L) dp of bucket k from the port's (NC, dp_len) state."""
    v = case["sb"].views[k]
    return dp[:, v["dp_off"]:v["dp_off"] + v["Bk"] * v["L"]].reshape(
        NC, v["Bk"], v["L"])


def jax_dp(case, k, rows_total, ck, lanes):
    """The port's initial dp of bucket k in a JAX layout (NC, L', lanes)
    with the centre of row j at j + ck."""
    v = case["sb"].views[k]
    W, L = v["W"], v["L"]
    d = port_dp_block(case, case["st"]["dp"], k)
    out = np.zeros((NC, rows_total, lanes), np.float32)
    out[:, ck - W:ck - W + L, :d.shape[1]] = d.transpose(0, 2, 1)
    return out


def slots(x, g, fill=0.0):
    """(NC, m) or (m,) global -> slot layout (..., mbk, lanes)."""
    x = np.asarray(x)
    valid = g >= 0
    return np.where(valid, x[..., np.clip(g, 0, None)], fill)


def check_bucket(case, k, dp_twin, outs, ys, dp_j, ck, g, chains):
    """Hold the twin's bucket k against JAX slot outputs ys
    [(mbk, lanes) x 5 per chain] and dp (NC, L', lanes)."""
    v = case["sb"].views[k]
    W, L, Bk = v["W"], v["L"], v["Bk"]
    valid = g >= 0
    nb, causal, postp, binc, dps = outs[:5]
    for c in chains:
        for name, twin, jx in (("beta", nb, ys[c][0]), ("postp", postp,
                                                         ys[c][2]),
                               ("beta_inc", binc, ys[c][3]),
                               ("dps", dps, ys[c][4])):
            np.testing.assert_allclose(
                twin[c][g[valid]], np.asarray(jx)[valid], **TOL,
                err_msg=f"bucket {k} chain {c} {name}")
        np.testing.assert_array_equal(
            causal[c][g[valid]], np.asarray(ys[c][1])[valid] != 0)
        got = port_dp_block(case, dp_twin, k)[c]               # (Bk, L)
        ref = np.asarray(dp_j)[c, ck - W:ck - W + L, :Bk].T
        np.testing.assert_allclose(got, ref, **TOL,
                                   err_msg=f"bucket {k} chain {c} dp")


def xin_rows(st, g, shrink, dt=np.float32):
    """The 12 per-variant rows of the JAX kernels' xin, (NC, mbk, lanes)
    each (rows 5-6 are the pre-drawn u and z)."""
    c4 = slots(st["C4"], g, 1.0)
    ones = np.ones((NC,) + g.shape, dt)
    return [np.broadcast_to(slots(st["bh"], g), (NC,) + g.shape),
            slots(st["C2"], g), c4, slots(st["s1"], g, 1.0), np.sqrt(c4),
            slots(st["u"], g, 2.0), slots(st["z"], g), slots(st["cb"], g),
            ones * st["inv_odd_p"][:, None, None],
            ones * st["p"][:, None, None], ones * dt(shrink),
            ones * st["sparse"].astype(dt)[:, None, None]]


def xin_mc(st, g, shrink):
    rows = xin_rows(st, g, shrink)
    rows += [np.zeros_like(rows[0])] * (gp.NIN - len(rows))
    return jnp.asarray(np.stack(rows).transpose(2, 1, 0, 3), jnp.float32)


def sums(outs):
    return outs[5], outs[6]


CASES = [(1.0, False), (0.9, True)]


def test_block_bands_buckets_equal_jax(case):
    """The port's own build and the rebuild from JAX's buckets (interop)
    hold the JAX package's buckets exactly; so does block_layout."""
    jbb, pbb = case["jbb"], case["pbb"]
    rebuilt = interop.block_bands_from_numpy(jbb.buckets, jbb.m,
                                             jbb.dropped_r2, jbb.kept_r2)
    for bb in (pbb, rebuilt):
        assert len(jbb.buckets) == len(bb.buckets) == 3
        for (jb, jg), (pb, pg) in zip(jbb.buckets, bb.buckets):
            np.testing.assert_array_equal(pb, jb)
            np.testing.assert_array_equal(pg, jg)
        assert bb.dropped_r2 == jbb.dropped_r2 and bb.kept_r2 == jbb.kept_r2
    for a, b in zip(pgb.block_layout(SIZES), jgb.block_layout(SIZES)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shrink,no_jump", CASES)
def test_twin_matches_sweep_gibbs_batched(case, shrink, no_jump):
    """The JAX package's XLA twin, vmapped over chains per bucket."""
    dp_t, outs = run_twin(case, shrink, no_jump)
    st = case["st"]
    bands, gidx = case["jbb"].device_put()
    run = jax.vmap(jgb._sweep_gibbs_batched,
                   in_axes=(0, 0, None, None, 0, 0, 0, 0, 0, 0, None, None,
                            0, 0, None))
    h2 = np.zeros(NC)
    gap = np.zeros(NC)
    for k, (bk, gk_) in enumerate(zip(bands, gidx)):
        g = np.asarray(gk_)
        ck = (bk.shape[1] - 8) // 2
        rows = xin_rows(st, g, shrink)
        dp_j = jax_dp(case, k, bk.shape[0] + bk.shape[1], ck, g.shape[1])
        dpk, nbk, aux = run(jnp.asarray(dp_j), jnp.asarray(rows[7]), bk,
                            jnp.asarray(rows[0][0]), jnp.asarray(rows[1]),
                            jnp.asarray(rows[2]), jnp.asarray(rows[3]),
                            jnp.asarray(st["inv_odd_p"]),
                            jnp.asarray(st["p"]), jnp.asarray(st["sparse"]),
                            jnp.float32(shrink), no_jump,
                            jnp.asarray(rows[5]), jnp.asarray(rows[6]), ck)
        gapk, causalk, h2k, postpk, betak, dpsk = aux
        ys = [[nbk[c], causalk[c], postpk[c], betak[c], dpsk[c]]
              for c in range(NC)]
        check_bucket(case, k, dp_t, outs, ys, dpk, ck, g, range(NC))
        h2 += np.asarray(h2k)
        gap += np.asarray(gapk)
    np.testing.assert_allclose(sums(outs)[0], h2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sums(outs)[1], gap, rtol=1e-4)


@pytest.mark.parametrize("shrink,no_jump", CASES)
def test_twin_matches_k3_interpret(case, shrink, no_jump):
    """K3: one chain per call, blocks in lanes (chains 0 and 1: the
    second has the sparse skip on)."""
    dp_t, outs = run_twin(case, shrink, no_jump)
    st = case["st"]
    bands, gidx = case["jbb"].device_put()
    for k, (bk, gk_) in enumerate(zip(bands, gidx)):
        g = np.asarray(gk_)
        ck = (bk.shape[1] - 8) // 2
        dp_all = jax_dp(case, k, bk.shape[0] + bk.shape[1] - 1, ck,
                        g.shape[1])
        rows = xin_rows(st, g, shrink)
        ys, dps = [None] * NC, np.zeros_like(dp_all)
        for c in (0, 1):
            xr = [r[c] for r in rows]
            xin = np.stack(xr + [np.zeros_like(xr[0])] * (gp.NIN - 12),
                           axis=1)
            y, dpc, _, _ = gp.sweep_bucket_pallas(
                bk, jnp.asarray(xin, jnp.float32), jnp.asarray(dp_all[c]),
                ck, no_jump, interpret=True)
            y = np.asarray(y)
            ys[c] = [y[:, i, :] for i in range(5)]
            dps[c] = np.asarray(dpc)
        check_bucket(case, k, dp_t, outs, ys, dps, ck, g, (0, 1))


@pytest.mark.parametrize("shrink,no_jump", CASES)
def test_twin_matches_k4_interpret(case, shrink, no_jump):
    """K4: all chains share one band read, RG = 8 rows a grid step."""
    dp_t, outs = run_twin(case, shrink, no_jump)
    st = case["st"]
    bands, gidx = case["jbb"].device_put()
    h2 = np.zeros(NC)
    for k, (bk, gk_) in enumerate(zip(bands, gidx)):
        g = np.asarray(gk_)
        ck = (bk.shape[1] - 8) // 2
        dp_j = jax_dp(case, k, bk.shape[0] + bk.shape[1], ck, g.shape[1])
        ys, dpk, h2k, _ = gp.sweep_bucket_pallas_mc(
            bk, xin_mc(st, g, shrink), jnp.asarray(dp_j), ck, 8, no_jump,
            interpret=True)
        ys = np.asarray(ys)
        check_bucket(case, k, dp_t, outs,
                     [[ys[:, c, i, :] for i in range(5)] for c in range(NC)],
                     dpk, ck, g, range(NC))
        h2 += np.asarray(h2k).sum(1)
    np.testing.assert_allclose(sums(outs)[0], h2, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shrink,no_jump", CASES)
def test_twin_matches_k5_interpret(case, shrink, no_jump):
    """K5: the width-paneled kernel on device_put_mc's layout."""
    dp_t, outs = run_twin(case, shrink, no_jump)
    st = case["st"]
    bands, centers, gidx, meta = case["jbb"].device_put_mc()
    gap = np.zeros(NC)
    for k, (bk, bc, gk_, (ck, WP)) in enumerate(zip(bands, centers, gidx,
                                                    meta)):
        g = np.asarray(gk_)
        dp_j = jax_dp(case, k, bk.shape[0] + bk.shape[1], ck, g.shape[1])
        ys, dpk, _, gapk = gp.sweep_bucket_pallas_v3(
            bk, bc, xin_mc(st, g, shrink), jnp.asarray(dp_j), ck, WP,
            no_jump, interpret=True)
        ys = np.asarray(ys)
        check_bucket(case, k, dp_t, outs,
                     [[ys[:, c, i, :] for i in range(5)] for c in range(NC)],
                     dpk, ck, g, range(NC))
        gap += np.asarray(gapk).sum(1)
    np.testing.assert_allclose(sums(outs)[1], gap, rtol=1e-4)


def test_bucketed_sweep_matches_jax(case):
    """One NC-chain sweep over every bucket, global vectors in and out,
    against `_sweeps_bucketed_mc(use_pallas=False)` with the same draws."""
    st, m = case["st"], case["m"]
    bands, gidx = case["jbb"].device_put()
    dp_pads = tuple(jnp.asarray(jax_dp(case, k, b.shape[0] + b.shape[1],
                                       (b.shape[1] - 8) // 2, b.shape[2]))
                    for k, b in enumerate(bands))
    J = lambda a: jnp.asarray(a)  # noqa: E731
    dp_j, nb_j, aux_j = jgb._sweeps_bucketed_mc(
        bands, gidx, dp_pads, J(st["cb"]),
        (J(st["bh"]), J(st["C2"]), J(st["C4"]), J(st["s1"])), J(st["u"]),
        J(st["z"]), J(st["inv_odd_p"]), J(st["p"]), J(st["sparse"]),
        0.95, True, m, use_pallas=False)
    t = {k: torch.as_tensor(v) for k, v in st.items()}
    dp = t["dp"].clone()
    nb, aux = pgb.sweeps_bucketed_mc(
        case["sb"], dp, t["cb"], (t["bh"], t["C2"], t["C4"], t["s1"]),
        t["u"], t["z"], t["inv_odd_p"], t["p"], t["sparse"], 0.95, True)
    np.testing.assert_allclose(nb.numpy(), np.asarray(nb_j), **TOL)
    np.testing.assert_array_equal(aux[1].numpy(), np.asarray(aux_j[1]))
    for i in (3, 4, 5):
        np.testing.assert_allclose(aux[i].numpy(), np.asarray(aux_j[i]),
                                   **TOL)
    np.testing.assert_allclose(aux[0].numpy(), np.asarray(aux_j[0]),
                               rtol=1e-4)
    np.testing.assert_allclose(aux[2].numpy(), np.asarray(aux_j[2]),
                               rtol=1e-4, atol=1e-6)
    for k, b in enumerate(bands):
        W, L = case["sb"].views[k]["W"], case["sb"].views[k]["L"]
        ck = (b.shape[1] - 8) // 2
        Bk = case["sb"].views[k]["Bk"]
        np.testing.assert_allclose(
            port_dp_block(case, dp.numpy(), k),
            np.asarray(dp_j[k])[:, ck - W:ck - W + L, :Bk].transpose(0, 2, 1),
            **TOL)


def test_float64_twin_matches_float32(case):
    """dtype float64 runs the same sweep in double: one sweep agrees with
    the float32 one to float32 round-off."""
    _, outs32 = run_twin(case, 1.0, False)
    sb64 = case["pbb"].device_put("cpu", dtype=np.float64)
    t = {k: torch.as_tensor(v).double() if v.dtype == np.float32
         else torch.as_tensor(v) for k, v in case["st"].items()}
    dp = t["dp"].clone()
    outs64 = gk.sweep(sb64, dp, t["cb"], t["bh"], t["C2"], t["C4"], t["s1"],
                      t["u"], t["z"], t["inv_odd_p"], t["p"], t["sparse"],
                      1.0, False)
    assert outs64[0].dtype == torch.float64
    np.testing.assert_array_equal(outs64[1].numpy(), outs32[1])
    np.testing.assert_allclose(outs64[0].numpy(), outs32[0], rtol=1e-5,
                               atol=1e-6)


def test_sweep_checks_operands(case):
    sb = case["sb"]
    t = {k: torch.as_tensor(v) for k, v in case["st"].items()}
    with pytest.raises(ValueError, match="C2 must be"):
        gk.sweep(sb, t["dp"].clone(), t["cb"], t["bh"], t["C2"][:, :5],
                 t["C4"], t["s1"], t["u"], t["z"], t["inv_odd_p"], t["p"],
                 t["sparse"], 1.0, False)
    pl = gk.plan(sb, 30, 227 << 10)
    tiles = -(-30 // pl.nct)
    assert 1 <= pl.nct <= gk.RING_MAX_CHAINS and -(-30 // tiles) == pl.nct
    assert pl.threads == gk.ring_threads(pl.nct) and pl.smem <= 227 << 10
    # the ring and the strips need their own ~28 KB, so a device with 4 KB
    # of shared memory a block cannot hold this band
    with pytest.raises(ValueError, match="ring of"):
        gk.plan(sb, 30, 4096)
