"""The JAX package's `matmul_precision` option in the port
(`bigsnpr_tpu_torch/config.py`, `ops/precision.py`, port DEVIATIONS #36),
and the JAX options the port used to refuse (#4, #34).

- The option's surface against the JAX package's
  (tests/test_assertions.py::test_config_options_context): the default,
  the scoped override and its restore, the env variable, unknown names.
- The helper on the CPU at each name against a float64 product of the
  operands rounded as the name says ("default": bf16; "high": bf16 hi +
  lo, hi·hi + hi·lo + lo·hi): within 1e-6 of max |float64| (only the
  float32 accumulation rounds); "highest" is torch's float32 product bit
  for bit.
- Each site that reads the option against the JAX package at the same
  name. JAX on the CPU computes float32 at every name, so the bounds are
  the port's rounding: "highest" the site's own parity bound as in its
  module's test; "high" 1e-4 and "default" 1e-2 of max |JAX| for a
  product, 1e-3 and 5e-2 for a statistic computed from products
  (t-scores, singular values, imputed dosages).
- No call changes torch's process-wide matmul flags (an autouse check).
- snp_randomSVD's JAX engine names, a DosagePack under the mesh engines,
  the mesh's precision names, `enable_compilation_cache`."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu import config as jcfg
from bigsnpr_tpu.assoc import pcadapt as jpca
from bigsnpr_tpu.core.dosage import DosagePack as JaxDosagePack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.io import bgen as jbgen
from bigsnpr_tpu.ops import grm as jgrm
from bigsnpr_tpu.ops.matvec import XlaOperator
from bigsnpr_tpu.pca import project as jproj
from bigsnpr_tpu.utils import impute as jimp
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.assoc import pcadapt as ppca
from bigsnpr_tpu_torch.core import unpack
from bigsnpr_tpu_torch.ops import cuda_build, precision
from bigsnpr_tpu_torch.parallel import mesh as pmesh
from bigsnpr_tpu_torch.pca import project as pproj
from bigsnpr_tpu_torch.utils import impute as pimp

from test_torch_bgen import bgen_file  # noqa: F401  (a module fixture)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("highest", "high", "default")
# relative to max |JAX|: a product, and a statistic computed from products
BOUND = {"product": {"high": 1e-4, "default": 1e-2},
         "statistic": {"high": 1e-3, "default": 5e-2}}


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield
    # the option never touches torch's process-wide flags
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert pt.config.matmul_precision == "highest"


def at(name):
    """Both packages' option set to `name`."""
    stack = contextlib.ExitStack()
    stack.enter_context(jcfg.options(matmul_precision=name))
    stack.enter_context(pt.config.options(matmul_precision=name))
    return stack


def within(got, ref, name, kind, highest):
    """max |got - ref| <= bound * max |ref|, NaN at the same places."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    bound = highest if name == "highest" else BOUND[kind][name]
    err = np.nanmax(np.abs(got - ref)) / np.nanmax(np.abs(ref))
    assert err <= bound, (name, err, bound)
    return err


# ---------------------------------------------------------------------------
# the option
# ---------------------------------------------------------------------------

def test_option_surface_matches_jax():
    """tests/test_assertions.py::test_config_options_context, in both
    packages side by side."""
    for cfg in (jcfg, pt.config):
        assert cfg.get_option("matmul_precision") == "highest"
        with cfg.options(matmul_precision="default", check_args=False,
                         pallas_mxu="split2"):
            assert cfg.get_option("matmul_precision") == "default"
            assert cfg.get_option("check_args") is False
            assert cfg.pallas_mxu == "split2"
        assert cfg.get_option("matmul_precision") == "highest"
        assert cfg.get_option("check_args") is True
        assert cfg.pallas_mxu == "highest"
        with pytest.raises(KeyError):
            cfg.get_option("nope")
    for name in NAMES:
        jcfg.set_matmul_precision(name)
        pt.config.set_matmul_precision(name)
        try:
            assert pt.config.matmul_precision == jcfg.matmul_precision
            # the port's dot_precision is the name (torch has no enum)
            assert pt.config.dot_precision() == name
            assert jcfg.dot_precision() == jcfg._PRECISIONS[name]
        finally:
            jcfg.set_matmul_precision("highest")
            pt.config.set_matmul_precision("highest")


def test_unknown_name_raises():
    for call in (lambda: pt.config.set_matmul_precision("bf16"),
                 lambda: pt.config.set_option("matmul_precision", "low"),
                 lambda: precision.resolve("fast")):
        with pytest.raises(ValueError, match="matmul_precision"):
            call()
    with pytest.raises(ValueError, match="matmul_precision"):
        with pt.config.options(matmul_precision="tf32"):
            pass
    assert pt.config.matmul_precision == "highest"
    # a bad name set behind the setter's back is caught where it is read
    pt.config.matmul_precision = "half"
    try:
        with pytest.raises(ValueError, match="matmul_precision"):
            precision.mm(torch.ones(2, 2), torch.ones(2, 2))
    finally:
        pt.config.matmul_precision = "highest"


def test_env_variable():
    """BIGSNPR_MATMUL_PRECISION is read at import by both packages; an
    unknown value raises where it is read (the port: ValueError)."""
    code = ("import bigsnpr_tpu.config as j, bigsnpr_tpu_torch as pt\n"
            "print(j.matmul_precision, pt.config.matmul_precision,"
            " pt.config.dot_precision())\n"
            "pt.config.matmul_precision = 'x'\n"
            "try:\n"
            "    pt.config.dot_precision()\n"
            "except ValueError:\n"
            "    print('raised')\n")
    env = {**os.environ, "BIGSNPR_MATMUL_PRECISION": "high",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["high", "high", "high", "raised"]


# ---------------------------------------------------------------------------
# the helper
# ---------------------------------------------------------------------------

def rounded64(a):
    """The bf16 terms (hi, lo) of `a` as float64."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi.double(), lo.double()


def reference64(a, b, name):
    ah, al = rounded64(a)
    bh, bl = rounded64(b)
    if name == "highest":
        return a.double() @ b.double()
    if name == "default":
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


@pytest.mark.parametrize("op", ["mm", "addmm_", "bmm"])
@pytest.mark.parametrize("name", NAMES)
def test_helper_rounds_as_the_name_says(op, name):
    g = torch.Generator().manual_seed(3)
    a = torch.randn((3, 37, 200), generator=g) + 0.5
    b = torch.randn((3, 200, 11), generator=g)
    acc = torch.randn((37, 11), generator=g)
    if op == "mm":
        got, ref = precision.mm(a[0], b[0], name), reference64(a[0], b[0],
                                                               name)
        out = torch.empty_like(got)
        assert precision.mm(a[0], b[0], name, out=out) is out
        assert torch.equal(out, got)
        if name == "highest":
            assert torch.equal(got, a[0] @ b[0])
    elif op == "addmm_":
        # a transposed operand, as the sites pass X.T
        at_ = a[0].T.contiguous().T
        got = precision.addmm_(acc.clone(), at_, b[0], name)
        ref = acc.double() + reference64(a[0], b[0], name)
        if name == "highest":
            assert torch.equal(got, acc.clone().addmm_(at_, b[0]))
    else:
        got, ref = precision.bmm(a, b, name), reference64(a, b, name)
        if name == "highest":
            assert torch.equal(got, torch.bmm(a, b))
    assert got.dtype == torch.float32
    err = (got.double() - ref).abs().max() / ref.abs().max()
    assert err <= 1e-6, err
    if name == "default":          # the rounding shows: far from exact
        exact = reference64(a, b, "highest")
        exact = exact if op == "bmm" else exact[0]
        exact = exact + acc.double() if op == "addmm_" else exact
        assert (got.double() - exact).abs().max() > 1e-4 * exact.abs().max()


def test_split_is_exact_to_bf16x2():
    x = torch.randn(10_000, dtype=torch.float32) * 3
    hi, lo = precision.split_bf16(x)
    r = x.double() - hi.double() - lo.double()
    assert (r.abs() <= x.double().abs() * 2.0 ** -16).all()
    assert torch.equal(hi, x.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the sites, against the JAX package at the same name
# ---------------------------------------------------------------------------

def fake_packs(n, m, seed, na_prob=0.04):
    jp = bt.snp_fake(n, m, seed=seed, na_prob=na_prob)
    return jp, interop.pack_from_numpy(np.asarray(jp.packed), n)


@pytest.mark.parametrize("name", NAMES)
def test_grm(name):
    jp, pp = fake_packs(97, 260, seed=51)
    with at(name):
        K, _, _ = pt.bed_tcrossprodSelf(pp, block=64)
        Kj, _, _ = jgrm.bed_tcrossprodSelf(jp, block=64)
    within(K, Kj, name, "product", 2e-6)


def test_grm_default_moves_away_from_highest():
    """"default" reaches the GRM's product: it differs from "highest" by
    far more than float32 round-off, which "highest" keeps to float64."""
    jp, pp = fake_packs(97, 260, seed=51)
    sc = bt.bed_scaleBinom(jp)
    Xt = np.nan_to_num((jp.to_dosage() - sc["center"]) / sc["scale"])
    K64 = Xt @ Xt.T
    Kh, _, _ = pt.bed_tcrossprodSelf(pp, block=64)
    with pt.config.options(matmul_precision="default"):
        Kd, _, _ = pt.bed_tcrossprodSelf(pp, block=64)
    top = np.abs(K64).max()
    assert np.abs(Kh - K64).max() <= 2e-6 * top
    assert np.abs(Kd - Kh).max() >= 1e-4 * top


@pytest.fixture(scope="module")
def dosages():
    rng = np.random.default_rng(81)
    m, n = 60, 150
    codes = rng.integers(7, 208, size=(m, n)).astype(np.uint8)
    codes[rng.random((m, n)) < 0.05] = 3
    return (JaxDosagePack(codes=codes, n=n),
            interop.dosage_from_numpy(codes, n))


@pytest.mark.parametrize("name", NAMES)
def test_byte_path(dosages, name):
    jd, pdp = dosages
    rng = np.random.default_rng(5)
    v = rng.standard_normal((jd.n, 4))
    u = rng.standard_normal((jd.m, 3))
    c = rng.uniform(0.2, 1.8, jd.m)
    s = rng.uniform(0.5, 1.0, jd.m)
    with at(name):
        for got, ref in ((pt.snp_cprodVec(pdp, v, c, s),
                          bt.snp_cprodVec(jd, v, c, s)),
                         (pt.snp_prodVec(pdp, u, c, s, block=16),
                          bt.snp_prodVec(jd, u, c, s))):
            within(got, ref, name, "product", 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_pcadapt_mult_lin_reg(name):
    jp, pp = fake_packs(331, 260, seed=4)
    U = np.random.default_rng(3).standard_normal((331, 3))
    with at(name):
        t_p = ppca.mult_lin_reg(pp, U, block=64)
        t_j = jpca.mult_lin_reg(jp, U, block=64)
    within(t_p, t_j, name, "statistic", 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_projection(name):
    jp, pp = fake_packs(203, 300, seed=9)
    sc = bt.bed_scaleBinom(jp)
    cols = np.sort(np.random.default_rng(1).choice(300, 170, replace=False))
    V = np.random.default_rng(2).standard_normal((170, 5))
    args = (V, sc["center"][cols], sc["scale"][cols])
    with at(name):
        xv_p, xn_p = pproj.prod_and_row_sums_sq(pp, *args, ind_col=cols,
                                                block=32)
        xv_j, xn_j = jproj.prod_and_row_sums_sq(jp, *args, ind_col=cols,
                                                block=32)
    within(xv_p, xv_j, name, "product", 1e-4)
    within(xn_p, xn_j, "highest", "product", 1e-4)   # no product in it


def structured_packs(n=240, m=400, seed=0):
    """tests/test_torch_matvec_svd.py's three populations."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    p = np.clip(rng.uniform(0.1, 0.5, m)[:, None]
                + rng.normal(0, 0.12, (m, 3)), 0.02, 0.98)
    X = rng.binomial(2, p[:, pop]).astype(float)
    X[rng.random((m, n)) < 0.02] = np.nan
    packed = unpack.np_pack_codes(unpack.np_dosage_to_codes(X))
    return JaxGenoPack(packed=packed, n=n), interop.pack_from_numpy(packed, n)


@pytest.mark.parametrize("name", NAMES)
def test_torch_operator_under_engine_xla(name):
    """TorchOperator (the JAX package's XlaOperator) reads the option at
    each call; randomSVD's "xla" engine runs it."""
    jp, pp = structured_packs()
    sc = bt.bed_scaleBinom(jp)
    rng = np.random.default_rng(2)
    V = rng.standard_normal((jp.n, 6))
    U = rng.standard_normal((jp.m, 2))
    jop = XlaOperator(jp, sc["center"], sc["scale"])
    pop = pt.TorchOperator(pp, sc["center"], sc["scale"], block=64)
    with at(name):
        within(pop.cprod(V), jop.cprod(V), name, "product", 2e-4)
        within(pop.prod(U), jop.prod(U), name, "product", 2e-4)
        svd = pt.snp_randomSVD(pp, k=4, tol=1e-7, engine="xla")
        jsvd = bt.snp_randomSVD(jp, k=4, tol=1e-7, engine="xla")
    within(svd.d, jsvd.d, name, "statistic", 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_prod_bgen_device_engine(bgen_file, name):  # noqa: F811
    path, ids, N = bgen_file
    beta = np.random.default_rng(4).standard_normal((len(ids), 2))
    rows = np.arange(0, N, 2)
    with at(name):
        got = pt.snp_prodBGEN(path, beta, ids, ind_row=rows,
                              engine="device", block_size=16)
        ref = jbgen.snp_prodBGEN(path, beta, ids, ind_row=rows,
                                 engine="device", block_size=16)
    within(got, ref, name, "product", 5e-6)


@pytest.mark.parametrize("name", NAMES)
def test_ridge_block(name):
    """The imputation's ridge block (the boost block reads no option in
    the JAX package): its predictions, a statistic of three products."""
    rng = np.random.default_rng(0)
    n, W, B, K = 301, 40, 24, 6
    X = rng.binomial(2, rng.uniform(0.1, 0.5, W), (n, W)).astype(float)
    X[:, 1:] = np.where(rng.random((n, W - 1)) < 0.8, X[:, :-1], X[:, 1:])
    X[rng.random((n, W)) < 0.1] = np.nan
    packed = unpack.np_pack_codes(unpack.np_dosage_to_codes(X.T))
    y_idx = np.resize(rng.permutation(W)[:B // 2 + 1], B).astype(np.int32)
    nb = np.stack([(y + rng.choice(np.arange(-6, 7), K, replace=False)) % W
                   for y in y_idx]).astype(np.int32)
    valid = (rng.random((B, K)) < 0.9).astype(np.float32)
    train = (rng.random((B, n)) < 0.8).astype(np.float32)
    arrays = (packed, nb, valid, y_idx, train)
    with at(name):
        import jax.numpy as jnp

        ref = np.asarray(jimp._impute_block_fn(n, W, K, B, 1e-3)(
            *map(jnp.asarray, arrays))[0])
        got = pimp._impute_block_ridge(
            torch.as_tensor(packed), n, torch.as_tensor(nb).long(),
            torch.as_tensor(valid), torch.as_tensor(y_idx).long(),
            torch.as_tensor(train), 1e-3)[0].numpy()
    within(got, ref, name, "statistic", 1e-4)


# ---------------------------------------------------------------------------
# the options the port used to refuse
# ---------------------------------------------------------------------------

def test_randomsvd_engine_names():
    """"pallas" and "device" are the kernels' operator on one device
    (the same d as "auto"), "xla" the plain-torch one (the same d as
    "torch"), and "xla" agrees with the JAX package's "xla" at tol."""
    jp, pp = structured_packs(seed=2)
    run = lambda e: pt.snp_randomSVD(pp, k=4, tol=1e-7, engine=e).d  # noqa: E731
    auto, torch_ = run("auto"), run("torch")
    for engine in ("pallas", "device"):
        np.testing.assert_array_equal(run(engine), auto)
    np.testing.assert_array_equal(run("xla"), torch_)
    ref = bt.snp_randomSVD(jp, k=4, tol=1e-7, engine="xla").d
    np.testing.assert_allclose(run("xla"), ref, rtol=1e-4)
    np.testing.assert_allclose(auto, ref, rtol=1e-4)


@pytest.mark.parametrize("engine", ["mesh", "mesh-device"])
def test_dosage_pack_under_the_mesh_engines(dosages, engine):
    """A DosagePack under "mesh" runs unsharded, as in the JAX package:
    the result of "auto" (held against the JAX package in
    tests/test_torch_dosage.py::test_randomsvd)."""
    _, pdp = dosages
    ref = pt.snp_randomSVD(pdp, k=3, tol=1e-7)
    got = pt.snp_randomSVD(pdp, k=3, tol=1e-7, engine=engine,
                           mesh=pmesh.make_mesh(2))
    np.testing.assert_array_equal(got.d, ref.d)
    np.testing.assert_array_equal(got.u, ref.u)


def test_mesh_takes_the_three_names():
    """MeshOperator and the *_fn builders take the JAX package's names and
    run K1 / K2 whatever the name: "default" is bit-equal to "highest"."""
    pp = pt.snp_fake(103, 57, seed=21, na_prob=0.03)
    sc = pt.bed_scaleBinom(pp)
    mesh = pmesh.make_mesh(2)
    V = np.random.default_rng(0).standard_normal((103, 4)).astype(np.float32)
    ops = {name: pmesh.MeshOperator(pp, sc["center"], sc["scale"],
                                    mesh=mesh, precision=name)
           for name in NAMES}
    B, Y = ops["highest"].power(V)
    for name in ("high", "default"):
        Bn, Yn = ops[name].power(V)
        np.testing.assert_array_equal(Bn, B)
        np.testing.assert_array_equal(Yn, Y)
        for fn in (pmesh.cprod_fn, pmesh.prod_fn, pmesh.power_both_fn):
            fn(mesh, name)
        pmesh.power_iter_fn(mesh, ops[name].n_pad, name)
    with pytest.raises(ValueError, match="precision"):
        pmesh.cprod_fn(mesh, "tf32")


def test_enable_compilation_cache(tmp_path, monkeypatch):
    """The port's counterpart of the JAX package's function: the native
    libraries build into the directory it returns (the argument, else
    $BIGSNPR_COMPILE_CACHE, else the package's _build/); a second build
    of the same source reuses the library."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    where = tmp_path / "cache"
    assert pt.config.enable_compilation_cache(str(where)) == str(where)
    assert where.is_dir() and cuda_build.BUILD_DIR == where
    src = os.path.join(REPO, "bigsnpr_tpu_torch", "native",
                       "ldsplit_native.cpp")
    lib = cuda_build.build(src)
    assert lib.parent == where and lib.exists()
    stamp = lib.stat().st_mtime_ns
    assert cuda_build.build(src) == lib and lib.stat().st_mtime_ns == stamp
    monkeypatch.setenv("BIGSNPR_COMPILE_CACHE", str(tmp_path / "env"))
    assert pt.config.enable_compilation_cache() == str(tmp_path / "env")
    monkeypatch.delenv("BIGSNPR_COMPILE_CACHE")
    assert pt.config.enable_compilation_cache() == str(
        cuda_build.DEFAULT_BUILD_DIR)
