"""Port parity: the `.gpk` store and reference `.rds` + `.bk` attachment.

The store: each package reads the other's (`GenoPack.save` /
`snp_attach`, `snp_readBed(backingfile=)`), `packed.bin` and `meta.json`
byte-equal, fam and map equal. `.rds`: there are no R fixtures here, so
the test serializes small R objects to XDR bytes itself (vectors, a list
with attributes, an environment, a data.frame with a factor, a bigSNP
with an FBM.code256 and its `.bk`), compressed each way R compresses, and
runs both packages' readers on them: the same values, the same pack; a
code256 table other than hard calls raises in the port (slice 6c)."""

import bz2
import gzip
import lzma
import struct

import numpy as np
import pandas as pd
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import genotypes as jg
from bigsnpr_tpu.io import bed as jbed
from bigsnpr_tpu.utils import rds as jrds
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.core import genotypes as pg
from bigsnpr_tpu_torch.utils import rds as prds

torch.set_num_threads(2)


def same_columns(port: dict, ref: pd.DataFrame):
    assert list(port) == list(ref.columns)
    for c in ref.columns:
        a, b = np.asarray(port[c]), ref[c].to_numpy()
        if b.dtype.kind == "f":
            assert np.array_equal(a.astype(np.float64), b, equal_nan=True), c
        else:
            assert [str(x) for x in a] == [str(x) for x in b], c


# ---------------------------------------------------------------------------
# the .gpk store
# ---------------------------------------------------------------------------

def test_store_both_directions(tmp_path):
    jp = bt.snp_fake(37, 53, seed=2, na_prob=0.05)
    pp = interop.pack_from_numpy(np.asarray(jp.packed), jp.n, fam=jp.fam,
                                 map=jp.map)
    a = jp.save(tmp_path / "jax")
    b = pp.save(tmp_path / "port")
    assert a.endswith(".gpk") and b.endswith(".gpk")
    for f in ("packed.bin", "meta.json"):
        assert (tmp_path / "jax.gpk" / f).read_bytes() == \
            (tmp_path / "port.gpk" / f).read_bytes()
    for mmap in (True, False):
        p_of_j = pt.snp_attach(a, mmap=mmap)
        j_of_p = jg.snp_attach(b, mmap=mmap)
        for got in (p_of_j, j_of_p):
            assert got.n == jp.n
            assert np.array_equal(np.asarray(got.packed), np.asarray(jp.packed))
        same_columns(p_of_j.fam, jp.fam)
        same_columns(p_of_j.map, jp.map)
        same_columns(pt.snp_attach(b).map, j_of_p.map)
        same_columns(pt.snp_attach(b).fam, j_of_p.fam)
    with pt.config.options(device="cpu"):
        assert np.array_equal(pt.snp_counts(pt.snp_attach(b)),
                              np.asarray(bt.snp_counts(jp)))


def test_store_without_metadata_and_readbed_backingfile(tmp_path):
    jp = bt.snp_fake(21, 17, seed=3)
    pp = pg.GenoPack(packed=np.asarray(jp.packed).copy(), n=jp.n)
    path = pt.snp_save(pp, tmp_path / "bare")
    assert sorted(p.name for p in (tmp_path / "bare.gpk").iterdir()) == [
        "meta.json", "packed.bin"]
    back = jg.snp_attach(path)
    assert back.fam is None and back.map is None
    assert np.array_equal(np.asarray(back.packed), np.asarray(jp.packed))
    bed = tmp_path / "x.bed"
    jbed.snp_writeBed(jp, bed)
    pt.snp_readBed(str(bed), backingfile=str(tmp_path / "p"))
    jbed.snp_readBed(str(bed), backingfile=str(tmp_path / "j"))
    for f in ("packed.bin", "meta.json"):
        assert (tmp_path / "p.gpk" / f).read_bytes() == \
            (tmp_path / "j.gpk" / f).read_bytes()
    with pt.config.options(device="cpu"):
        sub = pt.snp_readBed2(str(bed), backingfile=str(tmp_path / "p2"),
                              ind_row=[0, 3, 5], ind_col=[1, 2])
    ref = jbed.snp_readBed2(str(bed), backingfile=str(tmp_path / "j2"),
                            ind_row=[0, 3, 5], ind_col=[1, 2])
    assert np.array_equal(np.asarray(sub.packed), np.asarray(ref.packed))
    assert (tmp_path / "p2.gpk" / "packed.bin").read_bytes() == \
        (tmp_path / "j2.gpk" / "packed.bin").read_bytes()


# ---------------------------------------------------------------------------
# .rds: an XDR writer for the objects bigsnpr stores
# ---------------------------------------------------------------------------

NIL = struct.pack(">i", 254)


def flags(kind, attr=False, tag=False):
    return struct.pack(">i", kind | (attr << 9) | (tag << 10))


def charsxp(s):
    if s is None:
        return struct.pack(">ii", 9, -1)
    b = s.encode()
    return struct.pack(">ii", 9, len(b)) + b


def sym(name):
    return flags(1) + charsxp(name)


def pairlist(items):
    """A tagged pairlist (attributes, an environment's frame)."""
    out = b""
    for tag, value in items:
        out += flags(2, tag=True) + sym(tag) + value
    return out + NIL


def vec(kind, values, attrs=None):
    head = flags(kind, attr=bool(attrs)) + struct.pack(">i", len(values))
    if kind == 14:
        body = np.asarray(values, dtype=">f8").tobytes()
    elif kind in (13, 10):
        body = np.asarray(values, dtype=">i4").tobytes()
    elif kind == 16:
        body = b"".join(charsxp(v) for v in values)
    else:                                  # 19: a list of items
        body = b"".join(values)
    return head + body + (pairlist(attrs) if attrs else b"")


def strs(*v):
    return vec(16, list(v))


def env(bindings):
    return (flags(4) + struct.pack(">i", 0) + struct.pack(">i", 253)
            + pairlist(bindings) + NIL + NIL)


def rds_bytes(item, compress):
    raw = b"X\n" + struct.pack(">iii", 2, 0x040000, 0x020300) + item
    return {"gzip": gzip.compress, "bz2": bz2.compress, "xz": lzma.compress,
            "none": lambda b: b}[compress](raw)


def compare(a, b):
    """The port's and the JAX package's decoded objects hold the same."""
    assert type(a).__name__ == type(b).__name__
    if isinstance(a, prds.RObj):
        compare(a.value, b.value)
        assert list(a.attrs) == list(b.attrs)
        for k in a.attrs:
            compare(a.attrs[k], b.attrs[k])
    elif isinstance(a, prds.REnv):
        assert list(a.frame) == list(b.frame)
        for k in a.frame:
            compare(a.frame[k], b.frame[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            compare(x, y)
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            compare(x, y)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    elif isinstance(a, prds.ROpaque):
        assert a.kind == b.kind
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("compress", ["gzip", "bz2", "xz", "none"])
def test_rds_values_equal(tmp_path, compress):
    objs = {
        "real": vec(14, [1.5, np.nan, -2.0]),
        "int": vec(13, [1, -2147483648, 7]),
        "lgl": vec(10, [1, 0, -2147483648]),
        "str": strs("a", None, "ccc"),
        "list": vec(19, [vec(14, [1.0]), strs("x", "y")],
                    [("names", strs("u", "w")), ("class", strs("foo"))]),
        "env": env([("a", vec(14, [3.0])), ("b", strs("z"))]),
        "df": vec(19, [vec(13, [1, 2, 3]), strs("p", "q", "r"),
                       vec(13, [2, 1, 2], [("levels", strs("lo", "hi")),
                                          ("class", strs("factor"))])],
                  [("names", strs("i", "s", "f")),
                   ("class", strs("data.frame")),
                   ("row.names", vec(13, [-2147483648, -3]))]),
    }
    for name, item in objs.items():
        f = tmp_path / f"{name}.rds"
        f.write_bytes(rds_bytes(item, compress))
        a, b = prds.read_rds(f), jrds.read_rds(f)
        compare(a, b)
    df = prds.read_rds(tmp_path / "df.rds")
    same_columns(prds.to_frame(df), jrds.to_frame(jrds.read_rds(
        tmp_path / "df.rds")))
    assert list(prds.to_frame(df)["f"]) == ["hi", "lo", "hi"]


CODE_012 = [0.0, 1.0, 2.0] + [np.nan] * 253


def big_snp(tmp_path, n, m, code256, seed=0, stored="C:\\old\\place\\g.bk"):
    """A bigSNP .rds whose FBM.code256 points at a .bk elsewhere (the
    reference's relocation fix-up finds it beside the .rds); returns the
    path and the (m, n) byte codes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (m, n), dtype=np.uint8)
    (tmp_path / "g.bk").write_bytes(codes.tobytes())
    fbm = (flags(25, attr=True)
           + pairlist([(".xData", env([(".->nrow", vec(14, [float(n)])),
                                      (".->ncol", vec(14, [float(m)])),
                                      (".->code256", vec(14, code256)),
                                      (".->backingfile", strs(stored))])),
                       ("class", strs("FBM.code256"))]))
    fam = vec(19, [strs(*[f"F{i}" for i in range(n)]),
                   strs(*[f"S{i}" for i in range(n)]),
                   vec(13, list(rng.integers(1, 3, n)))],
              [("names", strs("family.ID", "sample.ID", "sex")),
               ("class", strs("data.frame")),
               ("row.names", vec(13, [-2147483648, -n]))])
    map_ = vec(19, [vec(13, [1] * m), strs(*[f"rs{j}" for j in range(m)]),
                    vec(13, list(range(1000, 1000 * (m + 1), 1000))),
                    strs(*["A"] * m), strs(*["G"] * m)],
               [("names", strs("chromosome", "marker.ID", "physical.pos",
                               "allele1", "allele2")),
                ("class", strs("data.frame")),
                ("row.names", vec(13, [-2147483648, -m]))])
    obj = vec(19, [fbm, fam, map_],
              [("names", strs("genotypes", "fam", "map")),
               ("class", strs("bigSNP"))])
    f = tmp_path / "g.rds"
    f.write_bytes(rds_bytes(obj, "gzip"))
    return f, codes


@pytest.mark.parametrize("n,m", [(13, 9), (16, 5)])
def test_bigsnp_rds_attaches_as_in_jax(tmp_path, n, m):
    f, codes = big_snp(tmp_path, n, m, CODE_012, seed=n)
    jp = jg.snp_attach(f)
    for pp in (pt.snp_attach(f), pt.snp_attach_rds(f, mmap=False)):
        assert pp.n == n and pp.m == m
        assert np.array_equal(np.asarray(pp.packed), np.asarray(jp.packed))
        same_columns(pp.fam, jp.fam)
        same_columns(pp.map, jp.map)
    dosage = np.where(codes == 3, np.nan, codes).T
    assert np.array_equal(pt.snp_attach(f).to_dosage(), dosage,
                          equal_nan=True)


def test_non_hard_call_code256_raises(tmp_path):
    code = list(np.arange(256) / 100.0)
    f, _ = big_snp(tmp_path, 8, 4, code)
    assert type(jg.snp_attach(f)).__name__ == "DosagePack"
    with pytest.raises(NotImplementedError, match="slice 6c"):
        pt.snp_attach(f)
    with pytest.raises(FileNotFoundError):
        pt.snp_attach_rds(f, bk_path=tmp_path / "missing.bk")
