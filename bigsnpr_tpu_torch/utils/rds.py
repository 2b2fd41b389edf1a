"""Minimal R serialization (.rds / .rda) reader.

A copy of `bigsnpr_tpu/utils/rds.py` (pure Python: bz2, gzip, lzma,
struct and numpy), whose `to_frame` returns a dict of numpy columns
(port DEVIATIONS #1). `snp_attach` reads a reference bigSNP `.rds` with
it. Supports the subset of the XDR format that bigsnpr objects and the
reference's fixtures use: atomic vectors, lists, data.frames, attributes,
factors, environments (RefClass fields), and gzip/bzip2/xz compression.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct

import numpy as np

_SYMSXP, _LISTSXP, _CHARSXP = 1, 2, 9
_CLOSXP, _ENVSXP, _PROMSXP, _LANGSXP = 3, 4, 5, 6
_SPECIALSXP, _BUILTINSXP = 7, 8
_LGLSXP, _INTSXP, _REALSXP, _CPLXSXP, _STRSXP, _VECSXP = 10, 13, 14, 15, 16, 19
_BCODESXP, _EXTPTRSXP, _WEAKREFSXP = 21, 22, 23
_RAWSXP = 24
_S4SXP = 25
_BASEENV, _EMPTYENV = 241, 242
_BCREPREF, _BCREPDEF = 243, 244
_PACKAGESXP, _NAMESPACESXP = 248, 249
_BASENAMESPACE = 250
_MISSINGARG, _UNBOUNDVALUE, _GLOBALENV = 251, 252, 253
_ATTRLISTSXP, _ATTRLANGSXP = 239, 240
_ALTREP, _NILVALUE, _REFSXP = 238, 254, 255
_NA_INT = -2147483648


class REnv:
    """A deserialized R environment: bindings in `frame`
    (RefClass/R6 instance fields land here)."""

    def __init__(self):
        self.frame = {}
        self.enclos = None
        self.attrs = {}
        self.locked = False

    def get(self, name, default=None):
        return self.frame.get(name, default)

    def __repr__(self):
        return f"REnv({list(self.frame)})"


class ROpaque:
    """Closures / bytecode / external pointers — structure preserved for
    stream correctness, contents not interpreted."""

    def __init__(self, kind, parts=None):
        self.kind = kind
        self.parts = parts

    def __repr__(self):
        return f"ROpaque({self.kind})"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0
        self.refs = []

    def rd(self, n):
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def rint(self):
        return struct.unpack(">i", self.rd(4))[0]

    def rdouble(self):
        return struct.unpack(">d", self.rd(8))[0]

    def read_header(self):
        if self.buf[:2] in (b"X\n",):
            self.pos = 2
        elif self.buf[:5] in (b"RDX2\n", b"RDX3\n"):
            self.pos = 5
            assert self.rd(2) == b"X\n", "only XDR format supported"
        else:
            raise ValueError("unrecognized R serialization header")
        version = self.rint()
        self.rint()  # writer version
        self.rint()  # min reader version
        if version >= 3:
            n = self.rint()
            self.rd(n)  # native encoding

    def item(self):
        flags = self.rint()
        ptype = flags & 255
        has_attr = bool(flags & (1 << 9))
        has_tag = bool(flags & (1 << 10))

        if ptype == _NILVALUE:
            return None
        if ptype == _GLOBALENV:
            return ROpaque("globalenv")
        if ptype == _EMPTYENV:
            return ROpaque("emptyenv")
        if ptype == _BASEENV:
            return ROpaque("baseenv")
        if ptype == _BASENAMESPACE:
            return ROpaque("basenamespace")
        if ptype == _UNBOUNDVALUE:
            return ROpaque("unbound")
        if ptype == _MISSINGARG:
            return ROpaque("missing")
        if ptype in (_NAMESPACESXP, _PACKAGESXP):
            assert self.rint() == 0, "bad persistent string vec"
            n = self.rint()
            names = [self.item() for _ in range(n)]
            obj = ROpaque("namespace" if ptype == _NAMESPACESXP
                          else "package", names)
            self.refs.append(obj)
            return obj
        if ptype == _ENVSXP:
            env = REnv()
            env.locked = bool(self.rint())
            self.refs.append(env)      # register BEFORE contents (cycles)
            env.enclos = self.item()
            frame = self.item()        # pairlist of bindings
            hashtab = self.item()      # VECSXP of pairlists
            attrs = self.item()
            if isinstance(frame, list):
                for tag, car in frame:
                    if tag is not None:
                        env.frame[tag] = car
            tab = unwrap(hashtab)
            if isinstance(tab, list):
                for chain in tab:
                    if isinstance(chain, list):
                        for tag, car in chain:
                            if tag is not None:
                                env.frame[tag] = car
            if isinstance(attrs, list):
                env.attrs = {t: c for t, c in attrs}
            return env
        if ptype == _CLOSXP:
            attr = self.item() if has_attr else None
            env = self.item() if has_tag else None
            formals = self.item()
            body = self.item()
            return ROpaque("closure", (attr, env, formals, body))
        if ptype in (_SPECIALSXP, _BUILTINSXP):
            n = self.rint()
            return ROpaque("builtin", self.rd(n).decode("ascii", "replace"))
        if ptype == _EXTPTRSXP:
            obj = ROpaque("extptr")
            self.refs.append(obj)
            prot = self.item()
            tag = self.item()
            obj.parts = (prot, tag)
            if has_attr:
                self.item()
            return obj
        if ptype == _WEAKREFSXP:
            obj = ROpaque("weakref")
            self.refs.append(obj)
            return obj
        if ptype == _BCODESXP:
            nreps = self.rint()
            reps = [None] * nreps
            return self._read_bc1(reps)
        if ptype == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.rint()
            return self.refs[idx - 1]
        if ptype == _SYMSXP:
            sym = self.item()
            self.refs.append(sym)
            return sym
        if ptype == _CHARSXP:
            n = self.rint()
            return None if n == -1 else self.rd(n).decode("utf-8", "replace")
        if ptype in (_LISTSXP, _LANGSXP, _PROMSXP):
            attr = self.item() if has_attr else None
            tag = self.item() if has_tag else None
            car = self.item()
            cdr = self.item()
            pairs = [(tag, car)]
            if isinstance(cdr, list):
                pairs.extend(cdr)
            return pairs
        if ptype == _ALTREP:
            info = self.item()      # pairlist: class, package, type
            state = self.item()
            self.item()             # attributes slot
            return self._decode_altrep(info, state)
        if ptype in (_INTSXP, _LGLSXP):
            n = self.rint()
            vals = np.frombuffer(self.rd(4 * n), dtype=">i4").astype(np.int64)
            attr = self.item() if has_attr else None
            if ptype == _LGLSXP:
                out = vals.astype(object)
                out[vals == _NA_INT] = None
                return _wrap(np.where(vals == _NA_INT, None, vals != 0), attr)
            vals = np.where(vals == _NA_INT, np.iinfo(np.int64).min, vals)
            return _wrap(vals, attr)
        if ptype == _REALSXP:
            n = self.rint()
            vals = np.frombuffer(self.rd(8 * n), dtype=">f8").astype(np.float64)
            attr = self.item() if has_attr else None
            return _wrap(vals, attr)
        if ptype == _STRSXP:
            n = self.rint()
            vals = [self.item() for _ in range(n)]
            attr = self.item() if has_attr else None
            return _wrap(vals, attr)
        if ptype == _VECSXP:
            n = self.rint()
            vals = [self.item() for _ in range(n)]
            attr = self.item() if has_attr else None
            return _wrap(vals, attr)
        if ptype == _CPLXSXP:
            n = self.rint()
            vals = np.frombuffer(self.rd(16 * n), dtype=">c16").astype(complex)
            attr = self.item() if has_attr else None
            return _wrap(vals, attr)
        if ptype == _RAWSXP:
            n = self.rint()
            vals = np.frombuffer(self.rd(n), dtype=np.uint8)
            attr = self.item() if has_attr else None
            return _wrap(vals, attr)
        if ptype == _S4SXP:
            attr = self.item() if has_attr else None
            return _wrap(None, attr)  # S4: slots live in the attributes
        raise ValueError(f"unhandled SEXP type {ptype} at offset {self.pos}")

    # -- bytecode (serialize.c ReadBC/ReadBCConsts/ReadBCLang) -------------
    def _read_bc1(self, reps):
        code = self.item()              # instruction INTSXP
        consts = self._read_bc_consts(reps)
        return ROpaque("bytecode", (code, consts))

    def _read_bc_consts(self, reps):
        n = self.rint()
        out = []
        for _ in range(n):
            t = self.rint()
            if t == _BCODESXP:
                out.append(self._read_bc1(reps))
            elif t in (_LANGSXP, _LISTSXP, _ATTRLANGSXP, _ATTRLISTSXP,
                       _BCREPDEF, _BCREPREF):
                out.append(self._read_bc_lang(t, reps))
            else:
                out.append(self.item())
        return out

    def _read_bc_lang(self, t, reps):
        if t == _BCREPREF:
            return reps[self.rint()]
        if t in (_BCREPDEF, _LANGSXP, _LISTSXP, _ATTRLANGSXP, _ATTRLISTSXP):
            pos = -1
            if t == _BCREPDEF:
                pos = self.rint()
                t = self.rint()
            has_a = t in (_ATTRLANGSXP, _ATTRLISTSXP)
            node = ROpaque("bclang")
            if pos >= 0:
                reps[pos] = node
            attr = self.item() if has_a else None
            tag = self.item()
            car = self._read_bc_lang(self.rint(), reps)
            cdr = self._read_bc_lang(self.rint(), reps)
            node.parts = (attr, tag, car, cdr)
            return node
        # default: the type int is only a dispatch tag; the item itself
        # follows with its own flags word (serialize.c ReadBCLang)
        return self.item()

    def _decode_altrep(self, info, state):
        cls = info[0][1] if isinstance(info, list) else None
        name = cls[0] if isinstance(cls, RObj) else cls
        if isinstance(name, list):
            name = name[0]
        # compact_intseq: state = [n, start, step] as doubles
        if name == "compact_intseq":
            n, start, step = np.asarray(state.value if isinstance(state, RObj) else state)
            return np.arange(start, start + n * step, step).astype(np.int64)
        if name == "compact_realseq":
            n, start, step = np.asarray(state.value if isinstance(state, RObj) else state)
            return start + np.arange(n) * step
        if name in ("wrap_real", "wrap_integer", "wrap_string", "wrap_logical"):
            inner = state[0] if isinstance(state, list) else state
            if isinstance(inner, list):
                inner = inner[0][1]
            return inner
        if name == "deferred_string":
            inner = state
            if isinstance(inner, list):
                inner = inner[0][1]
            return inner
        raise ValueError(f"unhandled ALTREP class {name!r}")


class RObj:
    """A value + its R attributes."""

    def __init__(self, value, attrs):
        self.value = value
        self.attrs = attrs or {}

    def __repr__(self):
        return f"RObj({type(self.value).__name__}, attrs={list(self.attrs)})"


def _wrap(value, attr_pairs):
    if attr_pairs is None:
        return value
    attrs = {}
    for tag, car in attr_pairs:
        attrs[tag] = car
    return RObj(value, attrs)


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:2] == b"BZ":
        return bz2.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    return raw


def read_rds(path):
    """Read a .rds file (single object)."""
    with open(path, "rb") as f:
        raw = f.read()
    r = _Reader(_decompress(raw))
    r.read_header()
    return r.item()


def read_rda(path) -> dict:
    """Read a .rda / .RData file (named environment) -> {name: value}."""
    with open(path, "rb") as f:
        raw = f.read()
    r = _Reader(_decompress(raw))
    r.read_header()
    top = r.item()
    return {tag: val for tag, val in top}


def to_frame(obj) -> dict:
    """An R data.frame RObj as a dict of numpy columns (factors as their
    level strings)."""
    assert isinstance(obj, RObj), "not a data.frame"
    names = obj.attrs.get("names")
    names = names.value if isinstance(names, RObj) else names
    cols = {}
    for name, col in zip(names, obj.value):
        if isinstance(col, RObj) and "levels" in col.attrs:  # factor
            levels = col.attrs["levels"]
            levels = levels.value if isinstance(levels, RObj) else levels
            vals = np.asarray(col.value)
            col = np.array([levels[v - 1] if v >= 1 else None for v in vals])
        elif isinstance(col, RObj):
            col = col.value
        cols[name] = np.asarray(col)
    return cols


def unwrap(obj):
    return obj.value if isinstance(obj, RObj) else obj


def s4_sparse_to_scipy(obj):
    """Convert a serialized Matrix::dsCMatrix / dgCMatrix RObj to scipy csc."""
    import scipy.sparse as sp

    a = obj.attrs
    def get(name):
        v = a[name]
        return v.value if isinstance(v, RObj) else v
    i = np.asarray(get("i"), dtype=np.int64)
    p = np.asarray(get("p"), dtype=np.int64)
    x = np.asarray(get("x"))
    dim = tuple(np.asarray(get("Dim"), dtype=np.int64))
    mat = sp.csc_matrix((x, i, p), shape=dim)
    cls = get("class")
    cls0 = cls[0] if isinstance(cls, (list, np.ndarray)) else cls
    if isinstance(cls0, bytes):
        cls0 = cls0.decode()
    if str(cls0).startswith("ds"):  # symmetric storage -> symmetrize
        mat = mat + mat.T - sp.diags(mat.diagonal())
    return mat.tocsc()
