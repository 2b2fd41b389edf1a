"""Declarative argument contracts.

The reference gates a per-argument assertion table behind
`options(bigstatsr.check.args)` and has every exported function call
`check_args()` on its own frame (reference R/utils-assert.R:19-49,
bigassertr primitives). Here it is a decorator: the contract table is
keyed by canonical argument NAME, so a function opts in with
`@check_args()` and gets every contract its signature matches — plus
per-call overrides, exactly like the reference's `list(...)` overwrite
semantics. Checks run on the host before any device work, and the whole
layer switches off globally with `set_check_args(False)` for hot inner
loops. A copy of `bigsnpr_tpu/utils/assertions.py`.
"""

from __future__ import annotations

import functools
import inspect
import os

import numpy as np

_ENABLED = os.environ.get("BIGSNPR_CHECK_ARGS", "1") != "0"


def set_check_args(enabled: bool) -> None:
    """Global gate (the reference's options(bigstatsr.check.args))."""
    global _ENABLED
    _ENABLED = bool(enabled)


def get_check_args() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------------
# assertion primitives (bigassertr analogs)
# ---------------------------------------------------------------------------

class ArgError(ValueError):
    pass


def _fail(msg, *a):
    raise ArgError(msg % a if a else msg)


def assert_not_null(x, name="x"):
    if x is None:
        _fail("'%s' must not be None.", name)


def assert_int(x, name="x"):
    if x is None:
        return
    arr = np.asarray(x)
    if arr.size and not (np.issubdtype(arr.dtype, np.integer)
                         or (np.issubdtype(arr.dtype, np.floating)
                             and np.all(np.mod(arr[np.isfinite(arr)], 1) == 0))):
        _fail("'%s' must contain integers only.", name)


def assert_pos(x, name="x", strict=True):
    if x is None:
        return
    arr = np.asarray(x, dtype=np.float64)
    if arr.size and ((arr <= 0).any() if strict else (arr < 0).any()):
        _fail("'%s' must contain only %s values.", name,
              "positive" if strict else "non-negative")


def assert_nonneg(x, name="x"):
    assert_pos(x, name, strict=False)


def assert_01(x, name="x"):
    if x is None:
        return
    arr = np.asarray(x)
    if not np.isin(arr, (0, 1)).all():
        _fail("'%s' must contain only 0s and 1s.", name)


def assert_nona(x, name="x"):
    if x is None:
        return
    arr = np.asarray(x, dtype=np.float64)
    if np.isnan(arr).any():
        _fail("'%s' must not contain NA/NaN values.", name)


def assert_sorted(x, name="x"):
    if x is None:
        return
    arr = np.asarray(x)
    if arr.size > 1 and (np.diff(arr) < 0).any():
        _fail("'%s' must be sorted in non-decreasing order.", name)


def assert_lengths(*xs, names=None):
    lens = {len(x) for x in xs if x is not None}
    if len(lens) > 1:
        _fail("incompatible lengths: %s", sorted(lens))


def assert_one_number(x, name="x"):
    if x is None:
        return
    if np.ndim(x) != 0 or not np.isfinite(float(x)):
        _fail("'%s' must be one finite number.", name)


def assert_one_number_or_na(x, name="x"):
    """Like assert_one_number but NA/NaN allowed (e.g. thr_r2=NaN skips
    clumping in the reference, R/autoSVD.R:107)."""
    if x is None:
        return
    if np.ndim(x) != 0:
        _fail("'%s' must be one number (or NA).", name)


def assert_one_int(x, name="x"):
    assert_one_number(x, name)
    if x is not None and float(x) != int(x):
        _fail("'%s' must be one integer.", name)


def assert_exist(path, name="file"):
    if path is not None and not os.path.exists(str(path)):
        _fail("'%s' file does not exist: %s", name, path)


def assert_noexist(path, name="file"):
    if path is not None and os.path.exists(str(path)):
        _fail("'%s' already exists: %s", name, path)


def assert_ext(path, ext, name="file"):
    if path is not None and not str(path).endswith(ext):
        _fail("'%s' must have extension '%s'.", name, ext)


def assert_pack(x, name="pack"):
    if x is None:
        return  # legitimate when a pre-built operator is supplied (op=)
    if not (hasattr(x, "packed") or hasattr(x, "codes")) or not hasattr(x, "n"):
        _fail("'%s' is not a GenoPack/DosagePack.", name)


def assert_index(x, name="ind"):
    """Row/column index vectors: integer, non-negative (0-based)."""
    if x is None:
        return
    arr = np.asarray(x)
    if arr.size == 0:
        return
    if not np.issubdtype(arr.dtype, np.integer):
        assert_int(arr, name)
    if (np.asarray(arr, dtype=np.int64) < 0).any():
        _fail("'%s' must contain non-negative (0-based) indices.", name)


def assert_df_beta(df, name="df_beta"):
    for key in ("beta", "beta_se", "n_eff"):
        if key not in df:
            _fail("'%s' must have a '%s' entry "
                  "(reference df_beta contract).", name, key)
    assert_lengths(np.asarray(df["beta"]), np.asarray(df["beta_se"]))
    assert_pos(np.asarray(df["beta_se"]), name + "$beta_se")


def assert_scaling_fun(f, name="fun_scaling"):
    if callable(f):
        sig = inspect.signature(f)
        params = set(sig.parameters)
        if not ({"pack", "ind_row"} <= params
                or any(p.kind == inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values())):
            _fail("'%s' must accept (pack, ind_row=...) "
                  "(reference assert_args(fun.scaling, ...)).", name)
    elif not (hasattr(f, "__getitem__")):
        _fail("'%s' must be callable or a {'center','scale'} mapping.", name)


# ---------------------------------------------------------------------------
# the declarative table: canonical argument name -> checker(value, name)
# (reference R/utils-assert.R:26-43)
# ---------------------------------------------------------------------------

CONTRACTS = {
    "pack": assert_pack,
    "ind_row": assert_index,
    "ind_col": assert_index,
    "ind_keep": assert_index,
    "ind_train": assert_index,
    "exclude": assert_index,
    # None is a supported default (falls back to pack.map chromosome
    # info inside the functions) — only non-None values are validated.
    "infos_chr": lambda x, name: None if x is None else assert_nona(x, name),
    "infos_pos": assert_nona,
    "df_beta": assert_df_beta,
    "fun_scaling": assert_scaling_fun,
    "y01_train": assert_01,
    "k": assert_one_int,
    "thr_r2": assert_one_number_or_na,
    "h2_init": assert_one_number,
    "burn_in": assert_one_int,
    "num_iter": assert_one_int,
    "bedfile": assert_exist,
    "bgenfiles": lambda x, name: [assert_exist(p, name) for p in np.atleast_1d(x)],
}


def check_args(**overrides):
    """Decorator: validate every argument whose name appears in
    CONTRACTS (or in `overrides`, which win — the reference's
    `list(...)` overwrite) before the function body runs. A no-op when
    set_check_args(False)."""

    def deco(fn):
        sig = inspect.signature(fn)
        table = {**{k: v for k, v in CONTRACTS.items()
                    if k in sig.parameters}, **overrides}
        if not table:
            return fn

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _ENABLED:
                bound = sig.bind_partial(*args, **kwargs)
                for name, checker in table.items():
                    if name in bound.arguments:
                        try:
                            checker(bound.arguments[name], name)
                        except ArgError:
                            raise
                        except TypeError:
                            checker(bound.arguments[name])
            return fn(*args, **kwargs)

        wrapper.__checked_args__ = tuple(table)
        return wrapper

    return deco
