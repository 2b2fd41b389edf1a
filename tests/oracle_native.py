"""The JAX package's native library (`bigsnpr_tpu.native`) for the port's
parity tests, built privately for this test process.

`bigsnpr_tpu.native.get_lib` builds `_io_native.so` in place beside its
sources at first use, without a lock, and keeps a failed load for the rest
of the process. Test processes that start together can race on that file,
and one that loads it half-written runs the JAX package's numpy fallbacks
instead (whose penalized-regression fits differ from the native CD by up to
5e-4). `private_native` builds the library once a process into pytest's
temporary directory, points the JAX package at it for a test module, fails
the module if it does not load, and restores the package's state after."""

import pytest

_PRIVATE = {}


def private_native(tmp_path_factory):
    """Generator for a module-scoped fixture: yields the loaded library."""
    from bigsnpr_tpu import native

    saved = (native._SO, native._LIB, native._TRIED)
    if "lib" not in _PRIVATE:
        native._SO = tmp_path_factory.mktemp("jax_native") / "_io_native.so"
        native._LIB, native._TRIED = None, False
        lib = native.get_lib()
        if lib is None:
            native._SO, native._LIB, native._TRIED = saved
            pytest.fail("the JAX package's native library did not build or "
                        "load: its oracle would be the numpy fallback")
        _PRIVATE.update(lib=lib, so=native._SO)
    native._SO, native._LIB, native._TRIED = (_PRIVATE["so"],
                                              _PRIVATE["lib"], True)
    yield _PRIVATE["lib"]
    native._SO, native._LIB, native._TRIED = saved
