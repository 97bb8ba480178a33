"""ctypes binding for the native Matrix Market parser (counterpart of ``tpcg/native/mtx_native.py``).

The parser is the repository's own framework-free C++ source,
``tpcg/native/mtx_reader.cpp``, reached by file path: importing
``tpcg.native`` would run ``tpcg/__init__.py``, which imports JAX.  It is
built with g++ at first use into ``tpcg_torch/_build/`` under a name that
carries a hash of the source and the flags; nothing is written into
``tpcg/native/``.  If the source is missing or the build or load fails,
``available()`` is False and the caller falls back to scipy, as in the JAX
package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from . import ROOT, gxx_build

SRC = ROOT / "tpcg" / "native" / "mtx_reader.cpp"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(gxx_build(SRC, "libtpcgio")))
            lib.tpcg_mtx_read.restype = ctypes.c_void_p
            lib.tpcg_mtx_read.argtypes = [ctypes.c_char_p]
            for name in ("tpcg_mtx_nrows", "tpcg_mtx_ncols", "tpcg_mtx_nnz"):
                getattr(lib, name).restype = ctypes.c_longlong
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            lib.tpcg_mtx_is_complex.restype = ctypes.c_int
            lib.tpcg_mtx_is_complex.argtypes = [ctypes.c_void_p]
            lib.tpcg_mtx_fill_csr.restype = None
            lib.tpcg_mtx_fill_csr.argtypes = [ctypes.c_void_p] * 4
            lib.tpcg_mtx_free.restype = None
            lib.tpcg_mtx_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def load(path: str):
    """Parse a Matrix Market file natively; returns scipy CSR or None."""
    import numpy as np
    import scipy.sparse as sp

    lib = _load()
    if lib is None:
        return None
    handle = lib.tpcg_mtx_read(os.fsencode(path))
    if not handle:
        return None
    try:
        n = lib.tpcg_mtx_nrows(handle)
        m = lib.tpcg_mtx_ncols(handle)
        nnz = lib.tpcg_mtx_nnz(handle)
        is_complex = lib.tpcg_mtx_is_complex(handle)
        indptr = np.zeros(n + 1, dtype=np.int64)
        indices = np.zeros(nnz, dtype=np.int64)
        data = np.zeros(nnz, dtype=np.complex128 if is_complex else np.float64)
        lib.tpcg_mtx_fill_csr(
            handle,
            indptr.ctypes.data_as(ctypes.c_void_p),
            indices.ctypes.data_as(ctypes.c_void_p),
            data.ctypes.data_as(ctypes.c_void_p))
        return sp.csr_matrix((data, indices, indptr), shape=(n, m))
    finally:
        lib.tpcg_mtx_free(handle)
