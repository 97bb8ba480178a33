"""ctypes binding for the native routing-table code (counterpart of ``tpcg/native/routing_native.py``).

The code is the repository's own framework-free C++ source,
``tpcg/native/routing_builder.cpp``, reached by file path (importing
``tpcg.native`` would import JAX).  It is built with g++ at first use into
``tpcg_torch/_build/`` under a name that carries a hash of the source and
the flags; nothing is written into ``tpcg/native/``.  If the build or the
load fails, ``available()`` is False and ``build_routing_spmv`` runs its
numpy code instead, as in the JAX package: two host implementations of one
preprocessing step.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading

from . import ROOT, gxx_build

SRC = ROOT / "tpcg" / "native" / "routing_builder.cpp"
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
            lib = ctypes.CDLL(str(gxx_build(SRC, "libtpcgroute")))
            i64 = ctypes.c_longlong
            lib.tpcg_route_build.restype = ctypes.c_void_p
            lib.tpcg_route_build.argtypes = [
                i64, i64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_ulonglong]
            for f in ("tpcg_route_m", "tpcg_route_layers",
                      "tpcg_route_stages"):
                getattr(lib, f).restype = i64
                getattr(lib, f).argtypes = [ctypes.c_void_p]
            lib.tpcg_route_fill.restype = None
            lib.tpcg_route_fill.argtypes = [ctypes.c_void_p] * 3
            lib.tpcg_route_free.restype = None
            lib.tpcg_route_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def build(rows, cols, n: int, seed: int = 0):
    """Native layer decomposition + Benes masks.

    rows/cols : int arrays (nnz,).
    Returns (masks int8 (L, S, m), layer int32 (nnz,), m), or None when the
    library is unavailable or refuses the input.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = len(rows)
    handle = lib.tpcg_route_build(
        n, nnz, rows.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p), seed)
    if not handle:
        return None
    try:
        m = lib.tpcg_route_m(handle)
        L = lib.tpcg_route_layers(handle)
        S = lib.tpcg_route_stages(handle)
        masks = np.zeros((L, S, m), dtype=np.int8)
        layer = np.zeros(nnz, dtype=np.int32)
        lib.tpcg_route_fill(handle,
                            masks.ctypes.data_as(ctypes.c_void_p),
                            layer.ctypes.data_as(ctypes.c_void_p))
        return masks, layer, int(m)
    finally:
        lib.tpcg_route_free(handle)
