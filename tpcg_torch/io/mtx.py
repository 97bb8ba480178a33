"""Matrix Market ingestion (counterpart of ``tpcg/io/mtx.py``).

The native C++ parser (``tpcg_torch.native.mtx_native``, built from the
repository's ``tpcg/native/mtx_reader.cpp``) is the fast path; scipy's
``mmread`` is the always-available fallback.  Both produce identical CSR.
"""
from __future__ import annotations


def read_matrix_market(path: str, dtype=None):
    """``load_matrix_market`` that also names the reader that ran:
    returns ``(csr, "native" | "scipy")``."""
    import scipy.io
    import scipy.sparse as sp

    from ..native import mtx_native
    A, reader = mtx_native.load(path), "native"
    if A is None:
        A, reader = scipy.io.mmread(path), "scipy"
    A = sp.csr_matrix(A)
    if dtype is not None:
        A = A.astype(dtype)
    A.sort_indices()
    return A, reader


def load_matrix_market(path: str, dtype=None, expand_symmetric: bool = True):
    """Load a Matrix Market file to CSR, with the contract of
    ``tpcg.io.load_matrix_market``: symmetric and hermitian files come back
    with both triangles (``expand_symmetric`` exists for API parity), and
    ``dtype`` downcasts as ``main.c:50-53`` does (double -> float complex).
    """
    return read_matrix_market(path, dtype)[0]
