"""Operation and byte counts of the ``banded`` class: a real symmetric
banded matrix stored by its diagonals, single precision.

Operations are report Table II's for a real iteration of one RHS,
``2 nnz + 10 n`` (the SpMV's multiply and add a nonzero; two dots and three
vector updates of 2 n each), the count of ``tpcg/utils/profiling.py::
cg_iteration_flops``.  The operator's data are its nonzero values: the
structure of a band is its offsets.
"""
from __future__ import annotations

ELEMENT_BYTES = 4          # float32
OFFSET_STEP = 37           # the stand-in's diagonals lie at multiples of 37


def n(cfg: dict) -> int:
    return cfg["n"]


def nnz(cfg: dict) -> int:
    """The main diagonal and ``half_band_diags`` pairs at +-37 k."""
    size, half = cfg["n"], cfg["half_band_diags"]
    return size + 2 * sum(size - OFFSET_STEP * k for k in range(1, half + 1))


def ops_per_iteration(cfg: dict) -> int:
    return 2 * nnz(cfg) + 10 * n(cfg)


def operator_bytes(cfg: dict) -> int:
    return ELEMENT_BYTES * nnz(cfg)
