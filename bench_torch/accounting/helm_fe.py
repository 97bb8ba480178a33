"""Operation and byte counts of the ``helm_fe`` class: the constant-
coefficient FE Helmholtz operator on an N x N grid (7-point stencil: the
node, E, W, N, S, NE, SW), complex single precision.

Operations are report Table II's for a complex iteration of one RHS,
``8 nnz + 40 n`` (the complex SpMV's 8 real operations a nonzero, and the
vector updates and dots): the count of ``tpcg/utils/profiling.py::
cg_iteration_flops`` and PERF.md section 2.
"""
from __future__ import annotations

ELEMENT_BYTES = 8          # complex64
TAPS = 7


def n(cfg: dict) -> int:
    return cfg["N"] ** 2


def nnz(cfg: dict) -> int:
    """Nonzeros of the assembled matrix: the node, E/W and N/S links of
    every node that has them, NE/SW links of every square."""
    N = cfg["N"]
    return N * N + 4 * N * (N - 1) + 2 * (N - 1) ** 2


def ops_per_iteration(cfg: dict) -> int:
    return 8 * nnz(cfg) + 40 * n(cfg)


def operator_bytes(cfg: dict) -> int:
    """The operator's own data: constant coefficients, one complex value a
    tap.  (The boundary rows follow from N, k and eps.)"""
    return TAPS * ELEMENT_BYTES
