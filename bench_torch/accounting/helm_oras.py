"""Operation and byte counts of the ``helm_oras`` class: the ORAS-FGMRES
solve of the constant-coefficient FE Helmholtz operator on the expanded
N x N grid, M x M subdomains of sdsz x sdsz nodes, complex single
precision.

An FGMRES iteration is one preconditioner application and one global
matvec.  The application is ``cg_max_it`` COCG iterations on each of the
``M^2`` subdomain blocks (7-point, ``sdsz^2`` nodes), each counted as report
Table II counts a complex iteration, ``8 nnz_s + 40 n_s``; the matvec is the
complex SpMV's ``8 nnz``.  The Arnoldi step's dots and updates (CGS2 over
at most ``n_iterations + 1`` basis vectors) are left out: under 0.1% of an
iteration at the cell's size.
"""
from __future__ import annotations

ELEMENT_BYTES = 8          # complex64
TAPS = 7


def _nnz7(N: int) -> int:
    """Nonzeros of the 7-point FE matrix on an N x N grid: the node, E/W and
    N/S links of every node that has them, NE/SW links of every square."""
    return N * N + 4 * N * (N - 1) + 2 * (N - 1) ** 2


def n(cfg: dict) -> int:
    return cfg["N"] ** 2


def nnz(cfg: dict) -> int:
    return _nnz7(cfg["N"])


def subdomain_ops(cfg: dict) -> int:
    """Table II operations of one COCG iteration on one subdomain block."""
    return 8 * _nnz7(cfg["sdsz"]) + 40 * cfg["sdsz"] ** 2


def ops_per_iteration(cfg: dict) -> int:
    return (cfg["cg_max_it"] * cfg["M_subd"] ** 2 * subdomain_ops(cfg)
            + 8 * nnz(cfg))


def operator_bytes(cfg: dict) -> int:
    """The operators' own data: constant coefficients, one complex value a
    tap, of the global operator and of the shared subdomain block."""
    return 2 * TAPS * ELEMENT_BYTES
