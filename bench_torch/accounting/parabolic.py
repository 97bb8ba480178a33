"""Operation and byte counts of the ``parabolic`` class: the parabolic_fem
stand-in, a 7-point FE stencil (the node, E, W, N, S, NE, SW) on an
Ng x Ng grid, real single precision.

Operations are report Table II's for a real iteration of one RHS,
``2 nnz + 10 n`` (the SpMV's multiply and add a nonzero; two dots and three
vector updates of 2 n each), as ``accounting/banded.py`` counts them.  The
operator's data are its seven constant taps: the boundary rows follow from
Ng.
"""
from __future__ import annotations

ELEMENT_BYTES = 4          # float32
TAPS = 7


def n(cfg: dict) -> int:
    return cfg["Ng"] ** 2


def nnz(cfg: dict) -> int:
    """Nonzeros of the assembled matrix: every node, its E/W and N/S links
    where the neighbour is on the grid (4 Ng short of 4 n), and its NE/SW
    links (2 (2 Ng - 1) short of 2 n)."""
    Ng = cfg["Ng"]
    return 7 * n(cfg) - 4 * Ng - 2 * (2 * Ng - 1)


def ops_per_iteration(cfg: dict) -> int:
    return 2 * nnz(cfg) + 10 * n(cfg)


def operator_bytes(cfg: dict) -> int:
    """The operator's own data: the seven constant taps."""
    return TAPS * ELEMENT_BYTES
