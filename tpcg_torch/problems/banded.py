"""Synthetic stand-ins for the report Fig. 5 matrices and the general-sparse rows.

SuiteSparse files are not redistributable here, so the JAX package's
benchmarks build matrices of the same size class, nnz per row and structure
family from a seed.  These are copies of those generators (numpy and scipy
only; the benchmark modules themselves are JAX-side):

  m_t1 class          banded_spd(97578, 50)      real SPD, 101 diagonals at
                      multiples of 37, nnz 9.76 M
                      (benchmarks/bench_general_sparse.py:23-37)
  parabolic_fem class parabolic_stencil(725)     the 725^2 7-point Stencil2D,
                      n = 525,625 (benchmarks/bench_fig5.py:195-217)
  mhd1280b class      banded_complex(1280, range(0, 9), seed=2)  complex
                      symmetric, 17 diagonals (benchmarks/bench_fig5.py:64-77,
                      234-236)
  1138_bus class      irregular_spd(1138, 3.56, seed=0)  real SPD random
                      graph, nnz ~9 k, no ordering makes it banded
                      (benchmarks/bench_fig5.py:37-46, 148-161)
  random-routed row   random_spd(97578, 100, seed=1)  real SPD, 100 random
                      columns a row, nnz 19,593,022
                      (benchmarks/bench_general_sparse.py:40-48)

``irregular_spd`` and ``random_spd`` take ``dtype=np.complex64`` for a
complex symmetric variant with the same pattern and real parts: the
imaginary parts are drawn after the real ones and the diagonal gains
``0.5j``, as in the construction of tests/test_api.py:114-119.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..sparse import Stencil2D


def banded_spd(n, half_band_diags, seed=0):
    """benchmarks/bench_general_sparse.py:23-37: a symmetric, strongly
    diagonally dominant band with diagonals at offsets 0, +-37 k."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    offs = [0] + [d for k in range(1, half_band_diags + 1)
                  for d in (k * 37, -k * 37)]
    rows, cols, vals = [], [], []
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        v = (rng.standard_normal(len(i)) * 0.1 if off else
             np.full(len(i), float(2 * half_band_diags + 2)))
        rows.append(i)
        cols.append(i + off)
        vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return (A + A.T) * 0.5 + sp.eye(n) * (2 * half_band_diags + 2)


def irregular_spd(n, per_row, seed=0, dtype=np.float32):
    """benchmarks/bench_fig5.py:37-46, the 1138_bus class: n * per_row
    random (row, column) pairs with 0.1 N(0, 1) values, symmetrised, plus
    (per_row + 2) I; complex dtypes add 0.1 N(0, 1) imaginary parts and
    0.5j on the diagonal."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    nnz = int(n * per_row)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) * 0.1
    diag = per_row + 2.0
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.standard_normal(nnz) * 0.1
        diag = diag + 0.5j
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T) * 0.5
    return sp.csr_matrix(A + sp.eye(n) * diag).astype(dtype)


def random_spd(n, per_row, seed=1, dtype=np.float64):
    """benchmarks/bench_general_sparse.py:40-48, the random-routed row:
    per_row random columns in every row with 0.05 N(0, 1) values,
    symmetrised, plus (per_row / 2) I; complex dtypes add 0.05 N(0, 1)
    imaginary parts and 0.5j on the diagonal."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, size=n * per_row)
    vals = rng.standard_normal(n * per_row) * 0.05
    diag = per_row * 0.5
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.standard_normal(n * per_row) * 0.05
        diag = diag + 0.5j
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T) * 0.5
    return sp.csr_matrix(A + sp.eye(n) * diag).astype(dtype)


def banded_complex(n, offsets, seed=0):
    """benchmarks/bench_fig5.py:64-77: complex symmetric (COCG territory),
    diagonally dominant."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        v = ((rng.standard_normal(len(i))
              + 1j * rng.standard_normal(len(i))) * 0.1
             if off else np.full(len(i), 2.0 * len(offsets) + 0.5j))
        rows.append(i)
        cols.append(i + off)
        vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return (A + A.T) * 0.5


def parabolic_stencil(Ng=725, device=None, diag=8.0) -> Stencil2D:
    """benchmarks/bench_fig5.py:195-217: the parabolic_fem class as an
    Ng x Ng 7-point float32 stencil (diagonal ``diag``, six -1 neighbours,
    taps that leave the grid zeroed); ``.to_dia()`` gives offsets 0, +-1,
    +-Ng, +-(Ng+1).  ``device`` defaults to the CUDA device (raising
    without one).

    The default diagonal 8 is bench_fig5.py's: strongly dominant, CG's
    ``<r, r>`` underflows within ~100 float32 iterations.  ``diag=6.0``
    makes the interior rows sum to zero (the boundary rows, whose outward
    taps are zeroed, carry the mass), which takes float32 CG thousands of
    iterations: the stiffness-dominated step of a parabolic problem."""
    device = resolve_device(device)
    offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1))
    coef = np.empty((7, Ng, Ng), np.float32)
    coef[0] = diag
    for s in range(1, 7):
        coef[s] = -1.0
    coef[1][:, -1] = 0
    coef[2][:, 0] = 0
    coef[3][-1, :] = 0
    coef[4][0, :] = 0
    coef[5][-1, :] = 0
    coef[5][:, -1] = 0
    coef[6][0, :] = 0
    coef[6][:, 0] = 0
    return Stencil2D(offs, torch.from_numpy(coef).to(device), (Ng, Ng))
