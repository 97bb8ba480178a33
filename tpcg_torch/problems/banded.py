"""Synthetic stand-ins for the banded report Fig. 5 matrices.

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
"""
from __future__ import annotations

import numpy as np
import torch

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


def parabolic_stencil(Ng=725, device="cpu") -> Stencil2D:
    """benchmarks/bench_fig5.py:195-217: the parabolic_fem class as an
    Ng x Ng 7-point float32 stencil (diagonal 8, six -1 neighbours, taps
    that leave the grid zeroed); ``.to_dia()`` gives offsets 0, +-1,
    +-Ng, +-(Ng+1)."""
    offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1))
    coef = np.empty((7, Ng, Ng), np.float32)
    coef[0] = 8.0
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
