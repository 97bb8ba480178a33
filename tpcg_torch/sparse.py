"""Sparse-matrix containers of the PyTorch port (counterpart of ``tpcg/sparse.py``).

``Stencil2D``
    The 2-D grid-stencil operator: coefficient fields over an (Nv, Nh) node
    grid with static (dm, dj) neighbour offsets.  The Helmholtz/Poisson
    assembly produces it, and its matvec is a sum of zero-filled 2-D shifts.

``DiaMatrix``
    Row-oriented padded-diagonal storage for banded matrices; its matvec is
    a sum of zero-filled 1-D shifts.

Coefficients are torch tensors on an explicit device: the containers never
move data on their own, ``.to(device)`` returns a copy on another device.
scipy CSR stays the host interchange format (``to_scipy`` / ``from_scipy``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _shift_rows(x: torch.Tensor, off: int) -> torch.Tensor:
    """out[i] = x[i + off] with zero fill outside [0, n).  Static ``off``."""
    if off == 0:
        return x
    n = x.shape[0]
    out = torch.zeros_like(x)
    if abs(off) >= n:
        return out
    if off > 0:
        out[:n - off] = x[off:]
    else:
        out[-off:] = x[:n + off]
    return out


def _shift2d(x: torch.Tensor, dm: int, dj: int) -> torch.Tensor:
    """out[..., m, j] = x[..., m+dm, j+dj] with zero fill (static offsets)."""
    if dm == 0 and dj == 0:
        return x
    nv, nh = x.shape[-2:]
    out = torch.zeros_like(x)
    rows = nv - abs(dm)
    cols = nh - abs(dj)
    if rows <= 0 or cols <= 0:
        return out
    m0, j0 = max(0, -dm), max(0, -dj)
    out[..., m0:m0 + rows, j0:j0 + cols] = \
        x[..., m0 + dm:m0 + dm + rows, j0 + dj:j0 + dj + cols]
    return out


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Row-oriented padded-diagonal matrix.

    ``data[d, i] = A[i, i + offsets[d]]`` (zero where the column falls
    outside ``[0, n)``), as in ``tpcg.sparse.DiaMatrix``.
    """
    offsets: Tuple[int, ...]
    data: torch.Tensor       # (ndiag, n)
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def to(self, device) -> "DiaMatrix":
        return dataclasses.replace(self, data=self.data.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  ``x``: (n,) or (n, nrhs)."""
        data = self.data
        if x.dim() > 1:
            data = data.reshape(data.shape + (1,) * (x.dim() - 1))
        y = data[0] * _shift_rows(x, self.offsets[0])
        for d in range(1, len(self.offsets)):
            y = y + data[d] * _shift_rows(x, self.offsets[d])
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def to_scipy(self):
        import scipy.sparse as sp
        rows, cols, vals = [], [], []
        data = self.data.cpu().numpy()
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(self.n, self.n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=self.shape)

    @staticmethod
    def from_scipy(A, dtype=None, device="cpu") -> "DiaMatrix":
        """Convert a scipy sparse matrix whose nonzeros lie on a small set
        of diagonals (vectorized scatter, as ``tpcg.sparse.DiaMatrix``)."""
        import scipy.sparse as sp
        A = sp.coo_matrix(A)
        n = A.shape[0]
        d = A.col - A.row
        offs = np.unique(d)
        data = np.zeros((len(offs), n), dtype=dtype or A.dtype)
        d_idx = np.searchsorted(offs, d)
        np.add.at(data, (d_idx, A.row), A.data)
        return DiaMatrix(tuple(int(o) for o in offs),
                         torch.from_numpy(data).to(device), n)


@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """2-D grid-stencil operator on an (Nv, Nh) node grid.

    ``coef[s, m, j]`` multiplies ``x[m + dm_s, j + dj_s]`` where
    ``offsets[s] = (dm_s, dj_s)``; a neighbour outside the grid reads 0.
    Rows are nodes in lexicographic order ``node = m * Nh + j``.  Batch dims
    lead: ``x`` may be (Nv, Nh) or (B, Nv, Nh).
    """
    offsets: Tuple[Tuple[int, int], ...]
    coef: torch.Tensor       # (noff, Nv, Nh)
    grid: Tuple[int, int]    # (Nv, Nh)

    @property
    def n(self):
        return self.grid[0] * self.grid[1]

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.coef.dtype

    @property
    def device(self):
        return self.coef.device

    def to(self, device) -> "Stencil2D":
        return dataclasses.replace(self, coef=self.coef.to(device))

    def apply_grid(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with grid-shaped x: (..., Nv, Nh)."""
        y = self.coef[0] * _shift2d(x, *self.offsets[0])
        for s in range(1, len(self.offsets)):
            y = y + self.coef[s] * _shift2d(x, *self.offsets[s])
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with flat x: (n,) or (n, nrhs)."""
        nv, nh = self.grid
        if x.dim() == 1:
            return self.apply_grid(x.reshape(nv, nh)).reshape(-1)
        xg = x.T.reshape(x.shape[1], nv, nh)
        yg = self.apply_grid(xg)
        return yg.reshape(x.shape[1], nv * nh).T

    def __matmul__(self, x):
        return self.matvec(x)

    def to_dia(self) -> DiaMatrix:
        """Flatten to row-major DiaMatrix (offset = dm*Nh + dj), masking the
        horizontal wrap-around so the two forms are exactly equivalent."""
        nv, nh = self.grid
        offs = []
        data = []
        coef = self.coef.cpu().numpy()
        for s, (dm, dj) in enumerate(self.offsets):
            c = coef[s].copy()
            # a horizontal neighbour that leaves the grid must vanish: in the
            # flat form it would be the next row's first node
            if dj > 0:
                c[:, nh - dj:] = 0
            elif dj < 0:
                c[:, : -dj] = 0
            offs.append(dm * nh + dj)
            data.append(c.reshape(-1))
        order = np.argsort(offs)
        data = np.stack([data[i] for i in order])
        return DiaMatrix(tuple(int(offs[i]) for i in order),
                         torch.from_numpy(data).to(self.device), nv * nh)

    def to_scipy(self):
        return self.to_dia().to_scipy()
