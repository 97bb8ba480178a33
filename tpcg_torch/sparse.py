"""Sparse-matrix containers of the PyTorch port (counterpart of ``tpcg/sparse.py``).

``Stencil2D``
    The 2-D grid-stencil operator: coefficient fields over an (Nv, Nh) node
    grid with static (dm, dj) neighbour offsets.  The Helmholtz/Poisson
    assembly produces it, and its matvec is a sum of zero-filled 2-D shifts.

``DiaMatrix``
    Row-oriented padded-diagonal storage for banded matrices; its matvec is
    a sum of zero-filled 1-D shifts.

``EllMatrix``
    Padded-row (ELLPACK) storage for general sparse matrices; its matvec is
    a gather.  ``to_device_matrix`` picks between the two for a scipy
    matrix, with reverse Cuthill-McKee reordering into a band.

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
class EllMatrix:
    """ELLPACK: rows padded to the max row degree L.

    ``vals[i, l]`` with column ``cols[i, l]``; padding slots have
    ``vals == 0`` and ``cols`` pointing at row ``i`` itself, so the gather
    stays in range, as in ``tpcg.sparse.EllMatrix``.
    """
    cols: torch.Tensor       # (n, L) int32
    vals: torch.Tensor       # (n, L)
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(self, cols=self.cols.to(device),
                                   vals=self.vals.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  ``x``: (n,) or (n, nrhs)."""
        L = self.cols.shape[1]
        gathered = torch.index_select(x, 0, self.cols.reshape(-1))
        gathered = gathered.reshape((self.n, L) + x.shape[1:])
        vals = self.vals
        if x.dim() > 1:
            vals = vals.reshape(vals.shape + (1,) * (x.dim() - 1))
        return torch.sum(vals * gathered, dim=1)

    def __matmul__(self, x):
        return self.matvec(x)

    @staticmethod
    def from_scipy(A, dtype=None, device="cpu") -> "EllMatrix":
        import scipy.sparse as sp
        A = sp.csr_matrix(A)
        return EllMatrix.from_csr_arrays(A.shape[0], A.data, A.indptr,
                                         A.indices, dtype=dtype,
                                         device=device)

    @staticmethod
    def from_csr_arrays(n, a_values, a_pointers, a_cols, dtype=None,
                        device="cpu") -> "EllMatrix":
        """Build from raw CSR arrays (the ``clcg::cg`` input surface),
        scattered into the padded (n, L) layout as JAX does."""
        a_pointers = np.asarray(a_pointers)
        a_cols = np.asarray(a_cols)
        a_values = np.asarray(a_values)
        deg = np.diff(a_pointers)
        L = max(int(deg.max()), 1)
        nnz = len(a_values)
        rows = np.repeat(np.arange(n), deg)
        lane = np.arange(nnz) - np.repeat(a_pointers[:-1], deg)
        cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, L))
        vals = np.zeros((n, L), dtype=dtype or a_values.dtype)
        cols[rows, lane] = a_cols
        vals[rows, lane] = a_values
        return EllMatrix(torch.from_numpy(cols).to(device),
                         torch.from_numpy(vals).to(device), n)


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


def _dia_worthwhile(A, prefer_dia_band: int) -> bool:
    import scipy.sparse as sp
    coo = sp.coo_matrix(A)
    offs = np.unique(coo.col - coo.row)
    n = A.shape[0]
    return (len(offs) * n <= max(4 * A.nnz, 16 * n)
            and len(offs) <= prefer_dia_band)


def to_device_matrix(A, prefer_dia_band: int = 4096, reorder: bool = False,
                     route_fallback: bool = False, device="cpu"):
    """Pick the device container for a scipy sparse matrix, on ``device``
    (``tpcg.sparse.to_device_matrix``).

    A matrix with a modest number of distinct diagonals (``ndiag * n``
    within ~4x of ``nnz``) becomes a ``DiaMatrix``; anything else an
    ``EllMatrix``.  ``reorder=True`` also tries symmetric reverse
    Cuthill-McKee (scipy's, so the permutation is JAX's) and returns
    ``(container, perm)``: the container holds ``A[perm][:, perm]``, so
    solve with ``b[perm]`` and un-permute; ``perm`` is None when the
    natural order is kept.

    ``route_fallback=True`` (implies the ``reorder`` return convention):
    where JAX builds its routing-network operand for a real matrix that no
    ordering makes banded, the port has none yet (ROADMAP queue 1 item 13).
    On a CUDA device that raises ``NotImplementedError``, and never takes
    the ELL gather instead; on the CPU it returns the ``EllMatrix``.
    """
    import scipy.sparse as sp
    A = sp.csr_matrix(A)
    if _dia_worthwhile(A, prefer_dia_band):
        M = DiaMatrix.from_scipy(A, device=device)
        return (M, None) if (reorder or route_fallback) else M
    if reorder or route_fallback:
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm]
        if _dia_worthwhile(Ap, prefer_dia_band):
            return DiaMatrix.from_scipy(Ap, device=device), perm
        if (route_fallback and not np.iscomplexobj(A.data)
                and torch.device(device).type == "cuda"):
            raise NotImplementedError(
                f"unstructured {A.shape[0]}x{A.shape[1]} matrix "
                f"(nnz={A.nnz}): JAX routes it through its routing-network "
                "SpMV, which tpcg_torch has not ported yet: ROADMAP queue 1 "
                "item 13 (queue 2 item 22)")
        return EllMatrix.from_scipy(A, device=device), None
    return EllMatrix.from_scipy(A, device=device)
