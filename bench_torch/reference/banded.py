"""Plain reference of the ``banded`` class: the m_t1-class stand-in
``banded_spd(n, half_band_diags, seed)``, a symmetric, strongly diagonally
dominant band with diagonals at offsets 0 and +-37 k.

``matrix`` is the benchmark's own copy of the generator (the same draws
from the same seed, in float64), so that later changes to the program
cannot move the yardstick.  ``Banded.apply`` multiplies (B, n) blocks in
the dtype it was made in: cuSPARSE's (or the CPU's) CSR product in float32
and float64, and a gather over the diagonals in other dtypes.  Plain
torch; nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

OFFSET_STEP = 37


def matrix(cfg: dict):
    """scipy CSR float64 matrix of the configuration."""
    import scipy.sparse as sp
    n, half = cfg["n"], cfg["half_band_diags"]
    rng = np.random.default_rng(cfg["matrix_seed"])
    offs = [0] + [d for k in range(1, half + 1)
                  for d in (k * OFFSET_STEP, -k * OFFSET_STEP)]
    rows, cols, vals = [], [], []
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        v = (rng.standard_normal(len(i)) * 0.1 if off else
             np.full(len(i), float(2 * half + 2)))
        rows.append(i)
        cols.append(i + off)
        vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return sp.csr_matrix((A + A.T) * 0.5 + sp.eye(n) * (2 * half + 2))


class Banded:
    def __init__(self, A, dtype, device):
        self.dtype = dtype
        if dtype in (torch.float32, torch.float64):
            self.csr = torch.sparse_csr_tensor(
                torch.from_numpy(A.indptr.astype(np.int64)),
                torch.from_numpy(A.indices.astype(np.int64)),
                torch.from_numpy(A.data), A.shape, dtype=dtype,
                device=device)
            return
        self.csr = None
        coo = A.tocoo()
        offs = np.unique(coo.col - coo.row)
        pad = int(np.abs(offs).max())
        data = np.zeros((A.shape[0], len(offs)))
        data[coo.row, np.searchsorted(offs, coo.col - coo.row)] = coo.data
        rows = np.arange(A.shape[0])[:, None]
        self.pad = pad
        self.idx = torch.from_numpy(rows + offs[None, :] + pad).to(device)
        self.vals = torch.from_numpy(data).to(device, dtype)

    def apply(self, u):
        """(A u,) for u (B, n) in this operator's dtype."""
        if self.csr is not None:
            return ((self.csr @ u.T.contiguous()).T.contiguous(),)
        up = torch.nn.functional.pad(u, (self.pad, self.pad))
        return ((up[:, self.idx] * self.vals).sum(dim=-1),)


def operator(cfg: dict, dtype, device) -> Banded:
    return Banded(matrix(cfg), dtype, device)
