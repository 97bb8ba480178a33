"""Entry ``api_cg``: the C-style surface ``tpcg_torch.cg(size, nnz, values,
b, indptr, indices, n_rhs, n_iterations)`` with the matrix as CSR arrays in
host memory and b, x and the residual history in host memory, as the
report's ``clcg::cg`` is called.  Every call converts the matrix (RCM
ordering and the device container), uploads, solves and downloads."""
from __future__ import annotations

import numpy as np


class Entry:
    CALLS = "cg"           # the program function a request calls

    def __init__(self, problem, cfg, traffic, device):
        self.device = device
        self.nrhs = traffic["n_rhs"]
        self.iterations = cfg["n_iterations"]
        self.csr = problem.csr()
        self.grid = problem.grid

    def describe(self) -> str:
        n, nnz = self.csr[:2]
        return f"tpcg_torch.cg n={n} nnz={nnz}"

    def request(self, b):
        """b: (n_rhs, N, N) complex64; column-major RHS stacking, RHS r at
        [r n, (r + 1) n)."""
        import tpcg_torch
        n, nnz, values, indptr, indices = self.csr
        return tpcg_torch.cg(
            n, nnz, values, b.reshape(-1), indptr, indices,
            n_rhs=self.nrhs, n_iterations=self.iterations,
            record_history=True, device=self.device)

    def result(self, out):
        """(x (n_rhs, N, N) complex128, history (rows, n_rhs) float64)."""
        x, hist = out
        return (np.asarray(x, np.complex128).reshape(self.nrhs, *self.grid),
                np.asarray(hist, np.float64).reshape(-1, self.nrhs))

    def close(self):
        self.csr = None
