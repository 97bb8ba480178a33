"""Entry ``cg_matrix``: ``tpcg_torch.cg_matrix(A, b, n_rhs, n_iterations)``
on a matrix the caller keeps on the device (``DiaMatrix``, made in set-up),
with b, x and the residual history as numpy arrays in host memory: the
report's block solve with the device buffers resident."""
from __future__ import annotations

import numpy as np


class Entry:
    CALLS = "cg_matrix"    # the program function a request calls

    def __init__(self, problem, cfg, traffic, device):
        self.A = problem.dia
        self.nrhs = traffic["n_rhs"]
        self.iterations = cfg["n_iterations"]

    def describe(self) -> str:
        return (f"tpcg_torch.cg_matrix DiaMatrix n={self.A.n} "
                f"diagonals={len(self.A.offsets)}")

    def request(self, b):
        """b: (n_rhs, n) float32; RHS r at [r n, (r + 1) n) of the packing."""
        import tpcg_torch
        return tpcg_torch.cg_matrix(
            self.A, b.reshape(-1), n_rhs=self.nrhs,
            n_iterations=self.iterations, record_history=True)

    def result(self, out):
        """(x (n_rhs, n) float64, history (rows, n_rhs) float64)."""
        x, hist = out
        return (np.asarray(x, np.float64).reshape(self.nrhs, -1),
                np.asarray(hist, np.float64).reshape(-1, self.nrhs))

    def close(self):
        self.A = None
