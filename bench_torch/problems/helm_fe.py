"""The program's constant-coefficient FE Helmholtz operator of a
configuration: ``tpcg_torch.problems.helm_fe(N, k, eps)``, assembled by the
program on the run's device, and its CSR arrays on the host for entries
that take a matrix."""
from __future__ import annotations

import numpy as np


class Problem:
    def __init__(self, cfg: dict, device):
        from tpcg_torch.problems import helm_fe
        self.grid = (cfg["N"], cfg["N"])
        self.stencil = helm_fe(cfg["N"], cfg["k"], cfg["eps"], device=device)

    def csr(self):
        """``(n, nnz, values, indptr, indices)`` of the assembled matrix,
        values complex64, on the host: what a caller of the C-style entry
        point holds."""
        A = self.stencil.to_scipy().tocsr().astype(np.complex64)
        A.sort_indices()
        return A.shape[0], A.nnz, A.data, A.indptr, A.indices


def build(cfg: dict, device) -> Problem:
    return Problem(cfg, device)
