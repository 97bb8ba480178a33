"""Entry ``hsolve``: ``tpcg_torch.hsolve(plan, b, n_iterations=...)``, one
global RHS a call on an ORAS-FGMRES plan made in set-up, with b, x and the
FGMRES residual estimates as numpy arrays in host memory.  Every call crops
b to the subdomains, uploads it, runs the fixed number of FGMRES iterations
(each one preconditioner application and one global matvec) and brings x
back as the global grid."""
from __future__ import annotations

import numpy as np


class Entry:
    CALLS = "hsolve"       # the program function a request calls

    def __init__(self, problem, cfg, traffic, device):
        self.plan = problem.plan
        self.grid = problem.grid
        self.iterations = cfg["n_iterations"]
        self.cfg = cfg

    def describe(self) -> str:
        c = self.cfg
        return (f"tpcg_torch.hsolve N={c['N']} M={c['M_subd']} "
                f"sdsz={c['sdsz']} CGMaxIT={c['cg_max_it']} "
                f"it={self.iterations}")

    def request(self, b):
        """b: (1, N, N) complex64, the global grid."""
        import tpcg_torch
        return tpcg_torch.hsolve(self.plan, b.reshape(self.grid),
                                 n_iterations=self.iterations)

    def result(self, out):
        """(x (1, N, N) complex128, history (rows, 1) float64)."""
        x, hist = out
        return (np.asarray(x, np.complex128).reshape(1, *self.grid),
                np.asarray(hist, np.float64).reshape(-1, 1))

    def close(self):
        self.plan = None
