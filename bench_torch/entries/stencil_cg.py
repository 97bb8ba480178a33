"""Entry ``stencil_cg``: the stencil planner's one-shot call
``tpcg_torch.stencil_cg(stencil, b, n_iterations=...)`` on a grid operator
the caller keeps on the device (``Stencil2D``, made in set-up), with b, x
and the residual history as numpy arrays in host memory.  Every call
plans (the path, the kernel's operands) and solves."""
from __future__ import annotations

import numpy as np


class Entry:
    CALLS = "stencil_cg"   # the program function a request calls

    def __init__(self, problem, cfg, traffic, device):
        self.stencil = problem.stencil
        self.grid = problem.grid
        self.iterations = cfg["n_iterations"]

    def describe(self) -> str:
        nv, nh = self.grid
        return (f"tpcg_torch.stencil_cg Stencil2D {nv}x{nh} "
                f"taps={len(self.stencil.offsets)}")

    def request(self, b):
        """b: (1, n) float32, the grid's nodes row by row."""
        import tpcg_torch
        return tpcg_torch.stencil_cg(self.stencil, b.reshape(self.grid),
                                     n_iterations=self.iterations)

    def result(self, out):
        """(x (1, n) float64, history (rows, 1) float64)."""
        x, hist = out
        return (np.asarray(x, np.float64).reshape(1, -1),
                np.asarray(hist, np.float64).reshape(-1, 1))

    def close(self):
        self.stencil = None
