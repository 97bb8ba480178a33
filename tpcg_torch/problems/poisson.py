"""2-D Poisson 5-point finite-difference operator.

Debug/alternative problem selected by the reference's ``Use_Poisson`` flag
(``p_h-PY_C-CL-multi-GPU.py:1637-1677``): diag 4, N/S/E/W = -1, no boundary
scaling (pure homogeneous-Dirichlet interior stencil on an N x N node grid).

The PyTorch port's copy of ``tpcg/problems/poisson.py``; it returns
``tpcg_torch.sparse.Stencil2D`` on ``device`` (default: the CUDA device,
raising without one; ``device="cpu"`` for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..sparse import Stencil2D

OFFSETS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


def poisson(N: int, dtype=np.float64, device=None) -> Stencil2D:
    device = resolve_device(device)
    diag = np.full((N, N), 4.0, dtype=dtype)
    east = np.full((N, N), -1.0, dtype=dtype)
    east[:, -1] = 0.0
    west = np.full((N, N), -1.0, dtype=dtype)
    west[:, 0] = 0.0
    north = np.full((N, N), -1.0, dtype=dtype)
    north[-1, :] = 0.0
    south = np.full((N, N), -1.0, dtype=dtype)
    south[0, :] = 0.0
    coef = np.stack([diag, east, west, north, south])
    return Stencil2D(OFFSETS, torch.from_numpy(coef).to(device), (N, N))
