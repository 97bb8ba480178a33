"""Carry operators from the JAX package into the port.

``from_tpcg`` turns a ``tpcg.sparse.Stencil2D`` or ``DiaMatrix`` into the
port's counterpart.  It reads only ``.offsets``, ``.grid`` / ``.n`` and
``np.asarray(.coef / .data)``, so it needs no JAX import: the tests build
both sides of a comparison from one object with it.
"""
from __future__ import annotations

import numpy as np
import torch

from .sparse import DiaMatrix, Stencil2D


def from_tpcg(container, device="cpu"):
    """``tpcg.sparse.Stencil2D`` / ``DiaMatrix`` -> the port's container."""
    if hasattr(container, "coef") and hasattr(container, "grid"):
        coef = np.array(np.asarray(container.coef))
        return Stencil2D(tuple((int(dm), int(dj))
                               for dm, dj in container.offsets),
                         torch.from_numpy(coef).to(device),
                         tuple(int(g) for g in container.grid))
    if hasattr(container, "data") and hasattr(container, "n"):
        data = np.array(np.asarray(container.data))
        return DiaMatrix(tuple(int(o) for o in container.offsets),
                         torch.from_numpy(data).to(device), int(container.n))
    raise TypeError(f"no port counterpart for {type(container).__name__}")


def coef3_from_numpy(np_coef3, device="cpu") -> torch.Tensor:
    """The output of ``tpcg.ops.fused_cg.prepare_coef3`` (as numpy) ->
    the (3, noff, Nv, Nh) float32 tensor the port's kernel takes."""
    c = np.asarray(np_coef3)
    if c.ndim != 4 or c.shape[0] != 3:
        raise ValueError(f"coef3 must be (3, noff, Nv, Nh), got {c.shape}")
    return torch.from_numpy(np.array(c, dtype=np.float32)).to(device)
