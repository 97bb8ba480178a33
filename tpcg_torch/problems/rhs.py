"""Right-hand sides for the Helmholtz problem suite.

The PyTorch port's copy of ``tpcg/problems/rhs.py``: plain numpy, which
callers hand to ``plan.solve`` or turn into device planes themselves.

``plane_wave_rhs`` is the impedance-boundary plane-wave load ("special RHS
from Ivan", ``helmFE_var.py:333-368`` and the per-subdomain twin
``p_h-PY_C-CL-multi-GPU.py:1367-1431``): for the incoming plane wave
``exp(i k a.x)`` with direction ``a = (1/sqrt2, 1/sqrt2)``, each boundary
node gets the edge-quadrature of ``i k (a.n - 1) exp(i k a.x)`` over its
incident boundary edges (3-point composite rule: midpoint-left, node,
midpoint-right weighted h/3; corners use the h/6*(2,1) end-of-edge rule).

Note: the reference parameterises the *right* boundary with the same point
list as the top boundary (``helmFE_var.py:354``).  For the default
symmetric direction vector ``a = (1/sqrt2, 1/sqrt2)`` the dot products are
identical under coordinate swap, so the geometrically-correct points used
here produce bit-identical values; for a non-symmetric ``a`` ours is the
correct integral (documented deliberate fix, SURVEY §"Quirks").

``rhs_left_k2`` / ``rhs_all_boundaries_k2`` are the simple k^2 loads
``rhsL`` / ``rhsA`` (``helmFE_var.py:370-389``).
"""
from __future__ import annotations

import numpy as np


def plane_wave_rhs(N: int, k: float, direction=None) -> np.ndarray:
    """Returns b as an (N, N) complex grid (row m = vertical index, col j =
    horizontal), matching ``rhs()``'s layout: ``b[0, :]`` bottom boundary,
    ``b[:, 0]`` left boundary.  Flatten row-major for the solver."""
    a = np.asarray(direction if direction is not None else
                   [1.0 / np.sqrt(2.0), 1.0 / np.sqrt(2.0)])
    h = 1.0 / (N - 1.0)
    x = np.linspace(0.0, 1.0, N)
    y = (x[1:] + x[:-1]) / 2.0          # edge midpoints
    b = np.zeros((N, N), dtype=np.complex128)

    # multipliers i*k*(a.n - 1) per side (outward normals)
    multbot = 1j * k * (-a[1] - 1.0)
    multtop = 1j * k * (a[1] - 1.0)
    multleft = 1j * k * (-a[0] - 1.0)
    multright = 1j * k * (a[0] - 1.0)

    def wave(pts):
        return np.exp(1j * k * (pts @ a))

    j = np.arange(1, N - 1)
    # interior of bottom boundary: points (y[j-1],0), (x[j],0), (y[j],0)
    pb = np.stack([np.stack([y[j - 1], np.zeros_like(y[j - 1])], -1),
                   np.stack([x[j], np.zeros_like(x[j])], -1),
                   np.stack([y[j], np.zeros_like(y[j])], -1)])
    b[0, 1:N - 1] = (h / 3.0) * multbot * wave(pb).sum(axis=0)
    # top
    pt = np.stack([np.stack([y[j - 1], np.ones_like(y[j - 1])], -1),
                   np.stack([x[j], np.ones_like(x[j])], -1),
                   np.stack([y[j], np.ones_like(y[j])], -1)])
    b[-1, 1:N - 1] = (h / 3.0) * multtop * wave(pt).sum(axis=0)
    # left
    pl = np.stack([np.stack([np.zeros_like(y[j - 1]), y[j - 1]], -1),
                   np.stack([np.zeros_like(x[j]), x[j]], -1),
                   np.stack([np.zeros_like(y[j]), y[j]], -1)])
    b[1:N - 1, 0] = (h / 3.0) * multleft * wave(pl).sum(axis=0)
    # right (geometrically-correct points; see module docstring)
    pr = np.stack([np.stack([np.ones_like(y[j - 1]), y[j - 1]], -1),
                   np.stack([np.ones_like(x[j]), x[j]], -1),
                   np.stack([np.ones_like(y[j]), y[j]], -1)])
    b[1:N - 1, -1] = (h / 3.0) * multright * wave(pr).sum(axis=0)

    def w(p):
        return np.exp(1j * k * (np.asarray(p) @ a))

    # corners: h/6 * mult * (2*wave(mid of incident edge) + wave(corner)),
    # summed over the two incident sides (``helmFE_var.py:356-367``).
    b[0, 0] = ((h / 6.0) * multleft * (2.0 * w([0.0, y[0]]) + w([0.0, 0.0]))
               + (h / 6.0) * multbot * (2.0 * w([y[0], 0.0]) + w([0.0, 0.0])))
    b[0, -1] = ((h / 6.0) * multbot * (2.0 * w([y[N - 2], 0.0]) + w([1.0, 0.0]))
                + (h / 6.0) * multright * (2.0 * w([1.0, y[0]]) + w([1.0, 0.0])))
    b[-1, 0] = ((h / 6.0) * multleft * (2.0 * w([0.0, y[N - 2]]) + w([0.0, 1.0]))
                + (h / 6.0) * multtop * (2.0 * w([y[0], 1.0]) + w([0.0, 1.0])))
    b[-1, -1] = ((h / 6.0) * multtop * (2.0 * w([y[N - 2], 1.0]) + w([1.0, 1.0]))
                 + (h / 6.0) * multright * (2.0 * w([1.0, y[N - 2]]) + w([1.0, 1.0])))
    return b


def rhs_left_k2(N: int, k: float) -> np.ndarray:
    """``rhsL``: k^2 on the interior of the left boundary
    (``helmFE_var.py:370-377``)."""
    b = np.zeros((N, N), dtype=np.complex128)
    b[1:N - 1, 0] = k * k
    return b


def rhs_all_boundaries_k2(N: int, k: float) -> np.ndarray:
    """``rhsA``: k^2 on all four boundaries (``helmFE_var.py:379-389``)."""
    b = np.zeros((N, N), dtype=np.complex128)
    b[:, 0] = k * k
    b[:, -1] = k * k
    b[0, :] = k * k
    b[-1, :] = k * k
    return b


def oshape_mask(N: int, inner: float = 1.0 / 3.0) -> np.ndarray:
    """Default O-shape-domain inactive-node mask (``OshapeD``,
    ``p_h-PY_C-CL-multi-GPU.py:3603-3605``): 1.0 on active nodes, 0.0 on
    the inactive middle square hole of side ``inner * N`` (the reference
    never populates ``InactiveNodes`` in-tree -- it is external input --
    so this provides the canonical O-shaped domain it names).
    """
    m = np.ones((N, N), dtype=np.float64)
    lo = int(round(N * (0.5 - inner / 2.0)))
    hi = int(round(N * (0.5 + inner / 2.0)))
    m[lo:hi, lo:hi] = 0.0
    return m
