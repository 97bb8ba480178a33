"""Plane-wave sources with seeded directions: the RHS generator of the
``helm_fe`` class.

``plane_wave`` is the benchmark's own copy of the program's
``problems/rhs.py::plane_wave_rhs`` (the impedance-boundary load of the
incoming wave ``exp(i k a.x)``: each boundary node gets the 3-point edge
quadrature of ``i k (a.n - 1) exp(i k a.x)`` over its boundary edges,
corners the h/6 (2, 1) end-of-edge rule), written so that later changes to
the program cannot move the yardstick.  ``pool`` draws the directions from
the seed.
"""
from __future__ import annotations

import numpy as np


def plane_wave(N: int, k: float, a) -> np.ndarray:
    """b as an (N, N) complex128 grid (row m vertical, column j
    horizontal; ``b[0, :]`` the bottom boundary) for direction ``a``."""
    a = np.asarray(a, dtype=np.float64)
    h = 1.0 / (N - 1.0)
    x = np.linspace(0.0, 1.0, N)
    mid = (x[1:] + x[:-1]) / 2.0          # edge midpoints
    b = np.zeros((N, N), dtype=np.complex128)

    def wave(px, py):
        return np.exp(1j * k * (px * a[0] + py * a[1]))

    # i k (a.n - 1) on each side, outward normals
    mult = {"bottom": 1j * k * (-a[1] - 1.0), "top": 1j * k * (a[1] - 1.0),
            "left": 1j * k * (-a[0] - 1.0), "right": 1j * k * (a[0] - 1.0)}
    inner = np.arange(1, N - 1)
    lo, at, hi = mid[inner - 1], x[inner], mid[inner]
    for side, fixed in (("bottom", 0.0), ("top", 1.0)):
        row = 0 if side == "bottom" else -1
        quad = (wave(lo, fixed) + wave(at, fixed) + wave(hi, fixed))
        b[row, 1:N - 1] = (h / 3.0) * mult[side] * quad
    for side, fixed in (("left", 0.0), ("right", 1.0)):
        col = 0 if side == "left" else -1
        quad = (wave(fixed, lo) + wave(fixed, at) + wave(fixed, hi))
        b[1:N - 1, col] = (h / 3.0) * mult[side] * quad

    def corner(cx, cy, side_v, side_h):
        # the two boundary edges at the corner: vertical side (x fixed) and
        # horizontal side (y fixed), each h/6 (2 wave(edge mid) + wave(c))
        my = mid[0] if cy == 0.0 else mid[-1]
        mx = mid[0] if cx == 0.0 else mid[-1]
        return ((h / 6.0) * mult[side_v] * (2.0 * wave(cx, my) + wave(cx, cy))
                + (h / 6.0) * mult[side_h] * (2.0 * wave(mx, cy)
                                              + wave(cx, cy)))

    b[0, 0] = corner(0.0, 0.0, "left", "bottom")
    b[0, -1] = corner(1.0, 0.0, "right", "bottom")
    b[-1, 0] = corner(0.0, 1.0, "left", "top")
    b[-1, -1] = corner(1.0, 1.0, "right", "top")
    return b


class Pool:
    """The run's requests: request ``i`` is ``traffic["n_rhs"]`` plane waves,
    each direction ``(cos t, sin t)`` with its own t drawn from the seed,
    uniform on [0, 2 pi), ``traffic["pool"]`` directions before any
    repeats.  ``pool[i]`` is made when it is asked for: complex64
    (n_rhs, N, N)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.N, self.k = cfg["N"], cfg["k"]
        self.nrhs = traffic["n_rhs"]
        self.angles = np.random.default_rng(seed).uniform(
            0.0, 2.0 * np.pi, traffic["pool"])

    def __getitem__(self, i: int) -> np.ndarray:
        out = np.empty((self.nrhs, self.N, self.N), dtype=np.complex64)
        for r in range(self.nrhs):
            t = self.angles[(i * self.nrhs + r) % len(self.angles)]
            out[r] = plane_wave(self.N, self.k, (np.cos(t), np.sin(t)))
        return out


def pool(cfg: dict, traffic: dict, seed: int) -> Pool:
    return Pool(cfg, traffic, seed)
