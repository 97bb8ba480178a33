"""Plain reference of the constant-coefficient FE Helmholtz operator.

``S = K - (k^2 + i eps) M - i eta B`` on an N x N node grid of the unit
square, P1 elements on squares split by their SW-NE diagonal, impedance
parameter ``eta = k`` (report Table I ``helm_fem``; Tali & Vainikko, *Block
Conjugate Gradient solver in OpenCL*, section VI):

* ``K``: the stiffness matrix, element matrix of a right triangle with legs
  h, ``1/2 [[2, -1, -1], [-1, 1, 0], [-1, 0, 1]]`` (right-angle corner first);
* ``M``: the mass matrix, element matrix ``h^2/24 [[2, 1, 1], [1, 2, 1],
  [1, 1, 2]]``;
* ``B``: the boundary mass matrix, edge matrix ``h/6 [[2, 1], [1, 2]]`` on
  every boundary edge.

The operator is applied element by element, matrix-free, to re/im planes
of shape (B, N, N) (row m vertical, column j horizontal; node m*N + j), in
the planes' own dtype.  It assembles nothing the program made: no
stencil, no coefficient table.  Plain torch, no kernel of the port.
"""
from __future__ import annotations

import torch


class HelmFE:
    """``helm_fe(N, k, eps)``'s operator on planes of one dtype."""

    def __init__(self, N: int, k: float, eps: float, dtype, device):
        self.N = N
        self.h = 1.0 / (N - 1.0)
        self.dtype = dtype
        self.device = device
        # the mass coefficient k^2 + i eps and eta = k, rounded to dtype
        self.cr = torch.tensor(k * k, dtype=dtype, device=device)
        self.ci = torch.tensor(eps, dtype=dtype, device=device)
        self.eta = torch.tensor(k, dtype=dtype, device=device)
        self.mass_w = torch.tensor(self.h * self.h / 24.0, dtype=dtype,
                                   device=device)
        self.edge_w = torch.tensor(self.h / 6.0, dtype=dtype, device=device)

    def _stiff_mass(self, u):
        """(K u, M u) for one real plane batch u (B, N, N)."""
        K = torch.zeros_like(u)
        M = torch.zeros_like(u)
        sw, se = u[:, :-1, :-1], u[:, :-1, 1:]
        ne, nw = u[:, 1:, 1:], u[:, 1:, :-1]
        # (right-angle corner R, A, B, and where each sits in the plane)
        for R, A, B, r_at, a_at, b_at in (
                (se, sw, ne, (slice(None, -1), slice(1, None)),
                 (slice(None, -1), slice(None, -1)),
                 (slice(1, None), slice(1, None))),
                (nw, sw, ne, (slice(1, None), slice(None, -1)),
                 (slice(None, -1), slice(None, -1)),
                 (slice(1, None), slice(1, None)))):
            K[(slice(None),) + r_at] += R - 0.5 * (A + B)
            K[(slice(None),) + a_at] += 0.5 * (A - R)
            K[(slice(None),) + b_at] += 0.5 * (B - R)
            s = R + A + B
            for X, at in ((R, r_at), (A, a_at), (B, b_at)):
                M[(slice(None),) + at] += self.mass_w * (X + s)
        return K, M

    def _boundary(self, u):
        """B u: the boundary mass matrix over the four sides."""
        out = torch.zeros_like(u)
        w = self.edge_w
        for side in ((0, slice(None)), (-1, slice(None)),
                     (slice(None), 0), (slice(None), -1)):
            v = u[(slice(None),) + side]              # (B, N) along the side
            o = out[(slice(None),) + side]
            o[:, :-1] += w * (2 * v[:, :-1] + v[:, 1:])
            o[:, 1:] += w * (v[:, :-1] + 2 * v[:, 1:])
        return out

    def apply(self, ur, ui):
        """S (ur + i ui) as planes (yr, yi)."""
        Kr, Mr = self._stiff_mass(ur)
        Ki, Mi = self._stiff_mass(ui)
        Br, Bi = self._boundary(ur), self._boundary(ui)
        yr = Kr - (self.cr * Mr - self.ci * Mi) + self.eta * Bi
        yi = Ki - (self.cr * Mi + self.ci * Mr) - self.eta * Br
        return yr, yi


def operator(cfg: dict, dtype, device) -> HelmFE:
    """The reference operator of a configuration of the ``helm_fe`` class."""
    return HelmFE(cfg["N"], cfg["k"], cfg["eps"], dtype, device)
