"""Plain reference of the ``parabolic`` class: the parabolic_fem stand-in,
a 7-point FE stencil on an Ng x Ng node grid (report Table I; Tali &
Vainikko, *Block Conjugate Gradient solver in OpenCL*).

Node ``m * Ng + j`` (row m, column j) couples to itself with the
configuration's ``diag`` and to its E, W, N, S, NE and SW neighbours
(``(m, j +- 1)``, ``(m +- 1, j)``, ``(m + 1, j + 1)``, ``(m - 1, j - 1)``)
with -1; a neighbour off the grid is absent.  The operator is applied
matrix-free, by zero padding, to (B, n) blocks in the blocks' own dtype.
It builds nothing the program made: no stencil, no coefficient table.
Plain torch, no kernel of the port.
"""
from __future__ import annotations

import torch

# the six off-diagonal links (row step, column step), each weighted -1
LINKS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1))


class Parabolic:
    """The configuration's operator on (B, n) blocks of one dtype."""

    def __init__(self, Ng: int, diag: float, dtype, device):
        self.Ng = Ng
        self.diag = torch.tensor(diag, dtype=dtype, device=device)

    def apply(self, u):
        """(A u,) for u (B, n)."""
        Ng = self.Ng
        g = u.reshape(u.shape[0], Ng, Ng)
        p = torch.nn.functional.pad(g, (1, 1, 1, 1))
        y = self.diag * g
        for dm, dj in LINKS:
            y = y - p[:, 1 + dm:1 + dm + Ng, 1 + dj:1 + dj + Ng]
        return (y.reshape(u.shape),)


def operator(cfg: dict, dtype, device) -> Parabolic:
    """The reference operator of a configuration of the ``parabolic``
    class."""
    return Parabolic(cfg["Ng"], cfg["diag"], dtype, device)
