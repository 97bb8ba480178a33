"""Equal-size partition of the 2-D grid (counterpart of
``tpcg/parallel/partition.py``).

The reference's subdomain tables (``SubDomain``/``DomainProc``/``GLOBALS``,
built by ``create_eqsize_subdomain_indeces``,
``p_h-PY_C-CL-multi-GPU.py:1744-1805``) as one static description: every
subdomain's box, its unique ("owned") region and the mask of it, in numpy.

The global grid is expanded by ``2*OL`` (``HSolver``,
``p_h-PY_C-CL-multi-GPU.py:3397-3402``), so that all ``M x M`` subdomains
are identical ``(short_w + 2*OL + 1)``-point squares: they share one
matrix, and their solves are the RHS of one batched CG (``UseCG == 2``).

The unique-region tables keep the reference's two quirks, which shape
every ``norm``/``wdot`` and so every residual history: the row block
``[short_w, short_w + OL)`` between subdomains 0 and 1 belongs to no one's
unique region, and the last global row and column are owned by no one.
``strict_parity=False`` gives a gapless partition instead.

The variable-size partition (the reference's ``OL < 0`` path,
``make_varsize_partition``) is ROADMAP queue 1 item 12, slice b.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """Static description of an M x M equal-size decomposition."""
    M: int                 # subdomains per side
    N: int                 # expanded global grid points per side
    OL: int                # overlap parameter
    short_w: int           # subdomain width without overlap
    sdsz: int              # subdomain grid points per side (all equal)
    row0: np.ndarray       # (nsubd,) global row of each subdomain's box
    col0: np.ndarray       # (nsubd,) global col
    urow: np.ndarray       # (nsubd, 2) local unique rows [r0, r1)
    ucol: np.ndarray       # (nsubd, 2) local unique cols [c0, c1)
    unique_mask: np.ndarray  # (nsubd, sdsz, sdsz) float64 1/0

    @property
    def nsubd(self):
        return self.M * self.M

    @property
    def n_global(self):
        return self.N * self.N

    def to_stacked(self, g: np.ndarray) -> np.ndarray:
        """Global (N, N) grid -> stacked (nsubd, sdsz, sdsz)."""
        S = self.sdsz
        return np.stack([g[r:r + S, c:c + S]
                         for r, c in zip(self.row0, self.col0)])

    def to_global(self, x: np.ndarray) -> np.ndarray:
        """Stacked (nsubd, sdsz, sdsz) -> global grid, each point from the
        first subdomain that holds it."""
        g = np.zeros((self.N, self.N), dtype=x.dtype)
        filled = np.zeros((self.N, self.N), dtype=bool)
        S = self.sdsz
        for p in range(self.nsubd):
            r, c = self.row0[p], self.col0[p]
            box = (slice(r, r + S), slice(c, c + S))
            g[box] = np.where(filled[box], g[box], x[p])
            filled[box] = True
        return g


def make_partition(M: int, W: int, OL: int,
                   strict_parity: bool = True) -> Partition:
    """The equal-size partition for subdomain width W, M x M subdomains,
    overlap OL: ``N = (W-1)*M + 1`` expanded to ``N + 2*OL``
    (``HSolver``, ``p_h-PY_C-CL-multi-GPU.py:3396-3402``)."""
    N = (W - 1) * M + 1 + 2 * OL
    short_w = (N - 2 * OL - 1) // M
    sdsz = short_w + 2 * OL + 1
    nsubd = M * M
    si, sj = np.divmod(np.arange(nsubd), M)

    def unique(s):
        """[lo, hi) of the unique rows (or cols) at grid position s."""
        if strict_parity:
            lo = np.where(s > 0, OL, 0)
            return lo, lo + short_w + np.where(s == M - 1, OL, 0)
        # gapless: subdomain 0 keeps the leading 2*OL expansion rows, the
        # last one the trailing row
        return (np.where(s == 0, 0, 2 * OL),
                np.where(s == M - 1, sdsz, 2 * OL + short_w))

    urow = np.stack(unique(si), axis=1).astype(np.int64)
    ucol = np.stack(unique(sj), axis=1).astype(np.int64)
    idx = np.arange(sdsz)
    rows = (idx >= urow[:, :1]) & (idx < urow[:, 1:])       # (nsubd, S)
    cols = (idx >= ucol[:, :1]) & (idx < ucol[:, 1:])
    mask = (rows[:, :, None] & cols[:, None, :]).astype(np.float64)
    return Partition(M=M, N=N, OL=OL, short_w=short_w, sdsz=sdsz,
                     row0=(si * short_w).astype(np.int64),
                     col0=(sj * short_w).astype(np.int64),
                     urow=urow, ucol=ucol, unique_mask=mask)
