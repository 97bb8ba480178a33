"""Overlap (halo) exchange, the distributed matvec and the unique-dof
reductions (counterpart of ``tpcg/parallel/halo.py``).

* ``ol_update`` == ``OL_update`` (``p_h-PY_C-CL-multi-GPU.py:2183-2497``):
  partition-of-unity overlap-add across up to 8 neighbours, with optional
  Restricted-AS zeroing of the outer ``OL`` ring and contact-line averaging.
* ``ax_op`` == ``Ax_op`` (``p_h-PY_C-CL-multi-GPU.py:2500-2746``): each
  subdomain's stencil matvec, then its outermost ring (width 1)
  overwritten with the neighbour's fully assembled values.
* ``norm`` / ``wdot`` == the unique-dof global reductions
  (``p_h-PY_C-CL-multi-GPU.py:2108-2121, 2845-2892``).

State lives in one ``(M, M, S, S)`` tensor (subdomain row, subdomain col,
local row, local col) on one device.  JAX writes each exchange as
zero-filled shifts of the subdomain grid times 0/1 masks; here the same
masks, built in numpy once, become tables of flat indices, so that an
exchange is a few gathers and scatters whatever M is:

* ``ol_update``: ``y = keep * x``, then three passes of ``y[dst] +=
  x[src]`` (the W/E strips, the S/N strips, the four corner blocks; within
  a pass no point is written twice), then ``y *= avg``.  Every point gets
  its adds in JAX's order (W, E, S, N, SW, NE, NW, SE), so the sums are
  JAX's, rounding included;
* ``ring_overwrite``: one ``y[dst] = y[src]``: no ring point is written
  twice and none is read after it is written.

JAX's two-plane float32 twins (``*_planes``) are left out: the port runs
complex64 natively.  ``ol_update`` and ``ring_overwrite`` (``ax_op``'s)
each record the span ``tpcg.halo`` of ``tpcg_torch.trace``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from .partition import Partition


def _sshift(x: np.ndarray, di: int, dj: int, fill=0) -> np.ndarray:
    """out[si, sj] = x[si + di, sj + dj] over the first two (subdomain-grid)
    axes, ``fill`` outside."""
    out = np.full_like(x, fill)
    M0, M1 = x.shape[:2]
    i0, i1 = max(0, -di), M0 - max(0, di)
    j0, j1 = max(0, -dj), M1 - max(0, dj)
    out[i0:i1, j0:j1] = x[i0 + di:i1 + di, j0 + dj:j1 + dj]
    return out


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """A partition and the static masks and index tables its operators use,
    built once in numpy and kept on each (device, dtype) they are asked
    for."""
    part: Partition

    def __post_init__(self):
        M, S, OL = self.part.M, self.part.sdsz, self.part.OL
        pos = np.arange(M)
        low, high = pos > 0, pos < M - 1     # a W/S and an E/N neighbour

        def restrict(width):
            # (M, S): which local indices of a strip take part, by grid
            # position: the `width` end indices drop where a neighbour lies
            # across them (the reference's strt/endt)
            m = np.ones((M, S), dtype=bool)
            m[low, :width] = False
            m[high, S - width:] = False
            return m

        row_ol, row_1 = restrict(OL), restrict(1)
        hW = low[None, :, None, None]
        hE = high[None, :, None, None]
        hS = low[:, None, None, None]
        hN = high[:, None, None, None]
        rr4 = row_ol[:, None, :, None]       # a W/E strip's rows, by si
        cc4 = row_ol[None, :, None, :]       # a N/S strip's columns, by sj

        # RAS keep-mask (p_h-PY_C-CL-multi-GPU.py:2336-2392): zero the outer
        # OL ring on sides with neighbours; a corner block wherever the
        # diagonal neighbour exists.
        keep = np.ones((M, M, S, S))
        keep[..., :, :OL] *= ~(hW & rr4)
        keep[..., :, S - OL:] *= ~(hE & rr4)
        keep[..., :OL, :] *= ~(hS & cc4)
        keep[..., S - OL:, :] *= ~(hN & cc4)
        keep[..., :OL, :OL] *= ~(hS & hW)
        keep[..., S - OL:, S - OL:] *= ~(hN & hE)
        keep[..., S - OL:, :OL] *= ~(hN & hW)
        keep[..., :OL, S - OL:] *= ~(hS & hE)

        # contact-line averaging (2486-2495): col OL / col S-OL-1 / row OL /
        # row S-OL-1 halved where that neighbour exists; corners get 1/4
        f = np.ones((M, S))
        f[low, OL] *= 0.5
        f[high, S - OL - 1] *= 0.5
        avg = f[:, None, :, None] * f[None, :, None, :]

        idx = np.arange(M * M * S * S).reshape(M, M, S, S)

        def table(moves):
            """(dst, src) flat indices of moves (at, mask, di, dj, src):
            point ``at`` of a subdomain takes point ``src`` of its neighbour
            (si + di, sj + dj) where ``mask`` is set."""
            dst, src = [], []
            for at, mask, di, dj, frm in moves:
                d = idx[(Ellipsis,) + at]
                s = _sshift(idx[(Ellipsis,) + frm], di, dj, fill=-1)
                on = np.broadcast_to(mask, d.shape)
                dst.append(d[on])
                src.append(s[on])
            dst, src = np.concatenate(dst), np.concatenate(src)
            assert len(np.unique(dst)) == len(dst) and (src >= 0).all()
            return np.stack([dst, src])

        # ol_update: a neighbour's inner strip (lo: its W/S side, hi: its
        # E/N side) is added to the own outer strip (a: W/S side, b: E/N)
        lo, hi = slice(OL, 2 * OL + 1), slice(S - 2 * OL - 1, S - OL)
        a, b, al = slice(0, OL + 1), slice(S - OL - 1, S), slice(None)
        passes = (
            (((al, a), hW & rr4, 0, -1, (al, hi)),           # W
             ((al, b), hE & rr4, 0, 1, (al, lo))),           # E
            (((a, al), hS & cc4, -1, 0, (hi, al)),           # S
             ((b, al), hN & cc4, 1, 0, (lo, al))),           # N
            (((a, a), hS & hW, -1, -1, (hi, hi)),            # SW
             ((b, b), hN & hE, 1, 1, (lo, lo)),              # NE
             ((b, a), hN & hW, 1, -1, (lo, hi)),             # NW
             ((a, b), hS & hE, -1, 1, (hi, lo))))            # SE
        # ring_overwrite: the ring adopts the neighbour's column/row `inner`
        # (W, S sides) or 2*OL (E, N sides); corners the diagonal one's
        inner = S - 2 * OL - 1
        rows1, cols1 = row_1[:, None, :], row_1[None, :, :]
        ring = (((al, 0), hW[..., 0] & rows1, 0, -1, (al, inner)),
                ((al, S - 1), hE[..., 0] & rows1, 0, 1, (al, 2 * OL)),
                ((0, al), hS[..., 0] & cols1, -1, 0, (inner, al)),
                ((S - 1, al), hN[..., 0] & cols1, 1, 0, (2 * OL, al)),
                ((0, 0), (hS & hW)[..., 0, 0], -1, -1, (inner, inner)),
                ((S - 1, S - 1), (hN & hE)[..., 0, 0], 1, 1,
                 (2 * OL, 2 * OL)),
                ((S - 1, 0), (hN & hW)[..., 0, 0], 1, -1, (2 * OL, inner)),
                ((0, S - 1), (hS & hE)[..., 0, 0], -1, 1, (inner, 2 * OL)))
        object.__setattr__(self, "_np", {
            "keep": keep, "avg": avg,
            "unique": self.part.unique_mask.reshape(M, M, S, S)})
        ring = table(ring)
        assert not np.isin(ring[1], ring[0]).any()
        object.__setattr__(self, "_tables", {
            "ol": [table(p) for p in passes], "ring": ring})
        object.__setattr__(self, "_cache", {})

    def _on(self, like: torch.Tensor) -> dict:
        """The masks as tensors of ``like``'s real dtype and the index
        tables, on its device."""
        rdt = like.real.dtype if like.is_complex() else like.dtype
        key = (like.device, rdt)
        got = self._cache.get(key)
        if got is None:
            got = {k: torch.from_numpy(v).to(like.device, rdt)
                   for k, v in self._np.items()}
            got["ol"] = [torch.from_numpy(t).to(like.device)
                         for t in self._tables["ol"]]
            got["ring"] = torch.from_numpy(self._tables["ring"]).to(
                like.device)
            self._cache[key] = got
        return got

    @property
    def grid_shape(self) -> Tuple[int, int, int, int]:
        M, S = self.part.M, self.part.sdsz
        return (M, M, S, S)

    # ------------------------------------------------------------------
    def ol_update(self, x: torch.Tensor, restricted: bool = True,
                  averaging: bool = True) -> torch.Tensor:
        """Overlap exchange of x (M, M, S, S): add each neighbour's inner
        (OL+1)-wide strip into the matching outer strip; first RAS-zero the
        own outer OL ring (``restricted``), last average the contact lines
        (``averaging``).  Defaults: the reference's ``Restricted_AS=True``,
        ``Averaging=1``.  Returns a new tensor."""
        t = self._on(x)
        with trace.span("halo"):
            xf = x.reshape(-1)
            y = x * t["keep"] if restricted else x.clone()
            yf = y.view(-1)
            for dst, src in t["ol"]:
                yf[dst] += xf[src]
            if averaging:
                y = y * t["avg"]
        return y

    # ------------------------------------------------------------------
    @staticmethod
    def apply_stencil_raw(coef: torch.Tensor, offsets,
                          x: torch.Tensor) -> torch.Tensor:
        """Each subdomain's stencil apply, *without* the boundary-ring fix-up
        (the outermost ring lacks its out-of-box neighbour terms).
        coef (noff, ..., S, S), x (..., S, S): x is zero-padded once and
        each tap reads a shifted view of it."""
        P = max(max(abs(dm), abs(dj)) for dm, dj in offsets)
        nv, nh = x.shape[-2:]
        xp = F.pad(x, (P, P, P, P))

        def tap(dm, dj):
            return xp[..., P + dm:P + dm + nv, P + dj:P + dj + nh]
        y = coef[0] * tap(*offsets[0])
        for s in range(1, len(offsets)):
            y = y + coef[s] * tap(*offsets[s])
        return y

    def ax_op(self, coef: torch.Tensor, offsets,
              x: torch.Tensor) -> torch.Tensor:
        """Distributed matvec of the global operator: coef (noff, M, M, S,
        S) is the global assembly cropped to each box (the reference's
        per-subdomain ``A[p][2]``); the outermost ring of the local apply
        is overwritten with the neighbours' values, as ``Ax_op`` does."""
        return self._ring_overwrite(self.apply_stencil_raw(coef, offsets, x))

    def ring_overwrite(self, y: torch.Tensor) -> torch.Tensor:
        """Overwrite each subdomain's outermost ring with the neighbours'
        fully assembled values (``Ax_op``'s receive phase,
        ``p_h-PY_C-CL-multi-GPU.py:2663-2744``).  Returns a new tensor."""
        return self._ring_overwrite(y.clone())

    def _ring_overwrite(self, y: torch.Tensor) -> torch.Tensor:
        """:meth:`ring_overwrite` in place on a contiguous y."""
        dst, src = self._on(y)["ring"]
        with trace.span("halo"):
            yf = y.view(-1)
            yf[dst] = yf[src]
        return y

    # ------------------------------------------------------------------
    def norm(self, z: torch.Tensor) -> torch.Tensor:
        """Global 2-norm over unique dofs (conjugated), == ``norm`` with
        its allreduce (``p_h-PY_C-CL-multi-GPU.py:2108-2121``); a 0-d real
        tensor on z's device."""
        u = self._on(z)["unique"]
        if z.is_complex():
            z = torch.view_as_real(z)
            return torch.sqrt(torch.sum((z[..., 0] * z[..., 0]
                                         + z[..., 1] * z[..., 1]) * u))
        return torch.sqrt(torch.sum(z * z * u))

    def wdot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Hermitian inner product over unique dofs (conj(x).y), == ``wdot``
        with its allreduce (``p_h-PY_C-CL-multi-GPU.py:2845-2892``).
        Batched over the leading axes of x: x (..., M, M, S, S)."""
        u = self._on(y)["unique"]
        n = u.numel()
        lead = x.shape[:-4]
        return torch.matmul(x.reshape(lead + (n,)).conj(),
                            (y * u).reshape(n))

    # ------------------------------------------------------------------
    def crop_stencil(self, coef_global: np.ndarray) -> np.ndarray:
        """Global stencil coefficients (noff, N, N) -> each box's
        (noff, M, M, S, S)."""
        st = np.stack([self.part.to_stacked(c) for c in coef_global])
        return st.reshape((len(coef_global),) + self.grid_shape)

    def crop_grid(self, g: np.ndarray) -> np.ndarray:
        """Global (N, N) field -> (M, M, S, S) stacked boxes."""
        return self.part.to_stacked(g).reshape(self.grid_shape)

    def to_global(self, x) -> np.ndarray:
        """(M, M, S, S) stacked boxes (numpy or a tensor) -> global (N, N)
        numpy grid."""
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        S = self.part.sdsz
        flat = np.asarray(x).reshape(self.part.nsubd, S, S)
        return self.part.to_global(flat)
