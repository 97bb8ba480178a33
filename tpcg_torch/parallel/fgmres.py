"""Flexible GMRES, right-preconditioned: the Krylov solver of the ORAS stack
(counterpart of ``tpcg/parallel/fgmres.py``).

== ``zpgmres`` (``p_h-PY_C-CL-multi-GPU.py:2837-3034``), the reference's
default Krylov method (``GMRES_VER='fgmres'``, ``:3541``): one Arnoldi step
an iteration with classical Gram-Schmidt done twice (CGS2), the Givens
rotations of the Hessenberg matrix on the host, the preconditioned basis
kept for the flexible update, and the unique-dof Hermitian ``wdot`` /
``norm`` for every reduction.  The reference's outer restart loop never
runs twice (the inner loop returns at ``kk == krylsize-1``, ``:3026-3031``),
so one cycle is its behaviour.

The bases and every vector operation stay on the vectors' device; the host
takes each iteration's Hessenberg column and subdiagonal (one copy, after
one wait) and runs the rotations in complex128, as the reference's ranks
do.  The bases are buffers that double when full, so a solve of k steps
holds k + 1 vectors of each, not ``krylsize``.  JAX's fused multi-step
chunks (``chunk > 1``) are a TPU latency device and are not ported.

``n_steps`` runs exactly that many Arnoldi steps (at most ``krylsize``)
with no early exit: the fixed-iteration protocol of the report applied to
the outer loop.

Spans and counters (``tpcg_torch.trace``): ``tpcg.arnoldi`` around each
step after the preconditioner (the matvec, CGS2, the basis update, the
column's trip to the host and the Givens step), and ``fgmres.iterations``,
one an Arnoldi step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import trace
from ..device import download, wait


@dataclasses.dataclass
class FGMRESResult:
    x: torch.Tensor
    iterations: int
    residual_norms: List[float]
    converged: bool


def _givens(h_diag: complex, h_sub: float):
    """The Givens rotation eliminating ``h_sub`` under ``h_diag``
    (``p_h-PY_C-CL-multi-GPU.py:3004-3015``)."""
    dotp = np.sqrt(abs(h_diag) ** 2 + abs(h_sub) ** 2)
    if abs(h_diag) != 0.0:
        g2 = h_sub * abs(h_diag) / (h_diag * dotp)
        g1 = abs(h_diag) / dotp
    elif abs(h_sub) != 0.0:
        g1 = 0.0
        g2 = h_sub / abs(h_sub)
    else:
        g1, g2 = 1.0, 0.0j
    return g1, g2


def _lincomb(c: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """sum_i c_i V_i over the leading axis of V."""
    return torch.tensordot(c.to(V.dtype), V, dims=1)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` in host memory, after the host waits for the card."""
    wait(t.device)
    return download(t)


class _Basis:
    """Rows of a Krylov basis in one buffer that doubles when it is full, up
    to ``cap`` rows."""

    def __init__(self, like: torch.Tensor, rows: int, cap: int):
        self.cap = cap
        self.buf = like.new_empty((min(rows, cap),) + like.shape)

    def set(self, i: int, v: torch.Tensor):
        if i == len(self.buf):
            grown = self.buf.new_empty((min(2 * i, self.cap),)
                                       + self.buf.shape[1:])
            grown[:i] = self.buf
            self.buf = grown
        self.buf[i] = v

    def rows(self, m: int) -> torch.Tensor:
        return self.buf[:m]


def fgmres(matvec: Callable, b: torch.Tensor, M: Optional[Callable] = None,
           x0: Optional[torch.Tensor] = None, tol: float = 1e-6,
           krylsize: int = 100, norm: Optional[Callable] = None,
           wdot: Optional[Callable] = None, n_steps: Optional[int] = None,
           callback: Optional[Callable] = None) -> FGMRESResult:
    """Solve ``A x = b`` with one FGMRES cycle of up to ``krylsize`` steps.

    matvec, M : the operator and the (flexible) preconditioner on tensors of
        b's shape ((M, M, S, S) fields in the ORAS layer).
    norm(v) -> 0-d real tensor, wdot(V, v) -> the Hermitian dots of the rows
        of V with v.  Defaults: dense complex reductions.
    tol : relative to ||r0|| (``:2938-2939``); ignored with ``n_steps``.
    n_steps : run exactly this many steps (capped at ``krylsize``).
    callback(res) : called with each residual estimate.
    """
    if norm is None:
        def norm(v):
            return torch.linalg.vector_norm(v)
    if wdot is None:
        def wdot(V, v):
            return torch.matmul(V.reshape(len(V), -1).conj(), v.reshape(-1))
    if M is None:
        def M(z):
            return z

    K = krylsize if n_steps is None else min(n_steps, krylsize)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b if x0 is None else b - matvec(x)
    beta = float(_to_host(norm(r)))
    residual_norms = [beta]
    if beta == 0.0 or K == 0:
        return FGMRESResult(x, 0, residual_norms, beta == 0.0)
    atol = tol * beta

    V = _Basis(r, K + 1 if n_steps is not None else 32, K + 1)
    Z = _Basis(r, K if n_steps is not None else 32, K)
    V.set(0, r / beta)
    H = np.zeros((K + 1, K), dtype=np.complex128)
    giv1 = np.zeros(K, dtype=np.float64)
    giv2 = np.zeros(K, dtype=np.complex128)
    s = np.zeros(K + 1, dtype=np.complex128)
    s[0] = beta

    def host_update(kk, hcol, h_sub):
        """Givens bookkeeping for one new column; returns the residual
        estimate."""
        H[: kk + 1, kk] = hcol
        # apply the previous rotations to the new column (:2999-3003)
        for i in range(kk):
            t = H[i, kk]
            H[i, kk] = giv1[i] * t + np.conj(giv2[i]) * H[i + 1, kk]
            H[i + 1, kk] = giv1[i] * H[i + 1, kk] - giv2[i] * t
        g1, g2 = _givens(H[kk, kk], h_sub)
        giv1[kk], giv2[kk] = g1, g2
        H[kk, kk] = g1 * H[kk, kk] + np.conj(g2) * h_sub
        s[kk + 1] = -g2 * s[kk]
        s[kk] = g1 * s[kk]
        res = abs(s[kk + 1])
        residual_norms.append(res)
        if callback is not None:
            callback(res)
        return res

    for kk in range(K):
        v = M(V.buf[kk])
        with trace.span("arnoldi"):
            trace.count("fgmres.iterations")
            Z.set(kk, v)
            pp = matvec(v)
            # two-pass classical Gram-Schmidt against the basis (:2977-2984)
            Vk = V.rows(kk + 1)
            d1 = wdot(Vk, pp)
            pp = pp - _lincomb(d1, Vk)
            d2 = wdot(Vk, pp)
            pp = pp - _lincomb(d2, Vk)
            h_sub = norm(pp)
            # happy breakdown: exact convergence inside the step gives
            # h_sub == 0; keep the (zero) basis vector finite instead of NaN
            # (the reference shares this flaw, :2987; JAX's fix)
            safe = torch.where(h_sub == 0, torch.ones_like(h_sub), h_sub)
            V.set(kk + 1, pp / safe.to(pp.dtype))
            col = _to_host(torch.cat([d1 + d2, h_sub.to(d1.dtype)[None]]))
            col = col.astype(np.complex128)
            res = host_update(kk, col[:-1], float(col[-1].real))
        if n_steps is None and res < atol:
            break
    converged = res < atol

    # back substitution H y = s on the rotated triangular system, with the
    # reference's underflow guard (``zsolupcont``, :2766-2834), then the
    # flexible update x += sum_i y_i Z[i]
    m = kk + 1
    y = np.zeros(m, dtype=np.complex128)
    for j in range(m - 1, -1, -1):
        acc = s[j] - np.dot(H[j, j + 1:m], y[j + 1:m])
        y[j] = 0.0 if abs(acc) < abs(H[j, j]) * 1e-16 else acc / H[j, j]
    x = x + _lincomb(torch.from_numpy(y).to(b.device), Z.rows(m))
    return FGMRESResult(x, m, residual_norms, converged)
