"""Complex arithmetic as explicit float planes (counterpart of ``tpcg/ops/cplx.py``).

Complex arrays are a leading size-2 axis of real planes, ``p[0] = re`` and
``p[1] = im``, and every complex operation is spelled out in real
arithmetic.  The JAX package chose planes because its TPU backend runs no
complex64; the port keeps the layout at its public functions so that the
tests compare like with like, and because the CUDA kernel
(``tpcg_torch.ops.fused_cg``) takes planes too.

This module is the port's plain oracle: ``block_cg_planes`` over a
``PairOperator`` (a Karatsuba complex SpMV in three real SpMVs) is what the
kernel path is gated against on the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def to_planes(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """complex array -> (2, ...) float planes on ``device`` (default: the
    CUDA device, raising without one)."""
    device = resolve_device(device)
    x = np.asarray(x)
    nd = _NP_DTYPE[dtype]
    return torch.from_numpy(np.stack([x.real.astype(nd),
                                      x.imag.astype(nd)])).to(device)


def from_planes(p) -> np.ndarray:
    """(2, ...) planes (tensor or array) -> complex numpy array."""
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().numpy()
    p = np.asarray(p)
    return p[0] + 1j * p[1]


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2, ...) x (2, ...) elementwise complex multiply (``cmplx.h:18-21``)."""
    return torch.stack([a[0] * b[0] - a[1] * b[1],
                        a[0] * b[1] + a[1] * b[0]])


def cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex division with Smith-style scaling: the naive |b|^2
    denominator underflows once residuals shrink past ~1e-19 in f32, which
    would NaN a long fixed-iteration CG run."""
    m = torch.maximum(torch.abs(b[0]), torch.abs(b[1]))
    ms = torch.where(m == 0, 1.0, m)
    b0, b1 = b[0] / ms, b[1] / ms
    d = (b0 * b0 + b1 * b1) * ms
    return torch.stack([(a[0] * b0 + a[1] * b1) / d,
                        (a[1] * b0 - a[0] * b1) / d])


def cabs(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a[0] * a[0] + a[1] * a[1])


def udot_planes(a: torch.Tensor, b: torch.Tensor, axis=0) -> torch.Tensor:
    """Unconjugated inner product (COCG bilinear form,
    ``kernel/complex/vdot.cl:15``): returns (2, ...reduced...).
    ``axis`` indexes the plane-sliced data array (a[0]), so axis=0 reduces
    the length-n axis of (2, n, nrhs) planes."""
    re = torch.sum(a[0] * b[0] - a[1] * b[1], dim=axis)
    im = torch.sum(a[0] * b[1] + a[1] * b[0], dim=axis)
    return torch.stack([re, im])


@dataclasses.dataclass(frozen=True)
class PairOperator:
    """Complex linear operator A = Ar + i*Ai as two real containers, plus
    the cached Karatsuba operator Ars = Ar + Ai.

    matvec on (2, n[, nrhs]) planes:
        m1 = Ar xr ; m2 = Ai xi ; m3 = Ars (xr + xi)
        y  = (m1 - m2, m3 - m1 - m2)            [3 real SpMVs]
    For a real matrix (Ai == 0) it degrades to 2 independent SpMVs.
    """
    ar: object
    ai: object
    ars: object
    real_only: bool = False

    @property
    def n(self):
        return self.ar.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xr, xi = x[0], x[1]
        if self.real_only:
            return torch.stack([self.ar.matvec(xr), self.ar.matvec(xi)])
        m1 = self.ar.matvec(xr)
        m2 = self.ai.matvec(xi)
        m3 = self.ars.matvec(xr + xi)
        return torch.stack([m1 - m2, m3 - m1 - m2])

    def __matmul__(self, x):
        return self.matvec(x)


def make_pair_operator(A, dtype=torch.float32) -> PairOperator:
    """Split a complex container from ``tpcg_torch.sparse`` (Stencil2D, field
    ``coef``; DiaMatrix, field ``data``) into a PairOperator on the
    container's device.  ``Ar + Ai`` is summed after the cast to ``dtype``,
    as ``tpcg.ops.cplx.make_pair_operator`` does."""
    for field in ("coef", "data"):
        if hasattr(A, field):
            v = getattr(A, field)
            if v.is_complex():
                re, im = v.real.to(dtype), v.imag.to(dtype)
            else:
                re, im = v.to(dtype), torch.zeros_like(v, dtype=dtype)
            real_only = not bool(torch.any(im != 0))
            return PairOperator(dataclasses.replace(A, **{field: re}),
                                dataclasses.replace(A, **{field: im}),
                                dataclasses.replace(A, **{field: re + im}),
                                real_only=real_only)
    raise TypeError(f"unsupported container {type(A)}")


class CGPlanesResult(NamedTuple):
    x: torch.Tensor                 # (2, n, nrhs)
    residual_history: torch.Tensor  # (iters+1, nrhs)
    delta: torch.Tensor             # (2, nrhs)


def block_cg_planes(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                    n_iterations: int = 10) -> CGPlanesResult:
    """Fixed-iteration block CG over complex planes.

    A : PairOperator or callable on (2, n, nrhs) planes.
    b : (2, n) or (2, n, nrhs).
    Identical recurrence to ``tpcg.ops.cplx.block_cg_planes`` (COCG dots,
    independent per-RHS scalars, exact-convergence guard), as a Python loop
    with no host synchronisation inside it.
    """
    matvec = A if callable(A) and not hasattr(A, "matvec") else A.matvec
    squeeze = b.dim() == 2
    if squeeze:
        b = b[..., None]
    if x0 is None:
        x0 = torch.zeros_like(b)
    elif x0.dim() == 2:
        x0 = x0[..., None]
    x = x0
    r = b - matvec(x)
    d = r
    delta = udot_planes(r, r, axis=0)          # (2, nrhs)
    history = [torch.sqrt(cabs(delta))]
    for _ in range(n_iterations):
        q = matvec(d)
        dq = udot_planes(d, q, axis=0)
        # freeze once converged past machine precision: <r,r> == 0, or
        # <d,q> == 0 (d underflowed to zero) -- running a fixed iteration
        # count far past convergence must not NaN the solution.
        done = ((delta[0] == 0) & (delta[1] == 0)) \
            | ((dq[0] == 0) & (dq[1] == 0))
        safe_dq = torch.where(done[None], torch.ones_like(dq), dq)
        alpha = torch.where(done[None], 0.0, cdiv(delta, safe_dq))
        x = x + cmul(alpha[:, None, :], d)
        r = r - cmul(alpha[:, None, :], q)
        delta_new = udot_planes(r, r, axis=0)
        safe_delta = torch.where(done[None], torch.ones_like(delta), delta)
        beta = torch.where(done[None], 0.0, cdiv(delta_new, safe_delta))
        d = r + cmul(beta[:, None, :], d)
        delta = delta_new
        history.append(torch.sqrt(cabs(delta)))
    if squeeze:
        x = x[..., 0]
    return CGPlanesResult(x=x, residual_history=torch.stack(history),
                          delta=delta)


def block_cg_planes_chunked(A, b: torch.Tensor,
                            x0: Optional[torch.Tensor] = None,
                            n_iterations: int = 10,
                            chunk: int = 32) -> CGPlanesResult:
    """Arbitrary-batch :func:`block_cg_planes`: RHS chunks solved one after
    another.  Per-RHS recurrences are independent (``clcg.c:317-333``), so
    chunking changes no result beyond reduction order.  Chunks are balanced
    (``ceil(nrhs/chunk)`` chunks of near-equal size), as in
    ``tpcg.ops.cplx.block_cg_planes_chunked``.
    """
    if b.dim() == 2 or b.shape[-1] <= chunk:
        return block_cg_planes(A, b, x0, n_iterations)
    nrhs = b.shape[-1]
    nc = -(-nrhs // chunk)
    size = -(-nrhs // nc)
    parts = []
    for lo in range(0, nrhs, size):
        hi = min(lo + size, nrhs)
        parts.append(block_cg_planes(
            A, b[..., lo:hi], None if x0 is None else x0[..., lo:hi],
            n_iterations))
    return CGPlanesResult(
        x=torch.cat([p.x for p in parts], dim=-1),
        residual_history=torch.cat([p.residual_history for p in parts], -1),
        delta=torch.cat([p.delta for p in parts], dim=-1))
