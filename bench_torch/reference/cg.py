"""Plain fixed-iteration CG for a real symmetric matrix, in any real dtype.

The reference solver of the real classes: one alpha and beta per RHS,
x0 = 0, and the guard of the report's solver that freezes a RHS once
``<r, r>`` or ``<d, A d>`` is exactly zero.  The history is ``sqrt|<r, r>|``
before the first iteration and after each.  Run in float64 it is the
reference; run in bfloat16 it is the control that the comparison has to
refuse.  Plain torch; nothing of the program.
"""
from __future__ import annotations

import torch


def _dot(a, b):
    return (a * b).sum(dim=tuple(range(1, a.dim())))


def _col(v, like):
    return v.reshape(-1, *([1] * (like.dim() - 1)))


def cg(op, b, n_iterations: int):
    """Solve ``A x = b`` from x0 = 0 with ``n_iterations`` of CG.

    op : has ``apply(u) -> (A u,)`` on (B, ...) blocks.
    b  : (B, ...) in the dtype to compute in.
    Returns ``(x, history)``, history float64 (n_iterations + 1, B) on b's
    device.
    """
    x = torch.zeros_like(b)
    r = b.clone()
    d = r.clone()
    delta = _dot(r, r)
    hist = [delta.abs().double().sqrt()]
    zero = torch.zeros_like(delta)
    for _ in range(n_iterations):
        q, = op.apply(d)
        dq = _dot(d, q)
        done = (delta == 0) | (dq == 0)
        alpha = torch.where(done, zero, delta / torch.where(done, 1, dq))
        x = x + _col(alpha, d) * d
        r = r - _col(alpha, q) * q
        new = _dot(r, r)
        beta = torch.where(done, zero, new / torch.where(done, 1, delta))
        d = r + _col(beta, d) * d
        delta = new
        hist.append(delta.abs().double().sqrt())
    return x, torch.stack(hist)
