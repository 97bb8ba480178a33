"""Plain fixed-iteration COCG on re/im planes, in any real dtype.

The reference solver of the benchmark's comparison: complex symmetric CG
with unconjugated dots (``<u, v> = sum u v``), one alpha and beta per RHS,
x0 = 0, and the guard of the report's solver that freezes a RHS once
``<r, r>`` or ``<d, S d>`` is exactly zero.  The history is
``sqrt|<r, r>|`` before the first iteration and after each.

Run in float64 it is the reference; run in bfloat16 it is the control that
the comparison has to refuse.  Plain torch; nothing of the program.
"""
from __future__ import annotations

import torch


def _udot(ar, ai, br, bi):
    """Unconjugated dot per RHS over the grid: (re, im), shape (B,)."""
    return ((ar * br - ai * bi).sum(dim=(1, 2)),
            (ar * bi + ai * br).sum(dim=(1, 2)))


def _div(nr, ni, dr, di):
    """(nr + i ni) / (dr + i di) by Smith's rule, worked out in float64 and
    rounded back to the planes' dtype: nothing overflows or underflows on
    the way when the dots grow tiny past convergence."""
    dtype = nr.dtype
    nr, ni, dr, di = nr.double(), ni.double(), dr.double(), di.double()
    wide = dr.abs() >= di.abs()
    t = torch.where(wide, di / dr, dr / di)
    den = torch.where(wide, dr + di * t, di + dr * t)
    re = torch.where(wide, nr + ni * t, nr * t + ni) / den
    im = torch.where(wide, ni - nr * t, ni * t - nr) / den
    return re.to(dtype), im.to(dtype)


def _col(v):
    return v[:, None, None]


def cocg(op, br, bi, n_iterations: int):
    """Solve ``S x = b`` from x0 = 0 with ``n_iterations`` of COCG.

    op     : has ``apply(ur, ui) -> (yr, yi)`` on (B, N, N) planes.
    br, bi : (B, N, N) planes of b, in the dtype to compute in.
    Returns ``(xr, xi, history)``, history float64 (n_iterations + 1, B)
    on the planes' device.
    """
    xr, xi = torch.zeros_like(br), torch.zeros_like(bi)
    rr, ri = br.clone(), bi.clone()
    dr, di = rr.clone(), ri.clone()
    deltar, deltai = _udot(rr, ri, rr, ri)
    hist = [torch.sqrt(torch.hypot(deltar, deltai).double())]
    zero = torch.zeros_like(deltar)
    for _ in range(n_iterations):
        qr, qi = op.apply(dr, di)
        dqr, dqi = _udot(dr, di, qr, qi)
        done = ((deltar == 0) & (deltai == 0)) | ((dqr == 0) & (dqi == 0))
        one = torch.where(done, 1, dqr)
        ar, ai = _div(deltar, deltai, one, torch.where(done, 0, dqi))
        ar, ai = torch.where(done, zero, ar), torch.where(done, zero, ai)
        xr = xr + (_col(ar) * dr - _col(ai) * di)
        xi = xi + (_col(ar) * di + _col(ai) * dr)
        rr = rr - (_col(ar) * qr - _col(ai) * qi)
        ri = ri - (_col(ar) * qi + _col(ai) * qr)
        newr, newi = _udot(rr, ri, rr, ri)
        oned = torch.where(done, 1, deltar)
        ber, bei = _div(newr, newi, oned, torch.where(done, 0, deltai))
        ber, bei = torch.where(done, zero, ber), torch.where(done, zero, bei)
        dr, di = (rr + (_col(ber) * dr - _col(bei) * di),
                  ri + (_col(ber) * di + _col(bei) * dr))
        deltar, deltai = newr, newi
        hist.append(torch.sqrt(torch.hypot(deltar, deltai).double()))
    return xr, xi, torch.stack(hist)
