"""The comparison that decides ``correct``.

The answers a run keeps (a sample of its requests drawn from the seed) are
held against the plain reference of the configuration's problem class
(``reference/<problem>.py``: COCG on re/im planes for complex classes, CG
for real ones), in float64, once the program's state is freed, over blocks
of RHS.  The numbers, each against the limit that ``limits/<cell>.json``
gives it (a cell compares those its limits name):

* ``missing_iterations``: how far the program's residual history is from
  ``n_iterations + 1`` rows: a solve that ran fewer iterations than asked
  (limit 0);
* ``hist_gap``: the widest relative gap between the program's residual
  history ``sqrt|<r, r>|`` and the reference's over the first
  ``hist_iterations`` iterations (assembly, RHS, operator and the
  solver's first steps);
* ``resid_gap``: the gap between the program's last history entry and
  ``sqrt|<r, r>|`` of the true residual ``r = b - S x`` of the x it
  returned, over ``|b| + |S x|``: x as returned is the x whose residual
  the solver reports;
* ``rel_residual``: the widest ``|b - S x| / |b|``, and
  ``rel_residual_median`` the median over the checked RHS;
* ``x_gap``: the widest ``max|x - x_ref| / max|x_ref|`` after every
  iteration.

A number that is not finite fails.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from bench_torch.reference.cg import cg
from bench_torch.reference.cocg import cocg

NUMBERS = ("missing_iterations", "hist_gap", "resid_gap", "rel_residual",
           "rel_residual_median", "x_gap")


def _worst(a: float, b: float) -> float:
    """The larger of two readings; NaN if either is NaN."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def reference_op(cell, dtype, device):
    ref = importlib.import_module(f"bench_torch.reference.{cell.problem}")
    return ref.operator(cell.config, dtype, device)


def planes(z, device, dtype=torch.float64):
    """(B, ...) numpy, complex or real -> a tuple of re/im planes, or of
    the one real plane, as ``dtype`` on ``device``."""
    if np.iscomplexobj(z):
        t = torch.from_numpy(np.ascontiguousarray(z, dtype=np.complex128))
        return t.real.to(device, dtype), t.imag.to(device, dtype)
    return (torch.from_numpy(np.ascontiguousarray(z, np.float64)).to(
        device, dtype),)


def solve(op, bp, n_iterations):
    """The reference solve of planes ``bp``: ``(x planes, history)``."""
    if len(bp) == 2:
        xr, xi, h = cocg(op, *bp, n_iterations)
        return (xr, xi), h
    x, h = cg(op, bp[0], n_iterations)
    return (x,), h


def _sum(t):
    return t.sum(dim=tuple(range(1, t.dim())))


def _modulus(p):
    return torch.sqrt(sum(c * c for c in p))


def _norm(p):
    return torch.sqrt(_sum(sum(c * c for c in p)))


def _self_udot(p):
    """``|<r, r>|`` unconjugated, per RHS."""
    if len(p) == 1:
        return _sum(p[0] * p[0]).abs()
    rr, ri = p
    return torch.hypot(_sum(rr * rr - ri * ri), _sum(2 * rr * ri))


def readings(cell, b, x, hist, device, block: int = 16, want=None,
             hist_ks=()):
    """The numbers of one set of answers.

    b    : (B, ...) the RHS as the program was given them;
    x    : (B, ...) the program's answers;
    hist : (rows, B), the program's residual histories.
    want : the names to read (default: those the cell's limits name);
    hist_ks : further spans at which to read ``hist_gap`` too, as
              ``hist_gap@K`` (for setting the limits).
    Returns ``(numbers, rel_residuals)``.
    """
    want = list(cell.limits["limits"] if want is None else want)
    its = cell.config["n_iterations"]
    K = cell.limits["hist_iterations"]
    ks = sorted({K, *hist_ks})
    iters = its if "x_gap" in want else ks[-1]
    op = reference_op(cell, torch.float64, device)
    got = dict.fromkeys(["resid_gap", "rel_residual", "x_gap"], 0.0)
    got["missing_iterations"] = float(abs(hist.shape[0] - (its + 1)))
    at = dict.fromkeys(ks, 0.0)
    rel = []
    for s in range(0, len(b), block):
        hp = torch.from_numpy(np.asarray(hist[:, s:s + block], np.float64))
        bp = planes(b[s:s + block], device)
        xref, hr = solve(op, bp, iters)
        span = min(ks[-1] + 1, hp.shape[0])
        hr = hr.cpu()[:span]
        gap = (hp[:span] - hr).abs() / hr
        for k in ks:
            at[k] = _worst(at[k], float(gap[:k + 1].max()))
        xp = planes(x[s:s + block], device)
        sx = op.apply(*xp)
        res = tuple(u - v for u, v in zip(bp, sx))
        true_h = torch.sqrt(_self_udot(res))
        scale = _norm(bp) + _norm(sx)
        resid = ((true_h.cpu() - hp[-1]).abs() / scale.cpu()).max()
        got["resid_gap"] = _worst(got["resid_gap"], float(resid))
        r = (_norm(res) / _norm(bp)).cpu()
        rel += r.tolist()
        got["rel_residual"] = _worst(got["rel_residual"], float(r.max()))
        if "x_gap" in want:
            dx = _modulus(tuple(u - v for u, v in zip(xp, xref)))
            top = _modulus(xref)
            gap_x = (dx.amax(dim=tuple(range(1, dx.dim())))
                     / top.amax(dim=tuple(range(1, top.dim()))))
            got["x_gap"] = _worst(got["x_gap"], float(gap_x.max()))
        del xref, xp, sx, res
    got["rel_residual_median"] = float(np.median(rel))
    got["hist_gap"] = at[K]
    out = {k: got[k] for k in NUMBERS if k in want}
    out.update({f"hist_gap@{k}": at[k] for k in hist_ks})
    return out, rel


def judge(cell, numbers: dict) -> tuple[bool, dict]:
    """``(ok, {name: {"value", "limit"}})``: each number within its limit,
    and finite."""
    out, ok = {}, True
    for name, limit in cell.limits["limits"].items():
        value = numbers[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
