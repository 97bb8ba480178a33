"""Block conjugate-gradient solver in plain PyTorch (counterpart of ``tpcg/cg.py``).

The fixed-iteration loop is a Python loop over tensor operations with no
host synchronisation inside it: on a CUDA device every iteration only
enqueues work, and the host waits once, when the caller reads the result.
Any dtype works, complex128 included.

Numerics match ``tpcg.cg`` and the NumPy oracle ``tpcg_torch.reference``:
unconjugated (COCG) dots, one alpha/beta per RHS column, and the freeze
guard that stops an exactly converged column instead of producing NaNs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


def udot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unconjugated inner product over axis 0 (COCG bilinear form).

    Matches ``kernel/complex/vdot.cl:15`` (``cmul`` without conjugation).
    """
    return torch.sum(a * b, dim=0)


class CGResult(NamedTuple):
    x: torch.Tensor                 # solution, same shape as b
    residual_history: torch.Tensor  # (n_iterations + 1, nrhs) sqrt|<r,r>|
    delta: torch.Tensor             # final <r, r> per RHS


def _as_matvec(A) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(A) and not hasattr(A, "matvec"):
        return A
    return A.matvec


def block_cg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             n_iterations: int = 10, dot: Callable = udot) -> CGResult:
    """Fixed-iteration block CG: ``nrhs`` independent CG recurrences sharing
    one SpMV per iteration (``tpcg.cg.block_cg``, ``clcg.c:297``).

    A  : a container from ``tpcg_torch.sparse`` or a matvec callable mapping
         (n, nrhs) -> (n, nrhs).
    b  : (n,) or (n, nrhs).
    x0 : initial guess, defaults to zeros.
    dot: inner product over axis 0; default unconjugated (COCG).
    """
    matvec = _as_matvec(A)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    d = r
    delta = dot(r, r)
    history = [torch.sqrt(torch.abs(delta))]
    for _ in range(n_iterations):
        q = matvec(d)
        dq = dot(d, q)
        # Guard exact convergence: once <r,r> (or <d,q>, after d underflows)
        # is exactly 0, alpha and beta would be 0/0; freeze the column
        # instead (the deliberate fix over clcg.c:317 that tpcg.cg keeps).
        done = (delta == 0) | (dq == 0)
        alpha = torch.where(done, 0, delta / torch.where(done, 1, dq))
        x = x + alpha * d
        r = r - alpha * q
        delta_new = dot(r, r)
        beta = torch.where(done, 0, delta_new / torch.where(done, 1, delta))
        d = r + beta * d
        delta = delta_new
        history.append(torch.sqrt(torch.abs(delta)))
    return CGResult(x=x, residual_history=torch.stack(history), delta=delta)


def cg_solve(A, b, x0=None, tol=1e-5, maxit=1000, M=None,
             dot: Callable = udot):
    """CG with preconditioning and early exit (``tpcg.cg.cg_solve``, the
    analogue of ``PCG`` in ``helmFE_var.py:546-586``).

    Returns ``(x, iterations)``.  Stops when ``sqrt|<r,r>|`` (max over RHS)
    drops below ``tol`` or after ``maxit`` iterations.  The stop test reads
    the residual norm on the host once per iteration, where JAX keeps the
    test inside ``lax.while_loop``.
    M : optional preconditioner matvec/callable (applied as z = M(r)).
    """
    matvec = _as_matvec(A)
    prec = (lambda r: r) if M is None else _as_matvec(M)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = torch.zeros_like(r)
    rho_prev = torch.ones(r.shape[1:], dtype=r.dtype, device=r.device)
    i = 0
    while i < maxit:
        z = prec(r)
        rho = dot(r, z)
        beta = (torch.zeros_like(rho) if i == 0 else
                torch.where(rho_prev == 0, 0,
                            rho / torch.where(rho_prev == 0, 1, rho_prev)))
        p = z + beta * p
        q = matvec(p)
        pq = dot(p, q)
        # breakdown / already-converged guard (as block_cg): a zero RHS
        # column must freeze, not NaN-poison every column
        done = (rho == 0) | (pq == 0)
        alpha = torch.where(done, 0, rho / torch.where(done, 1, pq))
        x = x + alpha * p
        r = r - alpha * q
        rho_prev = rho
        i += 1
        if float(torch.max(torch.sqrt(torch.abs(dot(r, r))))) < tol:
            break
    return x, i
