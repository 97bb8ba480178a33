"""NumPy reference solvers -- the correctness oracles.

The PyTorch port's own copy of ``tpcg/reference.py``, so that the port
stands alone without importing the JAX package.

The reference repo validates its GPU solvers by cross-checking against plain
NumPy implementations (``helmFE_var.py:507-586``, the big scripts' ``CG`` at
``p_h-PY_C-CL-multi-GPU.py:1333-1364``) and exact sparse solves
(``as_prec`` UseCG=0, ``p_h-PY_C-CL-multi-GPU.py:2001``).  We keep the same
oracles, with the same numerics:

* The inner product is **unconjugated** (``dot(r, r)``, not ``vdot``):
  for the complex-symmetric Helmholtz matrices this is the COCG method, and
  it is what every kernel in the reference computes
  (``kernel/complex/vdot.cl:15`` uses ``cmul`` without conjugation).
  Using the Hermitian product instead changes every residual history.
* ``cg`` runs a **fixed** number of iterations with no convergence test,
  like the device solver (``clcg.c:297``).
* ``cg_early_exit`` is the big-script variant that stops on
  ``sqrt(|dot(r, r)|) < tol`` (``p_h-PY_C-CL-multi-GPU.py:1358-1362``).
"""
from __future__ import annotations

import numpy as np


def udot(a, b):
    """Unconjugated inner product over the leading axis (COCG bilinear form).

    a, b: (n,) or (n, nrhs) -> scalar or (nrhs,).
    """
    return np.sum(a * b, axis=0)


def cg(A, b, x=None, n_iterations=10, record_history=False):
    """Fixed-iteration (block) conjugate gradients, unconjugated dots.

    Semantics of ``clcg.c:111-466`` / ``helmFE_var.py:507-544``: each RHS
    column runs an independent CG recurrence (its own alpha/beta), sharing
    only the SpMV; there is no convergence test.

    A : anything with ``@`` / ``.dot`` (scipy sparse, ndarray, our containers)
    b : (n,) or (n, nrhs)
    """
    b = np.asarray(b)
    if x is None:
        x = np.zeros_like(b)
    else:
        x = np.array(x, dtype=b.dtype, copy=True)
    r = b - A @ x
    d = r.copy()
    delta = udot(r, r)
    history = [np.sqrt(np.abs(delta))]
    for _ in range(n_iterations):
        q = A @ d
        alpha = delta / udot(d, q)
        x = x + alpha * d
        r = r - alpha * q
        delta_old = delta
        delta = udot(r, r)
        beta = delta / delta_old
        d = r + beta * d
        history.append(np.sqrt(np.abs(delta)))
    if record_history:
        return x, np.array(history)
    return x


def cg_early_exit(A, b, x=None, tol=1e-5, maxit=1000):
    """CG with residual-norm early exit, matching the big scripts' NumPy CG
    (``p_h-PY_C-CL-multi-GPU.py:1333-1364``): note it tests *after* the
    update, and the first iteration always runs."""
    b = np.asarray(b)
    if x is None:
        x = np.zeros_like(b)
    else:
        x = np.array(x, dtype=b.dtype, copy=True)
    r = b - A @ x
    rho_prev = None
    p = None
    for i in range(maxit):
        z = r
        rho = udot(r, z)
        if i == 0:
            p = z.copy()
        else:
            p = z + (rho / rho_prev) * p
        q = A @ p
        alpha = rho / udot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        if np.sqrt(np.abs(udot(r, r))) < tol:
            break
        rho_prev = rho
    return x


def pcg(A, b, M=None, x=None, tol=1e-6, maxit=1000, verbose=False):
    """Preconditioned CG (``helmFE_var.py:546-586``).

    M may be None, a scipy sparse matrix (spsolve if it has off-diagonal
    content, else matvec), a float (inner-CG tolerance), or a callable.
    """
    import scipy.sparse
    import scipy.sparse.linalg

    b = np.asarray(b)
    if x is None:
        x = np.zeros_like(b)
    else:
        x = np.array(x, dtype=b.dtype, copy=True)
    r = b - A @ x
    rho_prev = None
    p = None
    i = 0
    for i in range(maxit):
        if M is None:
            z = r
        elif scipy.sparse.issparse(M):
            if M.nnz > M.shape[0]:
                z = scipy.sparse.linalg.spsolve(scipy.sparse.csr_matrix(M), r)
            else:
                z = M @ r
        elif isinstance(M, float):
            z = cg_early_exit(A, r, tol=M)
        else:
            z = M(r)
        rho = udot(r, z)
        if i == 0:
            p = np.array(z, copy=True)
        else:
            p = z + (rho / rho_prev) * p
        q = A @ p
        alpha = rho / udot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        res2norm = np.sqrt(np.abs(udot(r, r)))
        if verbose:
            print(i, res2norm)
        if res2norm < tol:
            break
        rho_prev = rho
    return x, i


def gauss_seidel(A, b, maxit=1000, sweeps="forward", verbose=False):
    """(Symmetric) Gauss-Seidel sweeps on a sparse matrix.

    Replaces ``GaussSeidel``/``SymmGaussSeidel`` (``helmFE_var.py:391-505``)
    -- same iteration (initial x = b, row sweeps with diagonal scaling),
    implemented via scipy triangular solves instead of a Python nnz loop.

    sweeps: "forward" or "symmetric" (forward then backward per iteration).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = sp.csr_matrix(A)
    L = sp.tril(A, k=0, format="csr")           # D + strictly-lower
    U = sp.triu(A, k=1, format="csr")           # strictly-upper
    Uu = sp.triu(A, k=0, format="csr")          # D + strictly-upper
    Ll = sp.tril(A, k=-1, format="csr")         # strictly-lower
    x = np.array(b, copy=True)
    for t in range(maxit):
        x = spla.spsolve_triangular(L, b - U @ x, lower=True)
        if sweeps == "symmetric":
            x = spla.spsolve_triangular(Uu, b - Ll @ x, lower=False)
        if verbose:
            print(t, ":", np.max(np.abs(A @ x - b)))
    return x
