"""Drop-in API surface of the reference's C solver (counterpart of ``tpcg/api.py``).

``cg`` mirrors ``clcg::cg`` (``clcg.h:3-5``): CSR arrays in, solution out,
with the reference's column-major multi-RHS packing ``v[i + r*size]``.  The
matrix is converted once into a device container (``to_device_matrix``,
RCM reordering into a band where that helps) on the ``device`` the caller
names, and the whole fixed-iteration loop runs there.

Dispatch keys on the torch device (:func:`_on_card`), not on "not CPU":

* on a CUDA device, float32 / complex64 operands, in the order of
  ``tpcg/api.py:100-116`` and ``:138-145``:
  1. complex ``DiaMatrix`` -> the fused whole-solve kernel
     (``ops.fused_cg_dia``) if its fit rule passes, else the streaming
     complex kernel (``ops.stream_cg_dia``);
  2. real ``DiaMatrix`` -> the streaming real kernel;
  3. everything else (float64 / complex128, a real matrix with a complex
     RHS, ``Stencil2D``) -> eager ``block_cg`` / ``block_cg_planes`` on the
     device, exactly where JAX also takes XLA.
  Unstructured matrices and ``routing=`` raise ``NotImplementedError``:
  JAX sends them to its routing-network SpMV, which the port has not
  ported yet (ROADMAP queue 1 item 13).
* on the CPU, what JAX computes on the CPU: eager ``block_cg`` on the
  DIA / ELL container in the operands' dtype.

On a CUDA device no path runs on the CPU or on a kernel's plain version; a
kernel that cannot run raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .cg import block_cg
from .ops import fused_cg_dia as _fd
from .ops import stream_cg_dia as _sd
from .ops.cplx import block_cg_planes_chunked, make_pair_operator
from .sparse import DiaMatrix, EllMatrix, to_device_matrix

_ROUTING = ("routing tables (routing=) drive JAX's routing-network SpMV, "
            "which tpcg_torch has not ported yet: ROADMAP queue 1 item 13 "
            "(queue 2 item 22)")


def _on_card(device) -> bool:
    """The one device predicate of the dispatch: True on a CUDA device."""
    return torch.device(device).type == "cuda"


def _refuse_unstructured(A):
    if isinstance(A, EllMatrix):
        raise NotImplementedError(
            f"unstructured {A.n}x{A.n} matrix on a CUDA device: JAX routes "
            "it through its routing-network SpMV, which tpcg_torch has not "
            "ported yet: ROADMAP queue 1 item 13 (queue 2 item 22)")


def _tensor(M, dev, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(M)).to(dev, dtype)


def _solve_planes(A, B, X0, n_iterations, device):
    """Complex solve on the card: ``B``/``X0`` complex numpy (n, nrhs).
    Returns numpy ``(X, history)`` with X in B's dtype."""
    dtype = np.asarray(B).dtype
    if (dtype == np.complex64 and isinstance(A, DiaMatrix)
            and A.data.is_complex()):
        if _fd.fused_dia_cplx_fits(A):
            X, history = _fd.fused_cg_dia_cplx_block(A, B, X0, n_iterations)
            return X.cpu().numpy(), history.cpu().numpy()
        if _sd.dia_stream_cplx_fits(A):
            X, history = _sd.stream_cg_dia_cplx_block(A, B, X0, n_iterations)
            return X.cpu().numpy(), history.cpu().numpy()
    fdt = torch.float32 if dtype == np.complex64 else torch.float64
    pair = make_pair_operator(A, dtype=fdt)

    def planes(M):
        return torch.stack([_tensor(M.real, device, fdt),
                            _tensor(M.imag, device, fdt)])
    res = block_cg_planes_chunked(pair, planes(B),
                                  None if X0 is None else planes(X0),
                                  n_iterations=n_iterations)
    x = res.x.cpu().numpy()
    return (x[0] + 1j * x[1]).astype(dtype), \
        res.residual_history.cpu().numpy()


def _solve_real(A, B, X0, n_iterations, device):
    """Real solve (and every solve on the CPU): the streaming real kernel
    for a float32 ``DiaMatrix`` on the card, else eager ``block_cg`` in the
    operands' dtype.  Returns numpy ``(X, history)``."""
    B = np.asarray(B)
    if (_on_card(device) and isinstance(A, DiaMatrix)
            and A.dtype == torch.float32 and B.dtype == np.float32
            and _sd.dia_stream_fits(A)):
        X, history = _sd.stream_cg_dia_block(A, B, X0, n_iterations)
        return X.cpu().numpy(), history.cpu().numpy()
    result = block_cg(A, _tensor(B, device),
                      None if X0 is None else _tensor(X0, device),
                      n_iterations=n_iterations)
    return result.x.cpu().numpy(), result.residual_history.cpu().numpy()


def _unpermute(X, perm):
    if perm is None:
        return X
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return X[inv]


def cg(size: int, non_zeros: int, a_values, b, a_pointers, a_cols, x=None,
       n_rhs: int = 1, n_iterations: int = 10, is_complex=None,
       record_history: bool = False, routing=None, device="cpu"):
    """Solve ``A X = B`` with ``n_iterations`` of block CG on ``device``.

    a_values/a_pointers/a_cols : CSR arrays (len nnz / size+1 / nnz).
    b, x : length ``size * n_rhs``, column-major RHS stacking
           (``v[i + r*size]``); ``x`` is the initial guess (zeros if None).
    is_complex : inferred from dtypes when None (the C API's explicit flag,
           ``clcg.h:5``, is accepted for parity).
    routing : not ported (raises ``NotImplementedError``).
    device : where the operator lives and the solve runs (``"cpu"`` or a
           CUDA device); nothing falls back to another device.
    Returns the solution with the same packing (and the per-RHS residual
    history (n_iterations+1, n_rhs) when ``record_history``).
    """
    import scipy.sparse as sp

    if routing is not None:
        raise NotImplementedError(_ROUTING)
    a_values = np.asarray(a_values)
    b = np.asarray(b)
    if is_complex is None:
        is_complex = np.iscomplexobj(a_values) or np.iscomplexobj(b)
    dtype = np.complex64 if is_complex else np.float32
    if a_values.dtype in (np.complex128, np.float64):
        dtype = np.complex128 if is_complex else np.float64
    on_card = _on_card(device)
    A_sci = sp.csr_matrix((a_values.astype(dtype), np.asarray(a_cols),
                           np.asarray(a_pointers)), shape=(size, size))
    A, perm = to_device_matrix(A_sci, reorder=True,
                               route_fallback=on_card and not is_complex,
                               device=device)
    if on_card:
        _refuse_unstructured(A)
    B = np.asarray(b, dtype=dtype).reshape(n_rhs, size).T      # (n, nrhs)
    X0 = (np.asarray(x, dtype=dtype).reshape(n_rhs, size).T
          if x is not None else None)
    if perm is not None:
        B = B[perm]
        X0 = X0[perm] if X0 is not None else None
    if is_complex and on_card:
        X, history = _solve_planes(A, B, X0, n_iterations, device)
    else:
        X, history = _solve_real(A, B, X0, n_iterations, device)
    out = _unpermute(X, perm).T.reshape(-1)                    # column-major
    if record_history:
        return out, history
    return out


def cg_matrix(A, b, x=None, n_rhs=None, n_iterations=10,
              record_history=False, routing=None, device=None):
    """Convenience wrapper: a scipy matrix or a port container in, the same
    column-major packing and dispatch as :func:`cg`.

    device : where a scipy matrix is put and solved (default ``"cpu"``); a
             container is solved on its own device, and naming another
             device raises.
    """
    import scipy.sparse as sp

    if routing is not None:
        raise NotImplementedError(_ROUTING)
    perm = None
    if sp.issparse(A):
        device = "cpu" if device is None else device
        A, perm = to_device_matrix(sp.csr_matrix(A), reorder=True,
                                   route_fallback=_on_card(device),
                                   device=device)
    elif device is not None and torch.device(device) != A.device:
        raise ValueError(f"the container is on {A.device}, not {device}: "
                         "move it with .to(device)")
    else:
        device = A.device
    on_card = _on_card(device)
    if on_card:
        _refuse_unstructured(A)
    n = A.shape[0]
    b = np.asarray(b)
    n_rhs = n_rhs or (b.size // n)
    B = b.reshape(n_rhs, n).T
    X0 = np.asarray(x).reshape(n_rhs, n).T if x is not None else None
    if perm is not None:
        B = B[perm]
        X0 = X0[perm] if X0 is not None else None
    # a complex matrix with a real RHS still needs the complex solve
    a_dtype = torch.empty((), dtype=A.dtype).numpy().dtype
    is_complex = np.iscomplexobj(B) or np.issubdtype(a_dtype,
                                                     np.complexfloating)
    if is_complex and not np.iscomplexobj(B):
        B = B.astype(np.result_type(B.dtype, a_dtype))
        X0 = X0.astype(B.dtype) if X0 is not None else None
    if is_complex and on_card:
        X, history = _solve_planes(A, B, X0, n_iterations, device)
    else:
        X, history = _solve_real(A, B, X0, n_iterations, device)
    out = np.asarray(_unpermute(X, perm)).T.reshape(-1)
    if record_history:
        return out, history
    return out
