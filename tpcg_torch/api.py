"""Drop-in API surface of the reference's C solver (counterpart of ``tpcg/api.py``).

``cg`` mirrors ``clcg::cg`` (``clcg.h:3-5``): CSR arrays in, solution out,
with the reference's column-major multi-RHS packing ``v[i + r*size]``.  The
matrix is converted once into a device container (``to_device_matrix``,
RCM reordering into a band where that helps) on ``device``, and the whole
fixed-iteration loop runs there.  ``device`` defaults to the CUDA device
and raises without one; the CPU runs only when the caller passes
``device="cpu"`` (``tpcg_torch.device.resolve_device``).

Dispatch keys on the torch device (:func:`_on_card`), not on "not CPU":

* on a CUDA device, float32 / complex64 operands, in the order of
  ``tpcg/api.py:100-116`` and ``:138-145``:
  1. complex ``DiaMatrix`` -> the fused whole-solve kernel
     (``ops.fused_cg_dia``) if its fit rule passes, else the streaming
     complex kernel (``ops.stream_cg_dia``);
  2. real ``DiaMatrix`` -> the streaming real kernel;
  3. an unstructured matrix (no ordering makes it banded), or routing
     tables given as ``routing=`` (``tpcg/api.py:24-74``): eager
     ``block_cg`` over :class:`~tpcg_torch.ops.route_spmv.DeviceRouted`
     for a real one, ``block_cg_planes_chunked`` over ``routed_pair`` for
     a complex one or a complex RHS; each matvec is a launch of the CSR
     kernel ``csrc/route_spmv.cu``, in float32 as JAX's routed kernel;
  4. everything else (float64 / complex128 banded, a real banded matrix
     with a complex RHS, ``Stencil2D``) -> eager ``block_cg`` /
     ``block_cg_planes`` on the device, exactly where JAX also takes XLA.
* on the CPU, what JAX computes on the CPU: eager ``block_cg`` on the
  DIA / ELL container in the operands' dtype, and the routed operand's
  plain version where ``routing=`` is given.

On a CUDA device no path runs on the CPU or on a kernel's plain version; a
kernel that cannot run raises.

Each call is a span of ``tpcg_torch.trace`` (``tpcg.cg``, ``tpcg.cg_matrix``)
over its layers: ``tpcg.convert`` (CSR or scipy input into the device
container, with ``tpcg.convert.rcm`` and ``tpcg.convert.dia`` inside),
``tpcg.pack`` (the host's packing and permutation of b in and x out),
``tpcg.prepare`` (a DIA kernel's operands laid out on the device: the
matrix's planes, b's and x0's rows or planes), ``tpcg.upload``,
``tpcg.launch.<kernel>``, ``tpcg.download`` and
``tpcg.wait`` (the host's wait for the card before each blocking copy, so
that the copy's span holds the copy alone).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import trace
from .cg import block_cg
from .device import download, resolve_device, upload, wait
from .ops import fused_cg_dia as _fd
from .ops import stream_cg_dia as _sd
from .ops.cplx import block_cg_planes_chunked, make_pair_operator
from .ops.route_spmv import DeviceRouted, routed_pair
from .ops.routing import RoutedSpmv
from .sparse import DiaMatrix, EllMatrix, to_device_matrix


def _on_card(device) -> bool:
    """The one device predicate of the dispatch: True on a CUDA device."""
    return torch.device(device).type == "cuda"


def _is_complex_dtype(dt) -> bool:
    if isinstance(dt, torch.dtype):
        return dt.is_complex
    return np.issubdtype(np.dtype(dt), np.complexfloating)


def _tensor(M, dev, dtype=None):
    return upload(torch.from_numpy(np.ascontiguousarray(M)), dev, dtype)


def _fetch(*ts):
    """The results ``ts`` (on one device) as numpy arrays on the host, once
    the device has finished them."""
    wait(ts[0].device)
    return tuple(download(t) for t in ts)


def _routed_planes_op(A):
    """The planes operator of a container that does not split into
    (Ar, Ai, Ar + Ai): the unstructured operand (``tpcg/api.py:24-46``),
    else None."""
    return routed_pair(A) if isinstance(A, DeviceRouted) else None


def _resolve_routing(routing, size, is_complex, device):
    """Routing tables (a ``RoutedSpmv`` or the path of an ``.npz`` that
    ``RoutedSpmv.save`` / ``cli route`` wrote, by either package) -> the
    solve's operands, as ``tpcg/api.py:49-74``: ``(DeviceRouted, None)``
    for a real solve, ``(None, planes operator)`` for a complex one.  The
    CSR matrix is rebuilt from the tables on the host
    (``ops.routing.routed_to_csr``); the CSR arrays of the call are not
    read."""
    R = (RoutedSpmv.load(os.fspath(routing))
         if isinstance(routing, (str, os.PathLike)) else routing)
    if R.n != size:
        raise ValueError(
            f"routing tables are for n={R.n}, matrix has n={size}")
    with trace.span("convert"):
        D = DeviceRouted.from_routed(R, device=device)
    if is_complex or D.dtype.is_complex:
        return None, routed_pair(D)
    return D, None


def _solve_planes(A, B, X0, n_iterations, device, Pop=None):
    """Complex solve on the card (and every routed complex solve):
    ``B``/``X0`` complex numpy (n, nrhs); ``Pop`` overrides the planes
    operator.  Returns numpy ``(X, history)`` with X in B's dtype."""
    dtype = np.asarray(B).dtype
    if (Pop is None and dtype == np.complex64 and isinstance(A, DiaMatrix)
            and A.data.is_complex()):
        if _fd.fused_dia_cplx_fits(A):
            return _fetch(*_fd.fused_cg_dia_cplx_block(A, B, X0,
                                                       n_iterations))
        if _sd.dia_stream_cplx_fits(A):
            return _fetch(*_sd.stream_cg_dia_cplx_block(A, B, X0,
                                                        n_iterations))
    fdt = torch.float32 if dtype == np.complex64 else torch.float64
    if Pop is None:
        with trace.span("convert"):
            Pop = make_pair_operator(A, dtype=fdt)

    def planes(M):
        return torch.stack([_tensor(M.real, device, fdt),
                            _tensor(M.imag, device, fdt)])
    res = block_cg_planes_chunked(Pop, planes(B),
                                  None if X0 is None else planes(X0),
                                  n_iterations=n_iterations)
    x, history = _fetch(res.x, res.residual_history)
    with trace.span("pack"):
        return (x[0] + 1j * x[1]).astype(dtype), history


def _solve_real(A, B, X0, n_iterations, device):
    """Real solve (and every solve on the CPU): the streaming real kernel
    for a float32 ``DiaMatrix`` on the card, else eager ``block_cg`` in the
    operands' dtype (over a ``DeviceRouted``, each matvec a launch of the
    CSR kernel).  Returns numpy ``(X, history)``."""
    B = np.asarray(B)
    if (_on_card(device) and isinstance(A, DiaMatrix)
            and A.dtype == torch.float32 and B.dtype == np.float32
            and _sd.dia_stream_fits(A)):
        return _fetch(*_sd.stream_cg_dia_block(A, B, X0, n_iterations))
    result = block_cg(A, _tensor(B, device),
                      None if X0 is None else _tensor(X0, device),
                      n_iterations=n_iterations)
    return _fetch(result.x, result.residual_history)


def _unpermute(X, perm):
    if perm is None:
        return X
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return X[inv]


def cg(size: int, non_zeros: int, a_values, b, a_pointers, a_cols, x=None,
       n_rhs: int = 1, n_iterations: int = 10, is_complex=None,
       record_history: bool = False, routing=None, device=None):
    """Solve ``A X = B`` with ``n_iterations`` of block CG on ``device``.

    a_values/a_pointers/a_cols : CSR arrays (len nnz / size+1 / nnz).
    b, x : length ``size * n_rhs``, column-major RHS stacking
           (``v[i + r*size]``); ``x`` is the initial guess (zeros if None).
    is_complex : inferred from dtypes when None (the C API's explicit flag,
           ``clcg.h:5``, is accepted for parity).
    routing : precomputed routing tables for an unstructured matrix -- a
           ``RoutedSpmv`` or the path of an ``.npz`` written by
           ``python -m tpcg_torch.cli route`` (or ``tpcg.cli route``) --
           used as the operator instead of the CSR arrays; a complex solve
           on them runs in complex64.  Raises ``ValueError`` if they are for
           another size.
    device : where the operator lives and the solve runs: the CUDA device
           by default (raises without a card), or ``"cpu"`` only when asked
           for; nothing falls back to another device.
    Returns the solution with the same packing (and the per-RHS residual
    history (n_iterations+1, n_rhs) when ``record_history``).
    """
    with trace.span("cg"):
        return _cg(size, a_values, b, a_pointers, a_cols, x, n_rhs,
                   n_iterations, is_complex, record_history, routing, device)


def _cg(size, a_values, b, a_pointers, a_cols, x, n_rhs, n_iterations,
        is_complex, record_history, routing, device):
    import scipy.sparse as sp

    device = resolve_device(device)
    a_values = np.asarray(a_values)
    b = np.asarray(b)
    if is_complex is None:
        is_complex = np.iscomplexobj(a_values) or np.iscomplexobj(b)
    dtype = np.complex64 if is_complex else np.float32
    if a_values.dtype in (np.complex128, np.float64):
        dtype = np.complex128 if is_complex else np.float64
    on_card = _on_card(device)
    Pop, perm = None, None
    if routing is not None:
        A, Pop = _resolve_routing(routing, size, is_complex, device)
        if Pop is not None:
            is_complex, dtype = True, np.complex64   # routed values are f32
    else:
        with trace.span("convert"):
            A_sci = sp.csr_matrix((a_values.astype(dtype), np.asarray(a_cols),
                                   np.asarray(a_pointers)),
                                  shape=(size, size))
            # banded (after RCM where that helps) -> DIA; on the card an
            # unstructured real matrix -> the CSR kernel's operand, and a
            # complex one reaches it below through _routed_planes_op
            A, perm = to_device_matrix(
                A_sci, reorder=True,
                route_fallback=on_card and not is_complex, device=device)
            if on_card and isinstance(A, EllMatrix):
                A = DeviceRouted.from_ell(A)
    with trace.span("pack"):
        B = np.asarray(b, dtype=dtype).reshape(n_rhs, size).T    # (n, nrhs)
        X0 = (np.asarray(x, dtype=dtype).reshape(n_rhs, size).T
              if x is not None else None)
        if perm is not None:
            B = B[perm]
            X0 = X0[perm] if X0 is not None else None
    if is_complex and (on_card or Pop is not None):
        if Pop is None:
            Pop = _routed_planes_op(A)
        X, history = _solve_planes(A, B, X0, n_iterations, device, Pop)
    else:
        X, history = _solve_real(A, B, X0, n_iterations, device)
    with trace.span("pack"):
        out = _unpermute(X, perm).T.reshape(-1)                # column-major
    if record_history:
        return out, history
    return out


def cg_matrix(A, b, x=None, n_rhs=None, n_iterations=10,
              record_history=False, routing=None, device=None):
    """Convenience wrapper: a scipy matrix or a port container in, the same
    column-major packing and dispatch as :func:`cg`.

    routing : routing tables, as in :func:`cg`; ``A`` then gives only the
             size (and whether the solve is complex).
    device : where a scipy matrix is put and solved (default: the CUDA
             device, raising without a card; ``"cpu"`` only when asked
             for); a container is solved on its own device, and naming
             another device raises.  On the card an ``EllMatrix`` container
             runs through the CSR kernel, its padding dropped.
    """
    with trace.span("cg_matrix"):
        return _cg_matrix(A, b, x, n_rhs, n_iterations, record_history,
                          routing, device)


def _cg_matrix(A, b, x, n_rhs, n_iterations, record_history, routing,
               device):
    import scipy.sparse as sp

    n = A.shape[0]
    a_cplx = _is_complex_dtype(A.dtype)
    if sp.issparse(A):
        device = resolve_device(device)
    elif device is not None and torch.device(device) != A.device:
        raise ValueError(f"the container is on {A.device}, not {device}: "
                         "move it with .to(device)")
    else:
        device = A.device
    on_card = _on_card(device)
    perm, Pop = None, None
    b = np.asarray(b)
    if routing is not None:
        A, Pop = _resolve_routing(routing, n, np.iscomplexobj(b) or a_cplx,
                                  device)
    elif sp.issparse(A):
        with trace.span("convert"):
            A, perm = to_device_matrix(sp.csr_matrix(A), reorder=True,
                                       route_fallback=on_card, device=device)
    if on_card and isinstance(A, EllMatrix):
        with trace.span("convert"):
            A = DeviceRouted.from_ell(A)
    with trace.span("pack"):
        n_rhs = n_rhs or (b.size // n)
        B = b.reshape(n_rhs, n).T
        X0 = np.asarray(x).reshape(n_rhs, n).T if x is not None else None
        if perm is not None:
            B = B[perm]
            X0 = X0[perm] if X0 is not None else None
        # a complex matrix with a real RHS still needs the complex solve (a
        # routed complex operand has A None and Pop set)
        is_complex = (np.iscomplexobj(B) or A is None
                      or _is_complex_dtype(A.dtype))
        if is_complex and not np.iscomplexobj(B):
            a_dtype = (np.complex64 if A is None
                       else torch.empty((), dtype=A.dtype).numpy().dtype)
            B = B.astype(np.result_type(B.dtype, a_dtype))
            X0 = X0.astype(B.dtype) if X0 is not None else None
    if is_complex and (on_card or Pop is not None):
        if Pop is None:
            Pop = _routed_planes_op(A)
        if routing is not None:                 # routed values are f32
            B = B.astype(np.complex64)
            X0 = X0.astype(np.complex64) if X0 is not None else None
        X, history = _solve_planes(A, B, X0, n_iterations, device, Pop)
    else:
        X, history = _solve_real(A, B, X0, n_iterations, device)
    with trace.span("pack"):
        out = np.asarray(_unpermute(X, perm)).T.reshape(-1)
    if record_history:
        return out, history
    return out
