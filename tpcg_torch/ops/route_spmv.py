"""Unstructured SpMV for matrices no ordering makes banded (counterpart of ``tpcg/ops/route_spmv.py``).

JAX computes this product on the TPU through a routing network
(``tpcg.ops.routing``), because the TPU has no usable gather.  The port
keeps the function, ``y = A X`` in float32 on a block of right-hand sides,
and computes it from CSR: :func:`routed_matvec_block` launches the
hand-written CUDA kernel ``csrc/route_spmv.cu`` (one warp per row, see the
note there) on CUDA tensors and raises if it cannot; on CPU tensors it runs
:func:`routed_matvec_plain`, the same function in plain PyTorch (a gather
and a sum in row order).  ``tpcg_torch.trace``'s counter
``launch.route_spmv`` counts the launches.

The names are JAX's, so a reader finds each counterpart:

* :class:`DeviceRouted` -- the device container: CSR ``row_ptr``, ``col``
  and ``val`` (float32, or (2, nnz) re/im planes for complex values) on an
  explicit device, with ``matvec`` on (n,) or (n, nrhs), so ``block_cg``
  runs on it as JAX's does on its ``DeviceRouted``.  Built from a scipy
  matrix, from routing tables (:func:`tpcg_torch.ops.routing.routed_to_csr`)
  or from an ``EllMatrix`` (padding dropped).
* :func:`routed_matvec` -- ``A @ x`` for a container, in x's dtype.
* :func:`routed_pair` -- the operator on (2, n[, nrhs]) complex planes that
  ``block_cg_planes`` takes: JAX's Karatsuba ``PairOperator`` of three
  value planes becomes one launch of the complex instance (four products a
  nonzero), and JAX's ``real_only`` pair one launch of the real instance on
  the 2·nrhs columns.

Precision is JAX's: routed values are float32 (``routing.py:316-317``), so
the product runs in float32 whatever the caller's dtype and comes back in
it.  The kernel takes any nrhs (JAX's ``RHS_BATCH`` of 4 was a TPU
measurement): blocks past 8 columns run as launches of 8, 4, 2 and 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from ..device import resolve_device, upload

_INT32_MAX = 2**31 - 1
_COLS = (8, 4, 2, 1)         # the kernel's template instances


def check_int32(n: int, nnz: int) -> None:
    """Raise ``ValueError`` unless n + 1 row pointers and nnz entries fit the
    kernel's int32 indices."""
    if n + 1 > _INT32_MAX or nnz > _INT32_MAX:
        raise ValueError(f"n={n}, nnz={nnz}: the CSR kernel indexes rows and "
                         f"nonzeros in int32 (at most {_INT32_MAX})")


def _check_args(row_ptr, col, val, x, out):
    n, nnz = row_ptr.numel() - 1, col.numel()
    check_int32(n, nnz)
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise ValueError("row_ptr and col must be int32")
    if val.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("val and x must be float32")
    if n < 0 or row_ptr.dim() != 1 or col.dim() != 1:
        raise ValueError("row_ptr (n+1,) and col (nnz,) must be 1-D")
    cplx = val.dim() == 2
    want_val = (2, nnz) if cplx else (nnz,)
    want_x = (2, n) if cplx else (n,)
    if tuple(val.shape) != want_val or x.dim() != len(want_x) + 1 \
            or tuple(x.shape[:-1]) != want_x:
        raise ValueError(f"val {tuple(val.shape)} and x {tuple(x.shape)} do "
                         f"not match: real val (nnz,) with x (n, k), or "
                         f"complex val (2, nnz) with x (2, n, k); n={n}, "
                         f"nnz={nnz}")
    devs = {t.device for t in (row_ptr, col, val, x)}
    if out is not None:
        if (out.shape != x.shape or out.dtype != torch.float32
                or not out.is_contiguous()):
            raise ValueError("out must be a contiguous float32 tensor shaped "
                             "like x")
        if (out.untyped_storage().data_ptr()
                == x.untyped_storage().data_ptr()):
            raise ValueError("out shares its storage with x: the kernel "
                             "reads x while it writes y")
        devs.add(out.device)
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def routed_matvec_plain(row_ptr: torch.Tensor, col: torch.Tensor,
                        val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather x at the column of every
    nonzero, multiply by its value and sum into its row, in row order on
    every device.  ``val`` (nnz,) with ``x`` (n, k), or ``val`` (2, nnz)
    with ``x`` (2, n, k) re/im planes.

    Step p adds the p-th nonzero of every row that has one; the rows, sorted
    by length (longest first), make each step's rows a prefix.  Each step
    writes each row once, so the sum has one fixed order: two runs agree
    bit for bit on a card too (``index_add_`` adds there in no fixed
    order), and on the CPU it is the sequential sum ``index_add_`` gave."""
    n = row_ptr.numel() - 1
    lengths = (row_ptr[1:] - row_ptr[:-1]).long()
    y = torch.zeros_like(x)
    if n == 0 or col.numel() == 0:
        return y
    order = torch.argsort(lengths, descending=True, stable=True)
    longest = int(lengths[order[0]])
    # active[p]: how many rows have more than p nonzeros
    active = torch.searchsorted(-lengths[order],
                                -torch.arange(longest, device=x.device))
    starts = row_ptr[:-1].long()[order]
    cplx = val.dim() == 2
    for p, m in enumerate(active.tolist()):
        rows = order[:m]
        k = starts[:m] + p
        c = col[k].long()
        if not cplx:
            y[rows] = y[rows] + val[k][:, None] * x[c]
            continue
        vr, vi = val[0][k][:, None], val[1][k][:, None]
        xr, xi = x[0][c], x[1][c]
        y[0, rows] = y[0, rows] + (vr * xr - vi * xi)
        y[1, rows] = y[1, rows] + (vr * xi + vi * xr)
    return y


def _launch(row_ptr, col, val, x, out):
    n, nnz, ldx = row_ptr.numel() - 1, col.numel(), x.shape[-1]
    row_ptr, col, val, x = (t.contiguous() for t in (row_ptr, col, val, x))
    y = torch.empty_like(x) if out is None else out
    if n == 0 or ldx == 0:
        return y
    with _build.launch("route_spmv", x.device) as run:
        c0 = 0
        while c0 < ldx:
            nc = next(c for c in _COLS if c <= ldx - c0)
            run("tpcg_route_spmv",
                row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
                x.data_ptr(), y.data_ptr(), n, nnz, ldx, c0, nc,
                int(val.dim() == 2))
            c0 += nc
    return y


def routed_matvec_block(row_ptr: torch.Tensor, col: torch.Tensor,
                        val: torch.Tensor, x: torch.Tensor,
                        out: torch.Tensor = None) -> torch.Tensor:
    """``y = A x`` for the CSR matrix (``row_ptr`` int32 (n+1,), ``col``
    int32 (nnz,) with entries in [0, n), ``val`` float32 (nnz,)) and a
    float32 block ``x`` (n, k); complex: ``val`` (2, nnz) and ``x``, ``y``
    (2, n, k) re/im planes.  ``out``, if given, receives y and must not
    share storage with x.

    CUDA tensors launch ``csrc/route_spmv.cu`` (one launch per column
    chunk of at most 8, each counted in ``launch.route_spmv``);
    CPU tensors run :func:`routed_matvec_plain`.  Raises ``ValueError`` for
    operands the kernel does not take, int32 overflow among them."""
    _check_args(row_ptr, col, val, x, out)
    if x.device.type == "cuda":
        return _launch(row_ptr, col, val, x, out)
    if x.device.type == "cpu":
        y = routed_matvec_plain(row_ptr, col, val, x)
        return y if out is None else out.copy_(y)
    raise ValueError(f"no route_spmv kernel for device {x.device}")


@dataclasses.dataclass(frozen=True)
class DeviceRouted:
    """CSR operand of an unstructured matrix on an explicit device.

    ``val`` is float32 (nnz,), or (2, nnz) re/im planes for complex values;
    ``dtype`` says float32 or complex64 accordingly."""
    row_ptr: torch.Tensor    # (n + 1,) int32
    col: torch.Tensor        # (nnz,) int32
    val: torch.Tensor        # (nnz,) or (2, nnz) float32
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def nnz(self):
        return self.col.numel()

    @property
    def dtype(self):
        return torch.complex64 if self.val.dim() == 2 else torch.float32

    @property
    def device(self):
        return self.val.device

    def to(self, device) -> "DeviceRouted":
        return dataclasses.replace(self, row_ptr=self.row_ptr.to(device),
                                   col=self.col.to(device),
                                   val=self.val.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  ``x``: (n,) or (n, nrhs), real or complex."""
        return routed_matvec(self, x)

    def __matmul__(self, x):
        return self.matvec(x)

    @staticmethod
    def from_scipy(A, device=None) -> "DeviceRouted":
        """A square scipy sparse matrix on ``device`` (default: the CUDA
        device, raising without one), values cast to float32 planes."""
        import scipy.sparse as sp
        device = resolve_device(device)
        A = sp.csr_matrix(A)
        n = A.shape[0]
        if A.shape != (n, n):
            raise ValueError(f"square matrix expected, got {A.shape}")
        check_int32(n, A.nnz)
        data = (np.stack([A.data.real, A.data.imag])
                if np.iscomplexobj(A.data) else A.data)

        def put(a, dt):
            return upload(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)),
                          device)
        return DeviceRouted(put(A.indptr, np.int32), put(A.indices, np.int32),
                            put(data, np.float32), n)

    @staticmethod
    def from_routed(R, device=None) -> "DeviceRouted":
        """Routing tables (``tpcg_torch.ops.routing.RoutedSpmv``) -> the CSR
        matrix they hold, on ``device``."""
        from .routing import routed_to_csr
        return DeviceRouted.from_scipy(routed_to_csr(R), device=device)

    @staticmethod
    def from_ell(E) -> "DeviceRouted":
        """An ``EllMatrix`` on its own device, padding (zero slots) dropped."""
        keep = E.vals != 0
        counts = keep.sum(dim=1)
        row_ptr = torch.zeros(E.n + 1, dtype=torch.int64, device=E.device)
        row_ptr[1:] = torch.cumsum(counts, 0)
        v = E.vals[keep]
        v = (torch.stack([v.real, v.imag]) if v.is_complex() else v)
        check_int32(E.n, int(row_ptr[-1]))
        return DeviceRouted(row_ptr.to(torch.int32),
                            E.cols[keep].to(torch.int32),
                            v.to(torch.float32).contiguous(), E.n)


def routed_matvec(routed: DeviceRouted, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for ``x`` (n,) or (n, nrhs) of any float or complex dtype;
    the product runs in float32 and comes back in x's dtype (complex if the
    matrix is)."""
    squeeze = x.dim() == 1
    xm = x.reshape(routed.n, -1)
    if routed.val.dim() == 2 or xm.is_complex():
        xp = (torch.stack([xm.real, xm.imag]) if xm.is_complex()
              else torch.stack([xm, torch.zeros_like(xm)]))
        yp = routed_pair(routed).matvec(xp)
        y = torch.complex(yp[0], yp[1]).to(
            torch.promote_types(x.dtype, torch.complex64))
    else:
        y = routed_matvec_block(routed.row_ptr, routed.col, routed.val,
                                xm.to(torch.float32)).to(x.dtype)
    return y[:, 0] if squeeze else y


@dataclasses.dataclass(frozen=True)
class RoutedPair:
    """The complex operator of a :class:`DeviceRouted` on (2, n[, nrhs])
    float planes, as ``block_cg_planes`` takes it (JAX's ``routed_pair``
    ``PairOperator``): one kernel launch per column chunk, in float32, with
    the result in the planes' dtype."""
    routed: DeviceRouted

    @property
    def n(self):
        return self.routed.n

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        r = self.routed
        squeeze = x.dim() == 2
        xp = (x[..., None] if squeeze else x).to(torch.float32)
        k = xp.shape[-1]
        if r.val.dim() == 2:
            y = routed_matvec_block(r.row_ptr, r.col, r.val, xp)
        else:
            # a real matrix: both planes as 2k columns of the real instance
            xc = xp.permute(1, 0, 2).reshape(r.n, 2 * k)
            y = routed_matvec_block(r.row_ptr, r.col, r.val, xc)
            y = y.reshape(r.n, 2, k).permute(1, 0, 2)
        y = y.to(x.dtype)
        return y[..., 0] if squeeze else y

    def __matmul__(self, x):
        return self.matvec(x)


def routed_pair(routed, device=None) -> RoutedPair:
    """The planes operator of a :class:`DeviceRouted`, or of routing tables
    (``RoutedSpmv``, put on ``device``)."""
    if not isinstance(routed, DeviceRouted):
        routed = DeviceRouted.from_routed(routed, device=device)
    return RoutedPair(routed)
