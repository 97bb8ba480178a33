"""Fixed-iteration CG on banded DIA matrices (counterpart of ``tpcg/ops/stream_cg_dia.py``).

The reference's two largest Fig. 5 matrices (m_t1: n = 97,578, ~100
diagonals; parabolic_fem: n = 525,825, 7 diagonals) are banded, not 2-D
stencils.  ``stream_cg_dia_rows`` (real) and ``stream_cg_dia_rows_cplx``
(complex planes, COCG) run the whole fixed-iteration solve of up to 8 RHS
in one launch of the hand-written CUDA kernel ``csrc/stream_cg_dia.cu`` on
a CUDA tensor (see the note at the top of that file), and raise if it
cannot run; on a CPU tensor they run their plain PyTorch versions
(``*_plain``), which are also what the kernel is compared with on the card.
Larger RHS counts are split into balanced chunks, never zero-padded.

Layout: the matrix stays in its own row-DIA layout,
``values[d, i] = A[i, i + offsets[d]]`` (``DiaMatrix.data``), and the
direction sits in a zero-bordered buffer of length ``n + 2 max|offset|``.
The JAX kernel's column-major ``(nv, 128)`` regrid, its wrap-filled halo,
its ``_CHUNK = 256`` call splitting with the tail update in XLA, and its
deferred update exist because of TPU lanes and VMEM; they are not ported.

Freeze guards, as in the JAX kernels: real ``(delta == 0) | (<d,q> == 0)``,
complex ``|delta|^2 == 0 | |<d,q>|^2 == 0`` (``_mag2_zero``); both latch
per RHS for the whole solve (the JAX kernels latch within a 256-iteration
call).  A frozen RHS keeps its delta, so its history stays constant.

Public surface as in the JAX module: ``stream_cg_dia`` /
``stream_cg_dia_block`` (real), ``stream_cg_dia_cplx`` /
``stream_cg_dia_cplx_block`` (complex), and the fit rules
``dia_stream_fits`` / ``dia_stream_cplx_fits`` for this card.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build
from .cplx import cdiv, udot_planes

# fit rule: the kernel's tap list lives in shared memory, and its indices
# are 32-bit; operands past the card's memory fail to allocate and raise
_MAX_DIAGS = 4096
_MAX_RHS = 8


def _pad_for(offsets) -> int:
    return max(abs(int(o)) for o in offsets)


def _fits(dia) -> bool:
    n, offs = int(dia.n), [int(k) for k in dia.offsets]
    return 0 < len(offs) <= _MAX_DIAGS and n + 2 * _pad_for(offs) < 2**31


def dia_stream_fits(dia) -> bool:
    """Fit rule of the real kernel on this card (geometry only: ``n`` and
    ``offsets``): at most 4096 diagonals (the tap list is in shared memory)
    and the padded direction indexable in 32 bits."""
    return _fits(dia)


def dia_stream_cplx_fits(dia) -> bool:
    """Fit rule of the complex kernel: the same geometry limits as
    :func:`dia_stream_fits` (the planes share one index space)."""
    return _fits(dia)


def _check_args(offsets, values, b, x0, n_iterations, planes):
    if values.dim() != 3 or values.shape[0] != planes:
        raise ValueError(f"values must be ({planes}, ndiag, n), got "
                         f"{tuple(values.shape)}")
    _, ndiag, n = values.shape
    if len(offsets) != ndiag:
        raise ValueError(f"{len(offsets)} offsets for {ndiag} diagonals")
    if b.dim() != 3 or b.shape[0] != planes or b.shape[2] != n:
        raise ValueError(f"b must be ({planes}, B, {n}), got "
                         f"{tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("values", values), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def _dot(a, b, cplx):
    """Unconjugated dot over rows of (P, B, n) planes: real (B,), complex
    (2, B).  (The kernel sums rr*ri and doubles; doubling is exact, so
    the imaginary part of <r,r> has the same bits either way.)"""
    if cplx:
        return udot_planes(a, b, axis=-1)
    return torch.sum(a[0] * b[0], dim=-1)


def _stream_plain(offsets, values, b, x0, n_iterations):
    """The kernel's recurrence in plain PyTorch, for 1 (real) or 2 (complex)
    planes; see :func:`stream_cg_dia_rows_plain`."""
    cplx = values.shape[0] == 2
    n = values.shape[2]
    P = _pad_for(offsets)
    dpad = b.new_zeros(b.shape[:2] + (n + 2 * P,))
    d = dpad[:, :, P:P + n]                    # view of the interior

    def apply():
        qr = torch.zeros_like(b[0])
        qi = torch.zeros_like(b[0])
        for k, off in enumerate(offsets):
            vr = values[0, k]
            wr = dpad[0, :, P + off:P + off + n]
            if cplx:
                vi = values[1, k]
                wi = dpad[1, :, P + off:P + off + n]
                qr = qr + vr * wr - vi * wi
                qi = qi + vr * wi + vi * wr
            else:
                qr = qr + vr * wr
        return torch.stack([qr, qi]) if cplx else qr[None]

    def zero(v):
        return (v[0] * v[0] + v[1] * v[1] == 0) if cplx else v == 0

    def div(a, c):
        return cdiv(a, c) if cplx else a / c

    def hist_of(dl):
        return (torch.sqrt(torch.sqrt(dl[0] * dl[0] + dl[1] * dl[1]))
                if cplx else torch.sqrt(dl))

    # y + s v and y - s v for per-RHS scalars s (., B) and v (P, B, n),
    # complex terms in the kernel's order
    def add(y, s, v):
        if not cplx:
            return y + s[None, :, None] * v
        sr, si = s[0, :, None], s[1, :, None]
        return torch.stack([y[0] + sr * v[0] - si * v[1],
                            y[1] + sr * v[1] + si * v[0]])

    def sub(y, s, v):
        if not cplx:
            return y - s[None, :, None] * v
        sr, si = s[0, :, None], s[1, :, None]
        return torch.stack([y[0] - (sr * v[0] - si * v[1]),
                            y[1] - (sr * v[1] + si * v[0])])

    d.copy_(x0)
    r = b - apply()
    x = x0.clone()
    d.copy_(r)
    delta = _dot(r, r, cplx)
    hist = [hist_of(delta)]
    done = torch.zeros(b.shape[1], dtype=torch.bool, device=b.device)
    one = torch.ones_like(delta)
    for _ in range(n_iterations):
        q = apply()
        dc = d.clone()
        dq = _dot(dc, q, cplx)
        done = done | zero(delta) | zero(dq)
        alpha = torch.where(done, 0.0, div(delta, torch.where(done, one, dq)))
        x = add(x, alpha, dc)
        r = sub(r, alpha, q)
        dn = _dot(r, r, cplx)
        beta = torch.where(done, 0.0, div(dn, torch.where(done, one, delta)))
        delta = torch.where(done, delta, dn)
        hist.append(hist_of(delta))
        d.copy_(add(r, beta, dc))
    return x, torch.stack(hist)


def stream_cg_dia_rows_plain(offsets: Sequence[int], values: torch.Tensor,
                             b: torch.Tensor, x0: torch.Tensor,
                             n_iterations: int):
    """Plain PyTorch version of the real kernel: the same function, step
    for step.  ``values`` (ndiag, n) float32 row-DIA planes, ``b``/``x0``
    (B, n); returns ``x`` (B, n) and the history ``sqrt(delta)``
    (n_iterations+1, B)."""
    _check_args(offsets, values[None], b[None], x0[None], n_iterations, 1)
    x, hist = _stream_plain(offsets, values[None], b[None], x0[None],
                            n_iterations)
    return x[0], hist


def stream_cg_dia_rows_cplx_plain(offsets: Sequence[int],
                                  values: torch.Tensor, b: torch.Tensor,
                                  x0: torch.Tensor, n_iterations: int):
    """Plain PyTorch version of the complex kernel: ``values``
    (2, ndiag, n), ``b``/``x0`` (2, B, n) float32 re/im planes; returns
    ``x`` (2, B, n) and the history ``sqrt|delta|`` (n_iterations+1, B)."""
    _check_args(offsets, values, b, x0, n_iterations, 2)
    return _stream_plain(offsets, values, b, x0, n_iterations)


def kernel_limits() -> Tuple[int, int]:
    """(max RHS per launch, max diagonals) of the CUDA kernel."""
    rhs, diags = ctypes.c_int(), ctypes.c_int()
    _build.check(_build.load().tpcg_stream_dia_limits(ctypes.byref(rhs),
                                                       ctypes.byref(diags)),
                 "tpcg_stream_dia_limits")
    return rhs.value, diags.value


def _launch(offsets, values, b, x0, n_iterations):
    """Launch the CUDA kernel on the current stream of b's device; values
    (P, ndiag, n), b/x0 (P, B, n) with B within the kernel's limit."""
    lib = _build.load()
    planes, ndiag, n = values.shape
    nb = b.shape[1]
    max_rhs, max_diags = kernel_limits()
    if nb > max_rhs or ndiag > max_diags:
        raise ValueError(f"kernel takes at most {max_rhs} RHS and "
                         f"{max_diags} diagonals per launch, got {nb} and "
                         f"{ndiag}")
    values, b, x0 = values.contiguous(), b.contiguous(), x0.contiguous()
    P = _pad_for(offsets)
    dev = b.device
    cplx = int(planes == 2)
    with torch.cuda.device(dev):
        grid = ctypes.c_int()
        _build.check(lib.tpcg_stream_dia_grid(cplx, nb, n, ndiag,
                                              ctypes.byref(grid)),
                     "tpcg_stream_dia_grid")
        f32 = dict(dtype=torch.float32, device=dev)
        offs = torch.tensor([int(o) for o in offsets], dtype=torch.int32,
                            device=dev)
        x = torch.empty_like(b)
        hist = torch.empty((n_iterations + 1, nb), **f32)
        r = torch.empty_like(b)
        q = torch.empty_like(b)
        dpad = torch.empty((planes, nb, n + 2 * P), **f32)
        part = torch.empty((2, grid.value, nb, 2), **f32)
        err = lib.tpcg_stream_dia(
            cplx, values.data_ptr(), offs.data_ptr(), b.data_ptr(),
            x0.data_ptr(), x.data_ptr(), hist.data_ptr(), r.data_ptr(),
            q.data_ptr(), dpad.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), n, ndiag, nb, P, n_iterations, grid.value,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tpcg_stream_dia")
    if cplx:
        stream_cg_dia_rows_cplx.launches += 1
    else:
        stream_cg_dia_rows.launches += 1
    return x, hist


def _balanced(nrhs: int, cap: int):
    """Balanced chunks of at most ``cap``: ceil(nrhs/cap) chunks whose sizes
    differ by at most one (9 RHS at cap 8 -> 5 + 4, not 8 + 1 or a padded
    8 + 8)."""
    nc = -(-nrhs // cap)
    base, extra = divmod(nrhs, nc)
    lo = 0
    for c in range(nc):
        hi = lo + base + (c < extra)
        yield lo, hi
        lo = hi


def _solve(offsets, values, b, x0, n_iterations):
    """Dispatch on b's device; values (P, ndiag, n), b/x0 (P, B, n), at
    most 8 RHS (the kernel's limit) per run in balanced chunks."""
    if b.device.type == "cuda":
        run = _launch
    elif b.device.type == "cpu":
        run = _stream_plain
    else:
        raise ValueError(f"no stream_cg_dia kernel for device {b.device}")
    if b.shape[1] <= _MAX_RHS:
        return run(offsets, values, b, x0, n_iterations)
    xs, hists = [], []
    for lo, hi in _balanced(b.shape[1], _MAX_RHS):
        x, hist = run(offsets, values, b[:, lo:hi], x0[:, lo:hi],
                      n_iterations)
        xs.append(x)
        hists.append(hist)
    return torch.cat(xs, dim=1), torch.cat(hists, dim=1)


def stream_cg_dia_rows(offsets: Sequence[int], values: torch.Tensor,
                       b: torch.Tensor, x0: torch.Tensor, n_iterations: int):
    """Device-resident real solve: ``values`` (ndiag, n) float32 row-DIA
    planes (:func:`prepare_dia_rows`), ``b``/``x0`` (B, n) float32 on the
    same device.  Returns ``x`` (B, n) and the history (n_iterations+1, B).

    CUDA tensors launch the kernel, at most 8 RHS (the kernel's limit) per
    launch in balanced chunks; ``stream_cg_dia_rows.launches`` counts the
    launches.  CPU tensors run :func:`stream_cg_dia_rows_plain` in the same
    chunks."""
    _check_args(offsets, values[None], b[None], x0[None], n_iterations, 1)
    x, hist = _solve(offsets, values[None], b[None], x0[None], n_iterations)
    return x[0], hist


stream_cg_dia_rows.launches = 0


def stream_cg_dia_rows_cplx(offsets: Sequence[int], values: torch.Tensor,
                            b: torch.Tensor, x0: torch.Tensor,
                            n_iterations: int):
    """Device-resident complex solve: ``values`` (2, ndiag, n), ``b``/``x0``
    (2, B, n) float32 re/im planes.  Returns ``x`` (2, B, n) and the
    history (n_iterations+1, B).  Launches and chunks as
    :func:`stream_cg_dia_rows`; ``stream_cg_dia_rows_cplx.launches`` counts
    the launches."""
    _check_args(offsets, values, b, x0, n_iterations, 2)
    return _solve(offsets, values, b, x0, n_iterations)


stream_cg_dia_rows_cplx.launches = 0


def prepare_dia_rows(dia) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """Real :class:`DiaMatrix` -> (offsets, values (ndiag, n) float32) on
    its device: the matrix's own layout, nothing regridded."""
    return (tuple(int(o) for o in dia.offsets),
            dia.data.to(torch.float32).contiguous())


def prepare_dia_rows_cplx(dia) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """Complex (or real) :class:`DiaMatrix` -> (offsets, values
    (2, ndiag, n) float32 re/im planes) on its device."""
    v = dia.data
    if v.is_complex():
        planes = torch.stack([v.real, v.imag]).to(torch.float32)
    else:
        planes = torch.stack([v, torch.zeros_like(v)]).to(torch.float32)
    return tuple(int(o) for o in dia.offsets), planes.contiguous()


def _as_tensor(a, dev, dtype=None):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def _cols(B, dev):
    """(n,) or (n, nrhs) -> (nrhs, n) float32 rows on dev."""
    t = _as_tensor(B, dev, torch.float32)
    return (t[None] if t.dim() == 1 else t.T).contiguous()


def _cplx_cols(B, dev):
    """complex (n,) or (n, nrhs) -> (2, nrhs, n) float32 planes on dev."""
    t = _as_tensor(B, dev)
    t = t[None] if t.dim() == 1 else t.T
    if not t.is_complex():
        t = t.to(torch.complex64)
    return torch.stack([t.real, t.imag]).to(torch.float32).contiguous()


def stream_cg_dia_block(dia, B, X0=None, n_iterations: int = 10):
    """Multi-RHS real banded CG on a real :class:`DiaMatrix`: ``B``/``X0``
    (n, nrhs) (numpy or tensors).  Returns tensors on the matrix's device,
    ``X`` (n, nrhs) float32 and the history (n_iterations+1, nrhs).  Each
    launch applies every value fetch to up to 8 RHS (report Fig. 6); per RHS
    the result does not depend on the RHS count."""
    offsets, values = prepare_dia_rows(dia)
    dev = values.device
    b = _cols(B, dev)
    x0 = torch.zeros_like(b) if X0 is None else _cols(X0, dev)
    x, hist = stream_cg_dia_rows(offsets, values, b, x0, n_iterations)
    return x.T, hist


def stream_cg_dia(dia, b, x0=None, n_iterations: int = 10):
    """Real banded CG, one RHS: ``b``, ``x0`` (n,).  Returns (x (n,),
    history (n_iterations+1,)) as tensors on the matrix's device."""
    X, H = stream_cg_dia_block(dia, _as_tensor(b, "cpu")[:, None],
                               None if x0 is None
                               else _as_tensor(x0, "cpu")[:, None],
                               n_iterations)
    return X[:, 0], H[:, 0]


def stream_cg_dia_cplx_block(dia, B, X0=None, n_iterations: int = 10):
    """Multi-RHS complex banded COCG on a complex :class:`DiaMatrix`:
    ``B``/``X0`` complex (n, nrhs).  Returns ``X`` complex64 (n, nrhs) and
    the history (n_iterations+1, nrhs) on the matrix's device.  The JAX
    module runs columns one by one; here up to 8 share each launch, and per
    RHS the result does not depend on the RHS count."""
    offsets, values = prepare_dia_rows_cplx(dia)
    dev = values.device
    b = _cplx_cols(B, dev)
    x0 = torch.zeros_like(b) if X0 is None else _cplx_cols(X0, dev)
    x, hist = stream_cg_dia_rows_cplx(offsets, values, b, x0, n_iterations)
    return torch.complex(x[0], x[1]).T, hist


def stream_cg_dia_cplx(dia, b, x0=None, n_iterations: int = 10):
    """Complex banded COCG, one RHS: ``b``, ``x0`` complex (n,).  Returns
    (x complex64 (n,), history (n_iterations+1,))."""
    b = _as_tensor(b, "cpu")
    X, H = stream_cg_dia_cplx_block(
        dia, b[:, None],
        None if x0 is None else _as_tensor(x0, "cpu")[:, None],
        n_iterations)
    return X[:, 0], H[:, 0]
