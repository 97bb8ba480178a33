"""Whole-solve fused block CG on a complex 2-D stencil (counterpart of ``tpcg/ops/fused_cg.py``).

``fused_cg_stencil`` runs ``n_iterations`` of fixed-iteration block COCG for
B independent right-hand sides in one kernel launch.  On a CUDA tensor it
launches the hand-written kernel ``tpcg_torch/csrc/fused_cg.cu`` (one
persistent cooperative launch; see the note at the top of that file), and it
raises if the kernel cannot run.  On a CPU tensor it runs
:func:`fused_cg_stencil_plain`, the same function in plain PyTorch, which is
also what the kernel is compared with on the card.

Shapes are those of the JAX kernel: ``coef3`` (3, noff, Nv, Nh) float32
planes ``[Ar, Ai, Ar+Ai]`` (:func:`prepare_coef3`), ``b`` and ``x0``
(2, B, Nv, Nh) float32 re/im planes; the result is ``x`` (2, B, Nv, Nh) and
the residual history ``sqrt|<r,r>|`` (n_iterations+1, B).

The JAX kernel's ``packed``/unrolled scalar split and its eye-mask history
extraction exist because of Mosaic's layout limits; the port has one scalar
path.  Its ``_FUSED_RHS_CAP = 16`` was a Mosaic compile cap: the chunked
wrapper here chunks by the CUDA kernel's own RHS limit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build


def _pad_for(offsets) -> int:
    return max(max(abs(dm), abs(dj)) for dm, dj in offsets)


def _check_args(offsets, coef3, b, x0, n_iterations):
    if coef3.dim() != 4 or coef3.shape[0] != 3:
        raise ValueError(f"coef3 must be (3, noff, Nv, Nh), got "
                         f"{tuple(coef3.shape)}")
    _, noff, nv, nh = coef3.shape
    if len(offsets) != noff:
        raise ValueError(f"{len(offsets)} offsets for {noff} coefficient "
                         "planes")
    if b.dim() != 4 or b.shape[0] != 2 or tuple(b.shape[2:]) != (nv, nh):
        raise ValueError(f"b must be (2, B, {nv}, {nh}), got "
                         f"{tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("coef3", coef3), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def _udot_grid(a, b):
    """Unconjugated dot of (2, B, Nv, Nh) planes over the grid -> (2, B)."""
    return torch.stack([torch.sum(a[0] * b[0] - a[1] * b[1], dim=(-2, -1)),
                        torch.sum(a[0] * b[1] + a[1] * b[0], dim=(-2, -1))])


def _rr_grid(r):
    """<r, r> as the kernel forms it: (sum rr^2 - ri^2, 2 sum rr ri)."""
    return torch.stack([torch.sum(r[0] * r[0] - r[1] * r[1], dim=(-2, -1)),
                        2.0 * torch.sum(r[0] * r[1], dim=(-2, -1))])


def _cdiv(ar, ai, br, bi):
    """Smith-scaled complex division (``tpcg/ops/fused_cg.py::_cdiv_scalar``)."""
    m = torch.maximum(torch.abs(br), torch.abs(bi))
    ms = torch.where(m == 0, 1.0, m)
    b0, b1 = br / ms, bi / ms
    d = (b0 * b0 + b1 * b1) * ms
    return (ar * b0 + ai * b1) / d, (ai * b0 - ar * b1) / d


def _hist_row(delta):
    return torch.sqrt(torch.sqrt(delta[0] * delta[0] + delta[1] * delta[1]))


def cocg_padded_plain(apply, b: torch.Tensor, x0: torch.Tensor, P: int,
                      n_iterations: int):
    """The whole-solve COCG recurrence of the JAX package (``_init_state`` +
    ``_cg_scalar_step`` in ``tpcg/ops/fused_cg.py``) for any operator:
    ``apply(dpad)`` returns q = A d (2, B, Nv, Nh) from the zero-bordered
    direction buffer dpad (2, B, Nv + 2P, Nh + 2P), so every tap is a static
    slice and a tap outside the grid reads 0.

    Per RHS, alpha = delta/<d,q> and beta = delta'/delta with Smith
    division, both zeroed by the freeze guard
    ``(delta == 0) | (<d,q> == 0)``; history ``sqrt|<r,r>|``.
    """
    _, _, nv, nh = b.shape
    dpad = b.new_zeros((2, b.shape[1], nv + 2 * P, nh + 2 * P))
    d = dpad[:, :, P:P + nv, P:P + nh]          # view of the interior

    d.copy_(x0)
    r = b - apply(dpad)
    x = x0.clone()
    d.copy_(r)
    delta = _rr_grid(r)
    hist = [_hist_row(delta)]
    zero = torch.zeros_like(delta[0])
    for _ in range(n_iterations):
        q = apply(dpad)
        dc = d.clone()
        dq = _udot_grid(dc, q)
        done = ((delta[0] == 0) & (delta[1] == 0)) \
            | ((dq[0] == 0) & (dq[1] == 0))
        a_r, a_i = _cdiv(delta[0], delta[1], torch.where(done, 1.0, dq[0]),
                         torch.where(done, 0.0, dq[1]))
        a = torch.stack([torch.where(done, zero, a_r),
                         torch.where(done, zero, a_i)])[:, :, None, None]
        x = x + torch.stack([a[0] * dc[0] - a[1] * dc[1],
                             a[0] * dc[1] + a[1] * dc[0]])
        r = r - torch.stack([a[0] * q[0] - a[1] * q[1],
                             a[0] * q[1] + a[1] * q[0]])
        dn = _rr_grid(r)
        hist.append(_hist_row(dn))
        be_r, be_i = _cdiv(dn[0], dn[1], torch.where(done, 1.0, delta[0]),
                           torch.where(done, 0.0, delta[1]))
        be = torch.stack([torch.where(done, zero, be_r),
                          torch.where(done, zero, be_i)])[:, :, None, None]
        d.copy_(r + torch.stack([be[0] * dc[0] - be[1] * dc[1],
                                 be[0] * dc[1] + be[1] * dc[0]]))
        delta = dn
    return x, torch.stack(hist)


def fused_cg_stencil_plain(offsets: Sequence[Tuple[int, int]],
                           coef3: torch.Tensor, b: torch.Tensor,
                           x0: torch.Tensor, n_iterations: int):
    """Plain PyTorch version of the kernel: the same function, step for step:
    :func:`cocg_padded_plain` with the Karatsuba form of the stencil apply in
    the tap order of ``offsets``."""
    _check_args(offsets, coef3, b, x0, n_iterations)
    _, _, nv, nh = coef3.shape
    P = _pad_for(offsets)

    def apply(dpad):
        qr = torch.zeros_like(b[0])
        qi = torch.zeros_like(b[0])
        for s, (dm, dj) in enumerate(offsets):
            xr = dpad[0, :, P + dm:P + dm + nv, P + dj:P + dj + nh]
            xi = dpad[1, :, P + dm:P + dm + nv, P + dj:P + dj + nh]
            m1 = coef3[0, s] * xr
            m2 = coef3[1, s] * xi
            m3 = coef3[2, s] * (xr + xi)
            qr = qr + (m1 - m2)
            qi = qi + (m3 - m1 - m2)
        return torch.stack([qr, qi])

    return cocg_padded_plain(apply, b, x0, P, n_iterations)


def kernel_limits() -> Tuple[int, int]:
    """(max taps, max RHS per launch) of the CUDA kernel."""
    return _build.query("tpcg_fused_cg_limits")


def _launch(offsets, coef3, b, x0, n_iterations):
    """Launch the CUDA kernel on the current stream of b's device."""
    _, noff, nv, nh = coef3.shape
    nb = b.shape[1]
    max_taps, max_rhs = kernel_limits()
    if noff > max_taps or nb > max_rhs:
        raise ValueError(f"kernel takes at most {max_taps} taps and "
                         f"{max_rhs} RHS per launch, got {noff} and {nb} "
                         "(fused_cg_stencil_chunked splits larger batches)")
    coef3, b, x0 = coef3.contiguous(), b.contiguous(), x0.contiguous()
    P = _pad_for(offsets)
    dev = b.device
    with _build.launch("fused_cg", dev) as run:
        grid, = _build.query("tpcg_fused_cg_grid", nv * nh)
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.empty_like(b)
        hist = torch.empty((n_iterations + 1, nb), **f32)
        r = torch.empty_like(b)
        q = torch.empty_like(b)
        dpad = torch.empty((2, nb, nv + 2 * P, nh + 2 * P), **f32)
        part = torch.empty((2, grid, nb, 2), **f32)
        offs = _build.ints(v for tap in offsets for v in tap)
        run("tpcg_fused_cg_stencil",
            coef3.data_ptr(), b.data_ptr(), x0.data_ptr(), x.data_ptr(),
            hist.data_ptr(), r.data_ptr(), q.data_ptr(), dpad.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), nv, nh, nb, noff, offs,
            P, n_iterations, grid)
    return x, hist


def fused_cg_stencil(offsets: Sequence[Tuple[int, int]],
                     coef3: torch.Tensor, b: torch.Tensor,
                     x0: torch.Tensor, n_iterations: int):
    """Run ``n_iterations`` of block CG on a complex 2-D stencil operator.

    offsets : stencil offsets ((dm, dj), ...).
    coef3   : (3, noff, Nv, Nh) float32 planes [Ar, Ai, Ar+Ai]
              (build with :func:`prepare_coef3`).
    b, x0   : (2, B, Nv, Nh) float32 RHS / initial-guess planes.
    Returns (x, residual_history): (2, B, Nv, Nh) and (n_iterations+1, B),
    with the COCG numerics of ``tpcg_torch.ops.cplx.block_cg_planes``.

    CUDA tensors launch the kernel (``launch.fused_cg`` counts the
    launches); CPU tensors run :func:`fused_cg_stencil_plain`.
    """
    _check_args(offsets, coef3, b, x0, n_iterations)
    if b.device.type == "cuda":
        return _launch(offsets, coef3, b, x0, n_iterations)
    if b.device.type == "cpu":
        return fused_cg_stencil_plain(offsets, coef3, b, x0, n_iterations)
    raise ValueError(f"no fused_cg_stencil for device {b.device}")


def run_chunked(solve, b, x0, chunk: int):
    """``solve(b, x0)`` over RHS chunks of (2, B, Nv, Nh) planes, one launch
    after another, the batch split into the fewest launches of at most
    ``chunk`` RHS, balanced in size; results concatenated."""
    nb = b.shape[1]
    if nb <= chunk:
        return solve(b, x0)
    launches = -(-nb // chunk)
    cuts = [-(-nb * k // launches) for k in range(launches + 1)]
    runs = [solve(b[:, lo:hi], x0[:, lo:hi])
            for lo, hi in zip(cuts, cuts[1:])]
    return (torch.cat([x for x, _ in runs], dim=1),
            torch.cat([h for _, h in runs], dim=1))


def fused_cg_stencil_chunked(offsets, coef3, b, x0, n_iterations: int,
                             chunk: Optional[int] = None):
    """Arbitrary-batch fused CG: RHS chunks solved one launch after another
    (:func:`run_chunked`).

    Per-RHS recurrences are independent (``clcg.c:317-333``), and the
    kernel's sums for one RHS do not depend on the others, so each RHS gets
    the bits of a launch with that RHS alone.  ``chunk`` defaults to the
    CUDA kernel's RHS limit on a CUDA tensor and to the whole batch on a
    CPU tensor.
    """
    if chunk is None:
        chunk = kernel_limits()[1] if b.device.type == "cuda" else b.shape[1]
    return run_chunked(
        lambda bc, xc: fused_cg_stencil(offsets, coef3, bc, xc, n_iterations),
        b, x0, chunk)


def prepare_coef3(stencil, dtype=torch.float32) -> torch.Tensor:
    """Stencil2D (complex or real coef) -> (3, noff, Nv, Nh) [Ar, Ai, Ar+Ai]
    on the stencil's device; ``Ar + Ai`` is summed after the cast, as
    ``tpcg.ops.fused_cg.prepare_coef3`` does."""
    c = stencil.coef
    if c.is_complex():
        re, im = c.real.to(dtype), c.imag.to(dtype)
    else:
        re, im = c.to(dtype), torch.zeros_like(c, dtype=dtype)
    return torch.stack([re, im, re + im]).contiguous()


def fused_cg(stencil, b, x0=None, n_iterations: int = 10):
    """Convenience wrapper: complex numpy grids in, device planes out.

    stencil : Stencil2D (complex or real coefficients); runs on its device.
    b       : complex (B, Nv, Nh) or (Nv, Nh).
    Returns (x, hist) as :func:`fused_cg_stencil` does.
    """
    nv, nh = stencil.grid
    dev = stencil.device
    b = np.asarray(b).reshape(-1, nv, nh)
    coef3 = prepare_coef3(stencil)
    bp = torch.from_numpy(np.stack([b.real, b.imag]).astype(np.float32)).to(dev)
    if x0 is None:
        x0p = torch.zeros_like(bp)
    else:
        x0 = np.asarray(x0).reshape(-1, nv, nh)
        x0p = torch.from_numpy(
            np.stack([x0.real, x0.imag]).astype(np.float32)).to(dev)
    return fused_cg_stencil(stencil.offsets, coef3, bp, x0p, n_iterations)
