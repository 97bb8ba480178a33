"""Constant-coefficient stencils: interior taps plus boundary strips (counterpart of ``tpcg/ops/fused_cg_const.py``, the planner's ``l2-const`` path).

For the constant-coefficient Helmholtz and Poisson matrices every interior
node carries the same taps; only the ring of boundary nodes differs.
``split_const_stencil`` writes ``A = C + D``: C the constant stencil (one
complex scalar per tap) and D = A - C, nonzero only on the boundary ring,
kept as four strips.  The streaming path (``tpcg_torch.ops.stream_cg``)
builds its operator from this split, and so does the whole solve here.

``fused_cg_const_planes`` runs ``n_iterations`` of fixed-iteration block
COCG for B right-hand sides in one launch, with the operator of
:func:`apply_const_strips`: the interior taps as scalars and the four strips
read where they apply, no coefficient planes.  On a CUDA tensor it launches
the const instance of the hand-written kernel ``tpcg_torch/csrc/fused_cg.cu``
(the whole-solve kernel of ``fused_cg_stencil`` with the operator a template
parameter) and raises if it cannot run; on a CPU tensor it runs
:func:`fused_cg_const_planes_plain`, which is also what the kernel is
compared with on the card.  The recurrence is ``fused_cg_stencil``'s.

JAX keeps the left/right strips as one-hot edge blocks 128 lanes wide and
each strip with a third ``re + im`` plane, for its vector units; the
operator reads one column of the edge blocks and two of the three planes, so
the port keeps just those (``convert.const_operands_from_tpcg`` carries
JAX's form across).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .fused_cg import (_pad_for, cocg_padded_plain, kernel_limits,
                       run_chunked)


def split_const_stencil(stencil):
    """Stencil2D -> (const scalar taps, boundary strip corrections).

    Returns (consts, strips): consts a complex (noff,) numpy array (the
    coefficients at an interior reference node); strips a dict of complex
    numpy arrays
      bot/top    : (noff, Nh)     rows 0 / Nv-1
      left/right : (noff, Nv-2)   cols 0 / Nh-1, rows 1..Nv-2
    Raises ValueError if the interior is not constant or the deviation is
    wider than one ring.
    """
    # the interior test runs on the stencil's device, before the host copy:
    # on a card a variable-coefficient stencil is refused in milliseconds
    interior = stencil.coef[:, 2:-2, 2:-2]
    if not torch.allclose(interior, interior[:, :1, :1], rtol=1e-12,
                          atol=1e-14):
        raise ValueError("stencil interior is not constant-coefficient")
    c = stencil.coef.cpu().numpy()    # a host copy when on a card
    noff, nv, nh = c.shape
    consts = c[:, 2, 2].copy()
    # D = c - const.  Where a tap would leave the grid the assembly stores
    # 0, so D there is -const; harmless, because both the constant apply
    # and the strip correction read zero for such taps.
    delta = c - consts[:, None, None]
    strips = {
        "bot": delta[:, 0, :].copy(),
        "top": delta[:, nv - 1, :].copy(),
        "left": delta[:, 1:nv - 1, 0].copy(),
        "right": delta[:, 1:nv - 1, nh - 1].copy(),
    }
    # rows 1..nv-2, cols 1..nh-2 must have zero deviation
    if not np.allclose(delta[:, 1:-1, 1:-1], 0.0, atol=1e-14):
        raise ValueError("boundary deviation wider than one ring")
    return consts, strips


def tap_groups(values):
    """Taps with equal values, as the JAX kernels group them: a list of
    ``(value, [tap indices])`` in order of first appearance, members in tap
    order, taps whose value is zero (``0.0``, or ``(0.0, 0.0)`` for a
    (re, im) pair) left out.  Summing a group's shifted fields first and
    multiplying once is the JAX operators' order of operations."""
    groups = {}
    for s, v in enumerate(values):
        if (not any(v)) if isinstance(v, tuple) else v == 0.0:
            continue
        groups.setdefault(v, []).append(s)
    return list(groups.items())


def group_of(values):
    """Each tap's group in :func:`tap_groups` (-1 for a zero tap), the form
    the CUDA kernels take the grouping in."""
    out = [-1] * len(values)
    for g, (_, members) in enumerate(tap_groups(values)):
        for s in members:
            out[s] = g
    return out


def prepare_const(stencil):
    """Host preprocessing for :func:`fused_cg_const_planes`
    (``tpcg/ops/fused_cg_const.py::prepare_const``).

    Returns ``(cr, ci, strips)``: the interior taps as tuples of python
    floats and the boundary corrections as four float32 tensors on the
    stencil's device, ``(sb, st, sl, sr)``: bottom/top (2, noff, Nh) and
    left/right (2, noff, Nv-2), [re, im] (JAX's planes 0 and 1, the left and
    right blocks at their one-hot column).  Raises ValueError when the
    interior is not constant.
    """
    consts, strips = split_const_stencil(stencil)
    dev = stencil.device

    def planes(a):
        a = np.asarray(a)
        return torch.from_numpy(
            np.stack([a.real, a.imag]).astype(np.float32)).to(dev)
    cr = tuple(float(v) for v in consts.real)
    ci = tuple(float(v) for v in np.imag(consts))
    return cr, ci, tuple(planes(strips[k])
                         for k in ("bot", "top", "left", "right"))


def apply_const_strips(offsets, cr, ci, strips, dpad: torch.Tensor):
    """q = A d (2, B, Nv, Nh) from the zero-bordered direction buffer dpad
    (2, B, Nv + 2P, Nh + 2P), in the order of JAX's ``apply_const``
    (``fused_cg_const.py:154-242``): per group of equal nonzero interior
    taps, the shifted fields summed in tap order and multiplied once (the
    real part, then the imaginary part, each where nonzero); then, each
    summed from 0 over all taps, the bottom strip added on row 0, the top
    strip on row Nv-1, the left strip on column 0 and the right strip on
    column Nh-1 of rows 1..Nv-2."""
    sb, st, sl, sr = strips
    _, _, pv, ph = dpad.shape
    P = _pad_for(offsets)
    nv, nh = pv - 2 * P, ph - 2 * P

    def win(dm, dj):
        return dpad[:, :, P + dm:P + dm + nv, P + dj:P + dj + nh]

    qr = torch.zeros_like(dpad[0, :, :nv, :nh])
    qi = torch.zeros_like(qr)
    for (gr, gi), members in tap_groups(list(zip(cr, ci))):
        sx = win(*offsets[members[0]])
        for s in members[1:]:
            sx = sx + win(*offsets[s])
        gr, gi = float(np.float32(gr)), float(np.float32(gi))
        if gr != 0.0:
            qr = qr + gr * sx[0]
            qi = qi + gr * sx[1]
        if gi != 0.0:
            qr = qr - gi * sx[1]
            qi = qi + gi * sx[0]

    def ring(strip, rows, cols):
        # sum_s strip_s * d(n + s) over the taps, from 0 in tap order
        ar = ai = 0.0
        for s, (dm, dj) in enumerate(offsets):
            xr = dpad[0, :, P + dm + rows, P + dj + cols]
            xi = dpad[1, :, P + dm + rows, P + dj + cols]
            ar = ar + (strip[0, s] * xr - strip[1, s] * xi)
            ai = ai + (strip[0, s] * xi + strip[1, s] * xr)
        return ar, ai

    full = torch.arange(nh, device=dpad.device)
    inner = torch.arange(1, nv - 1, device=dpad.device)
    for strip, rows, cols in ((sb, 0, full), (st, nv - 1, full),
                              (sl, inner, 0), (sr, inner, nh - 1)):
        ar, ai = ring(strip, rows, cols)
        qr[:, rows, cols] = qr[:, rows, cols] + ar
        qi[:, rows, cols] = qi[:, rows, cols] + ai
    return torch.stack([qr, qi])


def _check_args(offsets, grid, cr, ci, strips, b, x0, n_iterations):
    nv, nh = grid
    noff = len(offsets)
    if len(cr) != noff or len(ci) != noff:
        raise ValueError(f"cr and ci must hold {noff} taps")
    shapes = ((2, noff, nh),) * 2 + ((2, noff, nv - 2),) * 2
    if len(strips) != 4 or any(tuple(s.shape) != want
                               for s, want in zip(strips, shapes)):
        raise ValueError(f"strips must be (sb, st, sl, sr) of shapes "
                         f"{shapes}, got {[tuple(s.shape) for s in strips]}")
    if b.dim() != 4 or b.shape[0] != 2 or tuple(b.shape[2:]) != (nv, nh):
        raise ValueError(f"b must be (2, B, {nv}, {nh}), got "
                         f"{tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in [("strips", t) for t in strips] + [("b", b), ("x0", x0)]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def fused_cg_const_planes_plain(offsets, grid, cr, ci, strips, b, x0,
                                n_iterations: int):
    """Plain PyTorch version of the kernel: ``fused_cg_stencil``'s
    recurrence (:func:`tpcg_torch.ops.fused_cg.cocg_padded_plain`) with the
    operator of :func:`apply_const_strips`."""
    _check_args(offsets, grid, cr, ci, strips, b, x0, n_iterations)
    return cocg_padded_plain(
        lambda dpad: apply_const_strips(offsets, cr, ci, strips, dpad), b, x0,
        _pad_for(offsets), n_iterations)


def _launch(offsets, grid, cr, ci, strips, b, x0, n_iterations):
    """Launch the const instance of the CUDA kernel on the current stream
    of b's device."""
    nv, nh = grid
    noff, nb = len(offsets), b.shape[1]
    max_taps, max_rhs = kernel_limits()
    if noff > max_taps or nb > max_rhs:
        raise ValueError(f"kernel takes at most {max_taps} taps and "
                         f"{max_rhs} RHS per launch, got {noff} and {nb} "
                         "(fused_cg_const_chunked splits larger batches)")
    strips = [s.contiguous() for s in strips]
    b, x0 = b.contiguous(), x0.contiguous()
    P = _pad_for(offsets)
    dev = b.device
    with _build.launch("fused_const", dev) as run:
        grid_size, = _build.query("tpcg_fused_cg_grid", nv * nh)
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.empty_like(b)
        hist = torch.empty((n_iterations + 1, nb), **f32)
        r = torch.empty_like(b)
        q = torch.empty_like(b)
        dpad = torch.empty((2, nb, nv + 2 * P, nh + 2 * P), **f32)
        part = torch.empty((2, grid_size, nb, 2), **f32)
        offs = _build.ints(v for tap in offsets for v in tap)
        taps = _build.floats((*cr, *ci))
        groups = _build.ints(group_of(list(zip(cr, ci))))
        run("tpcg_fused_cg_const",
            *[s.data_ptr() for s in strips], b.data_ptr(), x0.data_ptr(),
            x.data_ptr(), hist.data_ptr(), r.data_ptr(), q.data_ptr(),
            dpad.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), nv, nh,
            nb, noff, offs, taps, groups, P, n_iterations, grid_size)
    return x, hist


def fused_cg_const_planes(offsets, grid, cr, ci, strips, b: torch.Tensor,
                          x0: torch.Tensor, n_iterations: int):
    """Fixed-iteration block COCG on a constant-coefficient stencil.

    offsets, grid : the stencil's.
    cr, ci, strips : from :func:`prepare_const`.
    b, x0 : (2, B, Nv, Nh) float32 RHS / initial-guess planes.
    Returns (x (2, B, Nv, Nh), residual_history (n_iterations+1, B)), as
    ``fused_cg_stencil``.

    CUDA tensors launch the kernel (``launch.fused_const``
    counts the launches); CPU tensors run
    :func:`fused_cg_const_planes_plain`.
    """
    _check_args(offsets, grid, cr, ci, strips, b, x0, n_iterations)
    if b.device.type == "cuda":
        return _launch(offsets, grid, cr, ci, strips, b, x0, n_iterations)
    if b.device.type == "cpu":
        return fused_cg_const_planes_plain(offsets, grid, cr, ci, strips, b,
                                           x0, n_iterations)
    raise ValueError(f"no fused_cg_const_planes for device {b.device}")


def fused_cg_const_chunked(offsets, grid, cr, ci, strips, b, x0,
                           n_iterations: int, chunk: Optional[int] = None):
    """Arbitrary-batch :func:`fused_cg_const_planes`: batches past the
    kernel's RHS limit (the default ``chunk`` on a CUDA tensor; the whole
    batch on a CPU tensor) run as balanced launches one after another."""
    if chunk is None:
        chunk = kernel_limits()[1] if b.device.type == "cuda" else b.shape[1]
    return run_chunked(
        lambda bc, xc: fused_cg_const_planes(offsets, grid, cr, ci, strips,
                                             bc, xc, n_iterations),
        b, x0, chunk)
