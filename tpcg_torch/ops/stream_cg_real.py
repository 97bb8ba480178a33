"""Fixed-iteration CG on real stencils from 1024^2 nodes (counterpart of ``tpcg/ops/stream_cg_real.py``, the planner's ``stream-real`` path).

The real twin of :mod:`tpcg_torch.ops.stream_cg`: single-RHS CG on one
float32 plane per field, the state (x, r, the direction d and q = A d) in
device memory, with two operators:

  const mode : constant interior taps, constant left/right edge taps on
               columns 0 and Nh-1, and bottom/top row strips
               corner-adjusted by the edge taps (:func:`prepare_stream_real`,
               :func:`apply_const_real`).  Interior taps with equal
               coefficients are summed first and multiplied once, as JAX's
               K1 does.
  coef mode  : per-node coefficient planes (:func:`prepare_stream_coef_real`,
               :func:`apply_coef_real`), for variable coefficients.

``stream_cg_real_planes`` / ``stream_cg_real_coef_planes`` run
``n_iterations`` of CG with these operators.  On a CUDA tensor they launch
the hand-written kernel ``tpcg_torch/csrc/stream_cg_real.cu`` (one
persistent cooperative launch per solve, both modes; see the note at the top
of that file) and raise if it cannot run.  On a CPU tensor they run the
``_plain`` versions, the same functions in plain PyTorch, which are also
what the kernel is compared with on the card.

One Hopper kernel takes the place of the JAX package's tiers for these
functions: v2 (``_build_k1_real_const``, ``_build_k1_real_coef``,
``_make_k2_real``), v4 (``stream_cg_v4_real.py::_build_resident_real``, const
with keep_q / recompute / q_hbm, and coef) and v5
(``stream_cg_v5_real.py::_build_v5_real``, tiers A and B, ``qx`` and the
column-padded ``cpos`` route).  Their VMEM budgets, row-block chunking,
128-lane column padding and q modes exist for the TPU; so does the JAX
planner's row padding of heights it cannot stream (``pad->stream-real``):
the kernel reads any height and width.

One deliberate difference from JAX: the dot products <d, q> and <r, r> are
summed in float64 and rounded to float32 once (JAX sums them in float32 by
row blocks), in the kernel and the plain version alike, so that both round
to the same alpha and beta at full size (``stream_cg_sym``'s finding).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .fused_cg import _pad_for
from .fused_cg_const import group_of, tap_groups

Offset = Tuple[int, int]


def _allclose(a, b, rtol, atol) -> bool:
    return bool(torch.allclose(a, torch.as_tensor(b, dtype=a.dtype,
                                                  device=a.device).expand_as(a),
                               rtol=rtol, atol=atol))


def split_const_stencil_real(stencil):
    """Real Stencil2D -> (const taps, boundary strips), the contract of
    ``tpcg/ops/stream_cg_real.py::split_const_stencil_real``.

    Returns (consts, strips): consts a (noff,) tensor (the coefficients at
    the interior node (2, 2)); strips a dict of tensors on the stencil's
    device, in its dtype:
      bot/top    : (noff, Nh)     rows 0 / Nv-1, minus the constant taps
      left/right : (noff, Nv-2)   cols 0 / Nh-1, rows 1..Nv-2, likewise
    Both tests run on the stencil's device.  Raises ValueError if the
    interior is not constant or the deviation is wider than one ring.
    """
    c = stencil.coef
    if c.is_complex():
        raise ValueError("split_const_stencil_real takes a real stencil; "
                         "complex stencils use stream_cg.prepare_stream")
    nv, nh = stencil.grid
    interior = c[:, 2:-2, 2:-2]
    consts = interior[:, 0, 0].clone()
    if not _allclose(interior, consts[:, None, None], 1e-12, 1e-14):
        raise ValueError("stencil interior is not constant-coefficient")
    delta = c - consts[:, None, None]
    if not _allclose(delta[:, 1:-1, 1:-1], 0.0, 0.0, 1e-14):
        raise ValueError("boundary deviation wider than one ring")
    strips = {"bot": delta[:, 0, :], "top": delta[:, nv - 1, :],
              "left": delta[:, 1:nv - 1, 0], "right": delta[:, 1:nv - 1, nh - 1]}
    return consts, strips


def prepare_stream_real(stencil):
    """Host preprocessing of a constant-tap real stencil
    (``tpcg/ops/stream_cg_real.py::prepare_stream_real``).

    Returns ``(taps, strips)``:
      taps   : (c, lc, rc), three tuples of ``noff`` python floats: the
               interior taps and the left/right edge taps, as JAX gives
               them (the stencil's values; the kernel and the plain version
               compute with their float32 roundings, as the JAX kernels do).
      strips : float32 tensor (2, noff, Nh) on the stencil's device,
               [bottom, top] row corrections for rows 0 and Nv-1, adjusted at
               columns 0 and Nh-1 by the edge taps (bit for bit JAX's
               ``(sb, st)`` with its unit axis dropped).
    The constancy tests run on the stencil's device; only the taps reach
    the host.  Raises ValueError when the interior or an edge is not
    constant (the planner then takes coef mode).
    """
    consts, strips = split_const_stencil_real(stencil)
    nh = stencil.grid[1]

    def _edge_const(a, name):
        if not _allclose(a, a[:, :1], 1e-12, 1e-14):
            raise ValueError(f"{name} edge coefficients not constant")
        return a[:, 0].clone()

    lc = _edge_const(strips["left"], "left")
    rc = _edge_const(strips["right"], "right")
    sb = strips["bot"].clone()
    st = strips["top"].clone()
    for s in (sb, st):
        s[:, 0] -= lc
        s[:, nh - 1] -= rc
    taps = tuple(tuple(float(v) for v in t.cpu().tolist())
                 for t in (consts, lc, rc))
    return taps, torch.stack([sb, st]).to(torch.float32).contiguous()


def prepare_stream_coef_real(stencil) -> torch.Tensor:
    """(noff, Nv, Nh) float32 coefficient planes on the stencil's device
    (``tpcg/ops/stream_cg_real.py::prepare_stream_coef_real``)."""
    if stencil.coef.is_complex():
        raise ValueError("prepare_stream_coef_real takes a real stencil")
    return stencil.coef.to(torch.float32).contiguous()


def _shifted(xp: torch.Tensor, offsets, P: int) -> List[torch.Tensor]:
    """x(n + s) for every offset s, zero off the grid."""
    nv, nh = xp.shape
    xpad = torch.nn.functional.pad(xp, (P, P, P, P))
    return [xpad[P + dm:P + dm + nv, P + dj:P + dj + nh] for dm, dj in offsets]


def _f32(v) -> float:
    return float(np.float32(v))


def apply_const_real(offsets: Sequence[Offset], taps, strips: torch.Tensor,
                     xp: torch.Tensor) -> torch.Tensor:
    """q = A x on an (Nv, Nh) float32 plane with the operator of
    :func:`prepare_stream_real`, in the order of JAX's const K1
    (``stream_cg_real.py:193-239``) and of the kernel, step for step: from
    q = 0, per group of equal nonzero interior taps (in order of first
    appearance) the shifted fields summed in tap order, times the tap, added
    to q; then on column 0 the nonzero left edge taps' terms summed from 0
    in tap order and added, likewise the right edge taps on column Nh-1;
    then on row 0 the bottom strip's terms over all taps, summed from 0 and
    added, and the top strip's on row Nv-1.  A neighbour off the grid reads
    0."""
    c, lc, rc = taps
    nv, nh = xp.shape
    xs = _shifted(xp, offsets, _pad_for(offsets))
    q = torch.zeros_like(xp)
    for g, members in tap_groups(c):
        sx = xs[members[0]]
        for s in members[1:]:
            sx = sx + xs[s]
        q = q + _f32(g) * sx
    for col, edge in ((0, lc), (nh - 1, rc)):
        a = torch.zeros_like(xp[:, col])
        for s, v in enumerate(edge):
            if v != 0.0:
                a = a + _f32(v) * xs[s][:, col]
        q[:, col] = q[:, col] + a
    for row, k in ((0, 0), (nv - 1, 1)):
        a = torch.zeros_like(xp[row])
        for s in range(len(offsets)):
            a = a + strips[k, s] * xs[s][row]
        q[row] = q[row] + a
    return q


def apply_coef_real(offsets: Sequence[Offset], coefp: torch.Tensor,
                    xp: torch.Tensor) -> torch.Tensor:
    """q = sum_s c_s(n) x(n + s) in tap order from q = 0, a neighbour off
    the grid reading 0 (JAX's coef K1, ``stream_cg_real.py:288-291``)."""
    q = torch.zeros_like(xp)
    for s, xs in enumerate(_shifted(xp, offsets, _pad_for(offsets))):
        q = q + coefp[s] * xs
    return q


def cg_real_plain(apply, bp: torch.Tensor, x0p: torch.Tensor,
                  n_iterations: int, dot_dtype=torch.float64):
    """The real v2 iteration of the JAX package, step for step, for any
    operator ``apply`` on an (Nv, Nh) float32 plane: the plain version of
    the kernel.  ``dot_dtype`` is the type the dot products are summed in
    before they are rounded to float32.

    r0 = b - A x0, delta0 = <r0, r0>; then per iteration d = r + beta d,
    q = A d, alpha = delta / <d, q>, x += alpha d, r -= alpha q,
    delta' = <r, r>, beta = delta' / delta, with the freeze guard
    ``done = (delta == 0) | (<d, q> == 0)`` evaluated afresh every iteration,
    zeroing alpha and beta.  History ``sqrt(delta)``, n_iterations + 1
    rows.
    """
    def dot(a, b):
        return torch.sum(a.to(dot_dtype) * b.to(dot_dtype)).to(bp.dtype)

    x = x0p.clone()
    r = bp - apply(x0p)
    d = torch.zeros_like(bp)
    delta = dot(r, r)
    hist = [torch.sqrt(delta)]
    beta = torch.zeros_like(delta)
    zero, one = torch.zeros_like(delta), torch.ones_like(delta)
    for _ in range(n_iterations):
        d = r + beta * d
        q = apply(d)
        dq = dot(d, q)
        done = (delta == 0) | (dq == 0)
        alpha = torch.where(done, zero, delta / torch.where(done, one, dq))
        x = x + alpha * d
        r = r - alpha * q
        dn = dot(r, r)
        hist.append(torch.sqrt(dn))
        beta = torch.where(done, zero, dn / torch.where(done, one, delta))
        delta = dn
    return x, torch.stack(hist)


def _check_planes(b, x0, n_iterations, *others):
    if b.dim() != 2:
        raise ValueError(f"b must be (Nv, Nh), got {tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("b", b), ("x0", x0)) + others:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def _check_const(offsets, grid, taps, strips, b, x0, n_iterations):
    noff = len(offsets)
    if len(taps) != 3 or any(len(t) != noff for t in taps):
        raise ValueError(f"taps must be three tuples of {noff} values")
    if tuple(strips.shape) != (2, noff, grid[1]):
        raise ValueError(f"strips must be (2, {noff}, {grid[1]}), got "
                         f"{tuple(strips.shape)}")
    if tuple(b.shape) != tuple(grid):
        raise ValueError(f"b must be {tuple(grid)}, got {tuple(b.shape)}")
    _check_planes(b, x0, n_iterations, ("strips", strips))


def _check_coef(offsets, coefp, b, x0, n_iterations):
    if coefp.dim() != 3 or coefp.shape[0] != len(offsets):
        raise ValueError(f"coefp must be ({len(offsets)}, Nv, Nh), got "
                         f"{tuple(coefp.shape)}")
    if tuple(b.shape) != tuple(coefp.shape[1:]):
        raise ValueError(f"b must be {tuple(coefp.shape[1:])}, got "
                         f"{tuple(b.shape)}")
    _check_planes(b, x0, n_iterations, ("coefp", coefp))


def stream_cg_real_planes_plain(offsets, grid, taps, strips, bp, x0p,
                                n_iterations: int):
    """Plain PyTorch version of the const-mode kernel: :func:`cg_real_plain`
    with the operator of :func:`apply_const_real`."""
    _check_const(offsets, grid, taps, strips, bp, x0p, n_iterations)
    return cg_real_plain(lambda v: apply_const_real(offsets, taps, strips, v),
                         bp, x0p, n_iterations)


def stream_cg_real_coef_planes_plain(offsets, coefp, bp, x0p,
                                     n_iterations: int):
    """Plain PyTorch version of the coef-mode kernel: :func:`cg_real_plain`
    with the operator of :func:`apply_coef_real`."""
    _check_coef(offsets, coefp, bp, x0p, n_iterations)
    return cg_real_plain(lambda v: apply_coef_real(offsets, coefp, v), bp,
                         x0p, n_iterations)


def kernel_limits() -> Tuple[int, int]:
    """(max taps, max stencil pad) of the CUDA kernel."""
    taps, pad = ctypes.c_int(), ctypes.c_int()
    _build.check(_build.load().tpcg_stream_real_limits(ctypes.byref(taps),
                                                       ctypes.byref(pad)),
                 "tpcg_stream_real_limits")
    return taps.value, pad.value


def _launch(offsets, operand, taps, bp, x0p, n_iterations):
    """Launch the CUDA kernel on the current stream of bp's device; const
    mode when ``taps`` is given (``operand`` the strips), else coef mode
    (``operand`` the coefficient planes)."""
    lib = _build.load()
    nv, nh = bp.shape
    noff = len(offsets)
    P = _pad_for(offsets)
    max_taps, max_pad = kernel_limits()
    if noff > max_taps or P > max_pad:
        raise ValueError(f"kernel takes at most {max_taps} taps within "
                         f"{max_pad} nodes, got {noff} taps within {P}")
    coef = taps is None
    if coef:      # the taps and groups are read in const mode only
        taps = ((0.0,) * noff,) * 3
    operand, bp, x0p = operand.contiguous(), bp.contiguous(), x0p.contiguous()
    dev = bp.device
    with torch.cuda.device(dev):
        blocks = ctypes.c_int()
        _build.check(lib.tpcg_stream_real_grid(nv, nh, P, int(coef),
                                               ctypes.byref(blocks)),
                     "tpcg_stream_real_grid")
        x = torch.empty_like(bp)
        hist = torch.empty((n_iterations + 1,), dtype=torch.float32,
                           device=dev)
        r = torch.empty_like(bp)
        q = torch.empty_like(bp)
        d = torch.empty((2, nv, nh), dtype=torch.float32, device=dev)
        part = torch.empty((2, blocks.value), dtype=torch.float64, device=dev)
        offs = (ctypes.c_int * (2 * noff))(
            *[int(v) for tap in offsets for v in tap])
        tap_vals = (ctypes.c_float * (3 * noff))(*[v for t in taps for v in t])
        groups = (ctypes.c_int * noff)(*group_of(taps[0]))
        err = lib.tpcg_stream_real(
            bp.data_ptr(), x0p.data_ptr(), operand.data_ptr(), x.data_ptr(),
            hist.data_ptr(), r.data_ptr(), q.data_ptr(), d.data_ptr(),
            part.data_ptr(), nv, nh, noff, offs, tap_vals, groups, int(coef),
            P, n_iterations, blocks.value,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tpcg_stream_real")
    stream_cg_real_planes.launches += 1
    return x, hist


def stream_cg_real_planes(offsets: Sequence[Offset], grid, taps,
                          strips: torch.Tensor, bp: torch.Tensor,
                          x0p: torch.Tensor, n_iterations: int):
    """Fixed-iteration single-RHS CG on a constant-tap real stencil.

    offsets : stencil offsets ((dm, dj), ...).
    grid    : (Nv, Nh).
    taps, strips : from :func:`prepare_stream_real`.
    bp, x0p : (Nv, Nh) float32 RHS / initial guess.
    Returns (x (Nv, Nh), residual_history (n_iterations+1,)).

    CUDA tensors launch the kernel (``stream_cg_real_planes.launches``
    counts the launches of both modes); CPU tensors run
    :func:`stream_cg_real_planes_plain`.
    """
    _check_const(offsets, grid, taps, strips, bp, x0p, n_iterations)
    if bp.device.type == "cuda":
        return _launch(offsets, strips, taps, bp, x0p, n_iterations)
    if bp.device.type == "cpu":
        return stream_cg_real_planes_plain(offsets, grid, taps, strips, bp,
                                           x0p, n_iterations)
    raise ValueError(f"no stream_cg_real_planes for device {bp.device}")


stream_cg_real_planes.launches = 0


def stream_cg_real_coef_planes(offsets: Sequence[Offset],
                               coefp: torch.Tensor, bp: torch.Tensor,
                               x0p: torch.Tensor, n_iterations: int):
    """Fixed-iteration single-RHS CG on a real stencil's coefficient planes
    (``coefp`` from :func:`prepare_stream_coef_real`); returns as
    :func:`stream_cg_real_planes`, whose count its launches add to.  CPU
    tensors run :func:`stream_cg_real_coef_planes_plain`."""
    _check_coef(offsets, coefp, bp, x0p, n_iterations)
    if bp.device.type == "cuda":
        return _launch(offsets, coefp, None, bp, x0p, n_iterations)
    if bp.device.type == "cpu":
        return stream_cg_real_coef_planes_plain(offsets, coefp, bp, x0p,
                                                n_iterations)
    raise ValueError(f"no stream_cg_real_coef_planes for device {bp.device}")


def prepare_real(stencil):
    """``("const", (taps, strips))`` when :func:`prepare_stream_real`
    accepts the stencil, else ``("coef", coefp)``: JAX's choice between
    its two real modes."""
    try:
        return "const", prepare_stream_real(stencil)
    except ValueError:
        return "coef", prepare_stream_coef_real(stencil)


def solve_real_planes(offsets, prepared, bp, x0p, n_iterations):
    """One RHS through the mode ``prepared`` (from :func:`prepare_real`)
    names."""
    mode, operand = prepared
    if mode == "const":
        taps, strips = operand
        return stream_cg_real_planes(offsets, tuple(bp.shape), taps, strips,
                                     bp, x0p, n_iterations)
    return stream_cg_real_coef_planes(offsets, operand, bp, x0p,
                                      n_iterations)


def stream_cg_real(stencil, b, x0=None, n_iterations: int = 10):
    """Convenience wrapper: a real (Nv, Nh) numpy grid in, device planes out,
    on the stencil's device; const mode where the stencil allows it, else
    coef mode (``tpcg/ops/stream_cg_real.py::stream_cg_real``)."""
    nv, nh = stencil.grid
    dev = stencil.device

    def plane(z):
        return torch.from_numpy(
            np.asarray(z).reshape(nv, nh).astype(np.float32)).to(dev)
    bp = plane(b)
    x0p = torch.zeros_like(bp) if x0 is None else plane(x0)
    return solve_real_planes(stencil.offsets, prepare_real(stencil), bp, x0p,
                             n_iterations)
