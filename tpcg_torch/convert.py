"""Carry operators from the JAX package into the port.

``from_tpcg`` turns a ``tpcg.sparse.Stencil2D``, ``DiaMatrix`` or
``EllMatrix`` into the port's counterpart.  It reads only ``.offsets``,
``.grid`` / ``.n`` and ``np.asarray`` of the array fields, so it needs no
JAX import: the tests build both sides of a comparison from one object
with it.  ``coef3_from_numpy``, ``stream_operands_from_tpcg``,
``sym_operands_from_tpcg``, ``coef_operands_from_tpcg``,
``stream_real_operands_from_tpcg``,
``coef_real_from_tpcg`` and ``const_operands_from_tpcg`` do the same for the
operands the JAX kernels take, and ``routed_from_tpcg`` for JAX's routing
tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .sparse import DiaMatrix, EllMatrix, Stencil2D


def from_tpcg(container, device="cpu"):
    """``tpcg.sparse.Stencil2D`` / ``DiaMatrix`` / ``EllMatrix`` -> the
    port's container."""
    if hasattr(container, "coef") and hasattr(container, "grid"):
        coef = np.array(np.asarray(container.coef))
        return Stencil2D(tuple((int(dm), int(dj))
                               for dm, dj in container.offsets),
                         torch.from_numpy(coef).to(device),
                         tuple(int(g) for g in container.grid))
    if hasattr(container, "data") and hasattr(container, "n"):
        data = np.array(np.asarray(container.data))
        return DiaMatrix(tuple(int(o) for o in container.offsets),
                         torch.from_numpy(data).to(device), int(container.n))
    if hasattr(container, "cols") and hasattr(container, "vals"):
        cols = np.array(np.asarray(container.cols), dtype=np.int32)
        vals = np.array(np.asarray(container.vals))
        return EllMatrix(torch.from_numpy(cols).to(device),
                         torch.from_numpy(vals).to(device), int(container.n))
    raise TypeError(f"no port counterpart for {type(container).__name__}")


def coef3_from_numpy(np_coef3, device="cpu") -> torch.Tensor:
    """The output of ``tpcg.ops.fused_cg.prepare_coef3`` (as numpy) ->
    the (3, noff, Nv, Nh) float32 tensor the port's kernel takes."""
    c = np.asarray(np_coef3)
    if c.ndim != 4 or c.shape[0] != 3:
        raise ValueError(f"coef3 must be (3, noff, Nv, Nh), got {c.shape}")
    return torch.from_numpy(np.array(c, dtype=np.float32)).to(device)


def stream_operands_from_tpcg(taps, strips2, device="cpu"):
    """The output of ``tpcg.ops.stream_cg.prepare_stream`` -> the port's
    ``(taps, strips)``: the six tap tuples as python floats, and the
    (2, noff, 1, Nh) bottom / top strip pair (numpy via ``np.asarray``) as
    one (2, 2, noff, Nh) float32 tensor."""
    taps = tuple(tuple(float(v) for v in t) for t in taps)
    sb, st = (np.asarray(s) for s in strips2)
    if sb.ndim != 4 or sb.shape[2] != 1 or st.shape != sb.shape:
        raise ValueError(f"strips must be two (2, noff, 1, Nh) arrays, got "
                         f"{sb.shape} and {st.shape}")
    planes = np.stack([sb[:, :, 0], st[:, :, 0]]).astype(np.float32)
    return taps, torch.from_numpy(planes).to(device)


def sym_operands_from_tpcg(half_offsets, cplanes, device="cpu"):
    """The output of ``tpcg.ops.stream_cg_v4_sym.prepare_stream_sym`` -> the
    port's ``(half_offsets, cplanes)``: a list of (dm, dj) int pairs and the
    (2, nH1, Nv, Nh) float32 half planes (numpy via ``np.asarray``) as a
    tensor on ``device``."""
    c = np.asarray(cplanes)
    if c.ndim != 4 or c.shape[0] != 2 or c.shape[1] != len(half_offsets):
        raise ValueError(f"cplanes must be (2, {len(half_offsets)}, Nv, Nh), "
                         f"got {c.shape}")
    return ([(int(dm), int(dj)) for dm, dj in half_offsets],
            torch.from_numpy(np.array(c, dtype=np.float32)).to(device))


def coef_operands_from_tpcg(coefp, device="cpu") -> torch.Tensor:
    """The output of ``tpcg.ops.stream_cg.prepare_stream_coef`` (numpy via
    ``np.asarray``) -> the (2, noff, Nv, Nh) float32 coefficient planes the
    port's general ``stream-coef`` kernel takes, on ``device``."""
    c = np.asarray(coefp)
    if c.ndim != 4 or c.shape[0] != 2:
        raise ValueError(f"coefp must be (2, noff, Nv, Nh), got {c.shape}")
    return torch.from_numpy(np.array(c, dtype=np.float32)).to(device)


def stream_real_operands_from_tpcg(taps, strips2, device="cpu"):
    """The output of ``tpcg.ops.stream_cg_real.prepare_stream_real`` -> the
    port's ``(taps, strips)``: the three tap tuples (c, lc, rc) as python
    floats, and the (noff, 1, Nh) bottom / top strip pair (numpy via
    ``np.asarray``) as one (2, noff, Nh) float32 tensor."""
    taps = tuple(tuple(float(v) for v in t) for t in taps)
    sb, st = (np.asarray(s) for s in strips2)
    if sb.ndim != 3 or sb.shape[1] != 1 or st.shape != sb.shape:
        raise ValueError(f"strips must be two (noff, 1, Nh) arrays, got "
                         f"{sb.shape} and {st.shape}")
    planes = np.stack([sb[:, 0], st[:, 0]]).astype(np.float32)
    return taps, torch.from_numpy(planes).to(device)


def coef_real_from_tpcg(coefp, device="cpu") -> torch.Tensor:
    """The output of ``tpcg.ops.stream_cg_real.prepare_stream_coef_real``
    -> the (noff, Nv, Nh) float32 planes the port's coef mode takes."""
    c = np.asarray(coefp)
    if c.ndim != 3:
        raise ValueError(f"coefp must be (noff, Nv, Nh), got {c.shape}")
    return torch.from_numpy(np.array(c, dtype=np.float32)).to(device)


def const_operands_from_tpcg(cr, ci, strips4, device="cpu"):
    """The output of ``tpcg.ops.fused_cg_const.prepare_const`` -> the
    port's ``(cr, ci, (sb, st, sl, sr))``: the taps as python floats; the
    (3, noff, 1, Nh) row strips as (2, noff, Nh) tensors (planes 0 and 1,
    re and im) and the one-hot (3, noff, Nv-2, W) edge blocks as
    (2, noff, Nv-2) tensors (column 0 of the left block, W-1 of the right),
    float32 on ``device``."""
    sb, st, sl, sr = (np.asarray(s) for s in strips4)
    if sb.ndim != 4 or sb.shape[2] != 1 or sl.ndim != 4:
        raise ValueError(f"strips4 must be (3, noff, 1, Nh) rows and "
                         f"(3, noff, Nv-2, W) edge blocks, got {sb.shape} "
                         f"and {sl.shape}")
    parts = (sb[:2, :, 0], st[:2, :, 0], sl[:2, :, :, 0], sr[:2, :, :, -1])
    return (tuple(float(v) for v in cr), tuple(float(v) for v in ci),
            tuple(torch.from_numpy(np.array(p, dtype=np.float32)).to(device)
                  for p in parts))


def routed_from_tpcg(obj, device="cpu"):
    """``tpcg.ops.routing.RoutedSpmv`` (int8 masks (L, S, m)) or
    ``tpcg.ops.route_spmv.DeviceRouted`` (packed int32 masks
    (L, W, m/128, 128)) -> the port's ``DeviceRouted``: the CSR matrix the
    tables hold, on ``device``."""
    from .ops.route_spmv import DeviceRouted
    from .ops.routing import RoutedSpmv, benes_strides, unpack_masks
    masks = np.asarray(obj.masks)
    vals = np.asarray(obj.vals)
    if masks.ndim == 4:                  # JAX's device operand: packed bits
        L, W = masks.shape[:2]
        m = int(obj.m)
        masks = unpack_masks(masks.reshape(L, W, m), benes_strides(m))
        vals = vals.reshape(L, m)
    elif masks.ndim != 3:
        raise TypeError(f"no routing tables in {type(obj).__name__}")
    return DeviceRouted.from_routed(RoutedSpmv(masks, vals, int(obj.n)),
                                    device=device)
