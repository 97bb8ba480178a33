"""Constant-coefficient stencils: interior taps plus boundary strips (counterpart of ``tpcg/ops/fused_cg_const.py``, host part).

For the constant-coefficient Helmholtz and Poisson matrices every interior
node carries the same taps; only the ring of boundary nodes differs.
``split_const_stencil`` writes ``A = C + D``: C the constant stencil (one
complex scalar per tap) and D = A - C, nonzero only on the boundary ring,
kept as four strips.  The streaming path (``tpcg_torch.ops.stream_cg``)
builds its operator from this split.

The whole-solve kernel of the JAX module (``fused_cg_const_planes``, the
planner's ``vmem-const`` path) is not ported yet: ROADMAP queue 2 item 2.
"""
from __future__ import annotations

import numpy as np
import torch


def split_const_stencil(stencil):
    """Stencil2D -> (const scalar taps, boundary strip corrections).

    Returns (consts, strips): consts a complex (noff,) numpy array (the
    coefficients at an interior reference node); strips a dict of complex
    numpy arrays
      bot/top    : (noff, Nh)     rows 0 / Nv-1
      left/right : (noff, Nv-2)   cols 0 / Nh-1, rows 1..Nv-2
    Raises ValueError if the interior is not constant or the deviation is
    wider than one ring of nodes.
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
