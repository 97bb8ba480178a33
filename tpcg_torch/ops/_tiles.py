"""The shared memory of an NVIDIA H100 (sm_90), and the geometry that the
TMA-fed streaming kernels share (``stream_cg.stream_layout``,
``stream_cg_coef.coef_layout``, ``stream_cg_real.real_layout``,
``stream_cg_sym.sym_layout``).

Each streaming kernel keeps its CG state in planes whose rows are padded to
a pitch, walks the grid in tiles, and streams each tile's halo box into a
ring of shared memory:

* the row pitch is nh + pad rounded up to 32 floats (128 B), so every row
  starts aligned and at least ``pad`` zero columns follow nh;
* a box starts ``col_halo`` columns (pad rounded up to 4) left of its tile
  and ``pad`` rows above it, so that its rows are 16-byte multiples (TMA's
  rule): tile_rows + 2 pad rows by tile_cols + 2 col_halo columns;
* where a ring would pass a block's shared memory, the layout shrinks it
  step by step (:func:`shrink`), in the kernel's own order of steps.

Each kernel's ring bytes and byte model stay in its module.  The fit rules
of kernel A (``stream_cg_dia``) and kernel B (``fused_cg_dia``) read
``BLOCK_SHARED`` too.  The kernels keep no copy of these numbers: a launch
that asks for more than the card gives a block is refused by the CUDA
runtime, and the wrapper raises.
"""
from __future__ import annotations

from typing import NamedTuple

SM_SHARED = 233472          # shared memory of one SM, bytes
BLOCK_SHARED = 232448       # the most one block may take, static included
BLOCK_RESERVED = 1024       # the runtime's own share of each block
STATIC_SHARED = 2048        # the streaming kernels' static shared memory,
                            # at most (each kernel's own is below it)


def round_up(v: int, m: int) -> int:
    """v rounded up to a multiple of m."""
    return -(-v // m) * m


def pitch(nh: int, pad: int) -> int:
    """The state planes' row pitch in floats."""
    return round_up(nh + pad, 32)


def col_halo(pad: int) -> int:
    """Box columns each side of a tile."""
    return round_up(pad, 4)


class Box(NamedTuple):
    """The halo box of a tile, the tile count of the grid, and ``share``:
    the box's nodes over the tile's (the halo's share is ``share - 1``)."""
    rows: int
    cols: int
    tiles: int
    share: float


def box(nv: int, nh: int, pad: int, rows: int, cols: int) -> Box:
    """The box of tiles of rows x cols nodes on an (nv, nh) grid, for a
    stencil of reach ``pad``."""
    br, bc = rows + 2 * pad, cols + 2 * col_halo(pad)
    return Box(br, bc, -(-nv // rows) * -(-nh // cols),
               br * bc / (rows * cols))


def blocks_per_sm(smem: int, cap: int) -> int:
    """Blocks an SM holds with ``smem`` bytes of ring each, at most
    ``cap``."""
    return min(cap, SM_SHARED // (smem + BLOCK_RESERVED + STATIC_SHARED))


def half(v: int) -> int:
    return v // 2


def one_less(v: int) -> int:
    return v - 1


def shrink(ring_bytes, knobs: dict, steps, refusal: str):
    """Shrink a ring to a block's shared memory: while ``STATIC_SHARED +
    ring_bytes(**knobs)`` passes ``BLOCK_SHARED``, the first of ``steps``,
    ``(knob, floor, smaller)``, whose knob is above its floor sets it to
    ``smaller(knob)``.  Returns the knobs and the ring's bytes; raises
    ``ValueError(refusal)`` when no step is left."""
    knobs = dict(knobs)
    while STATIC_SHARED + ring_bytes(**knobs) > BLOCK_SHARED:
        for knob, floor, smaller in steps:
            if knobs[knob] > floor:
                knobs[knob] = smaller(knobs[knob])
                break
        else:
            raise ValueError(refusal)
    return knobs, ring_bytes(**knobs)
