"""Fixed-iteration CG on real stencils (counterpart of ``tpcg/ops/stream_cg_real.py``, the planner's ``stream-real`` path: float32 grids from 8 nodes a side, float64 ones from 1024^2 nodes, on a card).

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
of that file) and raise if it cannot run.  :func:`card_layout` gives the
layout a launch runs, with its tiles, rings and byte counts: in const mode,
where the card holds one block for every tile of the grid, the resident
layout (:func:`resident_layout`): one tile a block for the whole solve, x,
r and q in registers, 16 + 8 h B a node and iteration (the counter
``resident.stream_real`` of ``tpcg_torch.trace`` counts such launches);
elsewhere the streaming layout (:func:`real_layout`): TMA-fed halo boxes,
the state (q included) in rows padded to 32 floats, 40 + 8 h B, plus 4 B a
tap in coef mode, where the kernel reads the coefficient planes copied to
its pitch (:func:`pad_real_planes`; the planner makes the copy once a
plan).
On a CPU tensor they run the ``_plain`` versions, the same
functions in plain PyTorch, which are also what the kernel is compared
with on the card.

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

import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build, _tiles
from .. import trace
from .fused_cg import _pad_for
from .fused_cg_const import group_of, tap_groups
from .stream_cg_coef import pad_rows

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
    0.  The grid's width is the strips': xp may carry zero columns past it
    (the kernel's padded rows, :func:`real_layout`), which read as the
    zeros off the grid and stay zero in q."""
    c, lc, rc = taps
    nv, nh = xp.shape[0], strips.shape[-1]
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
        a = torch.zeros_like(xp[row, :nh])
        for s in range(len(offsets)):
            a = a + strips[k, s] * xs[s][row, :nh]
        q[row, :nh] = q[row, :nh] + a
    q[:, nh:] = 0.0
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
    return _build.query("tpcg_stream_real_limits")[:2]


def resident_limits() -> Tuple[int, int]:
    """(tallest tile, blocks an SM) of the CUDA kernel's resident mode: x, r
    and q of half the tile's rows' nodes a thread fit the registers that its
    launch bounds of that many blocks an SM leave."""
    return _build.query("tpcg_stream_real_limits")[2:]


# The kernel's tiles and rings (csrc/stream_cg_real.cu), from the sweeps of
# probes/stream_cg_phases.py --kernel real and --kernel real-coef on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings): const mode's tile
# rows and blocks an SM, and below SMALL_GRID_NODES nodes its smaller tiles
# and more blocks an SM, which the sweep found faster there (they do not
# share out evenly: at 725^2 nodes 8-row tiles leave 546 tiles to 528
# blocks, 18 of them with two, which the others wait for at every
# barrier); coef mode's tile rows, coefficient ring slots and blocks an SM;
# the state ring slots of both.  A grid that one wave of blocks holds
# takes const mode's resident layout instead (resident_layout), whose
# bounds are the kernel's (resident_limits).
TILE_ROWS = 16
BLOCKS_PER_SM = 3
SMALL_GRID_NODES = 2048 * 2048
SMALL_TILE_ROWS = 8
SMALL_BLOCKS_PER_SM = 4
COEF_TILE_ROWS = 4
COEF_STAGES = 2
COEF_BLOCKS_PER_SM = 2
STAGES = 2
TILE_COLS = 128


class RealLayout(NamedTuple):
    """Where ``csrc/stream_cg_real.cu`` keeps its state and how it tiles
    it."""
    pitch: int          # row pitch of r, d, q, the working x and the
                        # coefficient planes' copy (floats)
    tile_rows: int      # a tile is tile_rows x tile_cols nodes
    tile_cols: int
    col_halo: int       # box columns each side of a tile: pad rounded up to 4
    box_rows: int       # halo box: tile_rows + 2 pad rows ...
    box_cols: int       # ... by tile_cols + 2 col_halo columns
    stages: int         # state ring slots
    coef_stages: int    # coefficient ring slots (coef mode; 0 in const)
    blocks_per_sm: int
    tiles: int          # tiles of the grid
    smem_bytes: int     # the rings' dynamic shared memory
    bytes_a: float      # bytes a node: phase A
    bytes_b: float      # phase B
    resident: bool      # one tile a block, x, r and q in registers (const
                        # mode, where the card holds a block a tile)


def _ring_bytes(rows, pad, hc, noff, coef, stages, coef_stages):
    """The kernel's ``smem_bytes``: state slots of two halo boxes (phase A:
    r and d_old), and in coef mode coefficient slots of the tile's noff
    planes; each box rounded up to 32 floats."""
    box = _tiles.round_up((rows + 2 * pad) * (TILE_COLS + 2 * hc), 32)
    cbox = _tiles.round_up(noff * rows * TILE_COLS, 32) if coef else 0
    return 4 * ((coef_stages if coef else 0) * cbox + stages * 2 * box)


_SHRINK = (("coef_stages", 1, _tiles.one_less), ("rows", 1, _tiles.half))


def resident_rows(nv: int, nh: int, blocks: int, max_rows: int):
    """The fewest tile rows whose tiles of an (nv, nh) grid number at most
    ``blocks``, or None where that takes more than ``max_rows`` rows."""
    per_col = blocks // -(-nh // TILE_COLS)   # tiles down a column of tiles
    if per_col < 1:
        return None
    rows = -(-nv // per_col)
    return rows if rows <= max_rows else None


def resident_layout(nv: int, nh: int, pad: int, noff: int, sms: int,
                    max_rows: int, per_sm: int):
    """Const mode's resident layout of an (nv, nh) grid with ``noff`` taps
    within ``pad`` nodes, on a card of ``sms`` SMs, for a kernel whose
    resident mode takes tiles of at most ``max_rows`` rows at ``per_sm``
    blocks an SM (:func:`resident_limits`); None where there is none.  One
    block a tile: the tiles of the fewest rows (:func:`resident_rows`) that
    number at most ``sms * per_sm``, where an SM's shared memory holds
    ``per_sm`` rings of those rows.  Bytes a node 8 (1 + h) + 4 in phase A
    (r and d_old with their halo, d' written) and 4 in phase B (r
    written)."""
    rows = resident_rows(nv, nh, sms * per_sm, max_rows)
    if rows is None:
        return None
    hc = _tiles.col_halo(pad)
    smem = _ring_bytes(rows, pad, hc, noff, False, STAGES, 0)
    if _tiles.blocks_per_sm(smem, per_sm) < per_sm:
        return None
    box = _tiles.box(nv, nh, pad, rows, TILE_COLS)
    return RealLayout(_tiles.pitch(nh, pad), rows, TILE_COLS, hc, box.rows,
                      box.cols, STAGES, 0, per_sm, box.tiles, smem,
                      8 * box.share + 4, 4.0, True)


def real_layout(nv: int, nh: int, pad: int, noff: int, coef: bool,
                tile_rows: int = None, stages: int = None,
                coef_stages: int = None) -> RealLayout:
    """The streaming layout of ``csrc/stream_cg_real.cu`` on an (nv, nh)
    grid with ``noff`` taps within ``pad`` nodes, in coef mode or const mode
    (defaults: the module's ``TILE_ROWS`` and ``BLOCKS_PER_SM`` in const
    mode, ``SMALL_TILE_ROWS`` and ``SMALL_BLOCKS_PER_SM`` there below
    ``SMALL_GRID_NODES`` nodes, ``COEF_TILE_ROWS``, ``COEF_STAGES`` and
    ``COEF_BLOCKS_PER_SM`` in coef mode, ``STAGES`` in both).

    A launch runs it in coef mode, and in const mode where the card cannot
    hold the resident layout (:func:`card_layout`).

    The pitch, the column halo and the box are the streaming kernels'
    (``_tiles``); coef mode's planes are copied to the same pitch
    (:func:`pad_real_planes`).  Where the rings would pass a block's shared
    memory (large pads and tap counts), the layout drops to one coefficient
    slot, then halves the tile's rows: every pad and tap count the kernel
    takes (:func:`kernel_limits`: 8 and 16) runs.  Bytes a node per
    iteration, with h the halo's share of a box (box / tile - 1; the
    pitch's zero columns not counted): phase A 8 (1 + h) + 8, plus 4 noff
    in coef mode (r and d_old with their halo, d' and q, the tile's
    planes); phase B 24 (x, d', r and q read, x and r written)."""
    if coef:
        rows = COEF_TILE_ROWS if tile_rows is None else tile_rows
        cst = COEF_STAGES if coef_stages is None else coef_stages
        cap = COEF_BLOCKS_PER_SM
    else:
        small = nv * nh < SMALL_GRID_NODES
        rows = tile_rows if tile_rows is not None else (
            SMALL_TILE_ROWS if small else TILE_ROWS)
        cst = 0
        cap = SMALL_BLOCKS_PER_SM if small else BLOCKS_PER_SM
    stages = STAGES if stages is None else stages
    hc = _tiles.col_halo(pad)
    fit, smem = _tiles.shrink(
        functools.partial(_ring_bytes, pad=pad, hc=hc, noff=noff, coef=coef,
                          stages=stages),
        dict(rows=rows, coef_stages=cst), _SHRINK,
        f"no ring of {stages} slots fits a block at pad {pad} with {noff} "
        f"taps")
    box = _tiles.box(nv, nh, pad, fit["rows"], TILE_COLS)
    return RealLayout(_tiles.pitch(nh, pad), fit["rows"], TILE_COLS, hc,
                      box.rows, box.cols, stages, fit["coef_stages"],
                      _tiles.blocks_per_sm(smem, cap), box.tiles, smem,
                      8 * box.share + 8 + (4 * noff if coef else 0), 24.0,
                      False)


def pad_real_planes(offsets: Sequence[Offset],
                    coefp: torch.Tensor) -> torch.Tensor:
    """The coefficient planes (noff, Nv, Nh) copied to the kernel's pitch
    (:func:`real_layout`), zero past column Nh: the operand every coef-mode
    launch on the grid reads.  A plan makes it once (``auto``'s
    ``stream-real`` branch); the counter ``copy.pad_real_planes`` of
    ``tpcg_torch.trace`` counts the copies."""
    noff, nv, nh = coefp.shape
    pitch = real_layout(nv, nh, _pad_for(offsets), noff, True).pitch
    trace.count("copy.pad_real_planes")
    return pad_rows(coefp, pitch).contiguous()


def card_layout(nv: int, nh: int, pad: int, noff: int, coef: bool,
                dev=None) -> Tuple[RealLayout, int]:
    """The layout a launch runs on an (nv, nh) grid on CUDA device ``dev``
    (default the current one), and its blocks: in const mode the resident
    layout (:func:`resident_layout`) for the card's SMs and the kernel's
    :func:`resident_limits`, where there is one and the occupancy query
    finds that the card holds one block for each of its tiles; else the
    streaming layout (:func:`real_layout`), one block a tile, at most as
    many as the card holds at once."""
    def grid_of(lay):
        return _build.query("tpcg_stream_real_grid", nv, nh, lay.pitch, pad,
                            noff, int(coef), int(lay.resident), lay.tile_rows,
                            lay.col_halo, lay.stages, lay.coef_stages,
                            lay.blocks_per_sm)[0]
    if not coef:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lay = resident_layout(nv, nh, pad, noff, sms, *resident_limits())
        grid = 0 if lay is None else grid_of(lay)
        if grid:
            return lay, grid
    lay = real_layout(nv, nh, pad, noff, coef)
    return lay, grid_of(lay)


def grid_blocks(nv: int, nh: int, pad: int, noff: int, coef: bool) -> int:
    """Blocks of one launch on an (nv, nh) grid on the current CUDA device
    (:func:`card_layout`)."""
    return card_layout(nv, nh, pad, noff, coef)[1]


def _launch(offsets, operand, taps, bp, x0p, n_iterations, cpad=None):
    """Launch the CUDA kernel on the current stream of bp's device; const
    mode when ``taps`` is given (``operand`` the strips), else coef mode
    (``operand`` the coefficient planes; ``cpad`` the planes at the
    kernel's pitch, :func:`pad_real_planes`, or None to copy them for this
    launch)."""
    nv, nh = bp.shape
    noff = len(offsets)
    P = _pad_for(offsets)
    max_taps, max_pad = kernel_limits()
    if noff > max_taps or P > max_pad:
        raise ValueError(f"kernel takes at most {max_taps} taps within "
                         f"{max_pad} nodes, got {noff} taps within {P}")
    coef = taps is None
    bp, x0p = bp.contiguous(), x0p.contiguous()
    dev = bp.device
    pitch = _tiles.pitch(nh, P)
    if coef:
        # the taps and groups are read in const mode only
        taps = ((0.0,) * noff,) * 3
        if cpad is None:
            cpad = pad_real_planes(offsets, operand)
        if (tuple(cpad.shape) != (noff, nv, pitch)
                or cpad.dtype != torch.float32 or cpad.device != dev
                or not cpad.is_contiguous()):
            raise ValueError(f"cpad must be contiguous float32 ({noff}, {nv}, "
                             f"{pitch}) on {dev}, got "
                             f"{tuple(cpad.shape)} {cpad.dtype} on "
                             f"{cpad.device}")
        operand = cpad
    else:
        operand = operand.contiguous()
    with _build.launch("stream_real", dev) as run:
        lay, blocks = card_layout(nv, nh, P, noff, coef, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.empty_like(bp)
        hist = torch.empty((n_iterations + 1,), **f32)
        # state in the kernel's padded rows, zero past column nh; in
        # resident mode q and the working x stay in registers
        r = torch.zeros((nv, pitch), **f32)
        q = xw = None
        if not lay.resident:
            q = torch.zeros_like(r)
            xw = torch.zeros_like(r)
        d = torch.zeros((2, nv, pitch), **f32)
        part = torch.empty((2, blocks), dtype=torch.float64, device=dev)
        offs = _build.ints(v for tap in offsets for v in tap)
        tap_vals = _build.floats(v for t in taps for v in t)
        groups = _build.ints(group_of(taps[0]))
        run("tpcg_stream_real",
            bp.data_ptr(), x0p.data_ptr(), operand.data_ptr(), x.data_ptr(),
            hist.data_ptr(), r.data_ptr(), None if q is None else q.data_ptr(),
            d.data_ptr(), None if xw is None else xw.data_ptr(),
            part.data_ptr(), nv, nh, pitch, noff, offs, tap_vals, groups,
            int(coef), int(lay.resident), P, lay.tile_rows, lay.col_halo,
            lay.stages, lay.coef_stages, n_iterations, blocks)
        if lay.resident:
            trace.count("resident.stream_real")
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

    CUDA tensors launch the kernel (``launch.stream_real``
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


def stream_cg_real_coef_planes(offsets: Sequence[Offset],
                               coefp: torch.Tensor, bp: torch.Tensor,
                               x0p: torch.Tensor, n_iterations: int,
                               cpad: torch.Tensor = None):
    """Fixed-iteration single-RHS CG on a real stencil's coefficient planes
    (``coefp`` from :func:`prepare_stream_coef_real`); returns as
    :func:`stream_cg_real_planes`, whose count its launches add to.

    cpad : the planes at the kernel's pitch (:func:`pad_real_planes`), made
           once for many launches on one grid.  None costs each launch a
           full copy of the planes (335 MB at N = 4096 with 5 taps).
           coefp may be the view ``cpad[..., :Nh]``, so that only the copy
           is kept.  Read on a card only.

    CPU tensors run :func:`stream_cg_real_coef_planes_plain`."""
    _check_coef(offsets, coefp, bp, x0p, n_iterations)
    if bp.device.type == "cuda":
        return _launch(offsets, coefp, None, bp, x0p, n_iterations, cpad)
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


def solve_real_planes(offsets, prepared, bp, x0p, n_iterations, cpad=None):
    """One RHS through the mode ``prepared`` (from :func:`prepare_real`)
    names; ``cpad``: coef mode's planes at the kernel's pitch (see
    :func:`stream_cg_real_coef_planes`)."""
    mode, operand = prepared
    if mode == "const":
        taps, strips = operand
        return stream_cg_real_planes(offsets, tuple(bp.shape), taps, strips,
                                     bp, x0p, n_iterations)
    return stream_cg_real_coef_planes(offsets, operand, bp, x0p,
                                      n_iterations, cpad=cpad)


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
