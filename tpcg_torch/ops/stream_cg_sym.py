"""Fixed-iteration COCG on symmetric variable-coefficient complex stencils (counterpart of ``tpcg/ops/stream_cg_v4_sym.py`` and ``stream_cg_v5_sym.py``, the planner's ``stream-coef`` path).

CG needs a symmetric operator, and a symmetric stencil's ``noff`` coefficient
planes hold every value twice: ``plane_{-s}(n) = A[n, n-s] = A[n-s, n] =
plane_s(n - s)``.  :func:`prepare_stream_sym` keeps the centre plane and one
plane per offset pair (the half planes), and :func:`apply_sym_planes`
applies each pair as

    q(n) += c_s(n) x(n+s) + c_s(n-s) x(n-s),

a coefficient or a neighbour outside the grid reading 0.

``stream_cg_sym_planes`` runs ``n_iterations`` of single-RHS complex COCG
with this operator, the CG state (x, r, the direction d and q = A d) in
device memory.  On a CUDA tensor it launches the hand-written kernel
``tpcg_torch/csrc/stream_cg_sym.cu`` (one persistent cooperative launch per
solve; :func:`sym_layout` gives its tiles and rings, and it reads the half
planes copied to its padded row pitch, :func:`pad_sym_planes`; see the note
at the top of that file) and raises if the kernel cannot run.  On a CPU
tensor it runs :func:`stream_cg_sym_planes_plain`, the same function in
plain PyTorch, which is also what the kernel is compared with on the card.

One Hopper kernel takes the place of the JAX package's tiers for this
function: v4-sym (``_build_resident_sym``), v5-sym (``_build_v5_sym``) and,
for symmetric stencils, v2-coef (``_build_k1_coef`` + ``_make_k2``) and
v3-coef (``_build_merged``, coefficient variant).  Their row blocks, VMEM
budgets, q modes and 128-lane alignment exist for the TPU; so does the JAX
planner's row padding of heights it cannot stream (``pad->``): the kernel
reads any height and width.

Two deliberate differences from JAX:

* JAX forms r0 = b - A x0 with the general coefficient kernel
  (``_build_k1_coef``) over full planes rebuilt from the half planes
  (``reconstruct_coef``); the port applies the half-plane operator for r0
  too, so no full planes are needed on the device.  Only the order of the
  additions in A x0 differs, and with x0 = 0 both give r0 = b exactly.
* The dot products <d, q> and <r, r> are summed in float64 and rounded to
  float32 once (JAX sums them in float32 by row blocks); every other step
  is float32.  On this class float32 COCG is sensitive to the order of its
  sums: on helm_fe_var(1024, 40, C, rho=0.1) the iteration with float32
  sums lies a quarter of max|x| from the one with float64 sums after 100
  iterations (``chip_smoke.py`` prints this spread at every size).  With
  float64 sums the kernel and this plain version nearly always round to
  the same float32 scalars, and a rare difference is one float32 ulp, not
  a float32-order spread, so the kernel can be held to its plain version
  at full size; the result is also nearer the exact iteration than a
  float32 order.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build, _tiles
from .. import trace
from .fused_cg import _pad_for
from .stream_cg import cocg_planes_plain
from .stream_cg_coef import pad_rows

Offset = Tuple[int, int]


def _shift(p: torch.Tensor, dm: int, dj: int) -> torch.Tensor:
    """out[..., m, j] = p[..., m - dm, j - dj], zero where that leaves the
    grid."""
    nv, nh = p.shape[-2:]
    out = torch.zeros_like(p)
    out[..., max(dm, 0):nv + min(dm, 0), max(dj, 0):nh + min(dj, 0)] = \
        p[..., max(-dm, 0):nv + min(-dm, 0), max(-dj, 0):nh + min(-dj, 0)]
    return out


def prepare_stream_sym(stencil) -> Tuple[List[Offset], torch.Tensor]:
    """Half-plane operands of a symmetric stencil (``tpcg/ops/
    stream_cg_v4_sym.py::prepare_stream_sym``).

    Returns ``(half_offsets, cplanes)``: ``[(0, 0)]`` followed by the offsets
    greater than (0, 0) in the stencil's order, and the float32 tensor
    (2, nH1, Nv, Nh) of their coefficient planes, [re, im], on the stencil's
    device (bit for bit JAX's).  Raises ValueError when the stencil has no
    centre tap, an offset lacks its mirror, or a pair fails
    ``plane_{-s}(n) == plane_s(n - s)`` at rtol 1e-12, atol 1e-13 (JAX's
    ``np.allclose``; the test runs on the stencil's device).
    """
    c = stencil.coef
    offsets = [tuple(int(v) for v in o) for o in stencil.offsets]
    idx = {o: i for i, o in enumerate(offsets)}
    half = [o for o in offsets if o > (0, 0)]
    if (0, 0) not in idx:
        raise ValueError("stencil has no centre tap")
    for o in offsets:
        if o != (0, 0) and (-o[0], -o[1]) not in idx:
            raise ValueError(f"offset {o} has no mirror; not symmetric")
    for dm, dj in half:
        if not torch.allclose(c[idx[(-dm, -dj)]], _shift(c[idx[(dm, dj)]],
                                                          dm, dj),
                              rtol=1e-12, atol=1e-13):
            raise ValueError(
                f"coefficients not symmetric across offset {(dm, dj)}")
    planes = torch.stack([c[idx[(0, 0)]]] + [c[idx[o]] for o in half])
    imag = planes.imag if planes.is_complex() else torch.zeros_like(planes)
    return [(0, 0)] + half, torch.stack([planes.real, imag]).to(torch.float32)


def reconstruct_coef(offsets: Sequence[Offset], half_offsets: Sequence[Offset],
                     cplanes: torch.Tensor) -> torch.Tensor:
    """(2, nH1, Nv, Nh) half planes -> (2, noff, Nv, Nh) full planes in the
    ``offsets`` order, ``plane_{-s}(n) = plane_s(n - s)`` with zero fill
    (``tpcg/ops/stream_cg_v4_sym.py::reconstruct_coef``)."""
    half_idx = {tuple(o): i for i, o in enumerate(half_offsets)}
    planes = []
    for dm, dj in (tuple(o) for o in offsets):
        if (dm, dj) in half_idx:
            planes.append(cplanes[:, half_idx[(dm, dj)]])
        else:
            planes.append(_shift(cplanes[:, half_idx[(-dm, -dj)]], -dm, -dj))
    return torch.stack(planes, dim=1)


def apply_sym_planes(half_offsets: Sequence[Offset], cplanes: torch.Tensor,
                     xp: torch.Tensor) -> torch.Tensor:
    """q = A x on (2, Nv, Nh) float32 planes from the half planes.

    The order of JAX's ``emit_q`` (``stream_cg_v4_sym.py:218-242``) and of
    the kernel, step for step: from q = 0, the centre term, then for each
    half offset s its down term c_s(n) x(n+s) and its mirrored up term
    c_s(n-s) x(n-s), each as ``q_re + c_re x_re - c_im x_im``,
    ``q_im + c_re x_im + c_im x_re``.  Outside the grid both the
    coefficients and x read 0, as JAX's zero-filled padded scratch does.
    """
    _, nv, nh = xp.shape
    P = _pad_for(half_offsets)
    xpad = torch.nn.functional.pad(xp, (P, P, P, P))
    cpad = torch.nn.functional.pad(cplanes, (P, P, P, P))

    def win(t, dm, dj):
        return t[..., P + dm:P + dm + nv, P + dj:P + dj + nh]

    qr = torch.zeros_like(xp[0])
    qi = torch.zeros_like(xp[0])
    for t, (dm, dj) in enumerate(half_offsets):
        terms = [(cplanes[:, t], win(xpad, dm, dj))]
        if (dm, dj) != (0, 0):
            terms.append((win(cpad[:, t], -dm, -dj), win(xpad, -dm, -dj)))
        for (cr, ci), (xr, xi) in terms:
            qr = qr + cr * xr - ci * xi
            qi = qi + cr * xi + ci * xr
    return torch.stack([qr, qi])


def _check_args(half_offsets, cplanes, b, x0, n_iterations):
    half_offsets = [tuple(o) for o in half_offsets]
    if (not half_offsets or half_offsets[0] != (0, 0)
            or any(o <= (0, 0) for o in half_offsets[1:])):
        raise ValueError(f"half_offsets must be (0, 0) followed by offsets "
                         f"greater than (0, 0), got {half_offsets}")
    if cplanes.dim() != 4 or tuple(cplanes.shape[:2]) != (2,
                                                          len(half_offsets)):
        raise ValueError(f"cplanes must be (2, {len(half_offsets)}, Nv, Nh), "
                         f"got {tuple(cplanes.shape)}")
    nv, nh = cplanes.shape[2:]
    if tuple(b.shape) != (2, nv, nh):
        raise ValueError(f"b must be (2, {nv}, {nh}), got {tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("cplanes", cplanes), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def stream_cg_sym_planes_plain(half_offsets: Sequence[Offset],
                               cplanes: torch.Tensor, bp: torch.Tensor,
                               x0p: torch.Tensor, n_iterations: int):
    """Plain PyTorch version of the kernel: the iteration of
    ``stream_cg.cocg_planes_plain`` (unconjugated dots, Smith division, the
    exact-zero freeze guard ``(delta == 0) | (<d,q> == 0)`` that JAX's sym
    kernels use too) with the operator of :func:`apply_sym_planes`, the dot
    products summed in float64 and rounded to float32 (see the module
    note)."""
    _check_args(half_offsets, cplanes, bp, x0p, n_iterations)
    return cocg_planes_plain(
        lambda v: apply_sym_planes(half_offsets, cplanes, v), bp, x0p,
        n_iterations, dot_dtype=torch.float64)


def kernel_limits() -> Tuple[int, int]:
    """(max half offsets, max stencil pad) of the CUDA kernel."""
    return _build.query("tpcg_stream_sym_limits")


# The kernel's tile and rings (csrc/stream_cg_sym.cu), from the sweep of
# probes/stream_cg_phases.py --kernel sym on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, Findings): tile rows, state ring slots, coefficient ring
# slots and the most blocks an SM.
TILE_ROWS = 8
STAGES = 2
COEF_STAGES = 1
BLOCKS_PER_SM = 2
TILE_COLS = 128             # 64 where a 128-column tile's rings do not fit


class SymLayout(NamedTuple):
    """Where ``csrc/stream_cg_sym.cu`` keeps its state and how it tiles
    it."""
    pitch: int          # row pitch of r, d, q, the working x and the half
                        # planes' copy (floats)
    tile_rows: int      # a tile is tile_rows x tile_cols nodes
    tile_cols: int
    col_halo: int       # box columns each side of a tile: pad rounded up to 4
    box_rows: int       # state box: tile_rows + 2 pad rows ...
    box_cols: int       # ... by tile_cols + 2 col_halo columns
    coef_rows: int      # coefficient box: tile_rows + pad rows by box_cols
    stages: int         # state ring slots: r and d_old boxes each
    coef_stages: int    # coefficient ring slots: a tile's 2 nh1 planes each
    blocks_per_sm: int
    tiles: int          # tiles of the grid
    smem_bytes: int     # the rings' dynamic shared memory
    bytes_a: float      # bytes a node: phase A (r, d_old halos; d', q; x
                        # read and written; the half planes with their halo)
    bytes_b: float      # phase B (r, q read; r written)


def _ring_bytes(rows, cols, pad, hc, nh1, stages, coef_stages):
    """The kernel's ``smem_bytes``: coefficient slots of tile_rows + pad
    box rows of 2 nh1 planes, state slots of two halo boxes (both planes);
    each box rounded up to 32 floats."""
    bc = cols + 2 * hc
    box = _tiles.round_up(2 * (rows + 2 * pad) * bc, 32)
    cbox = _tiles.round_up((rows + pad) * 2 * nh1 * bc, 32)
    return 4 * (coef_stages * cbox + stages * 2 * box)


_SHRINK = (("coef_stages", 1, _tiles.one_less), ("rows", 2, _tiles.half),
           ("cols", 64, _tiles.half), ("rows", 1, _tiles.half))


def sym_layout(nv: int, nh: int, pad: int, nh1: int, tile_rows: int = None,
               stages: int = None, coef_stages: int = None) -> SymLayout:
    """The layout of a launch of ``csrc/stream_cg_sym.cu`` on an (nv, nh)
    grid with ``nh1`` half planes within ``pad`` nodes (defaults: the
    module's ``TILE_ROWS``, ``STAGES``, ``COEF_STAGES``,
    ``BLOCKS_PER_SM``).

    The pitch, the column halo and the state box are the streaming
    kernels' (``_tiles``); the half planes are copied to the same pitch
    (:func:`pad_sym_planes`); the coefficient box also starts ``pad`` rows
    above the tile, for the mirrored terms c_s(n - s).  Where the rings
    would pass a block's shared memory (large pads and half-plane counts),
    the layout drops to one coefficient slot, halves the tile down to two
    rows, narrows it to 64 columns, then to one row: every pad and
    half-plane count the kernel takes (:func:`kernel_limits`: 8 and 16)
    runs.  Bytes a node per iteration, with h_s and h_c the halo's shares
    of a state and a coefficient box (box / tile - 1): phase A 16 (1 + h_s)
    + 32 + 8 nh1 (1 + h_c), phase B 24 (the kernel defers x += alpha d'
    into the next phase A; the pitch's zero columns not counted)."""
    stages = STAGES if stages is None else stages
    hc = _tiles.col_halo(pad)
    fit, smem = _tiles.shrink(
        functools.partial(_ring_bytes, pad=pad, hc=hc, nh1=nh1,
                          stages=stages),
        dict(rows=TILE_ROWS if tile_rows is None else tile_rows,
             cols=TILE_COLS,
             coef_stages=COEF_STAGES if coef_stages is None else coef_stages),
        _SHRINK, f"no ring of {stages} slots fits a block at pad {pad} "
        f"with {nh1} half planes")
    rows, cols = fit["rows"], fit["cols"]
    box = _tiles.box(nv, nh, pad, rows, cols)
    share_c = (rows + pad) * box.cols / (rows * cols)
    return SymLayout(_tiles.pitch(nh, pad), rows, cols, hc, box.rows,
                     box.cols, rows + pad, stages, fit["coef_stages"],
                     _tiles.blocks_per_sm(smem, BLOCKS_PER_SM), box.tiles,
                     smem, 16 * box.share + 32 + 8 * nh1 * share_c, 24.0)


def pad_sym_planes(half_offsets: Sequence[Offset],
                   cplanes: torch.Tensor) -> torch.Tensor:
    """The half planes (2, nH1, Nv, Nh) copied to the kernel's pitch
    (:func:`sym_layout`), zero past column Nh: the operand every launch on
    the grid reads.  A plan makes it once (``auto``'s ``stream-coef``
    branch); the counter ``copy.pad_sym_planes`` of ``tpcg_torch.trace``
    counts the copies."""
    _, nh1, nv, nh = cplanes.shape
    pitch = sym_layout(nv, nh, _pad_for(half_offsets), nh1).pitch
    trace.count("copy.pad_sym_planes")
    return pad_rows(cplanes, pitch).contiguous()


def grid_blocks(nv: int, nh: int, pad: int, nh1: int) -> int:
    """Blocks of one launch on an (nv, nh) grid on the current CUDA device,
    with :func:`sym_layout`'s tiles (one block a tile, at most as many as the
    card holds at once)."""
    lay = sym_layout(nv, nh, pad, nh1)
    return _build.query("tpcg_stream_sym_grid", nv, nh, lay.pitch, pad, nh1,
                        lay.tile_rows, lay.tile_cols, lay.col_halo,
                        lay.stages, lay.coef_stages, lay.blocks_per_sm)[0]


def _launch(half_offsets, cplanes, bp, x0p, n_iterations, cpad):
    """Launch the CUDA kernel on the current stream of bp's device; cpad:
    the half planes at the kernel's pitch (:func:`pad_sym_planes`), or None
    to copy them for this launch (a full copy of the half planes)."""
    _, nh1, nv, nh = cplanes.shape
    P = _pad_for(half_offsets)
    max_half, max_pad = kernel_limits()
    if nh1 > max_half or P > max_pad:
        raise ValueError(f"kernel takes at most {max_half} half offsets "
                         f"within {max_pad} nodes, got {nh1} within {P}")
    bp, x0p = bp.contiguous(), x0p.contiguous()
    dev = bp.device
    lay = sym_layout(nv, nh, P, nh1)
    if cpad is None:
        cpad = pad_sym_planes(half_offsets, cplanes)
    if (tuple(cpad.shape) != (2, nh1, nv, lay.pitch)
            or cpad.dtype != torch.float32 or cpad.device != dev
            or not cpad.is_contiguous()):
        raise ValueError(f"cpad must be contiguous float32 (2, {nh1}, {nv}, "
                         f"{lay.pitch}) on {dev}, got {tuple(cpad.shape)} "
                         f"{cpad.dtype} on {cpad.device}")
    with _build.launch("stream_sym", dev) as run:
        blocks = grid_blocks(nv, nh, P, nh1)
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.empty_like(bp)
        hist = torch.empty((n_iterations + 1,), **f32)
        # state in the kernel's padded rows, zero past column nh
        r = torch.zeros((2, nv, lay.pitch), **f32)
        q = torch.zeros_like(r)
        xw = torch.zeros_like(r)
        d = torch.zeros((2, 2, nv, lay.pitch), **f32)
        part = torch.empty((2, blocks, 2), dtype=torch.float64, device=dev)
        offs = _build.ints(v for o in half_offsets for v in o)
        run("tpcg_stream_sym",
            bp.data_ptr(), x0p.data_ptr(), cpad.data_ptr(), x.data_ptr(),
            hist.data_ptr(), r.data_ptr(), q.data_ptr(), d.data_ptr(),
            xw.data_ptr(), part.data_ptr(), nv, nh, lay.pitch, nh1, offs, P,
            lay.tile_rows, lay.tile_cols, lay.col_halo, lay.stages,
            lay.coef_stages, n_iterations, blocks)
    return x, hist


def stream_cg_sym_planes(half_offsets: Sequence[Offset],
                         cplanes: torch.Tensor, bp: torch.Tensor,
                         x0p: torch.Tensor, n_iterations: int,
                         cpad: torch.Tensor = None):
    """Fixed-iteration single-RHS complex COCG on a symmetric stencil.

    half_offsets, cplanes : from :func:`prepare_stream_sym`.
    bp, x0p : (2, Nv, Nh) float32 RHS / initial-guess planes.
    cpad : the half planes at the kernel's pitch (:func:`pad_sym_planes`),
           made once for many launches on one grid.  None costs each launch
           a full copy of the half planes (0.54 GB at N = 4096 with 4 of
           them).  cplanes may be the view ``cpad[..., :Nh]``, so that only
           the copy is kept.  Read on a card only.
    Returns (x_planes (2, Nv, Nh), residual_history (n_iterations+1,)).

    CUDA tensors launch the kernel (``launch.stream_sym``
    counts the launches); CPU tensors run
    :func:`stream_cg_sym_planes_plain`.
    """
    _check_args(half_offsets, cplanes, bp, x0p, n_iterations)
    if bp.device.type == "cuda":
        return _launch(half_offsets, cplanes, bp, x0p, n_iterations, cpad)
    if bp.device.type == "cpu":
        return stream_cg_sym_planes_plain(half_offsets, cplanes, bp, x0p,
                                          n_iterations)
    raise ValueError(f"no stream_cg_sym_planes for device {bp.device}")


def stream_cg_sym(stencil, b, x0=None, n_iterations: int = 10):
    """Convenience wrapper: a complex (Nv, Nh) numpy grid in, device planes
    out, on the stencil's device (see :func:`stream_cg_sym_planes`)."""
    nv, nh = stencil.grid
    dev = stencil.device
    half_offsets, cplanes = prepare_stream_sym(stencil)

    def planes(z):
        z = np.asarray(z).reshape(nv, nh)
        return torch.from_numpy(
            np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    bp = planes(b)
    x0p = torch.zeros_like(bp) if x0 is None else planes(x0)
    return stream_cg_sym_planes(half_offsets, cplanes, bp, x0p, n_iterations)
