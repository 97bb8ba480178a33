"""Fixed-iteration COCG on constant-tap complex stencils beyond the whole-solve size (counterpart of ``tpcg/ops/stream_cg.py``, the planner's ``stream`` path).

``stream_cg_const_planes`` runs ``n_iterations`` of single-RHS complex COCG
on a stencil whose interior taps are constant, with the CG state (x, r and
the direction d) in device memory; ``stream_cg_const_planes_batched``
runs the same for B right-hand sides, each with its own alpha, beta and
freeze guard.  On CUDA tensors both launch the hand-written kernel
``tpcg_torch/csrc/stream_cg.cu`` (one persistent cooperative launch per
solve, or per chunk of at most ``kernel_limits()[2]`` RHS; see the note at
the top of that file) and raise if the kernel cannot run; the counter
``launch.stream_const`` of ``tpcg_torch.trace`` counts the launches of both.
Each RHS of a chunk gives the bits of its own single-RHS launch.  On CPU
tensors they run :func:`stream_cg_const_planes_plain` (per RHS), the same
function in plain PyTorch, which is also what the kernel is compared with
on the card.

The operator (``prepare_stream``) is the JAX package's: constant interior
taps, constant left/right edge taps applied to columns 0 and Nh-1 of every
row, and the bottom/top row strips, corner-adjusted so that the edge taps'
application on rows 0 and Nv-1 is cancelled where it does not belong.  A
neighbour outside the grid reads 0.

One Hopper kernel takes the place of the JAX package's tiers for this
function (v2 ``_build_kernels`` + ``_make_k2``, the batched
``_build_k1_const_batched`` + ``_make_k2_batched``, v3 const
``_build_merged``, v4 ``_build_resident``, v5 ``_build_v5``): their VMEM
budgets, row-block sizes, 128-lane column padding (``cpos``,
``pad_strips``), q-residency modes and the batched tier's chunk of 16 exist
for the TPU.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build, _tiles
from .fused_cg import _cdiv, _hist_row, _pad_for, _rr_grid, _udot_grid
from .fused_cg_const import split_const_stencil


def prepare_stream(stencil):
    """Host preprocessing of a constant-tap stencil for the streaming path.

    Returns ``(taps, strips)``:
      taps   : (cr, ci, lcr, lci, rcr, rci), six tuples of ``noff`` python
               floats: the interior taps and the left/right edge taps, as the
               JAX package's ``prepare_stream`` gives them (float64 values;
               the kernel and the plain version compute with their float32
               roundings, as the JAX kernels do with these scalars).
      strips : float32 tensor (2, 2, noff, Nh) on the stencil's device:
               [bottom, top] x [re, im] row corrections for rows 0 and Nv-1,
               adjusted at columns 0 and Nh-1 by the edge taps.
    Raises ValueError when the interior is not constant or an edge is not
    constant (the JAX planner then takes ``stream-coef``).
    """
    consts, strips = split_const_stencil(stencil)
    nh = stencil.grid[1]

    def _edge_const(a, name):
        if not np.allclose(a, a[:, :1], rtol=1e-12, atol=1e-14):
            raise ValueError(f"{name} edge coefficients not constant")
        return a[:, 0].copy()

    lc = _edge_const(strips["left"], "left")     # (noff,) complex
    rc = _edge_const(strips["right"], "right")
    sb = strips["bot"].copy()                    # (noff, Nh) complex
    st = strips["top"].copy()
    sb[:, 0] -= lc
    sb[:, nh - 1] -= rc
    st[:, 0] -= lc
    st[:, nh - 1] -= rc
    taps = (tuple(float(v) for v in consts.real),
            tuple(float(v) for v in consts.imag),
            tuple(float(v) for v in lc.real),
            tuple(float(v) for v in lc.imag),
            tuple(float(v) for v in rc.real),
            tuple(float(v) for v in rc.imag))
    planes = np.stack([np.stack([sb.real, sb.imag]),
                       np.stack([st.real, st.imag])]).astype(np.float32)
    return taps, torch.from_numpy(planes).to(stencil.device)


def _taps32(taps):
    """The six tap tuples as float32 values (python floats)."""
    return [[float(np.float32(v)) for v in t] for t in taps]


def _check_args(offsets, grid, taps, strips, b, x0, n_iterations,
                batched=False):
    nv, nh = grid
    noff = len(offsets)
    if len(taps) != 6 or any(len(t) != noff for t in taps):
        raise ValueError(f"taps must be six tuples of {noff} values")
    if tuple(strips.shape) != (2, 2, noff, nh):
        raise ValueError(f"strips must be (2, 2, {noff}, {nh}), got "
                         f"{tuple(strips.shape)}")
    if batched:
        if (b.dim() != 4 or b.shape[0] != 2 or b.shape[1] < 1
                or tuple(b.shape[2:]) != (nv, nh)):
            raise ValueError(f"b must be (2, B, {nv}, {nh}) with B >= 1, got "
                             f"{tuple(b.shape)}")
    elif tuple(b.shape) != (2, nv, nh):
        raise ValueError(f"b must be (2, {nv}, {nh}), got {tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("strips", strips), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def _edge_sum(cr, ci, xs, sel):
    """sum_s (cr_s + i ci_s) * x_s[sel], accumulated from 0 in tap order;
    cr_s / ci_s are python floats or tensors broadcasting against
    x_s[sel]."""
    ar = ai = 0.0
    for s, (xr, xi) in enumerate(xs):
        xr, xi = xr[sel], xi[sel]
        ar = ar + cr[s] * xr - ci[s] * xi
        ai = ai + cr[s] * xi + ci[s] * xr
    return ar, ai


def apply_const_planes(offsets, taps, strips, xp):
    """q = A x on (2, Nv, Nh) float32 planes, with the operator of
    :func:`prepare_stream` (the counterpart of
    ``tpcg/ops/stream_cg_v5.py::apply_const_planes_xla`` without ``cpos``).

    The kernel's order of operations, step for step: the interior taps in
    tap order; then, each summed from 0 over the taps and added to q, the
    left edge taps on column 0, the right edge taps on column Nh-1, the
    bottom strip on row 0 and the top strip on row Nv-1.
    """
    cr, ci, lcr, lci, rcr, rci = _taps32(taps)
    _, nv, nh = xp.shape
    P = _pad_for(offsets)
    xpad = torch.nn.functional.pad(xp, (P, P, P, P))
    xs = [(xpad[0, P + dm:P + dm + nv, P + dj:P + dj + nh],
           xpad[1, P + dm:P + dm + nv, P + dj:P + dj + nh])
          for dm, dj in offsets]
    qr = torch.zeros_like(xp[0])
    qi = torch.zeros_like(xp[0])
    for s, (xr, xi) in enumerate(xs):
        qr = qr + cr[s] * xr - ci[s] * xi
        qi = qi + cr[s] * xi + ci[s] * xr
    col0, coln = (slice(None), 0), (slice(None), nh - 1)
    for sel, (er, ei) in ((col0, (lcr, lci)), (coln, (rcr, rci))):
        ar, ai = _edge_sum(er, ei, xs, sel)
        qr[sel] = qr[sel] + ar
        qi[sel] = qi[sel] + ai
    for sel, k in (((0, slice(None)), 0), ((nv - 1, slice(None)), 1)):
        ar, ai = _edge_sum(strips[k, 0], strips[k, 1], xs, sel)
        qr[sel] = qr[sel] + ar
        qi[sel] = qi[sel] + ai
    return torch.stack([qr, qi])


def cocg_planes_plain(apply, bp: torch.Tensor, x0p: torch.Tensor,
                      n_iterations: int, dot_dtype=torch.float32):
    """The v2 iteration of the JAX package, step for step, for any operator
    ``apply`` on (2, Nv, Nh) float32 planes: the plain version of the
    streaming kernels.  ``dot_dtype`` is the type the dot products are
    summed in before they are rounded to float32 (float64 for the
    symmetric-coefficient kernel, float32 for the constant-tap one).

    r0 = b - A x0; then per iteration d = r + beta d, q = A d,
    alpha = delta / <d,q>, x += alpha d, r -= alpha q, delta' = <r,r>,
    beta = delta' / delta, with unconjugated dots, Smith division, and the
    freeze guard ``done = (delta == 0) | (<d,q> == 0)`` (both parts),
    evaluated afresh every iteration, zeroing alpha and beta.  History
    ``sqrt(sqrt(delta_r^2 + delta_i^2))``, n_iterations + 1 rows.
    """
    def udot(a, b):
        return _udot_grid(a.to(dot_dtype), b.to(dot_dtype)).to(bp.dtype)

    def rr(r):
        return _rr_grid(r.to(dot_dtype)).to(bp.dtype)

    x = x0p.clone()
    r = bp - apply(x0p)
    d = torch.zeros_like(bp)
    delta = rr(r)
    hist = [_hist_row(delta)]
    beta = torch.zeros_like(delta)
    zero = torch.zeros_like(delta[0])
    for _ in range(n_iterations):
        d = torch.stack([r[0] + beta[0] * d[0] - beta[1] * d[1],
                         r[1] + beta[0] * d[1] + beta[1] * d[0]])
        q = apply(d)
        dq = udot(d, q)
        done = ((delta[0] == 0) & (delta[1] == 0)) \
            | ((dq[0] == 0) & (dq[1] == 0))
        a_r, a_i = _cdiv(delta[0], delta[1], torch.where(done, 1.0, dq[0]),
                         torch.where(done, 0.0, dq[1]))
        a_r, a_i = torch.where(done, zero, a_r), torch.where(done, zero, a_i)
        x = torch.stack([x[0] + a_r * d[0] - a_i * d[1],
                         x[1] + a_r * d[1] + a_i * d[0]])
        r = torch.stack([r[0] - (a_r * q[0] - a_i * q[1]),
                         r[1] - (a_r * q[1] + a_i * q[0])])
        dn = rr(r)
        hist.append(_hist_row(dn))
        b_r, b_i = _cdiv(dn[0], dn[1], torch.where(done, 1.0, delta[0]),
                         torch.where(done, 0.0, delta[1]))
        beta = torch.stack([torch.where(done, zero, b_r),
                            torch.where(done, zero, b_i)])
        delta = dn
    return x, torch.stack(hist)


def stream_cg_const_planes_plain(offsets: Sequence[Tuple[int, int]], grid,
                                 taps, strips: torch.Tensor,
                                 bp: torch.Tensor, x0p: torch.Tensor,
                                 n_iterations: int):
    """Plain PyTorch version of the kernel: :func:`cocg_planes_plain` with
    the operator of :func:`apply_const_planes`."""
    _check_args(offsets, grid, taps, strips, bp, x0p, n_iterations)
    return cocg_planes_plain(
        lambda v: apply_const_planes(offsets, taps, strips, v), bp, x0p,
        n_iterations)


def stream_cg_const_planes_batched_plain(offsets: Sequence[Tuple[int, int]],
                                         grid, taps, strips: torch.Tensor,
                                         bp: torch.Tensor, x0p: torch.Tensor,
                                         n_iterations: int):
    """Plain version of the batched kernel: each RHS of (2, B, Nv, Nh)
    planes through :func:`stream_cg_const_planes_plain` (the RHS share
    nothing but the operator); returns x (2, B, Nv, Nh) and the history
    (n_iterations + 1, B)."""
    _check_args(offsets, grid, taps, strips, bp, x0p, n_iterations,
                batched=True)
    runs = [stream_cg_const_planes_plain(offsets, grid, taps, strips,
                                         bp[:, c], x0p[:, c], n_iterations)
            for c in range(bp.shape[1])]
    return (torch.stack([x for x, _ in runs], dim=1),
            torch.stack([h for _, h in runs], dim=1))


# The kernel's tile and ring (csrc/stream_cg.cu), from the sweep of
# probes/stream_cg_phases.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# Findings): tile rows, ring slots and the most blocks an SM.
TILE_ROWS = 16
STAGES = 2
BLOCKS_PER_SM = 2
TILE_COLS = 128


class StreamLayout(NamedTuple):
    """Where ``csrc/stream_cg.cu`` keeps its state and how it tiles it."""
    pitch: int        # row pitch of r, d and the working x (floats)
    tile_rows: int    # a tile is tile_rows x TILE_COLS nodes
    col_halo: int     # box columns each side of a tile: pad rounded up to 4
    box_rows: int     # halo box: tile_rows + 2 pad rows ...
    box_cols: int     # ... by TILE_COLS + 2 col_halo columns
    stages: int       # ring slots of shared memory, one mbarrier each
    blocks_per_sm: int
    tiles: int        # tiles of the grid
    smem_bytes: int   # the ring's dynamic shared memory
    bytes_a: float    # bytes a node and RHS: phase A (r, d_old halos; d')
    bytes_b: float    # phase B (d' halo; r, x read and written)


def stream_layout(nv: int, nh: int, pad: int, tile_rows: int = None,
                  stages: int = None) -> StreamLayout:
    """The layout of one launch of ``csrc/stream_cg.cu`` on an (nv, nh) grid
    with a stencil of reach ``pad`` (defaults: the module's ``TILE_ROWS``,
    ``STAGES``, ``BLOCKS_PER_SM``).

    The pitch, the column halo and the box are the streaming kernels'
    (``_tiles``).  Bytes a node and RHS per iteration, with h = box / tile
    - 1 the halo's share: phase A 16 (1 + h) + 8, phase B 8 (1 + h) + 32.
    ``smem_bytes`` is the kernel's own formula (``smem_bytes`` in the
    source)."""
    rows = TILE_ROWS if tile_rows is None else tile_rows
    stages = STAGES if stages is None else stages
    box = _tiles.box(nv, nh, pad, rows, TILE_COLS)
    halo = _tiles.round_up(2 * box.rows * box.cols, 32)
    own = 2 * rows * TILE_COLS
    stage = max(2 * halo, halo + 2 * own)
    return StreamLayout(_tiles.pitch(nh, pad), rows, _tiles.col_halo(pad),
                        box.rows, box.cols, stages, BLOCKS_PER_SM, box.tiles,
                        4 * stages * stage, 16 * box.share + 8,
                        8 * box.share + 32)


def kernel_limits() -> Tuple[int, int, int]:
    """(max taps, max stencil pad, max RHS in one launch) of the CUDA
    kernel."""
    return _build.query("tpcg_stream_cg_limits")


def grid_blocks(nv: int, nh: int, pad: int, nb: int) -> int:
    """Blocks of one launch of the nb-RHS instance on an (nv, nh) grid on
    the current CUDA device, with :func:`stream_layout`'s tiles: the
    single-RHS grid, whatever nb."""
    lay = stream_layout(nv, nh, pad)
    return _build.query("tpcg_stream_cg_grid", nb, nv, nh, lay.pitch, pad,
                        lay.tile_rows, lay.col_halo, lay.stages,
                        lay.blocks_per_sm)[0]


def _launch(offsets, grid, taps, strips, bp, x0p, n_iterations,
            chunk=None):
    """Launch the CUDA kernel on the current stream of bp's device for the
    (2, B, Nv, Nh) planes bp, once per chunk of at most ``chunk`` RHS (the
    kernel's limit by default), queued with no host sync; returns x
    (2, B, Nv, Nh) and the history (n_iterations + 1, B)."""
    nv, nh = grid
    n = nv * nh
    noff = len(offsets)
    nb = bp.shape[1]
    P = _pad_for(offsets)
    max_taps, max_pad, max_rhs = kernel_limits()
    chunk = max_rhs if chunk is None else chunk
    if noff > max_taps or P > max_pad or not 1 <= chunk <= max_rhs:
        raise ValueError(f"kernel takes at most {max_taps} taps within "
                         f"{max_pad} nodes and {max_rhs} RHS a launch, got "
                         f"{noff} taps within {P} and chunks of {chunk}")
    strips, bp, x0p = strips.contiguous(), bp.contiguous(), x0p.contiguous()
    dev = bp.device
    m = min(nb, chunk)
    lay = stream_layout(nv, nh, P)
    with _build.launch("stream_const", dev) as run:
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.empty_like(bp)
        # state for the largest chunk in the kernel's padded rows, reused by
        # the chunks in turn; the columns past nh stay zero
        r = torch.zeros((m, 2, nv, lay.pitch), **f32)
        d = torch.zeros((2, m, 2, nv, lay.pitch), **f32)
        xw = torch.zeros((m, 2, nv, lay.pitch), **f32)
        offs = _build.ints(v for tap in offsets for v in tap)
        tap_vals = _build.floats(v for t in _taps32(taps) for v in t)
        hists = []
        for lo in range(0, nb, chunk):
            k = min(chunk, nb - lo)
            blocks = grid_blocks(nv, nh, P, k)
            hist = torch.empty((n_iterations + 1, k), **f32)
            part = torch.empty((2, k, blocks, 2), **f32)
            run("tpcg_stream_cg",
                bp[:, lo].data_ptr(), x0p[:, lo].data_ptr(),
                strips.data_ptr(), x[:, lo].data_ptr(), hist.data_ptr(),
                r.data_ptr(), d.data_ptr(), xw.data_ptr(), part.data_ptr(),
                k, nb * n, nv, nh, lay.pitch, noff, offs, tap_vals, P,
                lay.tile_rows, lay.col_halo, lay.stages, n_iterations,
                blocks)
            hists.append(hist)
    return x, hists[0] if len(hists) == 1 else torch.cat(hists, dim=1)


def stream_cg_const_planes(offsets: Sequence[Tuple[int, int]], grid, taps,
                           strips: torch.Tensor, bp: torch.Tensor,
                           x0p: torch.Tensor, n_iterations: int):
    """Fixed-iteration single-RHS complex COCG on a constant-tap stencil.

    offsets : stencil offsets ((dm, dj), ...).
    grid    : (Nv, Nh).
    taps, strips : from :func:`prepare_stream`.
    bp, x0p : (2, Nv, Nh) float32 RHS / initial-guess planes.
    Returns (x_planes (2, Nv, Nh), residual_history (n_iterations+1,)).

    CUDA tensors launch the kernel's single-RHS instance
    (``launch.stream_const`` counts the launches); CPU tensors
    run :func:`stream_cg_const_planes_plain`.
    """
    _check_args(offsets, grid, taps, strips, bp, x0p, n_iterations)
    if bp.device.type == "cuda":
        x, hist = _launch(offsets, grid, taps, strips, bp[:, None],
                          x0p[:, None], n_iterations)
        return x[:, 0], hist[:, 0]
    if bp.device.type == "cpu":
        return stream_cg_const_planes_plain(offsets, grid, taps, strips, bp,
                                            x0p, n_iterations)
    raise ValueError(f"no stream_cg_const_planes for device {bp.device}")


def stream_cg_const_planes_batched(offsets: Sequence[Tuple[int, int]], grid,
                                   taps, strips: torch.Tensor,
                                   bp: torch.Tensor, x0p: torch.Tensor,
                                   n_iterations: int, chunk: int = None):
    """B right-hand sides at once, each with its own alpha, beta and freeze
    guard (the function and contract of JAX's
    ``stream_cg_const_planes_batched``).

    bp, x0p : (2, B, Nv, Nh) float32 planes; taps, strips from
              :func:`prepare_stream`.
    chunk   : RHS a launch on a card, at most (and by default) the
              kernel's ``kernel_limits()[2]``.
    Returns (x (2, B, Nv, Nh), residual_history (n_iterations+1, B)).

    CUDA tensors launch the kernel once per chunk of RHS (counted in
    ``launch.stream_const``), queued on the current stream with
    no host sync; each RHS gives the bits of its own single-RHS launch, so
    the chunking changes no result.  CPU tensors run
    :func:`stream_cg_const_planes_batched_plain`.
    """
    _check_args(offsets, grid, taps, strips, bp, x0p, n_iterations,
                batched=True)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if bp.device.type == "cuda":
        return _launch(offsets, grid, taps, strips, bp, x0p, n_iterations,
                       chunk)
    if bp.device.type == "cpu":
        return stream_cg_const_planes_batched_plain(offsets, grid, taps,
                                                    strips, bp, x0p,
                                                    n_iterations)
    raise ValueError(f"no stream_cg_const_planes_batched for device "
                     f"{bp.device}")


def stream_cg_const(stencil, b, x0=None, n_iterations: int = 10):
    """Convenience wrapper: a complex (Nv, Nh) numpy grid in, device planes
    out, on the stencil's device (see :func:`stream_cg_const_planes`)."""
    nv, nh = stencil.grid
    dev = stencil.device
    taps, strips = prepare_stream(stencil)

    def planes(z):
        z = np.asarray(z).reshape(nv, nh)
        return torch.from_numpy(
            np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    bp = planes(b)
    x0p = torch.zeros_like(bp) if x0 is None else planes(x0)
    return stream_cg_const_planes(stencil.offsets, stencil.grid, taps, strips,
                                  bp, x0p, n_iterations)
