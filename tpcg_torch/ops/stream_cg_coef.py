"""Fixed-iteration COCG on general variable-coefficient complex stencils (counterpart of the general-coefficient part of ``tpcg/ops/stream_cg.py``, the planner's ``stream-coef`` path for non-symmetric stencils).

The operator is a complex 2-D stencil with a full coefficient plane per
offset (:func:`prepare_stream_coef`, (2, noff, Nv, Nh) float32):

    q(n) = sum_s c_s(n) x(n + s),

summed over the offsets in the stencil's order, a neighbour outside the grid
reading 0 whatever its coefficient says.  Nothing is assumed of the
coefficients, so this path takes the stencils that ``prepare_stream_sym``
refuses.

``stream_cg_coef_planes`` runs ``n_iterations`` of single-RHS complex COCG
with this operator, and ``stream_cg_coef_planes_batched_fat`` the same for B
right-hand sides with independent alpha and beta
(``stream_cg_coef_planes_batched`` is the same function under the name of
JAX's other batched entry point).  On CUDA tensors they launch the
hand-written kernel ``tpcg_torch/csrc/stream_cg_coef.cu`` (one persistent
cooperative launch per chunk of at most 8 RHS, which share one read of the
coefficient planes; :func:`coef_layout` gives its tiles and rings; see the
note at the top of that file) and raise if it cannot run;
the counter ``launch.stream_coef`` of ``tpcg_torch.trace`` counts the
launches of all of them.  On
CPU tensors they run their plain versions, the same functions in plain
PyTorch, which are also what the kernel is compared with on the card.

One Hopper kernel takes the place of the JAX package's tiers for this
function: v2 (``_build_k1_coef`` + ``_make_k2``), v3-coef (``_build_merged``),
v4-coef (``_build_resident``) and, for several RHS, the batched kernels
(``_build_k1_coef_batched`` and the fat ``_build_k1_coef_batched_fat``, each
with its K2).  Their row
blocks, VMEM budgets, ``keep_r``, the 128-row padding and the ``nb*Bv*Nh``
compile cap exist for the TPU: the kernel reads any height and width.

One deliberate difference from JAX, as on the symmetric path
(``stream_cg_sym.py``): the dot products <d, q> and <r, r> are summed in
float64 and rounded to float32 once (JAX sums them in float32 by row
blocks); every other step is float32, in JAX's order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build, _tiles
from .fused_cg import _pad_for
from .stream_cg import cocg_planes_plain

Offset = Tuple[int, int]


def prepare_stream_coef(stencil) -> torch.Tensor:
    """(2, noff, Nv, Nh) float32 coefficient planes [re, im] on the device of
    the stencil's coefficients (``tpcg/ops/stream_cg.py::
    prepare_stream_coef``: the same values, bit for bit)."""
    c = stencil.coef
    imag = c.imag if c.is_complex() else torch.zeros_like(c)
    real = c.real if c.is_complex() else c
    return torch.stack([real, imag]).to(torch.float32)


def apply_coef_planes(offsets: Sequence[Offset], coefp: torch.Tensor,
                      xp: torch.Tensor) -> torch.Tensor:
    """q = A x on (2, Nv, Nh) float32 planes.

    JAX's order (``stream_cg.py:538-544``) and the kernel's, step for step:
    from q = 0, for each offset s in the stencil's order,
    ``q_re + c_re x_re - c_im x_im`` and ``q_im + c_re x_im + c_im x_re``,
    with x(n + s) read from a zero border: a neighbour outside the grid
    reads 0.
    """
    _, nv, nh = xp.shape
    P = _pad_for(offsets)
    xpad = torch.nn.functional.pad(xp, (P, P, P, P))
    qr = torch.zeros_like(xp[0])
    qi = torch.zeros_like(xp[0])
    for s, (dm, dj) in enumerate(offsets):
        ar, ai = coefp[0, s], coefp[1, s]
        win = xpad[:, P + dm:P + dm + nv, P + dj:P + dj + nh]
        qr = qr + ar * win[0] - ai * win[1]
        qi = qi + ar * win[1] + ai * win[0]
    return torch.stack([qr, qi])


def _check_args(offsets, coefp, b, x0, n_iterations, batched):
    offsets = [tuple(o) for o in offsets]
    if not offsets:
        raise ValueError("offsets must not be empty")
    if coefp.dim() != 4 or tuple(coefp.shape[:2]) != (2, len(offsets)):
        raise ValueError(f"coefp must be (2, {len(offsets)}, Nv, Nh), got "
                         f"{tuple(coefp.shape)}")
    nv, nh = coefp.shape[2:]
    want = "(2, B, Nv, Nh)" if batched else "(2, Nv, Nh)"
    if (b.dim() != (4 if batched else 3) or b.shape[0] != 2
            or tuple(b.shape[-2:]) != (nv, nh)):
        raise ValueError(f"b must be {want} with (Nv, Nh) = {(nv, nh)}, got "
                         f"{tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("coefp", coefp), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def stream_cg_coef_planes_plain(offsets: Sequence[Offset],
                                coefp: torch.Tensor, bp: torch.Tensor,
                                x0p: torch.Tensor, n_iterations: int):
    """Plain PyTorch version of the kernel for one RHS: the iteration of
    ``stream_cg.cocg_planes_plain`` (unconjugated dots, Smith division, the
    exact-zero freeze guard ``(delta == 0) | (<d,q> == 0)`` evaluated every
    iteration, as JAX's K1/K2 do) with the operator of
    :func:`apply_coef_planes`, the dot products summed in float64 and
    rounded to float32."""
    _check_args(offsets, coefp, bp, x0p, n_iterations, batched=False)
    return cocg_planes_plain(
        lambda v: apply_coef_planes(offsets, coefp, v), bp, x0p,
        n_iterations, dot_dtype=torch.float64)


def stream_cg_coef_planes_batched_fat_plain(offsets: Sequence[Offset],
                                            coefp: torch.Tensor,
                                            bp: torch.Tensor,
                                            x0p: torch.Tensor,
                                            n_iterations: int):
    """Plain version of the batched kernel: each RHS of (2, B, Nv, Nh)
    planes through :func:`stream_cg_coef_planes_plain` (the RHS share
    nothing but the operator); returns x (2, B, Nv, Nh) and the history
    (n_iterations + 1, B)."""
    _check_args(offsets, coefp, bp, x0p, n_iterations, batched=True)
    runs = [stream_cg_coef_planes_plain(offsets, coefp, bp[:, c], x0p[:, c],
                                        n_iterations)
            for c in range(bp.shape[1])]
    return (torch.stack([x for x, _ in runs], dim=1),
            torch.stack([h for _, h in runs], dim=1))


def kernel_limits() -> Tuple[int, int, int]:
    """(max offsets, max stencil pad, max RHS in one launch) of the CUDA
    kernel."""
    return _build.query("tpcg_stream_coef_limits")


# The kernel's tile and rings (csrc/stream_cg_coef.cu), from the sweep of
# probes/stream_cg_phases.py --kernel coef on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, Findings): tile rows, state ring slots, coefficient ring
# slots and the most blocks an SM.
TILE_ROWS = 4
STAGES = 2
COEF_STAGES = 1
BLOCKS_PER_SM = 2
TILE_COLS = 128
MAX_OFF = 32                # the kernel's kMaxOff
MAX_RHS = 8                 # the kernel's kMaxRhs


class CoefLayout(NamedTuple):
    """Where ``csrc/stream_cg_coef.cu`` keeps its state and how it tiles
    it."""
    pitch: int          # row pitch of r, d, q, the working x and the
                        # coefficient copy (floats)
    tile_rows: int      # a tile is tile_rows x TILE_COLS nodes
    col_halo: int       # box columns each side of a tile: pad rounded up to 4
    box_rows: int       # halo box: tile_rows + 2 pad rows ...
    box_cols: int       # ... by TILE_COLS + 2 col_halo columns
    stages: int         # state ring slots: one RHS's r and d_old boxes each
    coef_stages: int    # coefficient ring slots: a tile's 2 noff planes each
    blocks_per_sm: int
    rhs_per_launch: int
    tiles: int          # tiles of the grid
    smem_bytes: int     # the rings' dynamic shared memory
    bytes_a: float      # bytes a node and RHS: phase A (r, d_old halos; d',
                        # q; the coefficients over the RHS of a launch)
    bytes_b: float      # phase B (x, d', r, q read; x, r written)


def _ring_bytes(rows, pad, hc, noff, stages, coef_stages):
    """The kernel's ``smem_bytes``: coefficient slots of 2 noff tile
    planes, state slots of two halo boxes (both planes, 32-float
    multiples)."""
    box = _tiles.round_up(2 * (rows + 2 * pad) * (TILE_COLS + 2 * hc), 32)
    return 4 * (coef_stages * 2 * noff * rows * TILE_COLS + stages * 2 * box)


_SHRINK = (("coef_stages", 1, _tiles.one_less), ("rows", 2, _tiles.half))


def coef_layout(nv: int, nh: int, pad: int, nb: int, noff: int = None,
                tile_rows: int = None, stages: int = None,
                coef_stages: int = None) -> CoefLayout:
    """The layout of a launch of ``csrc/stream_cg_coef.cu`` for nb RHS on an
    (nv, nh) grid with a stencil of ``noff`` offsets (default: the most a
    stencil of reach ``pad`` can have, at most ``MAX_OFF``) within ``pad``
    nodes (defaults: the module's ``TILE_ROWS``, ``STAGES``,
    ``COEF_STAGES``, ``BLOCKS_PER_SM``).

    The pitch, the column halo and the box are the streaming kernels'
    (``_tiles``); the coefficient planes are copied to the same pitch.
    Where the rings would pass a block's shared memory (large pads and
    offset counts), the layout drops to one coefficient slot, then halves
    the tile, down to two rows.  The tile, the rings and so the grid do not
    depend on nb: every RHS of a launch gives the bits of its own one-RHS
    launch, and a launch takes ``MAX_RHS`` RHS at every pad.  Bytes a node
    and RHS per iteration, with h = box / tile - 1 the halo's share: phase
    A 16 (1 + h) + 16 + 8 noff / nb, phase B 48 (the pitch's zero columns
    not counted)."""
    noff = min(MAX_OFF, (2 * pad + 1) ** 2) if noff is None else noff
    stages = STAGES if stages is None else stages
    hc = _tiles.col_halo(pad)
    fit, smem = _tiles.shrink(
        functools.partial(_ring_bytes, pad=pad, hc=hc, noff=noff,
                          stages=stages),
        dict(rows=TILE_ROWS if tile_rows is None else tile_rows,
             coef_stages=COEF_STAGES if coef_stages is None else coef_stages),
        _SHRINK, f"no ring of {stages} slots fits a block at pad {pad} "
        f"with {noff} offsets")
    box = _tiles.box(nv, nh, pad, fit["rows"], TILE_COLS)
    return CoefLayout(_tiles.pitch(nh, pad), fit["rows"], hc, box.rows,
                      box.cols, stages, fit["coef_stages"],
                      _tiles.blocks_per_sm(smem, BLOCKS_PER_SM), MAX_RHS,
                      box.tiles, smem, 16 * box.share + 16 + 8 * noff / nb,
                      48.0)


def pad_rows(t: torch.Tensor, pitch: int) -> torch.Tensor:
    """A copy of t (..., Nh) with its rows padded to ``pitch`` floats, zero
    past column Nh: the layout of the kernel's coefficient planes."""
    return torch.nn.functional.pad(t, (0, pitch - t.shape[-1]))


def grid_blocks(nv: int, nh: int, pad: int, nb: int, noff: int) -> int:
    """Blocks of one launch of the nb-RHS instance on an (nv, nh) grid on
    the current CUDA device, with :func:`coef_layout`'s tiles: the one-RHS
    grid, whatever nb (one block a tile, at most as many as the card holds
    at once)."""
    lay = coef_layout(nv, nh, pad, nb, noff)
    return _build.query("tpcg_stream_coef_grid", nb, nv, nh, lay.pitch, pad,
                        noff, lay.tile_rows, lay.col_halo, lay.stages,
                        lay.coef_stages, lay.blocks_per_sm)[0]


def _launch(offsets, coefp, bp, x0p, n_iterations):
    """Launch the CUDA kernel on the current stream of bp's device for the
    (2, B, Nv, Nh) planes bp, once per chunk of at most the layout's RHS a
    launch, queued with no host sync; returns x (2, B, Nv, Nh) and the
    history (n_iterations + 1, B)."""
    noff, nv, nh = coefp.shape[1:]
    n = nv * nh
    nb = bp.shape[1]
    P = _pad_for(offsets)
    max_off, max_pad, _ = kernel_limits()
    if noff > max_off or P > max_pad:
        raise ValueError(f"kernel takes at most {max_off} offsets within "
                         f"{max_pad} nodes, got {noff} offsets within {P}")
    bp, x0p = bp.contiguous(), x0p.contiguous()
    dev = bp.device
    lay = coef_layout(nv, nh, P, nb, noff)
    chunk = lay.rhs_per_launch
    with _build.launch("stream_coef", dev) as run:
        f32 = dict(dtype=torch.float32, device=dev)
        # the coefficient planes at the kernel's pitch, once a solve
        cpad = pad_rows(coefp, lay.pitch).contiguous()
        x = torch.empty_like(bp)
        offs = _build.ints(v for o in offsets for v in o)
        hists = []
        for lo in range(0, nb, chunk):
            k = min(chunk, nb - lo)
            blocks = grid_blocks(nv, nh, P, k, noff)
            # state in the kernel's padded rows, zero past column nh
            r = torch.zeros((k, 2, nv, lay.pitch), **f32)
            q = torch.zeros_like(r)
            xw = torch.zeros_like(r)
            d = torch.zeros((2, k, 2, nv, lay.pitch), **f32)
            hist = torch.empty((n_iterations + 1, k), **f32)
            part = torch.empty((2, blocks, k, 2), dtype=torch.float64,
                               device=dev)
            run("tpcg_stream_coef",
                bp[:, lo].data_ptr(), x0p[:, lo].data_ptr(), cpad.data_ptr(),
                x[:, lo].data_ptr(), hist.data_ptr(), r.data_ptr(),
                q.data_ptr(), d.data_ptr(), xw.data_ptr(), part.data_ptr(),
                k, nb * n, nv, nh, lay.pitch, noff, offs, P, lay.tile_rows,
                lay.col_halo, lay.stages, lay.coef_stages, n_iterations,
                blocks)
            hists.append(hist)
    return x, hists[0] if len(hists) == 1 else torch.cat(hists, dim=1)


def stream_cg_coef_planes(offsets: Sequence[Offset], coefp: torch.Tensor,
                          bp: torch.Tensor, x0p: torch.Tensor,
                          n_iterations: int):
    """Fixed-iteration single-RHS complex COCG on a general
    variable-coefficient stencil.

    offsets : the stencil's offsets ((dm, dj), ...), in the order of the
              coefficient planes.
    coefp   : (2, noff, Nv, Nh) float32, from :func:`prepare_stream_coef`.
    bp, x0p : (2, Nv, Nh) float32 RHS / initial-guess planes.
    Returns (x_planes (2, Nv, Nh), residual_history (n_iterations+1,)).

    CUDA tensors launch the kernel's single-RHS instance
    (``launch.stream_coef`` counts the launches); CPU tensors
    run :func:`stream_cg_coef_planes_plain`.
    """
    _check_args(offsets, coefp, bp, x0p, n_iterations, batched=False)
    if bp.device.type == "cuda":
        x, hist = _launch(offsets, coefp, bp[:, None], x0p[:, None],
                          n_iterations)
        return x[:, 0], hist[:, 0]
    if bp.device.type == "cpu":
        return stream_cg_coef_planes_plain(offsets, coefp, bp, x0p,
                                           n_iterations)
    raise ValueError(f"no stream_cg_coef_planes for device {bp.device}")


def stream_cg_coef_planes_batched_fat(offsets: Sequence[Offset],
                                      coefp: torch.Tensor, bp: torch.Tensor,
                                      x0p: torch.Tensor, n_iterations: int):
    """B right-hand sides at once, each with its own alpha, beta and freeze
    guard, sharing one read of the coefficient planes per launch (the
    function of JAX's ``stream_cg_coef_planes_batched_fat``).

    bp, x0p : (2, B, Nv, Nh) float32 planes.
    Returns (x (2, B, Nv, Nh), residual_history (n_iterations+1, B)).

    CUDA tensors launch the kernel once per chunk of at most
    ``coef_layout(...).rhs_per_launch`` RHS (8; counted in
    ``launch.stream_coef``), queued on the current stream with
    no host sync; CPU tensors run
    :func:`stream_cg_coef_planes_batched_fat_plain`.  Each RHS of a launch
    follows its plain version and gives the bits of its own single-RHS
    launch (the tile, the rings and the grid do not depend on the RHS
    count), so the chunking changes no result.
    """
    _check_args(offsets, coefp, bp, x0p, n_iterations, batched=True)
    if bp.device.type == "cpu":
        return stream_cg_coef_planes_batched_fat_plain(offsets, coefp, bp,
                                                       x0p, n_iterations)
    if bp.device.type != "cuda":
        raise ValueError(f"no stream_cg_coef_planes_batched_fat for device "
                         f"{bp.device}")
    return _launch(offsets, coefp, bp, x0p, n_iterations)


def stream_cg_coef_planes_batched(offsets: Sequence[Offset],
                                  coefp: torch.Tensor, bp: torch.Tensor,
                                  x0p: torch.Tensor, n_iterations: int):
    """JAX's ``stream_cg_coef_planes_batched`` (a (row block, RHS) grid,
    one RHS a grid column): the function of
    :func:`stream_cg_coef_planes_batched_fat`, which it runs, the same
    kernel on a card (one launch per chunk of RHS, counted in
    ``launch.stream_coef``) and the plain version on the CPU.
    bp, x0p : (2, B, Nv, Nh); returns (x (2, B, Nv, Nh), residual_history
    (n_iterations+1, B))."""
    return stream_cg_coef_planes_batched_fat(offsets, coefp, bp, x0p,
                                             n_iterations)


def stream_cg_coef_planes_batched_plain(offsets: Sequence[Offset],
                                        coefp: torch.Tensor,
                                        bp: torch.Tensor, x0p: torch.Tensor,
                                        n_iterations: int):
    """Plain version of :func:`stream_cg_coef_planes_batched`: each RHS
    through :func:`stream_cg_coef_planes_plain`."""
    return stream_cg_coef_planes_batched_fat_plain(offsets, coefp, bp, x0p,
                                                   n_iterations)


def stream_cg_coef(stencil, b, x0=None, n_iterations: int = 10):
    """Convenience wrapper: a complex (Nv, Nh) numpy grid in, device planes
    out, on the stencil's device (see :func:`stream_cg_coef_planes`)."""
    nv, nh = stencil.grid
    dev = stencil.device
    coefp = prepare_stream_coef(stencil)

    def planes(z):
        z = np.asarray(z).reshape(nv, nh)
        return torch.from_numpy(
            np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    bp = planes(b)
    x0p = torch.zeros_like(bp) if x0 is None else planes(x0)
    return stream_cg_coef_planes(stencil.offsets, coefp, bp, x0p,
                                 n_iterations)
