"""Fixed-iteration CG on banded DIA matrices (counterpart of ``tpcg/ops/stream_cg_dia.py``).

The reference's two largest Fig. 5 matrices (m_t1: n = 97,578, ~100
diagonals; parabolic_fem: n = 525,825, 7 diagonals) are banded, not 2-D
stencils.  ``stream_cg_dia_rows`` (real) and ``stream_cg_dia_rows_cplx``
(complex planes, COCG) run the whole fixed-iteration solve of up to 8 RHS
in one launch of the hand-written CUDA kernel ``csrc/stream_cg_dia.cu`` on
a CUDA tensor (see the note at the top of that file), and raise if it
cannot run; on a CPU tensor they run their plain PyTorch versions
(``*_plain``), which are also what the kernel is compared with on the card.
Larger RHS counts are split into balanced chunks, never zero-padded; in
cluster mode (below) one launch takes them all as clusters side by side.

Layout: the matrix stays in its own row-DIA layout,
``values[d, i] = A[i, i + offsets[d]]`` (``DiaMatrix.data``), and the
direction sits in a zero-bordered buffer of length ``n + 2 max|offset|``.
Each block of the launch owns one tile of consecutive rows and, where it
fits the block's shared memory, stages its window of the direction there
once an iteration (:func:`dia_layout`).  A band whose tiles, values and
windows fit the shared memory of at most 16 blocks runs as one
thread-block cluster instead (cluster mode): its blocks exchange partials
and the direction's halo over distributed shared memory, and no grid
barrier is left.  A batch runs as G such clusters in one launch, k RHS
each (:func:`cluster_split`: the fewest RHS a cluster whose clusters the
card holds at once), and no cluster waits for another.
The JAX kernel's column-major ``(nv, 128)`` regrid, its wrap-filled halo,
its ``_CHUNK = 256`` call splitting with the tail update in XLA, and its
deferred update exist because of TPU lanes and VMEM; they are not ported.

Freeze guards, as in the JAX kernels: real ``(delta == 0) | (<d,q> == 0)``,
complex ``|delta|^2 == 0 | |<d,q>|^2 == 0`` (``_mag2_zero``); both latch
per RHS until the next multiple of 256 iterations, as the JAX kernels latch
within one call of ``_CHUNK = 256`` iterations and its wrapper clears the
flag between calls.  A frozen RHS keeps its delta, so its history stays
constant, and its direction is r (beta = 0): where <d,q> reached 0 with
delta not 0, the RHS resumes at the next multiple of 256 from d = r, a
steepest-descent restart, as JAX's does.

Public surface as in the JAX module: ``stream_cg_dia`` /
``stream_cg_dia_block`` (real), ``stream_cg_dia_cplx`` /
``stream_cg_dia_cplx_block`` (complex), and the fit rules
``dia_stream_fits`` / ``dia_stream_cplx_fits`` for this card.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, _tiles
from .. import trace
from ..device import upload
from .cplx import cdiv, udot_planes

# fit rule: the kernel's tap list lives in shared memory, and its indices
# are 32-bit; operands past the card's memory fail to allocate and raise
_MAX_DIAGS = 4096
_MAX_RHS = 8
# a frozen RHS stays frozen until the next multiple of this many iterations
# (JAX's ``_CHUNK``, the iterations of one kernel call)
_LATCH_ITERS = 256
# the kernel's tiles: at least this many rows, at most one tile an SM
TILE_ROWS_MIN = 512
# a bound on the kernel's static shared memory (its reductions and
# scalars); the rest of the block's (_tiles.BLOCK_SHARED) holds the window,
# each thread's ring of values (8 diagonals of 2 rows, 384 threads) and the
# taps
_STATIC_SMEM = 1280
RING_BYTES = 4 * 8 * 2 * 384
# cluster mode: at most this many blocks, ahead of each one's window the
# slots of the partials pushed to it (<d,q> and <r,r>, 8 bytes a RHS and
# block) and its mbarriers
MAX_CLUSTER = 16
_CLUSTER_SLOT_BYTES = 2 * MAX_CLUSTER * 8
_CLUSTER_BAR_BYTES = 4 * 8
# cluster mode: each of a block's 384 threads takes 3 rows at once, and
# keeps x, r and q of its rows in registers where planes x RHS x 3 <= 16
# (the kernel's kThreads, kClusterRows and its resident test)
_THREADS = 384
CLUSTER_ROWS = 3


def _pad_for(offsets) -> int:
    return max(abs(int(o)) for o in offsets)


def _fits(dia) -> bool:
    n, offs = int(dia.n), [int(k) for k in dia.offsets]
    return 0 < len(offs) <= _MAX_DIAGS and n + 2 * _pad_for(offs) < 2**31


def dia_stream_fits(dia) -> bool:
    """Fit rule of the real kernel on this card (geometry only: ``n`` and
    ``offsets``): at most 4096 diagonals (the tap list is in shared memory)
    and the padded direction indexable in 32 bits."""
    return _fits(dia)


def dia_stream_cplx_fits(dia) -> bool:
    """Fit rule of the complex kernel: the same geometry limits as
    :func:`dia_stream_fits` (the planes share one index space)."""
    return _fits(dia)


class DiaLayout(NamedTuple):
    """A launch's geometry: ``tile_rows`` rows a block, ``tiles`` blocks,
    whether each block stages its window of the direction in shared memory
    (``staged``), the dynamic shared memory a block takes, and ``cluster``:
    the blocks of the one thread-block cluster that runs the launch
    (``tiles``), or 0 for a cooperative grid."""
    tile_rows: int
    tiles: int
    staged: bool
    smem: int
    cluster: int = 0


def tile_rows(n: int, sms: int) -> int:
    """Rows of a block's tile: n over the SM count, rounded up to a warp's
    32 rows, and at least ``TILE_ROWS_MIN``, so that a launch has at most one
    tile an SM.  It depends on n and the card alone, never on the RHS count,
    so each RHS gives the same bits in a launch of any size."""
    per_sm = -(-n // sms)
    return max(TILE_ROWS_MIN, -(-per_sm // 32) * 32)


def _window(rows: int, offsets, nb: int, planes: int) -> int:
    """Bytes of a block's window for tiles of ``rows`` rows: the tile and
    ``max|off|`` rows each side, for every RHS and plane, in float32, each
    (plane, RHS) row with up to 3 floats before it and rounded up to 16
    bytes (the cooperative copy moves aligned 16-byte pieces)."""
    rows = rows + 2 * _pad_for(offsets) + 3
    return 4 * planes * nb * (-(-rows // 4) * 4)


def window_bytes(n: int, offsets, nb: int, planes: int, sms: int) -> int:
    """Shared memory of one block's window in a cooperative launch: its
    tile's rows (:func:`tile_rows`) and ``max|off|`` rows each side, for
    every RHS and plane (:func:`_window`)."""
    return _window(tile_rows(n, sms), offsets, nb, planes)


def cluster_smem(rows: int, offsets, nb: int, planes: int) -> int:
    """Dynamic shared memory of a block in cluster mode, tiles of ``rows``
    rows: the slots of the partials pushed to it and its mbarriers, its
    window, its tile's values (every diagonal and plane) and the tap
    list."""
    return (_CLUSTER_SLOT_BYTES * nb + _CLUSTER_BAR_BYTES
            + _window(rows, offsets, nb, planes)
            + 4 * planes * len(offsets) * rows + 4 * len(offsets))


def _rows_of(n: int, blocks: int) -> int:
    """n over ``blocks`` rows, rounded up to a warp's 32."""
    return -(-n // (32 * blocks)) * 32


def cluster_tile_rows(n: int, sms: int) -> int:
    """Rows of a tile in cluster mode: n over ``MAX_CLUSTER`` blocks rounded
    up to 32 rows, and at least the cooperative tile (:func:`tile_rows`), so
    that a small band takes few blocks."""
    return max(tile_rows(n, sms), _rows_of(n, MAX_CLUSTER))


def dia_layout(n: int, offsets, nb: int, planes: int, sms: int,
               cluster=None) -> DiaLayout:
    """The layout of a launch of ``csrc/stream_cg_dia.cu`` on a card with
    ``sms`` SMs.  Cluster mode wherever the tiles of
    :func:`cluster_tile_rows`, with their resident values and their windows
    sized for 8 RHS (the kernel's limit, so the rule does not read ``nb``
    and a RHS's bits do not depend on the launch), fit a block's shared
    memory.  Else a cooperative grid of the tiles of :func:`tile_rows`,
    staged wherever the window, the rings of values and the tap list fit
    the block's shared memory, else read from L2 (the same values, so the
    choice changes no bits).

    ``cluster``, for probes and tests: 0 takes the cooperative layout, C a
    cluster of n over C rows rounded up to 32 a block (whether or not it
    fits; the kernel refuses what does not)."""
    budget = _tiles.BLOCK_SHARED - _STATIC_SMEM
    if cluster is None:
        rows = cluster_tile_rows(n, sms)
        if cluster_smem(rows, offsets, _MAX_RHS, planes) <= budget:
            cluster = -(-n // rows)
    elif cluster:
        rows = _rows_of(n, cluster)
        cluster = -(-n // rows)
    if cluster:
        return DiaLayout(rows, cluster, False,
                         cluster_smem(rows, offsets, nb, planes), cluster)
    rows = tile_rows(n, sms)
    fixed = RING_BYTES + 4 * len(offsets)
    win = window_bytes(n, offsets, nb, planes, sms)
    staged = win + fixed <= budget
    return DiaLayout(rows, -(-n // rows), staged,
                     fixed + (win if staged else 0))


def cluster_resident(tile_rows: int, nb: int, planes: int) -> bool:
    """Whether a cluster-mode launch of ``nb`` RHS a cluster keeps x, r
    and q in registers (the kernel then touches no r or q in memory): the
    tile is one pass of the threads' 3 rows and their state fits."""
    return (planes * nb * CLUSTER_ROWS <= 16
            and tile_rows <= CLUSTER_ROWS * _THREADS)


def cluster_split(nrhs: int,
                  active: Callable[[int], int]) -> Optional[Tuple[int, int]]:
    """(k, G) of a cluster-mode launch of ``nrhs`` RHS: G = ceil(nrhs / k)
    clusters side by side, k RHS each (the last may take fewer, and no RHS
    is padded in or solved twice), for the smallest k (at most 8) whose G
    clusters the card holds at once; ``active(k)`` is that count for the
    k-RHS instance (the kernel's occupancy query).  None where even 8 RHS a
    cluster leave more clusters than that.  The cluster's shape is the
    layout rule's alone, so each RHS keeps the bits of its 1-RHS launch."""
    for k in range(1, min(nrhs, _MAX_RHS) + 1):
        g = -(-nrhs // k)
        if g <= active(k):
            return k, g
    return None


def _check_args(offsets, values, b, x0, n_iterations, planes):
    if values.dim() != 3 or values.shape[0] != planes:
        raise ValueError(f"values must be ({planes}, ndiag, n), got "
                         f"{tuple(values.shape)}")
    _, ndiag, n = values.shape
    if len(offsets) != ndiag:
        raise ValueError(f"{len(offsets)} offsets for {ndiag} diagonals")
    if b.dim() != 3 or b.shape[0] != planes or b.shape[2] != n:
        raise ValueError(f"b must be ({planes}, B, {n}), got "
                         f"{tuple(b.shape)}")
    if x0.shape != b.shape:
        raise ValueError(f"x0 {tuple(x0.shape)} != b {tuple(b.shape)}")
    for name, t in (("values", values), ("b", b), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")


def _dot(a, b, cplx):
    """Unconjugated dot over rows of (P, B, n) planes: real (B,), complex
    (2, B).  (The kernel sums rr*ri and doubles; doubling is exact, so
    the imaginary part of <r,r> has the same bits either way.)"""
    if cplx:
        return udot_planes(a, b, axis=-1)
    return torch.sum(a[0] * b[0], dim=-1)


def _stream_plain(offsets, values, b, x0, n_iterations):
    """The kernel's recurrence in plain PyTorch, for 1 (real) or 2 (complex)
    planes; see :func:`stream_cg_dia_rows_plain`."""
    cplx = values.shape[0] == 2
    n = values.shape[2]
    P = _pad_for(offsets)
    dpad = b.new_zeros(b.shape[:2] + (n + 2 * P,))
    d = dpad[:, :, P:P + n]                    # view of the interior

    def apply():
        qr = torch.zeros_like(b[0])
        qi = torch.zeros_like(b[0])
        for k, off in enumerate(offsets):
            vr = values[0, k]
            wr = dpad[0, :, P + off:P + off + n]
            if cplx:
                vi = values[1, k]
                wi = dpad[1, :, P + off:P + off + n]
                qr = qr + vr * wr - vi * wi
                qi = qi + vr * wi + vi * wr
            else:
                qr = qr + vr * wr
        return torch.stack([qr, qi]) if cplx else qr[None]

    def zero(v):
        return (v[0] * v[0] + v[1] * v[1] == 0) if cplx else v == 0

    def div(a, c):
        return cdiv(a, c) if cplx else a / c

    def hist_of(dl):
        return (torch.sqrt(torch.sqrt(dl[0] * dl[0] + dl[1] * dl[1]))
                if cplx else torch.sqrt(dl))

    # y + s v and y - s v for per-RHS scalars s (., B) and v (P, B, n),
    # complex terms in the kernel's order
    def add(y, s, v):
        if not cplx:
            return y + s[None, :, None] * v
        sr, si = s[0, :, None], s[1, :, None]
        return torch.stack([y[0] + sr * v[0] - si * v[1],
                            y[1] + sr * v[1] + si * v[0]])

    def sub(y, s, v):
        if not cplx:
            return y - s[None, :, None] * v
        sr, si = s[0, :, None], s[1, :, None]
        return torch.stack([y[0] - (sr * v[0] - si * v[1]),
                            y[1] - (sr * v[1] + si * v[0])])

    d.copy_(x0)
    r = b - apply()
    x = x0.clone()
    d.copy_(r)
    delta = _dot(r, r, cplx)
    hist = [hist_of(delta)]
    done = torch.zeros(b.shape[1], dtype=torch.bool, device=b.device)
    one = torch.ones_like(delta)
    for it in range(n_iterations):
        if it % _LATCH_ITERS == 0:
            done = torch.zeros_like(done)
        q = apply()
        dc = d.clone()
        dq = _dot(dc, q, cplx)
        done = done | zero(delta) | zero(dq)
        alpha = torch.where(done, 0.0, div(delta, torch.where(done, one, dq)))
        x = add(x, alpha, dc)
        r = sub(r, alpha, q)
        dn = _dot(r, r, cplx)
        beta = torch.where(done, 0.0, div(dn, torch.where(done, one, delta)))
        delta = torch.where(done, delta, dn)
        hist.append(hist_of(delta))
        d.copy_(add(r, beta, dc))
    return x, torch.stack(hist)


def stream_cg_dia_rows_plain(offsets: Sequence[int], values: torch.Tensor,
                             b: torch.Tensor, x0: torch.Tensor,
                             n_iterations: int):
    """Plain PyTorch version of the real kernel: the same function, step
    for step.  ``values`` (ndiag, n) float32 row-DIA planes, ``b``/``x0``
    (B, n); returns ``x`` (B, n) and the history ``sqrt(delta)``
    (n_iterations+1, B)."""
    _check_args(offsets, values[None], b[None], x0[None], n_iterations, 1)
    x, hist = _stream_plain(offsets, values[None], b[None], x0[None],
                            n_iterations)
    return x[0], hist


def stream_cg_dia_rows_cplx_plain(offsets: Sequence[int],
                                  values: torch.Tensor, b: torch.Tensor,
                                  x0: torch.Tensor, n_iterations: int):
    """Plain PyTorch version of the complex kernel: ``values``
    (2, ndiag, n), ``b``/``x0`` (2, B, n) float32 re/im planes; returns
    ``x`` (2, B, n) and the history ``sqrt|delta|`` (n_iterations+1, B)."""
    _check_args(offsets, values, b, x0, n_iterations, 2)
    return _stream_plain(offsets, values, b, x0, n_iterations)


def kernel_limits() -> Tuple[int, int]:
    """(max RHS per launch, max diagonals) of the CUDA kernel."""
    return _build.query("tpcg_stream_dia_limits")


@functools.lru_cache(maxsize=None)
def _grid(dev, planes, nb, n, ndiag, pad, tile_rows, staged, cluster):
    """(grid, clusters) of ``tpcg_stream_dia_grid`` for the nb-RHS instance
    of a layout on ``dev``: the blocks of the grid or of one cluster (0
    where the card holds no such cluster), and in cluster mode how many
    such clusters the card holds at once.  It rests on the instance and the
    card alone, so a process asks once."""
    with torch.cuda.device(dev):
        return _build.query("tpcg_stream_dia_grid", int(planes == 2), nb, n,
                            ndiag, pad, tile_rows, staged, cluster)


def _grid_of(dev, offsets, n, planes, nb, lay):
    return _grid(dev, planes, nb, n, len(offsets), _pad_for(offsets),
                 lay.tile_rows, int(lay.staged), lay.cluster)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_rhs(offsets, values, dev) -> int:
    """The most RHS one launch takes on ``dev``: in cluster mode 8 a cluster
    times the clusters of the 8-RHS instance that the card holds at once,
    else the kernel's 8."""
    planes, _, n = values.shape
    lay = dia_layout(n, offsets, _MAX_RHS, planes, _sms(dev))
    if not lay.cluster:
        return _MAX_RHS
    return _MAX_RHS * max(1, _grid_of(dev, offsets, n, planes, _MAX_RHS,
                                      lay)[1])


def _launch(offsets, values, b, x0, n_iterations):
    """Launch the CUDA kernel on the current stream of b's device; values
    (P, ndiag, n), b/x0 (P, B, n): in cluster mode B RHS as the clusters
    of :func:`cluster_split`, at most :func:`_launch_rhs`; else B within
    the kernel's limit."""
    planes, ndiag, n = values.shape
    nb = b.shape[1]
    values, b, x0 = values.contiguous(), b.contiguous(), x0.contiguous()
    P = _pad_for(offsets)
    dev = b.device
    cplx = int(planes == 2)
    kernel = "stream_dia_cplx" if cplx else "stream_dia"
    with _build.launch(kernel, dev) as run:
        max_rhs, max_diags = kernel_limits()
        sms = _sms(dev)
        lay = dia_layout(n, offsets, min(nb, max_rhs), planes, sms)
        # k RHS a cluster (or the launch), G clusters side by side
        k, clusters = nb, 1
        if lay.cluster:
            split = cluster_split(nb, lambda rhs: _grid_of(
                dev, offsets, n, planes, rhs, lay)[1])
            if split is None:
                # the card cannot hold the cluster: the cooperative layout
                lay = dia_layout(n, offsets, nb, planes, sms, cluster=0)
            else:
                k, clusters = split
                lay = dia_layout(n, offsets, k, planes, sms)
        if k > max_rhs or ndiag > max_diags:
            raise ValueError(f"kernel takes at most {max_rhs} RHS and "
                             f"{max_diags} diagonals per launch, got {nb} "
                             f"and {ndiag}")
        grid = _grid_of(dev, offsets, n, planes, k, lay)[0]
        f32 = dict(dtype=torch.float32, device=dev)
        offs = upload(torch.tensor([int(o) for o in offsets],
                                   dtype=torch.int32), dev)
        # x, r, q and the history hold the G k RHS of the clusters: a
        # short last cluster's missing ones are solved on zeros and dropped
        span = k * clusters
        x = torch.empty((planes, span, n), **f32)
        hist = torch.empty((n_iterations + 1, span), **f32)
        # r and q, which the kernel touches only where x, r and q of a
        # tile do not fit the registers; the padded direction (the
        # window's aligned copies may read 3 floats past its end) and the
        # partials, which stay in shared memory in cluster mode
        r = q = dpad = part_dq = part_rr = None
        if not (lay.cluster and cluster_resident(lay.tile_rows, k, planes)):
            r, q = torch.empty_like(x), torch.empty_like(x)
        if not lay.cluster:
            dpad = torch.empty(planes * nb * (n + 2 * P) + 4, **f32)
            part_dq, part_rr = torch.empty((2, grid, nb, 2), **f32)
        scratch = [None if t is None else t.data_ptr()
                   for t in (r, q, dpad, part_dq, part_rr)]
        run("tpcg_stream_dia",
            cplx, values.data_ptr(), offs.data_ptr(), b.data_ptr(),
            x0.data_ptr(), x.data_ptr(), hist.data_ptr(), *scratch, n, ndiag,
            k, P, n_iterations, lay.tile_rows, int(lay.staged), lay.cluster,
            grid, clusters, nb)
        if lay.staged:
            trace.count("staged." + kernel)
        if lay.cluster:
            trace.count("cluster." + kernel)
            trace.count("cluster_grid." + kernel, clusters)
    if span > nb:
        x, hist = x[:, :nb].contiguous(), hist[:, :nb].contiguous()
    return x, hist


def _balanced(nrhs: int, cap: int):
    """Balanced chunks of at most ``cap``: ceil(nrhs/cap) chunks whose sizes
    differ by at most one (9 RHS at cap 8 -> 5 + 4, not 8 + 1 or a padded
    8 + 8)."""
    nc = -(-nrhs // cap)
    base, extra = divmod(nrhs, nc)
    lo = 0
    for c in range(nc):
        hi = lo + base + (c < extra)
        yield lo, hi
        lo = hi


def _solve(offsets, values, b, x0, n_iterations):
    """Dispatch on b's device; values (P, ndiag, n), b/x0 (P, B, n), in
    balanced chunks of at most 8 RHS (the kernel's limit) a run, or on a
    card in cluster mode of :func:`_launch_rhs` (one launch a batch while
    the card holds its clusters at once)."""
    if b.device.type == "cuda":
        run = _launch
    elif b.device.type == "cpu":
        run = _stream_plain
    else:
        raise ValueError(f"no stream_cg_dia kernel for device {b.device}")
    cap = _MAX_RHS
    if run is _launch and b.shape[1] > cap:
        cap = _launch_rhs(offsets, values, b.device)
    if b.shape[1] <= cap:
        return run(offsets, values, b, x0, n_iterations)
    xs, hists = [], []
    for lo, hi in _balanced(b.shape[1], cap):
        x, hist = run(offsets, values, b[:, lo:hi], x0[:, lo:hi],
                      n_iterations)
        xs.append(x)
        hists.append(hist)
    return torch.cat(xs, dim=1), torch.cat(hists, dim=1)


def stream_cg_dia_rows(offsets: Sequence[int], values: torch.Tensor,
                       b: torch.Tensor, x0: torch.Tensor, n_iterations: int):
    """Device-resident real solve: ``values`` (ndiag, n) float32 row-DIA
    planes (:func:`prepare_dia_rows`), ``b``/``x0`` (B, n) float32 on the
    same device.  Returns ``x`` (B, n) and the history (n_iterations+1, B).

    CUDA tensors launch the kernel, at most 8 RHS (the kernel's limit) per
    launch in balanced chunks, or in cluster mode the batch in one launch
    of clusters side by side; ``tpcg_torch.trace``'s counter
    ``launch.stream_dia`` counts the launches, ``staged.stream_dia``
    those that staged the direction in shared memory,
    ``cluster.stream_dia`` those that ran as thread-block clusters and
    ``cluster_grid.stream_dia`` their clusters.  CPU tensors run
    :func:`stream_cg_dia_rows_plain` in chunks of 8."""
    _check_args(offsets, values[None], b[None], x0[None], n_iterations, 1)
    x, hist = _solve(offsets, values[None], b[None], x0[None], n_iterations)
    return x[0], hist


def stream_cg_dia_rows_cplx(offsets: Sequence[int], values: torch.Tensor,
                            b: torch.Tensor, x0: torch.Tensor,
                            n_iterations: int):
    """Device-resident complex solve: ``values`` (2, ndiag, n), ``b``/``x0``
    (2, B, n) float32 re/im planes.  Returns ``x`` (2, B, n) and the
    history (n_iterations+1, B).  Launches and chunks as
    :func:`stream_cg_dia_rows`; the counters ``launch.stream_dia_cplx``,
    ``staged.stream_dia_cplx``, ``cluster.stream_dia_cplx`` and
    ``cluster_grid.stream_dia_cplx`` count the launches, the staged ones,
    those that ran as clusters and their clusters."""
    _check_args(offsets, values, b, x0, n_iterations, 2)
    return _solve(offsets, values, b, x0, n_iterations)


def prepare_dia_rows(dia) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """Real :class:`DiaMatrix` -> (offsets, values (ndiag, n) float32) on
    its device: the matrix's own layout, nothing regridded."""
    return (tuple(int(o) for o in dia.offsets),
            dia.data.to(torch.float32).contiguous())


def prepare_dia_rows_cplx(dia) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """Complex (or real) :class:`DiaMatrix` -> (offsets, values
    (2, ndiag, n) float32 re/im planes) on its device."""
    v = dia.data
    if v.is_complex():
        planes = torch.stack([v.real, v.imag]).to(torch.float32)
    else:
        planes = torch.stack([v, torch.zeros_like(v)]).to(torch.float32)
    return tuple(int(o) for o in dia.offsets), planes.contiguous()


def _as_tensor(a, dev, dtype=None):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return upload(t, dev, dtype)


def _cols(B, dev):
    """(n,) or (n, nrhs) -> (nrhs, n) float32 rows on dev."""
    t = _as_tensor(B, dev, torch.float32)
    return (t[None] if t.dim() == 1 else t.T).contiguous()


def _cplx_cols(B, dev):
    """complex (n,) or (n, nrhs) -> (2, nrhs, n) float32 planes on dev."""
    t = _as_tensor(B, dev)
    t = t[None] if t.dim() == 1 else t.T
    if not t.is_complex():
        t = t.to(torch.complex64)
    return torch.stack([t.real, t.imag]).to(torch.float32).contiguous()


def stream_cg_dia_block(dia, B, X0=None, n_iterations: int = 10):
    """Multi-RHS real banded CG on a real :class:`DiaMatrix`: ``B``/``X0``
    (n, nrhs) (numpy or tensors).  Returns tensors on the matrix's device,
    ``X`` (n, nrhs) float32 and the history (n_iterations+1, nrhs).  Each
    launch applies every value fetch to up to 8 RHS (report Fig. 6); per RHS
    the result does not depend on the RHS count."""
    with trace.span("prepare"):
        offsets, values = prepare_dia_rows(dia)
        dev = values.device
        b = _cols(B, dev)
        x0 = torch.zeros_like(b) if X0 is None else _cols(X0, dev)
    x, hist = stream_cg_dia_rows(offsets, values, b, x0, n_iterations)
    return x.T, hist


def stream_cg_dia(dia, b, x0=None, n_iterations: int = 10):
    """Real banded CG, one RHS: ``b``, ``x0`` (n,).  Returns (x (n,),
    history (n_iterations+1,)) as tensors on the matrix's device."""
    X, H = stream_cg_dia_block(dia, _as_tensor(b, "cpu")[:, None],
                               None if x0 is None
                               else _as_tensor(x0, "cpu")[:, None],
                               n_iterations)
    return X[:, 0], H[:, 0]


def stream_cg_dia_cplx_block(dia, B, X0=None, n_iterations: int = 10):
    """Multi-RHS complex banded COCG on a complex :class:`DiaMatrix`:
    ``B``/``X0`` complex (n, nrhs).  Returns ``X`` complex64 (n, nrhs) and
    the history (n_iterations+1, nrhs) on the matrix's device.  The JAX
    module runs columns one by one; here up to 8 share each launch, and per
    RHS the result does not depend on the RHS count."""
    with trace.span("prepare"):
        offsets, values = prepare_dia_rows_cplx(dia)
        dev = values.device
        b = _cplx_cols(B, dev)
        x0 = torch.zeros_like(b) if X0 is None else _cplx_cols(X0, dev)
    x, hist = stream_cg_dia_rows_cplx(offsets, values, b, x0, n_iterations)
    return torch.complex(x[0], x[1]).T, hist


def stream_cg_dia_cplx(dia, b, x0=None, n_iterations: int = 10):
    """Complex banded COCG, one RHS: ``b``, ``x0`` complex (n,).  Returns
    (x complex64 (n,), history (n_iterations+1,))."""
    b = _as_tensor(b, "cpu")
    X, H = stream_cg_dia_cplx_block(
        dia, b[:, None],
        None if x0 is None else _as_tensor(x0, "cpu")[:, None],
        n_iterations)
    return X[:, 0], H[:, 0]
