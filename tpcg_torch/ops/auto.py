"""Execution-path selection for stencil CG solves (counterpart of ``tpcg/ops/auto.py``).

Six paths are ported; each maps to a planner path of the JAX package:

  l2-coef     : JAX's ``vmem-coef``.  The whole fixed-iteration solve in one
                launch of the hand-written CUDA kernel
                (``tpcg_torch.ops.fused_cg.fused_cg_stencil``).  On the H100
                the coefficient planes and the CG state stay resident in the
                50 MB L2 during that launch, where on the TPU they sat in
                VMEM.  The default for complex grids up to 512^2 nodes with
                at most two RHS on a CUDA device, as JAX picks ``vmem-coef``.
  l2-const    : JAX's ``vmem-const``, taken only when forced, as in JAX (on
                the TPU ``vmem-coef`` was faster at every resident size).
                The same whole solve with the constant-tap operator
                (``tpcg_torch.ops.fused_cg_const.fused_cg_const_planes``, the
                const instance of the same CUDA kernel): interior taps as
                scalars and four boundary strips, no coefficient planes.
  stream      : JAX's ``stream``.  Complex stencils past 512^2 nodes whose
                interior and edge taps are constant (``prepare_stream``
                succeeds): the hand-written CUDA kernel of
                ``tpcg_torch.ops.stream_cg.stream_cg_const_planes_batched``,
                the state in device memory, one launch per chunk of up to
                eight RHS or one per RHS (see below).
  stream-coef : JAX's ``stream-coef``.  Complex stencils past 512^2 nodes
                with variable coefficients.  Where ``prepare_stream_sym``
                accepts the stencil (symmetric), one launch of the
                hand-written CUDA kernel
                ``tpcg_torch.ops.stream_cg_sym.stream_cg_sym_planes`` per
                RHS, half of the coefficient planes streamed; otherwise the
                hand-written CUDA kernel of
                ``tpcg_torch.ops.stream_cg_coef`` on the full planes
                (``prepare_stream_coef``): one launch of
                ``stream_cg_coef_planes_batched_fat`` per chunk of at most
                eight RHS, which share one read of the coefficients (one
                RHS runs the single-RHS instance).
  stream-real : JAX's ``stream-real``.  Real stencils on a CUDA device:
                float32 grids from 8 nodes a side, float64 grids from
                1024^2 nodes (JAX's threshold for every real grid, a rule of
                its VMEM tiers; the port's float32 rule is the H100's, see
                ``_REAL_F32_MIN_SIDE``): one launch of the hand-written CUDA
                kernel
                ``tpcg_torch/csrc/stream_cg_real.cu`` per RHS, in const mode
                where ``prepare_stream_real`` accepts the stencil, else in
                coef mode (``tpcg_torch.ops.stream_cg_real``; the plan
                copies the coefficient planes to the kernel's row pitch
                once, and every launch reads that copy).  ``solve``
                returns real float32 x, and ``solve_planes`` takes and returns
                single (Nv, Nh) or (B, Nv, Nh) float32 planes.
  eager       : JAX's ``xla``.  Plain PyTorch: ``block_cg_planes_chunked``
                over float32 planes for complex stencils on a CUDA device,
                and ``block_cg`` in the stencil's own dtype otherwise.  The
                default on the CPU, for larger complex batches, and on a
                card for float64 real stencils below 1024^2 nodes and
                float32 ones under 8 nodes a side.  On a real stencil
                ``solve_planes`` takes single (Nv, Nh) or (B, Nv, Nh) planes,
                as on ``stream-real``, so the surface does not change with
                the path.

Several RHS on ``stream`` share a launch (chunks of up to eight) on grids
of 1024^2 to below 4096^2 nodes, where that was faster per RHS-iteration
on the H100, and run one launch a RHS elsewhere (``_stream_chunk``; the
numbers are beside ``_STREAM_BATCH_MIN_NODES`` and in PERF.md); each
RHS gives the same bits either way.  JAX takes its batched kernels only
where no resident tier fits, and chunks of 16.  On the other streaming
paths but general ``stream-coef`` several RHS run as sequential
single-RHS launches queued on one stream, as JAX's ``lax.map`` runs them;
any batch size.

Heights JAX cannot stream (no row block of at least 8 rows that leaves two
blocks, e.g. primes): JAX row-pads them to a multiple of 128
(``_pad_rows``), and the padded operator lands on ``stream-coef`` or
``stream-real``.  The Hopper kernels read any height, so the port does not
pad: JAX's ``pad->stream-coef`` becomes ``stream`` for constant taps and
``stream-coef`` for variable coefficients, and
``pad->stream-real`` becomes ``stream-real``, on the unpadded grid.

Every plan is span ``tpcg.plan`` of ``tpcg_torch.trace`` and counts its
path in ``plan.<path>``; ``StencilCGPlan.solve`` and ``solve_planes`` are
span ``tpcg.solve``, and ``stencil_cg`` span ``tpcg.stencil_cg`` around
both.  ``solve`` copies b and x0 to the device and x and the history back
through ``device.upload`` and ``device.download`` (spans ``tpcg.upload``,
``tpcg.wait``, ``tpcg.download``; counters ``h2d_bytes``, ``d2h_bytes``)
on every path, its host-side packing in ``tpcg.pack``.

The planner dispatches on the torch device of the stencil's coefficients.
Every tier JAX's planner picks has its kernel on a CUDA device; a kernel
that cannot run raises, and nothing runs silently on the plain path
instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import trace
from ..cg import block_cg
from ..device import download, upload, wait
from .cplx import block_cg_planes_chunked, make_pair_operator
from .fused_cg import fused_cg_stencil_chunked, prepare_coef3
from .fused_cg_const import fused_cg_const_chunked, prepare_const
from .stream_cg import prepare_stream, stream_cg_const_planes_batched
from .stream_cg_coef import (prepare_stream_coef,
                             stream_cg_coef_planes_batched_fat)
from .stream_cg_real import (pad_real_planes, prepare_real,
                             solve_real_planes)
from .stream_cg_sym import (pad_sym_planes, prepare_stream_sym,
                            stream_cg_sym_planes)

# JAX's _VMEM_NODES: complex grids up to here take the whole-solve kernel
_L2_NODES = 512 * 512
# JAX's _REAL_STREAM_NODES: real grids from here take the stream-real tier
# (float64 real grids on a card keep this rule; below it they run eager in
# float64)
_REAL_STREAM_NODES = 1024 * 1024
# A float32 real grid on a card takes stream-real whenever both sides are at
# least _REAL_F32_MIN_SIDE: the smallest side swept, and the kernel won at
# every size.  Whole solves of 5000 iterations on device operands, 1 RHS, us
# an iteration, eager (plain block_cg) / stream-real, on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, Findings; probes/planner_real_sweep.py): the
# 7-point FE stencil parabolic_stencil(N, diag=6.0) at N=8 474.5 / 10.9,
# 16 384.3 / 11.5, 32 466.4 / 10.9, 64 500.6 / 10.3, 128 410.1 / 10.6,
# 256 487.3 / 10.9, 512 486.4 / 12.2, 725 475.4 / 19.1, 1023 496.0 / 22.9;
# Poisson at 256 411.9 / 10.1 and 725 401.9 / 17.1.  (JAX's threshold was
# its VMEM tier rule on the TPU.)
_REAL_F32_MIN_SIDE = 8
# JAX's _FUSED_BATCH_MAX: larger complex batches take the plain path
_FUSED_BATCH_MAX = 2


# stream: on grids of at least _STREAM_BATCH_MIN_NODES and fewer than
# _STREAM_BATCH_MAX_NODES nodes several RHS share a launch of
# csrc/stream_cg.cu (chunks of up to 8); elsewhere each RHS has its own
# launch.  Per RHS-iteration, batched / sequential on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, Findings;
# probes/stream_batch_boundary.py): 1.003 at N=1024 B=2 and 0.932 at B=8,
# 1.025 / 0.953 at N=1200 B=2 / 4, 0.901 / 0.839 at 1448 B=2 / 8, 0.949 /
# 0.890 at 2048 B=2 / 8, 0.958 at 2896, 0.962 at 3072, and 0.990 / 1.013 at
# 4096 B=2 / 4, against 0.9986 between two identical launches.  (The
# kernel's earlier design, which stored q, lost 5-16% at 1024: one RHS's
# state stayed in the L2 between one-RHS launches; the padded, TMA-fed
# design's one-RHS launch gains nothing there.)
_STREAM_BATCH_MIN_NODES = 1024 * 1024
_STREAM_BATCH_MAX_NODES = 4096 * 4096


def _stream_chunk(nv: int, nh: int):
    """RHS a launch on the ``stream`` path for an (nv, nh) grid: ``None``
    (the kernel's limit, 8) where several RHS sharing a launch of
    ``csrc/stream_cg.cu`` were faster per RHS-iteration than one launch per
    RHS (``_STREAM_BATCH_MIN_NODES`` <= nodes < ``_STREAM_BATCH_MAX_NODES``),
    else 1.  Each RHS gives the same bits either way."""
    batched = _STREAM_BATCH_MIN_NODES <= nv * nh < _STREAM_BATCH_MAX_NODES
    return None if batched else 1


_PORTED = ("l2-coef", "l2-const", "stream", "stream-coef", "stream-real",
           "eager")


def _norm_b(b, nv, nh):
    # squeeze only for inputs WITHOUT a batch axis: an (Nv, Nh) grid or
    # a flat (Nv*Nh,) vector.  Anything else -- explicit (B, Nv, Nh),
    # flat (B*Nv*Nh,), column-stacked (B, Nv*Nh) -- keeps its batch axis
    # in the output (tpcg/ops/auto.py::_norm_b).
    b = np.asarray(b)
    squeeze = (b.shape == (nv, nh)
               or (b.ndim == 1 and b.size == nv * nh))
    B = b.reshape(-1, nv, nh)
    return B, squeeze


@dataclass
class StencilCGPlan:
    """A chosen execution path for one (stencil, n_iterations) pair."""
    path: str        # l2-coef | l2-const | stream | stream-coef |
    #                  stream-real | eager
    grid: tuple
    n_iterations: int
    _solve: Callable = field(repr=False)
    _solve_planes: Callable = field(repr=False)
    real_planes: bool = False   # solve_planes takes real planes

    def solve(self, b, x0=None):
        """b, x0 : (Nv, Nh) or (B, Nv, Nh) numpy arrays (or any shape
        ``_norm_b`` accepts); complex, or real on ``stream-real``.

        Returns numpy ``(x, history)``: x shaped like b (complex64 on the
        complex float32 paths, float32 on ``stream-real``, the stencil's
        dtype on the CPU eager path) and history ``(n_iterations+1,)`` for a
        single RHS, else ``(n_iterations+1, B)``.  Each call uploads b and
        downloads x; repeated device-resident solves use
        :meth:`solve_planes`.
        """
        with trace.span("solve"):
            return self._solve(b, x0)

    def solve_planes(self, bp: torch.Tensor,
                     x0p: Optional[torch.Tensor] = None):
        """Device-resident surface: ``bp``/``x0p`` are float32 tensors on
        the plan's device: re/im planes (2, Nv, Nh) or (2, B, Nv, Nh), or for
        a real stencil on ``stream-real`` and ``eager`` (``real_planes``)
        single planes (Nv, Nh) or (B, Nv, Nh).  Returns device tensors
        ``(x, history)`` shaped like the input and like :meth:`solve`'s
        history, with no host round trip."""
        axis = 0 if self.real_planes else 1   # the batch axis
        squeeze = bp.dim() == axis + 2
        with trace.span("solve"):
            if squeeze:
                bp = bp.unsqueeze(axis)
                x0p = None if x0p is None else x0p.unsqueeze(axis)
            if x0p is None:
                x0p = torch.zeros_like(bp)
            x, hist = self._solve_planes(bp, x0p)
        if squeeze:
            return x.select(axis, 0), hist[:, 0]
        return x, hist


def _prepare_coef(stencil):
    """The ``stream-coef`` operand: ``prepare_stream_sym``'s
    ``(half_offsets, cplanes)`` where it accepts the stencil, else
    ``prepare_stream_coef``'s full planes (one tensor), as JAX's planner
    tries its sym branch first (``tpcg/ops/auto.py:655-660``)."""
    try:
        return prepare_stream_sym(stencil)
    except ValueError:
        return prepare_stream_coef(stencil)


def _pick_path(stencil, nb: int, on_cuda: bool):
    """The planner's default choice: ``(path, prepared)``, where
    ``prepared`` is ``prepare_stream``'s result on the ``stream`` path,
    :func:`_prepare_coef`'s on ``stream-coef`` and ``prepare_real``'s on
    ``stream-real``.

    ``on_cuda`` says whether the solve runs on a card; off the card every
    stencil takes ``eager``.  On the card the rule is JAX's on an
    accelerator (``tpcg/ops/auto.py::plan_stencil_cg``) without its row
    padding (see the module note), but for real float32 grids, which take
    ``stream-real`` from ``_REAL_F32_MIN_SIDE`` nodes a side."""
    nv, nh = stencil.grid
    n = nv * nh
    if not on_cuda:
        return "eager", None
    if stencil.coef.is_complex():
        if n <= _L2_NODES:
            return ("l2-coef" if nb <= _FUSED_BATCH_MAX else "eager"), None
        try:
            return "stream", prepare_stream(stencil)
        except ValueError:
            return "stream-coef", _prepare_coef(stencil)
    if n >= _REAL_STREAM_NODES or (stencil.coef.dtype == torch.float32
                                   and min(nv, nh) >= _REAL_F32_MIN_SIDE):
        return "stream-real", prepare_real(stencil)
    return "eager", None


def plan_stencil_cg(stencil, n_iterations: int, nb: int = 1,
                    path: Optional[str] = None) -> StencilCGPlan:
    """Pick and prepare the CG path for ``stencil`` on its device.

    nb   : planned RHS batch size (every path takes any batch at solve time).
    path : force ``"l2-coef"``, ``"l2-const"``, ``"stream"``,
           ``"stream-coef"``, ``"stream-real"`` or ``"eager"`` (JAX's
           ``vmem-coef`` and ``vmem-const`` are ``l2-coef`` and
           ``l2-const`` here).  On a CPU device the kernel paths run their
           kernels' plain versions.  Forcing ``stream`` or ``l2-const`` on
           a stencil whose taps are not constant raises ``ValueError``
           (``prepare_stream``'s, ``prepare_const``'s), as JAX's planner
           does; forcing ``stream-real`` on a complex stencil raises
           ``ValueError``.  ``stream-coef`` takes any stencil: the
           symmetric kernel where ``prepare_stream_sym`` accepts it, else
           the general one.

    The plan is span ``tpcg.plan`` of ``tpcg_torch.trace`` (the choice,
    the kernel's operands and padded copies, the solver), and counts its
    path in ``plan.<path>``.
    """
    with trace.span("plan"):
        plan = _plan(stencil, n_iterations, nb, path)
        trace.count("plan." + plan.path)
        return plan


def _plan(stencil, n_iterations, nb, path):
    nv, nh = stencil.grid
    prepared = None
    if path is None:
        path, prepared = _pick_path(stencil, nb,
                                    stencil.device.type == "cuda")
    elif path not in _PORTED:
        raise ValueError(f"unknown path {path!r}; ported: {_PORTED} (JAX's "
                         "vmem-coef and vmem-const are l2-coef and l2-const; "
                         "the pad-> plans are not needed: the kernels read "
                         "any height)")
    elif path == "stream":
        prepared = prepare_stream(stencil)
    elif path == "stream-coef":
        prepared = _prepare_coef(stencil)
    elif path == "stream-real":
        if stencil.coef.is_complex():
            raise ValueError("stream-real takes a real stencil")
        prepared = prepare_real(stencil)
    elif path == "l2-const":
        prepared = prepare_const(stencil)
    solve, solve_planes = _build_solver(stencil, n_iterations, path,
                                        prepared)
    real_planes = path == "stream-real" or (
        path == "eager" and not stencil.coef.is_complex())
    return StencilCGPlan(path=path, grid=(nv, nh), n_iterations=n_iterations,
                         _solve=solve, _solve_planes=solve_planes,
                         real_planes=real_planes)


def stencil_cg(stencil, b, x0=None, n_iterations: int = 10,
               path: Optional[str] = None):
    """One-shot convenience: plan + solve (see :func:`plan_stencil_cg`), in
    span ``tpcg.stencil_cg`` around ``tpcg.plan`` and ``tpcg.solve``."""
    with trace.span("stencil_cg"):
        nv, nh = stencil.grid
        nb = np.asarray(b).size // (nv * nh)
        plan = plan_stencil_cg(stencil, n_iterations, nb=nb, path=path)
        return plan.solve(b, x0)


def _upload_b(b, x0, nv, nh, dev, operand, dtype=None):
    """``(bp, x0p, squeeze)``: b and x0 (None: zeros) as ``_norm_b``'s
    (B, Nv, Nh) blocks made host tensors by ``operand`` (in span
    ``tpcg.pack``), then uploaded to ``dev`` as ``dtype``."""
    with trace.span("pack"):
        B, squeeze = _norm_b(b, nv, nh)
        bt = operand(B)
        x0t = None if x0 is None else operand(_norm_b(x0, nv, nh)[0])
    bp = upload(bt, dev, dtype)
    x0p = torch.zeros_like(bp) if x0t is None else upload(x0t, dev, dtype)
    return bp, x0p, squeeze


def _download(dev, x, hist, squeeze):
    """x and the history in host memory, after the solve (``tpcg.wait``);
    a single RHS's without its batch axis (``tpcg.pack``)."""
    wait(dev)
    x, hist = download(x), download(hist)
    if squeeze:
        with trace.span("pack"):
            return x[0], hist[:, 0]
    return x, hist


def _real_planes(B):
    """(B, Nv, Nh) numpy -> float32 host tensor."""
    return torch.from_numpy(np.ascontiguousarray(B, dtype=np.float32))


def _grid_planes(B):
    """(B, Nv, Nh) complex numpy -> (2, B, Nv, Nh) float32 host planes."""
    return torch.from_numpy(np.stack([B.real, B.imag]).astype(np.float32))


def _build_solver(stencil, n_iterations, path, prepared=None):
    nv, nh = stencil.grid
    n = nv * nh
    dev = stencil.device

    if path == "l2-coef":
        coef3 = prepare_coef3(stencil)

        def solve_planes(bp, x0p):
            return fused_cg_stencil_chunked(stencil.offsets, coef3, bp, x0p,
                                            n_iterations)
    elif path == "l2-const":
        cr, ci, strips = prepared

        def solve_planes(bp, x0p):
            return fused_cg_const_chunked(stencil.offsets, stencil.grid, cr,
                                          ci, strips, bp, x0p, n_iterations)
    elif path == "stream-real":
        cpad = None
        if prepared[0] == "coef" and prepared[1].device.type == "cuda":
            # coef mode's planes at the kernel's pitch, once a plan: every
            # launch (one a RHS) reads this copy, and the plan keeps no
            # other (the planes become a view of it)
            cpad = pad_real_planes(stencil.offsets, prepared[1])
            prepared = ("coef", cpad[..., :nh])

        def solve_planes(bp, x0p):
            # one launch per RHS, queued back to back on the current stream
            runs = [solve_real_planes(stencil.offsets, prepared, bp[c],
                                      x0p[c], n_iterations, cpad=cpad)
                    for c in range(bp.shape[0])]
            return (torch.stack([x for x, _ in runs]),
                    torch.stack([h for _, h in runs], dim=1))

        def solve_real(b, x0):
            bp, x0p, squeeze = _upload_b(b, x0, nv, nh, dev, _real_planes)
            return _download(dev, *solve_planes(bp, x0p), squeeze)
        return solve_real, solve_planes
    elif path == "stream-coef" and torch.is_tensor(prepared):
        # general coefficients: one launch per chunk of RHS, which share
        # one read of the planes (a single RHS runs the NB=1 instance)
        def solve_planes(bp, x0p):
            return stream_cg_coef_planes_batched_fat(
                stencil.offsets, prepared, bp, x0p, n_iterations)
    elif path == "stream":
        taps, strips = prepared
        chunk = _stream_chunk(nv, nh)

        def solve_planes(bp, x0p):
            # one launch per chunk of RHS, queued on the current stream
            return stream_cg_const_planes_batched(
                stencil.offsets, stencil.grid, taps, strips, bp, x0p,
                n_iterations, chunk=chunk)
    elif path == "stream-coef":
        half_offsets, cplanes = prepared
        cpad = None
        if cplanes.device.type == "cuda":
            # the half planes at the kernel's pitch, once a plan: every
            # launch (one a RHS) reads this copy, and the plan keeps no
            # other (cplanes becomes a view of it)
            cpad = pad_sym_planes(half_offsets, cplanes)
            cplanes = cpad[..., :nh]

        def solve_one(b, x0):
            return stream_cg_sym_planes(half_offsets, cplanes, b, x0,
                                        n_iterations, cpad=cpad)

        def solve_planes(bp, x0p):
            # one launch per RHS, queued back to back on the current
            # stream; no host sync between them
            runs = [solve_one(bp[:, c], x0p[:, c])
                    for c in range(bp.shape[1])]
            return (torch.stack([x for x, _ in runs], dim=1),
                    torch.stack([h for _, h in runs], dim=1))
    elif not stencil.coef.is_complex():
        # eager on a real stencil: real (B, Nv, Nh) planes through block_cg
        # in the stencil's dtype (at least float32), as solve runs it
        dt = torch.promote_types(stencil.dtype, torch.float32)

        def solve_planes(bp, x0p):
            nb = bp.shape[0]
            res = block_cg(stencil, bp.reshape(nb, n).T.to(dt),
                           x0p.reshape(nb, n).T.to(dt),
                           n_iterations=n_iterations)
            return res.x.T.reshape(nb, nv, nh), res.residual_history
    else:
        pair = make_pair_operator(stencil, dtype=torch.float32)

        def solve_planes(bp, x0p):
            nb = bp.shape[1]
            res = block_cg_planes_chunked(
                pair, bp.reshape(2, nb, n).transpose(1, 2),
                x0p.reshape(2, nb, n).transpose(1, 2),
                n_iterations=n_iterations)
            return (res.x.transpose(1, 2).reshape(2, nb, nv, nh),
                    res.residual_history)

    def solve_f32(b, x0):
        bp, x0p, squeeze = _upload_b(b, x0, nv, nh, dev, _grid_planes)
        x, hist = _download(dev, *solve_planes(bp, x0p), False)
        with trace.span("pack"):
            xc = (x[0] + 1j * x[1]).astype(np.complex64)
            if squeeze:
                return xc[0], hist[:, 0]
            return xc, hist

    if path != "eager" or (stencil.coef.is_complex()
                           and dev.type == "cuda"):
        return solve_f32, solve_planes

    # CPU (or a real stencil): block_cg in the stencil's dtype promoted to
    # at least single precision, as JAX's xla path does
    dt = torch.promote_types(
        stencil.dtype,
        torch.complex64 if stencil.coef.is_complex() else torch.float32)

    def solve(b, x0):
        bm, x0m, squeeze = _upload_b(
            b, x0, nv, nh, dev,
            lambda B: torch.from_numpy(B.reshape(-1, n).T.copy()), dt)
        res = block_cg(stencil, bm, x0m, n_iterations=n_iterations)
        return _download(dev, res.x.T.reshape(-1, nv, nh),
                         res.residual_history, squeeze)
    return solve, solve_planes
