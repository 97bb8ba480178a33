"""Whole-solve COCG for small complex banded matrices (counterpart of ``tpcg/ops/fused_cg_dia.py``).

The mhd1280b class (report Table I: complex n = 1,280, 17 diagonals) does
about 0.2 MFLOP per iteration: too little to fill the card, so a
multi-block kernel would pay its grid barriers every iteration.
``fused_cg_dia_rows_cplx`` runs the whole fixed-iteration solve of each RHS
in ONE thread block of the hand-written CUDA kernel ``csrc/fused_cg_dia.cu``
(values, x, r and the direction in shared memory; see the note there) on a
CUDA tensor, and raises if it cannot run.  On a CPU tensor it runs
:func:`fused_cg_dia_rows_cplx_plain`, the same function in plain PyTorch.

The recurrence is that of the JAX kernel: the direction update at the head
of each iteration, the freeze guard ``|delta|^2 == 0 | |<d,q>|^2 == 0``
evaluated afresh every iteration (not latched), Smith-scaled complex
division, history ``sqrt|<r,r>|``.  The JAX kernel's column-major
``(nv, 128)`` grid and wrap-filled pad exist for TPU lanes; the port reads
the matrix in its row-DIA layout against a zero-bordered direction.

``fused_dia_cplx_fits`` is this card's rule: the kernel's shared memory
(:func:`fused_dia_smem_bytes`) within what an H100 block may use
(``_tiles.BLOCK_SHARED``), and at most 8 rows per thread of a 1024-thread
block.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import _build, _tiles
from .. import trace
from ..device import upload
from .cplx import cdiv, udot_planes
from .stream_cg_dia import (_check_args, _cplx_cols, _pad_for,
                            prepare_dia_rows_cplx)

# the kernel's static shared memory (two reductions of 32 float2) and its
# row limit (1024 threads x 8 rows each, q kept in registers)
_STATIC_SMEM = 2 * 32 * 8
_MAX_ROWS = 8 * 1024


def fused_dia_smem_bytes(n: int, offsets) -> int:
    """Shared memory of one block: value planes (2, ndiag, n), x and r
    (2, n) each, the zero-bordered direction (2, n + 2 max|off|), the tap
    list, and the static reductions (``csrc/fused_cg_dia.cu::smem_bytes``)."""
    pn = n + 2 * _pad_for(offsets)
    nd = len(offsets)
    return 4 * (2 * nd * n + 4 * n + 2 * pn) + 4 * nd + _STATIC_SMEM


def _fits(n: int, offsets) -> bool:
    return (0 < n <= _MAX_ROWS and len(offsets) > 0
            and fused_dia_smem_bytes(n, offsets) <= _tiles.BLOCK_SHARED)


def fused_dia_cplx_fits(dia) -> bool:
    """True if one RHS of the complex DIA problem is resident in one block's
    shared memory (geometry only: ``n`` and ``offsets``)."""
    return _fits(int(dia.n), [int(k) for k in dia.offsets])


def _mag2_zero(v):
    return v[0] * v[0] + v[1] * v[1] == 0


def fused_cg_dia_rows_cplx_plain(offsets: Sequence[int],
                                 values: torch.Tensor, b: torch.Tensor,
                                 x0: torch.Tensor, n_iterations: int):
    """Plain PyTorch version of the kernel, step for step: ``values``
    (2, ndiag, n), ``b``/``x0`` (2, B, n) float32 re/im planes; returns
    ``x`` (2, B, n) and the history (n_iterations+1, B)."""
    _check_args(offsets, values, b, x0, n_iterations, 2)
    n = values.shape[2]
    P = _pad_for(offsets)
    dpad = b.new_zeros(b.shape[:2] + (n + 2 * P,))
    d = dpad[:, :, P:P + n]

    def apply():
        qr = torch.zeros_like(b[0])
        qi = torch.zeros_like(b[0])
        for k, off in enumerate(offsets):
            vr, vi = values[0, k], values[1, k]
            wr = dpad[0, :, P + off:P + off + n]
            wi = dpad[1, :, P + off:P + off + n]
            qr = qr + vr * wr - vi * wi
            qi = qi + vr * wi + vi * wr
        return qr, qi

    def hist_of(dl):
        return torch.sqrt(torch.sqrt(dl[0] * dl[0] + dl[1] * dl[1]))

    d.copy_(x0)
    qr, qi = apply()
    r = torch.stack([b[0] - qr, b[1] - qi])
    x = x0.clone()
    delta = udot_planes(r, r, axis=-1)
    hist = [hist_of(delta)]
    d.zero_()
    beta = torch.zeros_like(delta)
    one = torch.ones_like(delta)
    for _ in range(n_iterations):
        br, bi = beta[0, :, None], beta[1, :, None]
        dn = torch.stack([r[0] + br * d[0] - bi * d[1],
                          r[1] + br * d[1] + bi * d[0]])
        d.copy_(dn)
        qr, qi = apply()
        dq = udot_planes(dn, torch.stack([qr, qi]), axis=-1)
        done = _mag2_zero(delta) | _mag2_zero(dq)
        alpha = torch.where(done, 0.0, cdiv(delta, torch.where(done, one, dq)))
        ar, ai = alpha[0, :, None], alpha[1, :, None]
        x = torch.stack([x[0] + ar * dn[0] - ai * dn[1],
                         x[1] + ar * dn[1] + ai * dn[0]])
        r = torch.stack([r[0] - (ar * qr - ai * qi),
                         r[1] - (ar * qi + ai * qr)])
        dnew = udot_planes(r, r, axis=-1)
        hist.append(hist_of(dnew))
        beta = torch.where(done, 0.0, cdiv(dnew, torch.where(done, one, delta)))
        delta = dnew
    return x, torch.stack(hist)


def kernel_limits():
    """(max rows, max dynamic shared memory per block on the current
    device) of the CUDA kernel."""
    return _build.query("tpcg_fused_dia_limits")


def _launch(offsets, values, b, x0, n_iterations):
    _, ndiag, n = values.shape
    nb = b.shape[1]
    values, b, x0 = values.contiguous(), b.contiguous(), x0.contiguous()
    dev = b.device
    with _build.launch("fused_dia", dev) as run:
        offs = upload(torch.tensor([int(o) for o in offsets],
                                   dtype=torch.int32), dev)
        x = torch.empty_like(b)
        hist = torch.empty((n_iterations + 1, nb), dtype=torch.float32,
                           device=dev)
        run("tpcg_fused_dia",
            values.data_ptr(), offs.data_ptr(), b.data_ptr(), x0.data_ptr(),
            x.data_ptr(), hist.data_ptr(), n, ndiag, nb, _pad_for(offsets),
            n_iterations)
    return x, hist


def fused_cg_dia_rows_cplx(offsets: Sequence[int], values: torch.Tensor,
                           b: torch.Tensor, x0: torch.Tensor,
                           n_iterations: int):
    """Device-resident whole solve: ``values`` (2, ndiag, n) float32 re/im
    row-DIA planes (:func:`prepare_dia_rows_cplx`), ``b``/``x0`` (2, B, n).
    Returns ``x`` (2, B, n) and the history (n_iterations+1, B).

    CUDA tensors launch the kernel once, one block per RHS (the counter
    ``launch.fused_dia`` of ``tpcg_torch.trace`` counts the launches); a
    geometry that does not fit (:func:`fused_dia_cplx_fits`) raises.  CPU
    tensors run :func:`fused_cg_dia_rows_cplx_plain`."""
    _check_args(offsets, values, b, x0, n_iterations, 2)
    if b.device.type == "cuda":
        n = values.shape[2]
        if not _fits(n, offsets):
            raise ValueError(
                f"n={n} with {len(offsets)} diagonals needs "
                f"{fused_dia_smem_bytes(n, offsets)} bytes of shared memory "
                f"(limit {_tiles.BLOCK_SHARED}) or more than {_MAX_ROWS} "
                "rows: use the streaming kernel (tpcg_torch.ops.stream_cg_dia)")
        return _launch(offsets, values, b, x0, n_iterations)
    if b.device.type == "cpu":
        return fused_cg_dia_rows_cplx_plain(offsets, values, b, x0,
                                            n_iterations)
    raise ValueError(f"no fused_cg_dia kernel for device {b.device}")


def fused_cg_dia_cplx_block(dia, B, X0=None, n_iterations: int = 10):
    """Multi-RHS whole solve on a small complex :class:`DiaMatrix`:
    ``B``/``X0`` complex (n, nrhs).  Returns ``X`` complex64 (n, nrhs) and
    the history (n_iterations+1, nrhs) on the matrix's device.  Each RHS is
    its own block of one launch, so its result does not depend on the RHS
    count (the JAX wrapper lax.maps the columns)."""
    with trace.span("prepare"):
        offsets, values = prepare_dia_rows_cplx(dia)
        dev = values.device
        b = _cplx_cols(B, dev)
        x0 = torch.zeros_like(b) if X0 is None else _cplx_cols(X0, dev)
    x, hist = fused_cg_dia_rows_cplx(offsets, values, b, x0, n_iterations)
    return torch.complex(x[0], x[1]).T, hist


def fused_cg_dia_cplx(dia, b, x0=None, n_iterations: int = 10):
    """One RHS: ``b``, ``x0`` complex (n,).  Returns (x complex64 (n,),
    history (n_iterations+1,))."""
    b = torch.as_tensor(b)
    X, H = fused_cg_dia_cplx_block(
        dia, b[:, None], None if x0 is None else torch.as_tensor(x0)[:, None],
        n_iterations)
    return X[:, 0], H[:, 0]
