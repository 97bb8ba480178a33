"""Several right-hand sides on the port's ``stream`` path against the JAX
package's batched and merged streaming kernels, run in Pallas interpret mode
on the CPU.

The port runs B RHS of a constant-tap stencil through
``stream_cg_const_planes_batched`` (on a card, ``csrc/stream_cg.cu`` once per
chunk of RHS; here its plain version, each RHS through the single-RHS plain
version).  It is compared with JAX's ``stream_cg_const_planes_batched``
(``_build_k1_const_batched`` + ``_make_k2_batched``), with its merged v3
const kernel (``stream_cg_v3_const_planes``, one RHS), with JAX's planner
forced onto its batched tier, and, for the general-coefficient path, with
JAX's ``stream_cg_coef_planes_batched`` (``_build_k1_coef_batched``).

Tolerances: x within 2e-3 max|x| and the history within 5e-3 relative (the
JAX package's own, tests/test_stream_cg.py), over at most 15 iterations from
a seeded x0.  The two sides sum their dot products in different float32
orders (JAX by row blocks, and its batched driver fuses the delta0
reduction differently from its single-RHS one, parting by ~2e-6:
``tpcg/ops/stream_cg.py:1247-1258``), and COCG on the indefinite Helmholtz
matrix carries that rounding into the iterates.  Where both sides run the
same plain recurrence, results are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpcg
import tpcg.ops.auto as jauto
import tpcg_torch
from tpcg.ops.stream_cg import prepare_stream as jax_prepare_stream
from tpcg.ops.stream_cg import prepare_stream_coef as jax_prepare_coef
from tpcg.ops.stream_cg import (stream_cg_coef_planes_batched,
                                stream_cg_const_planes_batched)
from tpcg.ops.stream_cg_v3 import stream_cg_v3_const_planes
from tpcg.problems import helm_fe, helm_fe_var, local_rect, plane_wave_rhs
from tpcg.sparse import Stencil2D as JaxStencil2D
from tpcg_torch.convert import from_tpcg
from tpcg_torch.ops import auto
from tpcg_torch.ops import stream_cg as ts
from tpcg_torch.ops import stream_cg_coef as tgc
from tpcg_torch.trace import counters

K = 9.0


def _planes(z):
    """complex (..., Nv, Nh) numpy -> float32 planes (2, ..., Nv, Nh)."""
    return torch.from_numpy(np.stack([z.real, z.imag]).astype(np.float32))


def _x0(shape, seed=3):
    rng = np.random.default_rng(seed)
    return 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def _stencil(nv, nh):
    """helm_fe(N, 9, eps=9), or local_rect cut to nv x nh when not square."""
    if nv == nh:
        return helm_fe(nv, K, eps=K)
    return local_rect(max(nv, nh), K, K, eta=K, Nvert=nv, Nhoriz=nh)


def _batch(nv, nh, nb, seed=5):
    """The square grid's plane wave cut to size, times (1 + 0.1j r), plus a
    seeded perturbation per RHS: nb distinct complex RHS (nb, nv, nh)."""
    b = plane_wave_rhs(max(nv, nh), K)[:nv, :nh]
    return np.stack([b * (1 + 0.1j * r) for r in range(nb)]) \
        + 0.05 * _x0((nb, nv, nh), seed)


def _case(nv, nh, nb):
    A = _stencil(nv, nh)
    taps, strips = ts.prepare_stream(from_tpcg(A))
    return (A, taps, strips, _planes(_batch(nv, nh, nb)),
            _planes(_x0((nb, nv, nh))))


def _jax(v):
    return jnp.asarray(v.numpy())


def _assert_close(xt, ht, xj, hj):
    xt, ht = np.asarray(xt), np.asarray(ht)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert xt.shape == xj.shape and ht.shape == hj.shape
    assert np.isfinite(xt).all() and np.isfinite(ht).all()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=2e-3 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=5e-3)


def _port(A, taps, strips, bp, x0p, iters, **kw):
    return ts.stream_cg_const_planes_batched(A.offsets, A.grid, taps, strips,
                                             bp, x0p, iters, **kw)


@pytest.mark.parametrize("nv,nh,nb", [(48, 48, 3), (64, 64, 4), (40, 56, 3)])
def test_batched_plain_matches_jax_batched(nv, nh, nb):
    """#10 + #11: JAX's batched const K1 and K2 over a (row block, RHS)
    grid against the port's batched plain version, every RHS, 15
    iterations; a square and a non-square grid."""
    A, taps, strips, bp, x0p = _case(nv, nh, nb)
    iters = 15
    xj, hj = stream_cg_const_planes_batched(
        A.offsets, A.grid, *jax_prepare_stream(A), _jax(bp), _jax(x0p), iters,
        interpret=True)
    xt, ht = _port(A, taps, strips, bp, x0p, iters)
    assert xt.shape == (2, nb, nv, nh) and ht.shape == (iters + 1, nb)
    xj, hj = np.asarray(xj), np.asarray(hj)
    for c in range(nb):
        _assert_close(xt[:, c], ht[:, c], xj[:, c], hj[:, c])


@pytest.mark.parametrize("nb", [3, 10])
def test_each_rhs_is_its_single_rhs_solve(nb):
    """Each RHS of the batched plain version (B=10: more RHS than the
    kernel takes in one launch) is the single-RHS plain version's bit for
    bit, and the ``chunk`` argument changes nothing."""
    A, taps, strips, bp, x0p = _case(24, 32, nb)
    xt, ht = _port(A, taps, strips, bp, x0p, 12)
    for c in range(nb):
        x1, h1 = ts.stream_cg_const_planes(A.offsets, A.grid, taps, strips,
                                           bp[:, c], x0p[:, c], 12)
        assert torch.equal(xt[:, c], x1) and torch.equal(ht[:, c], h1)
    xc, hc = _port(A, taps, strips, bp, x0p, 12, chunk=3)
    assert torch.equal(xc, xt) and torch.equal(hc, ht)
    xp, hp = ts.stream_cg_const_planes_batched_plain(A.offsets, A.grid, taps,
                                                     strips, bp, x0p, 12)
    assert torch.equal(xp, xt) and torch.equal(hp, ht)


@pytest.mark.parametrize("keep_r", [True, False])
def test_plain_matches_jax_v3_const(keep_r):
    """#15 (const): JAX's merged v3 kernel, r kept in VMEM or streamed,
    against the port's single-RHS plain version (what ``csrc/stream_cg.cu``
    is held against on the card), 15 iterations."""
    A, taps, strips, bp, x0p = _case(64, 64, 1)
    bp, x0p = bp[:, 0], x0p[:, 0]
    xj, hj = stream_cg_v3_const_planes(
        A.offsets, A.grid, *jax_prepare_stream(A), _jax(bp), _jax(x0p), 15,
        keep_r=keep_r, interpret=True)
    xt, ht = ts.stream_cg_const_planes(A.offsets, A.grid, taps, strips, bp,
                                       x0p, 15)
    _assert_close(xt, ht, xj, hj)


def _nonsym(N, seed=0):
    """benchmarks/exp_batchfat.py's class helm_fe_var(N, 8, C, rho=0.5) with
    coefficient plane 1 scaled by 1.5 (non-symmetric), as
    tests/test_torch_stream_coef.py builds it."""
    C = 1.0 + 0.5 * np.random.default_rng(seed).random((N - 1, N - 1))
    A = helm_fe_var(N, 8.0, C, rho=0.5)
    c = np.array(np.asarray(A.coef))
    c[1] *= 1.5
    return JaxStencil2D(A.offsets, jnp.asarray(c), A.grid)


def test_coef_batched_plain_matches_jax_batched():
    """#9: JAX's ``stream_cg_coef_planes_batched`` (coefficient K1 over a
    (row block, RHS) grid) on a non-symmetric stencil, nb = 3, against the
    port's function of the same name (its plain version here), 12
    iterations (the general class parts fast: tests/test_torch_stream_coef.py)."""
    N, nb, iters = 48, 3, 12
    A = _nonsym(N)
    coefp = tgc.prepare_stream_coef(from_tpcg(A))
    b = plane_wave_rhs(N, 8.0)
    bp = _planes(np.stack([b * (1 + 0.1j * r) for r in range(nb)]))
    x0p = _planes(_x0((nb, N, N)))
    xj, hj = stream_cg_coef_planes_batched(
        A.offsets, A.grid, jax_prepare_coef(A), _jax(bp), _jax(x0p), iters,
        interpret=True)
    xt, ht = tgc.stream_cg_coef_planes_batched(A.offsets, coefp, bp, x0p,
                                               iters)
    xj, hj = np.asarray(xj), np.asarray(hj)
    for c in range(nb):
        _assert_close(xt[:, c], ht[:, c], xj[:, c], hj[:, c])
    xp, hp = tgc.stream_cg_coef_planes_batched_plain(A.offsets, coefp, bp,
                                                     x0p, iters)
    assert torch.equal(xp, xt) and torch.equal(hp, ht)


def test_forced_stream_plan_matches_jax_batched_planner(monkeypatch):
    """A forced ``stream`` plan at B=3 on the CPU (plain version, no launch)
    against JAX's planner in interpret mode with its resident tiers (v4, v5,
    column-padded v5) ruled out, so that it takes its batched kernels
    (``fnb``) for B >= 2, as it does on grids such as 2500 x 2500."""
    monkeypatch.setattr(jauto, "_VMEM_NODES", 16)
    monkeypatch.setattr(jauto, "_v4_config", lambda *a, **k: None)
    monkeypatch.setattr(jauto, "_v5_config", lambda *a, **k: None)
    N, nb, iters = 48, 3, 12
    A = helm_fe(N, K, eps=K)
    B = _batch(N, N, nb)
    jplan = tpcg.plan_stencil_cg(A, iters, nb=nb, interpret=True)
    assert jplan.path == "stream"
    xj, hj = jplan.solve(B)
    tplan = tpcg_torch.plan_stencil_cg(from_tpcg(A), iters, nb=nb,
                                       path="stream")
    before = counters().get("launch.stream_const", 0)
    xt, ht = tplan.solve(B)
    assert counters().get("launch.stream_const", 0) == before
    assert xt.dtype == np.complex64 and xt.shape == (nb, N, N)
    assert ht.shape == (iters + 1, nb)
    for c in range(nb):
        _assert_close(xt[c], ht[:, c], xj[c], hj[:, c])


def test_frozen_column_leaves_its_neighbour_alone():
    """A 2-RHS batch: column 0 has b = A x0 exactly, so r0 = 0 and it
    freezes at iteration 1 (x stays x0, the history 0); column 1 is live
    and gives the bits of its own single-RHS solve."""
    A, taps, strips, bp, x0p = _case(32, 32, 2)
    bp[:, 0] = ts.apply_const_planes(A.offsets, taps, strips, x0p[:, 0])
    xt, ht = _port(A, taps, strips, bp, x0p, 20)
    assert torch.equal(xt[:, 0], x0p[:, 0]) and torch.all(ht[:, 0] == 0)
    x1, h1 = ts.stream_cg_const_planes(A.offsets, A.grid, taps, strips,
                                       bp[:, 1], x0p[:, 1], 20)
    assert torch.equal(xt[:, 1], x1) and torch.equal(ht[:, 1], h1)
    assert torch.all(ht[1:, 1] > 0)


def test_zero_rhs_stays_zero():
    A, taps, strips, bp, _ = _case(24, 24, 3)
    x, h = _port(A, taps, strips, torch.zeros_like(bp), torch.zeros_like(bp),
                 30)
    assert x.shape == bp.shape and h.shape == (31, 3)
    assert torch.all(x == 0) and torch.all(h == 0)


def test_argument_checks():
    A, taps, strips, bp, x0p = _case(16, 16, 2)
    with pytest.raises(ValueError, match="b must be"):
        _port(A, taps, strips, bp[:, 0], x0p[:, 0], 3)
    with pytest.raises(ValueError, match="B >= 1"):
        _port(A, taps, strips, bp[:, :0], x0p[:, :0], 3)
    with pytest.raises(ValueError, match="b must be"):
        _port(A, taps, strips, bp[..., :8], x0p[..., :8], 3)
    with pytest.raises(ValueError, match="x0"):
        _port(A, taps, strips, bp, x0p[:, :1], 3)
    with pytest.raises(TypeError):
        _port(A, taps, strips, bp.double(), x0p.double(), 3)
    with pytest.raises(ValueError, match="chunk"):
        _port(A, taps, strips, bp, x0p, 3, chunk=0)
    with pytest.raises(ValueError, match="n_iterations"):
        _port(A, taps, strips, bp, x0p, -1)


@pytest.mark.parametrize("nb", [1, 10])
def test_stream_plan_runs_the_batched_function(nb):
    """The ``stream`` plan's device surface is the batched function with
    the planner's chunk: B=1 and B=10 through ``solve_planes`` equal
    ``stream_cg_const_planes_batched`` bit for bit, and ``solve`` gives the
    same numbers as complex64."""
    A, taps, strips, bp, x0p = _case(24, 24, nb)
    plan = tpcg_torch.plan_stencil_cg(from_tpcg(A), 10, nb=nb, path="stream")
    xp, hp = plan.solve_planes(bp, x0p)
    xb, hb = _port(A, taps, strips, bp, x0p, 10,
                   chunk=auto._stream_chunk(*A.grid))
    assert torch.equal(xp, xb) and torch.equal(hp, hb)
    B = _batch(24, 24, nb)
    X0 = _x0((nb, 24, 24))
    x, hist = plan.solve(B, X0)
    np.testing.assert_array_equal(x, (xb[0] + 1j * xb[1]).numpy()
                                  .astype(np.complex64))
    np.testing.assert_array_equal(hist, hb.numpy())
