"""tpcg_torch.ops.fused_cg_const (the planner's ``l2-const`` path, JAX's
``vmem-const``) against the JAX package's ``fused_cg_const_planes`` run in
Pallas interpret mode on the CPU.

The port's plain version (what the const instance of ``csrc/fused_cg.cu`` is
held against on the card) is compared at B=1 and B=2 with an initial guess,
on helm_fe and on helm_fe with a varying left edge (a constant interior,
non-constant edge strips: ``prepare_stream`` refuses it, ``prepare_const``
does not).  Tolerance: x within 2e-3 max|x| and the history within 1e-3
relative over at most 20 iterations with a plane wave RHS: on the
indefinite Helmholtz class two float32 orders of COCG part over longer
windows.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpcg
import tpcg_torch
from tpcg.ops import fused_cg_const as jfc
from tpcg.problems import helm_fe, local_rect, plane_wave_rhs
from tpcg.sparse import Stencil2D as JaxStencil2D
from tpcg_torch.convert import const_operands_from_tpcg, from_tpcg
from tpcg_torch.ops import fused_cg_const as tcc
from tpcg_torch.trace import counters

# the package exports a function named fused_cg that hides the module
tfc = importlib.import_module("tpcg_torch.ops.fused_cg")

K = 9.0


def _stencil(kind, N=24):
    """helm_fe(N, 9, eps=9), or the same with the diagonal of its left edge
    (rows 1..N-2 of column 0) scaled by a ramp: still symmetric, a constant
    interior, edge strips that are not constant."""
    A = helm_fe(N, K, eps=K)
    if kind == "edge":
        coef = np.array(np.asarray(A.coef))
        coef[0, 1:-1, 0] *= 1.0 + 0.02 * np.arange(N - 2)
        A = JaxStencil2D(A.offsets, jnp.asarray(coef), A.grid)
    return A


def _planes(Z):
    return torch.from_numpy(np.stack([Z.real, Z.imag]).astype(np.float32))


def _rhs(N, nb, seed=3):
    b = plane_wave_rhs(N, K)
    B = np.stack([b, 0.5j * b][:nb])
    rng = np.random.default_rng(seed)
    X0 = 0.1 * (rng.standard_normal(B.shape)
                + 1j * rng.standard_normal(B.shape))
    return _planes(B), _planes(X0)


def _assert_close(xt, ht, xj, hj):
    xt, ht = np.asarray(xt), np.asarray(ht)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert xt.shape == xj.shape and ht.shape == hj.shape
    assert np.isfinite(xt).all() and np.isfinite(ht).all()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=2e-3 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=1e-3)


@pytest.mark.parametrize("kind", ["helm_fe", "edge", "local_rect"])
def test_prepare_const_matches_jax(kind):
    """Taps equal JAX's exactly, and the converter's strips (planes 0 and 1,
    the edge blocks' one-hot column) equal the port's own bit for bit."""
    A = (local_rect(40, K, K, eta=K, Nvert=24, Nhoriz=36)
         if kind == "local_rect" else _stencil(kind))
    jcr, jci, js = jfc.prepare_const(A)
    cr, ci, strips = tcc.prepare_const(from_tpcg(A))
    assert (cr, ci) == (jcr, jci)
    nv, nh = A.grid
    noff = len(A.offsets)
    assert [tuple(s.shape) for s in strips] == [(2, noff, nh)] * 2 + [
        (2, noff, nv - 2)] * 2
    c2, i2, s2 = const_operands_from_tpcg(jcr, jci, js)
    assert (c2, i2) == (cr, ci)
    for a, b in zip(s2, strips):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    # the one-hot edge blocks hold nothing outside the column carried across
    sl, sr = np.asarray(js[2]), np.asarray(js[3])
    assert not sl[:, :, :, 1:].any() and not sr[:, :, :, :-1].any()


@pytest.mark.parametrize("kind,nv,nh", [("helm_fe", 24, 24),
                                        ("local_rect", 24, 36),
                                        ("local_rect", 29, 20),
                                        ("edge", 24, 24)])
def test_apply_const_strips_matches_scipy(kind, nv, nh):
    """The plain operator equals A.to_scipy() @ x in complex128 to float32
    rounding on square, non-square and prime-height grids, B=2."""
    A = (local_rect(max(nv, nh), K, K, eta=K, Nvert=nv, Nhoriz=nh)
         if kind == "local_rect" else _stencil(kind, nv))
    cr, ci, strips = tcc.prepare_const(from_tpcg(A))
    rng = np.random.default_rng(5)
    X = rng.standard_normal((2, nv, nh)) + 1j * rng.standard_normal((2, nv, nh))
    P = tfc._pad_for(A.offsets)
    dpad = torch.nn.functional.pad(_planes(X), (P, P, P, P))
    q = tcc.apply_const_strips(A.offsets, cr, ci, strips, dpad).double()
    q = (q[0] + 1j * q[1]).numpy()
    S = A.to_scipy()
    for c in range(2):
        ref = (S @ X[c].astype(np.complex64).reshape(-1)).reshape(nv, nh)
        assert np.abs(q[c] - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("kind,nb", [("helm_fe", 1), ("helm_fe", 2),
                                     ("edge", 1), ("edge", 2)])
def test_plain_matches_jax(kind, nb):
    """#2: the whole solve, B RHS with a seeded x0, 20 iterations."""
    A = _stencil(kind)
    bp, x0p = _rhs(A.grid[0], nb)
    xj, hj = jfc.fused_cg_const_planes(
        A.offsets, A.grid, *jfc.prepare_const(A), jnp.asarray(bp.numpy()),
        jnp.asarray(x0p.numpy()), 20, interpret=True)
    cr, ci, strips = tcc.prepare_const(from_tpcg(A))
    before = counters().get("launch.fused_const", 0)
    xt, ht = tcc.fused_cg_const_planes(A.offsets, A.grid, cr, ci, strips, bp,
                                       x0p, 20)
    assert counters().get("launch.fused_const", 0) == before
    _assert_close(xt, ht, xj, hj)


def test_plain_matches_the_coefficient_kernels_plain():
    """The const operator is the same matrix as the coefficient planes: the
    two plain whole solves agree (they apply it in different orders)."""
    A = _stencil("edge")
    T = from_tpcg(A)
    bp, x0p = _rhs(A.grid[0], 2)
    xc, hc = tcc.fused_cg_const_planes(A.offsets, A.grid,
                                       *tcc.prepare_const(T), bp, x0p, 20)
    xs, hs = tfc.fused_cg_stencil_plain(A.offsets, tfc.prepare_coef3(T), bp,
                                        x0p, 20)
    _assert_close(xc, hc, xs, hs)


@pytest.mark.parametrize("nb", [1, 2])
def test_forced_l2_const_plan_matches_jax_planner(nb):
    """``path="l2-const"`` on the CPU (the plain version) against JAX's
    ``vmem-const`` plan in interpret mode: complex64 x of JAX's shape."""
    N = 24
    A = _stencil("helm_fe", N)
    b = plane_wave_rhs(N, K)
    B = b if nb == 1 else np.stack([b, 0.5j * b])
    jplan = tpcg.plan_stencil_cg(A, 15, path="vmem-const", interpret=True)
    tplan = tpcg_torch.plan_stencil_cg(from_tpcg(A), 15, path="l2-const")
    assert tplan.path == "l2-const"
    xj, hj = jplan.solve(B)
    xt, ht = tplan.solve(B)
    assert xt.dtype == np.complex64
    _assert_close(xt, ht, xj, hj)
    xp, hp = tplan.solve_planes(_planes(np.asarray(B).reshape(-1, N, N)))
    assert xp.shape == (2, nb, N, N) and hp.shape == (16, nb)


def test_chunked_splits_into_balanced_launches(monkeypatch):
    """Five RHS with a chunk of two run as three launches of 2, 2 and 1,
    each RHS as in a launch of its own."""
    A = _stencil("helm_fe", 12)
    T = from_tpcg(A)
    cr, ci, strips = tcc.prepare_const(T)
    rng = np.random.default_rng(6)
    bp = torch.from_numpy(rng.standard_normal((2, 5, 12, 12)).astype(
        np.float32))
    sizes = []
    real = tcc.fused_cg_const_planes

    def spy(*args):
        sizes.append(args[5].shape[1])
        return real(*args)
    monkeypatch.setattr(tcc, "fused_cg_const_planes", spy)
    xc, hc = tcc.fused_cg_const_chunked(A.offsets, A.grid, cr, ci, strips,
                                        bp, torch.zeros_like(bp), 8, chunk=2)
    assert sizes == [2, 2, 1]
    for c in range(5):
        x1, h1 = real(A.offsets, A.grid, cr, ci, strips, bp[:, c:c + 1],
                      torch.zeros_like(bp[:, c:c + 1]), 8)
        np.testing.assert_allclose(xc[:, c:c + 1].numpy(), x1.numpy(),
                                   rtol=0, atol=1e-6 * x1.abs().max().item())
        np.testing.assert_allclose(hc[:, c:c + 1].numpy(), h1.numpy(),
                                   rtol=1e-6)


def test_variable_interior_is_refused():
    from tpcg.problems import helm_fe_var
    C = 1.0 + 0.5 * np.random.default_rng(4).random((11, 11))
    A = helm_fe_var(12, 12.0, C, rho=0.1)
    with pytest.raises(ValueError, match="not constant"):
        jfc.prepare_const(A)
    with pytest.raises(ValueError, match="not constant"):
        tpcg_torch.plan_stencil_cg(from_tpcg(A), 5, path="l2-const")


def test_argument_checks():
    A = _stencil("helm_fe", 12)
    cr, ci, strips = tcc.prepare_const(from_tpcg(A))
    bp, x0p = _rhs(12, 1)
    args = (A.offsets, A.grid, cr, ci)
    with pytest.raises(ValueError, match="strips"):
        tcc.fused_cg_const_planes(*args, strips[:3], bp, x0p, 3)
    with pytest.raises(ValueError, match="b must be"):
        tcc.fused_cg_const_planes(*args, strips, bp[0], x0p[0], 3)
    with pytest.raises(TypeError):
        tcc.fused_cg_const_planes(*args, strips, bp.double(), x0p.double(), 3)
    with pytest.raises(ValueError, match="taps"):
        tcc.fused_cg_const_planes(A.offsets, A.grid, cr[:3], ci, strips, bp,
                                  x0p, 3)
    with pytest.raises(ValueError, match="n_iterations"):
        tcc.fused_cg_const_planes(*args, strips, bp, x0p, -1)

