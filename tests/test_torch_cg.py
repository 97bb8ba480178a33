"""tpcg_torch.cg and tpcg_torch.ops.cplx against the JAX package and the
NumPy oracles."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import tpcg
import tpcg.ops.cplx as jcx
import tpcg_torch
import tpcg_torch.ops.cplx as tcx
from tpcg import reference
from tpcg.problems import helm_fe, plane_wave_rhs, poisson
from tpcg_torch import reference as treference
from tpcg_torch.convert import from_tpcg


def _helm_rhs(N, k, nb):
    b = plane_wave_rhs(N, k).reshape(-1)
    rng = np.random.default_rng(nb)
    cols = [b] + [rng.standard_normal(b.size) + 1j * rng.standard_normal(
        b.size) for _ in range(nb - 1)]
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("nb", [1, 3])
def test_block_cg_complex128_parity_1e10(nb):
    """The PARITY float64 gate: history within 1e-10 relative of the NumPy
    oracle, the solution within 1e-9."""
    S = helm_fe(10, 4.0, eps=4.0)
    B = _helm_rhs(10, 4.0, nb)
    x_ref, h_ref = reference.cg(S.to_scipy(), B, n_iterations=30,
                                record_history=True)
    res = tpcg_torch.block_cg(from_tpcg(S), torch.from_numpy(B),
                              n_iterations=30)
    assert res.x.dtype == torch.complex128
    h = res.residual_history.numpy()
    assert h.shape == (31, nb)
    assert (np.abs(h - h_ref) / np.abs(h_ref)).max() <= 1e-10
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(x_ref).max())


def test_block_cg_matches_jax_block_cg_real():
    S = poisson(12)
    b = np.cos(np.arange(S.n) * 0.37) + 1.5
    xj = tpcg.block_cg(S, jnp.asarray(b), n_iterations=40)
    xt = tpcg_torch.block_cg(from_tpcg(S), torch.from_numpy(b),
                             n_iterations=40)
    np.testing.assert_allclose(xt.x.numpy(), np.asarray(xj.x), rtol=1e-10)
    np.testing.assert_allclose(xt.residual_history.numpy(),
                               np.asarray(xj.residual_history), rtol=1e-10)
    np.testing.assert_allclose(xt.delta.numpy(), np.asarray(xj.delta),
                               rtol=1e-10)


@pytest.mark.parametrize("nb,iters,x0_seed", [(2, 25, None), (1, 15, 0)])
def test_block_cg_planes_f32_matches_jax(nb, iters, x0_seed):
    """f32 planes at tests/test_fused_cg.py's tolerances and windows: 25
    iterations from x0 = 0, 15 from a random x0."""
    N, k = 16, 5.0
    S = helm_fe(N, k, eps=k)
    b = plane_wave_rhs(N, k).reshape(-1)
    B = np.stack([(r + 1) * b for r in range(nb)], axis=1)
    X0 = np.zeros_like(B)
    if x0_seed is not None:
        rng = np.random.default_rng(x0_seed)
        X0 = rng.standard_normal(B.shape) + 1j * rng.standard_normal(B.shape)
    ref = jcx.block_cg_planes(jcx.make_pair_operator(S, dtype=jnp.float32),
                              jcx.to_planes(B, jnp.float32),
                              jcx.to_planes(X0, jnp.float32),
                              n_iterations=iters)
    got = tcx.block_cg_planes(tcx.make_pair_operator(from_tpcg(S)),
                              tcx.to_planes(B, device="cpu"),
                              tcx.to_planes(X0, device="cpu"),
                              n_iterations=iters)
    xr = jcx.from_planes(np.asarray(ref.x))
    np.testing.assert_allclose(tcx.from_planes(got.x), xr, rtol=0,
                               atol=2e-3 * np.abs(xr).max())
    hr = np.asarray(ref.residual_history)
    np.testing.assert_allclose(got.residual_history.numpy(), hr, rtol=2e-2,
                               atol=1e-3 * float(hr[0, 0]))


def test_zero_rhs_column_stays_finite():
    """The freeze guard: a zero column has delta == 0 from the start and
    must stay exactly zero, not NaN, while the other column converges."""
    S = from_tpcg(helm_fe(8, 3.0, eps=3.0))
    b = plane_wave_rhs(8, 3.0).reshape(-1)
    B = np.stack([b, np.zeros_like(b)], axis=1)
    res = tpcg_torch.block_cg(S, torch.from_numpy(B), n_iterations=150)
    assert torch.isfinite(res.x).all()
    assert torch.isfinite(res.residual_history).all()
    assert (res.x[:, 1] == 0).all()
    assert float(res.residual_history[-1, 0]) < 1e-8
    planes = tcx.block_cg_planes(tcx.make_pair_operator(S),
                                 tcx.to_planes(B, device="cpu"),
                                 n_iterations=150)
    assert torch.isfinite(planes.x).all()
    assert torch.isfinite(planes.residual_history).all()
    assert (planes.x[:, :, 1] == 0).all()


def test_block_cg_planes_chunked_equals_per_rhs():
    S = from_tpcg(helm_fe(8, 3.0, eps=3.0))
    B = _helm_rhs(8, 3.0, 5)
    P = tcx.make_pair_operator(S)
    whole = tcx.block_cg_planes(P, tcx.to_planes(B, device="cpu"),
                                n_iterations=12)
    chunked = tcx.block_cg_planes_chunked(P, tcx.to_planes(B, device="cpu"),
                                          n_iterations=12, chunk=2)
    assert chunked.x.shape == whole.x.shape
    assert chunked.residual_history.shape == (13, 5)
    # a chunk's width changes the f32 reduction order, so the f32 tolerances
    xw, hw = whole.x.numpy(), whole.residual_history.numpy()
    np.testing.assert_allclose(chunked.x.numpy(), xw, rtol=0,
                               atol=2e-3 * np.abs(xw).max())
    np.testing.assert_allclose(chunked.residual_history.numpy(), hw,
                               rtol=2e-2, atol=1e-3 * hw[0].max())


def test_cplx_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 6, 4))
    b = rng.standard_normal((2, 6, 4))
    b[:, 0, 0] = [1e-30, -3e-31]       # Smith scaling: no underflow to 0/0
    b[:, 1, 1] = [0.0, 2.0]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for tf, jf in ((tcx.cmul, jcx.cmul), (tcx.cdiv, jcx.cdiv)):
        np.testing.assert_allclose(tf(ta, tb).numpy(),
                                   np.asarray(jf(a, b)), rtol=1e-13)
    np.testing.assert_allclose(tcx.udot_planes(ta, tb, axis=0).numpy(),
                               np.asarray(jcx.udot_planes(a, b, axis=0)),
                               rtol=1e-12)
    np.testing.assert_allclose(tcx.cabs(ta).numpy(),
                               np.asarray(jcx.cabs(a)), rtol=1e-13)
    c = a[0] + 1j * a[1]
    np.testing.assert_array_equal(tcx.from_planes(tcx.to_planes(
        c, torch.float64, device="cpu")), c)
    np.testing.assert_allclose(tcx.cdiv(ta, tb).numpy()[0] + 1j
                               * tcx.cdiv(ta, tb).numpy()[1],
                               c / (b[0] + 1j * b[1]), rtol=1e-12)


def test_udot_is_unconjugated():
    a = torch.tensor([1 + 2j, 3 - 1j], dtype=torch.complex128)
    assert complex(tpcg_torch.udot(a, a)) == complex(np.sum(a.numpy() ** 2))


def test_cg_solve_matches_jax():
    S = poisson(10)
    b = np.sin(np.arange(S.n) * 0.3) + 1.0
    xj, ij = tpcg.cg_solve(S, jnp.asarray(b), tol=1e-8, maxit=500)
    xt, it = tpcg_torch.cg_solve(from_tpcg(S), torch.from_numpy(b),
                                 tol=1e-8, maxit=500)
    assert it == int(ij)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9,
                               atol=1e-12)
    x_ref = reference.cg_early_exit(S.to_scipy(), b, tol=1e-8, maxit=500)
    np.testing.assert_allclose(xt.numpy(), x_ref, rtol=1e-9, atol=1e-12)


ORACLES = {
    "cg": lambda m, A, b: m.cg(A, b, n_iterations=15, record_history=True),
    "cg_early_exit": lambda m, A, b: m.cg_early_exit(A, b, tol=1e-6),
    "pcg": lambda m, A, b: m.pcg(A, b, tol=1e-6),
    "pcg_jacobi": lambda m, A, b: m.pcg(
        A, b, M=sp.diags(1.0 / A.diagonal()), tol=1e-6),
    "gauss_seidel": lambda m, A, b: m.gauss_seidel(A, b, maxit=5,
                                                   sweeps="symmetric"),
}


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_reference_oracles_equal(name):
    """The port carries its own copy of the NumPy oracles: same results."""
    A = poisson(7).to_scipy().tocsr()
    b = np.linspace(1.0, 2.0, A.shape[0])
    got = ORACLES[name](treference, A, b)
    want = ORACLES[name](reference, A, b)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)
