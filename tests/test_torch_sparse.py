"""tpcg_torch.sparse against tpcg.sparse: matvecs in float64 to 1e-12,
scipy forms equal, to_device_matrix's choices equal, and from_tpcg
carrying operators across."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpcg.sparse as jsp
from tpcg.ops.fused_cg import prepare_coef3 as jax_prepare_coef3
from tpcg.problems import helm_fe, poisson
from tpcg_torch.convert import coef3_from_numpy, from_tpcg
from tpcg_torch.ops.fused_cg import prepare_coef3
from tpcg_torch.sparse import (DiaMatrix, EllMatrix, Stencil2D, _shift2d,
                               to_device_matrix)


def _operator(kind):
    return helm_fe(11, 4.0, eps=4.0) if kind == "complex" else poisson(9)


def _vectors(rng, shape, kind):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if kind == "complex" else x


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("nb", [1, 3])
def test_stencil_matvec_and_apply_grid(kind, nb):
    S = _operator(kind)
    T = from_tpcg(S)
    nv, nh = S.grid
    rng = np.random.default_rng(nb)
    xg = _vectors(rng, (nb, nv, nh), kind)
    want = np.asarray(S.apply_grid(xg))
    got = T.apply_grid(torch.from_numpy(xg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    xf = xg.reshape(nb, -1).T if nb > 1 else xg.reshape(-1)
    want = np.asarray(S.matvec(xf))
    got = T.matvec(torch.from_numpy(np.ascontiguousarray(xf))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # and against scipy, which knows nothing of grids
    np.testing.assert_allclose(got, S.to_scipy() @ xf, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_to_scipy_and_to_dia_equal(kind):
    S = _operator(kind)
    T = from_tpcg(S)
    assert (T.to_scipy() != S.to_scipy()).nnz == 0
    jd, td = S.to_dia(), T.to_dia()
    assert td.offsets == tuple(jd.offsets) and td.n == jd.n
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))


@pytest.mark.parametrize("nb", [1, 3])
def test_dia_matvec_and_from_scipy(nb):
    A = helm_fe(7, 3.0, eps=3.0).to_scipy()
    jd = jsp.DiaMatrix.from_scipy(A)
    td = DiaMatrix.from_scipy(A)
    assert td.offsets == tuple(jd.offsets)
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    rng = np.random.default_rng(4)
    x = _vectors(rng, (A.shape[0], nb) if nb > 1 else (A.shape[0],),
                 "complex")
    np.testing.assert_allclose(td.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.matvec(x)), rtol=1e-12,
                               atol=1e-12)
    assert (td.to_scipy() != A).nnz == 0


def test_from_tpcg_round_trips():
    S = helm_fe(6, 3.0, eps=3.0)
    T = from_tpcg(S)
    assert isinstance(T, Stencil2D)
    assert T.offsets == tuple(S.offsets) and T.grid == tuple(S.grid)
    np.testing.assert_array_equal(T.coef.numpy(), np.asarray(S.coef))
    # the JAX container rebuilt from the port's fields is the same operator
    back = jsp.Stencil2D(T.offsets, T.coef.numpy(), T.grid)
    assert (back.to_scipy() != S.to_scipy()).nnz == 0
    D = from_tpcg(S.to_dia())
    assert isinstance(D, DiaMatrix) and D.n == S.n
    assert (D.to_scipy() != S.to_scipy()).nnz == 0
    with pytest.raises(TypeError):
        from_tpcg(object())


def test_coef3_from_numpy_equals_prepare_coef3():
    S = helm_fe(9, 4.0, eps=4.0)
    jc = np.asarray(jax_prepare_coef3(S))
    tc = coef3_from_numpy(jc)
    assert tc.dtype == torch.float32 and tc.shape == jc.shape
    np.testing.assert_array_equal(prepare_coef3(from_tpcg(S)).numpy(), jc)
    np.testing.assert_array_equal(tc.numpy(), jc)
    with pytest.raises(ValueError):
        coef3_from_numpy(jc[0])


@pytest.mark.parametrize("dm,dj", [(0, 0), (2, -1), (-3, 4), (7, 0),
                                   (0, -9)])
def test_shift2d_zero_fill(dm, dj):
    x = torch.arange(5 * 7, dtype=torch.float64).reshape(5, 7) + 1
    got = _shift2d(x, dm, dj).numpy()
    want = np.zeros((5, 7))
    xn = x.numpy()
    for m in range(5):
        for j in range(7):
            if 0 <= m + dm < 5 and 0 <= j + dj < 7:
                want[m, j] = xn[m + dm, j + dj]
    np.testing.assert_array_equal(got, want)


def test_to_device_is_explicit():
    T = from_tpcg(poisson(4))
    assert T.to("cpu").coef.device.type == "cpu"
    assert T.device.type == "cpu"


def _random_sparse(n, per_row, seed, cplx=False):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, n * per_row)
    vals = rng.standard_normal(n * per_row)
    if cplx:
        vals = vals + 1j * rng.standard_normal(n * per_row)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return sp.csr_matrix(A + A.T + sp.eye(n) * per_row)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("nb", [1, 3])
def test_ell_matches_jax(cplx, nb):
    """EllMatrix.from_scipy / from_csr_arrays: the same padded (n, L) layout
    as JAX (padding slots point at their own row), the same matvec."""
    A = _random_sparse(70, 4, seed=nb, cplx=cplx)
    je = jsp.EllMatrix.from_scipy(A)
    te = EllMatrix.from_scipy(A)
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    np.testing.assert_array_equal(te.vals.numpy(), np.asarray(je.vals))
    te2 = EllMatrix.from_csr_arrays(70, A.data, A.indptr, A.indices)
    np.testing.assert_array_equal(te2.vals.numpy(), te.vals.numpy())
    x = _vectors(np.random.default_rng(9),
                 (70, nb) if nb > 1 else (70,), "complex")
    got = te.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(je.matvec(x)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got, A @ x, rtol=1e-12, atol=1e-12)
    back = from_tpcg(je)
    assert isinstance(back, EllMatrix) and back.n == 70
    np.testing.assert_array_equal(back.cols.numpy(), te.cols.numpy())


def _shuffled_band(n, seed):
    A = sp.csr_matrix(sp.diags([np.full(n - 2, -0.5), -np.ones(n - 1),
                                4 * np.ones(n), -np.ones(n - 1),
                                np.full(n - 2, -0.5)], [-2, -1, 0, 1, 2]))
    p = np.random.default_rng(seed).permutation(n)
    return sp.csr_matrix(A[p][:, p])


@pytest.mark.parametrize("kind", ["band", "shuffled", "unstructured"])
@pytest.mark.parametrize("reorder", [False, True])
def test_to_device_matrix_matches_jax(kind, reorder):
    """The same container class, offsets, data and RCM perm as
    tpcg.sparse.to_device_matrix."""
    A = {"band": sp.csr_matrix(helm_fe(7, 3.0, eps=3.0).to_scipy()),
         "shuffled": _shuffled_band(120, 3),
         "unstructured": _random_sparse(90, 5, seed=4)}[kind]
    jr = jsp.to_device_matrix(A, reorder=reorder)
    tr = to_device_matrix(A, reorder=reorder)
    if reorder:
        (jm, jp), (tm, tp) = jr, tr
        assert (jp is None) == (tp is None)
        if jp is not None:
            np.testing.assert_array_equal(tp, jp)
    else:
        jm, tm = jr, tr
    assert type(tm).__name__ == type(jm).__name__
    if isinstance(tm, DiaMatrix):
        assert tm.offsets == tuple(jm.offsets)
        np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
    else:
        np.testing.assert_array_equal(tm.vals.numpy(), np.asarray(jm.vals))
    assert kind != "shuffled" or not reorder or isinstance(tm, DiaMatrix)


def test_route_fallback_refuses_on_cuda_and_returns_ell_on_cpu():
    A = _random_sparse(90, 5, seed=4)
    M, perm = to_device_matrix(A, route_fallback=True)
    assert isinstance(M, EllMatrix) and perm is None
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        to_device_matrix(A, route_fallback=True, device="cuda")
    # a complex unstructured matrix has no route fallback in JAX either
    Mc, _ = to_device_matrix(_random_sparse(90, 5, seed=4, cplx=True),
                             route_fallback=True)
    assert isinstance(Mc, EllMatrix)
