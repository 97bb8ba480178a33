"""tpcg_torch.sparse against tpcg.sparse: matvecs in float64 to 1e-12,
scipy forms equal, and from_tpcg carrying operators across."""
import numpy as np
import pytest
import torch

import tpcg.sparse as jsp
from tpcg.ops.fused_cg import prepare_coef3 as jax_prepare_coef3
from tpcg.problems import helm_fe, poisson
from tpcg_torch.convert import coef3_from_numpy, from_tpcg
from tpcg_torch.ops.fused_cg import prepare_coef3
from tpcg_torch.sparse import DiaMatrix, Stencil2D, _shift2d


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
