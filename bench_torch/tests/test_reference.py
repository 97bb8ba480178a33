"""The plain reference against the program on the CPU at small sizes: the
operators equal the program's assembled matrices, the RHS generator the
program's ``plane_wave_rhs``, and float64 COCG and CG the program's
``block_cg`` in complex128 and float64.  (The reference itself imports
nothing of the program.)"""
import numpy as np
import pytest
import torch

from bench_torch.reference import banded
from bench_torch.reference.cg import cg
from bench_torch.reference.cocg import cocg
from bench_torch.reference.helm_fe import HelmFE
from bench_torch.rhs import gaussian
from bench_torch.rhs.plane_wave import plane_wave, pool


def _planes(z):
    z = torch.from_numpy(np.ascontiguousarray(z))
    return z.real.double(), z.imag.double()


@pytest.mark.parametrize("N, k, eps", [(5, 12.0, 12.0), (17, 12.0, 12.0),
                                       (33, 4.0, 1.0)])
def test_operator_equals_the_program_matrix(N, k, eps):
    from tpcg_torch.problems import helm_fe
    S = helm_fe(N, k, eps, device="cpu").to_scipy()
    rng = np.random.default_rng(N)
    u = rng.standard_normal((3, N, N)) + 1j * rng.standard_normal((3, N, N))
    yr, yi = HelmFE(N, k, eps, torch.float64, "cpu").apply(*_planes(u))
    want = np.stack([(S @ v.reshape(-1)).reshape(N, N) for v in u])
    got = (yr + 1j * yi).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("N", [4, 16, 128])
def test_plane_wave_equals_the_program_generator(N):
    from tpcg_torch.problems import plane_wave_rhs
    for t in np.random.default_rng(N).uniform(0, 2 * np.pi, 4):
        a = (np.cos(t), np.sin(t))
        want = plane_wave_rhs(N, 12.0, a)
        assert np.abs(plane_wave(N, 12.0, a) - want).max() <= \
            1e-14 * np.abs(want).max()


def test_pool_is_the_seed_s():
    cfg = {"N": 16, "k": 12.0}
    traffic = {"pool": 64, "n_rhs": 2}
    a = pool(cfg, traffic, 2**33 + 5)
    assert a[3].shape == (2, 16, 16) and a[3].dtype == np.complex64
    assert np.array_equal(a[3], pool(cfg, traffic, 2**33 + 5)[3])
    assert not np.array_equal(a[3], pool(cfg, traffic, 2**33 + 6)[3])
    assert not np.array_equal(a[3], a[4])


def test_gaussian_requests_share_no_column():
    cfg, traffic = {"n": 1000}, {"pool": 50, "n_rhs": 16}
    p = gaussian.pool(cfg, traffic, 2**33 + 7)
    cols = np.concatenate([p[i] for i in range(50)])
    assert cols.shape == (800, 1000) and cols.dtype == np.float32
    assert len(np.unique(cols[:, :4], axis=0)) == 800
    assert np.array_equal(p[7], gaussian.pool(cfg, traffic, 2**33 + 7)[7])


M_T1_SMALL = {"n": 3000, "half_band_diags": 50, "matrix_seed": 0}


def test_banded_matrix_equals_the_program_generator():
    from tpcg_torch.problems import banded_spd
    want = banded_spd(3000, 50, seed=0)
    got = banded.matrix(M_T1_SMALL)
    assert abs(got - want).max() == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_banded_apply_equals_the_matrix(dtype):
    A = banded.matrix(M_T1_SMALL)
    u = np.random.default_rng(3).standard_normal((3, 3000))
    y, = banded.operator(M_T1_SMALL, dtype, "cpu").apply(
        torch.from_numpy(u).to(dtype))
    want = (A @ u.T).T
    tol = 1e-13 if dtype == torch.float64 else 3e-2
    assert np.abs(y.double().numpy() - want).max() <= tol * np.abs(want).max()


def test_cg_float64_equals_the_program_block_cg():
    from tpcg_torch import DiaMatrix
    from tpcg_torch.cg import block_cg
    A = banded.matrix(M_T1_SMALL)
    b = np.random.default_rng(4).standard_normal((3, 3000))
    x, h = cg(banded.operator(M_T1_SMALL, torch.float64, "cpu"),
              torch.from_numpy(b), 12)
    res = block_cg(DiaMatrix.from_scipy(A, device="cpu"),
                   torch.from_numpy(b.T.copy()), n_iterations=12)
    assert np.abs(x.numpy().T - res.x.numpy()).max() <= \
        1e-10 * np.abs(x.numpy()).max()
    assert np.allclose(h.numpy(), res.residual_history.numpy(), rtol=1e-8)


def test_cocg_float64_equals_the_program_block_cg():
    from tpcg_torch.cg import block_cg
    from tpcg_torch.problems import helm_fe
    N, it = 16, 30
    b = np.stack([plane_wave(N, 12.0, (0.6, 0.8)),
                  plane_wave(N, 12.0, (-1.0, 0.0))])
    xr, xi, h = cocg(HelmFE(N, 12.0, 12.0, torch.float64, "cpu"),
                     *_planes(b), it)
    S = helm_fe(N, 12.0, 12.0, device="cpu")
    res = block_cg(S, torch.from_numpy(b.reshape(2, -1).T.copy()),
                   n_iterations=it)
    x = (xr + 1j * xi).numpy().reshape(2, -1).T
    assert np.abs(x - res.x.numpy()).max() <= 1e-10 * np.abs(x).max()
    assert np.allclose(h.numpy(), res.residual_history.numpy(), rtol=1e-10)
