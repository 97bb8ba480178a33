"""The CUDA kernel of tpcg_torch against its plain PyTorch version, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernel has no CPU mode.  The file imports no JAX, so that it also runs on a
machine that has a card and no JAX; tests/conftest.py imports JAX, so run
it there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

import tpcg_torch
from tpcg_torch.problems import helm_fe, plane_wave_rhs, poisson

# the package exports a function named fused_cg that hides the module
tfc = importlib.import_module("tpcg_torch.ops.fused_cg")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda:0")


def _assert_fused_close(xk, hk, xp, hp):
    """tests/test_fused_cg.py's tolerances: x within 2e-3 max|x|, history
    within rtol 2e-2 plus 1e-3 hist[0]."""
    xk, hk, xp, hp = (t.cpu().numpy() for t in (xk, hk, xp, hp))
    assert np.isfinite(xk).all() and np.isfinite(hk).all()
    np.testing.assert_allclose(xk, xp, rtol=0, atol=2e-3 * np.abs(xp).max())
    np.testing.assert_allclose(hk, hp, rtol=2e-2,
                               atol=1e-3 * np.abs(hp[0]).max())


def _case(dev, name, N, nb, x0_kind="0", k=5.0):
    if name == "poisson":
        S = poisson(N, device=dev)
        b = np.ones((N, N), dtype=complex)
    else:
        S = helm_fe(N, k, eps=k, device=dev)
        b = plane_wave_rhs(N, k)
    B = np.stack([(r + 1) * b for r in range(nb)])
    X0 = np.zeros_like(B)
    if x0_kind == "wave":
        # a smooth initial guess
        t = np.linspace(0.0, 1.0, N)
        w = 0.1 * np.exp(1j * k * (t[:, None] + t[None, :]) / np.sqrt(2.0))
        X0 = np.stack([(r + 1) * w for r in range(nb)])
    elif x0_kind == "random":
        # drawn as tests/test_fused_cg.py draws its initial guess
        rng = np.random.default_rng(0)
        X0 = rng.standard_normal(B.shape) + 1j * rng.standard_normal(B.shape)

    def planes(Z):
        return torch.from_numpy(
            np.stack([Z.real, Z.imag]).astype(np.float32)).to(dev)
    return S, tfc.prepare_coef3(S), planes(B), planes(X0)


# (problem, N, B, x0, k, iterations): random x0 at N=12, k=4, 15 iterations
# is tests/test_fused_cg.py's initial-guess case; N=512 runs the grid-stride
# loops with several nodes per thread
@pytest.mark.parametrize("name,N,nb,x0_kind,k,iters", [
    ("helm_fe", 16, 1, "0", 5.0, 25), ("helm_fe", 16, 3, "wave", 5.0, 25),
    ("helm_fe", 33, 3, "0", 5.0, 25), ("helm_fe", 33, 1, "wave", 5.0, 25),
    ("helm_fe", 12, 1, "random", 4.0, 15),
    ("helm_fe", 512, 2, "random", 12.0, 25),
    ("poisson", 16, 3, "0", 0.0, 25)])
def test_kernel_matches_plain(dev, name, N, nb, x0_kind, k, iters):
    S, coef3, bp, x0p = _case(dev, name, N, nb, x0_kind, k)
    before = tfc.fused_cg_stencil.launches
    xk, hk = tfc.fused_cg_stencil(S.offsets, coef3, bp, x0p, iters)
    assert tfc.fused_cg_stencil.launches == before + 1
    xp, hp = tfc.fused_cg_stencil_plain(S.offsets, coef3, bp, x0p, iters)
    _assert_fused_close(xk, hk, xp, hp)
    # fixed-order reductions: a second launch agrees bit for bit
    xk2, hk2 = tfc.fused_cg_stencil(S.offsets, coef3, bp, x0p, iters)
    assert torch.equal(xk, xk2) and torch.equal(hk, hk2)


@pytest.mark.parametrize("N", [128, 512])
def test_main_path_shape_matches_plain_over_100_iterations(dev, N):
    """The headline problem's shape through the planner, against the plain
    version: x and the history over 100 iterations."""
    S, coef3, bp, x0p = _case(dev, "helm_fe", N, 1, k=12.0)
    plan = tpcg_torch.plan_stencil_cg(S, 100)
    assert plan.path == "l2-coef"
    xk, hk = plan.solve_planes(bp, x0p)
    xp, hp = tfc.fused_cg_stencil_plain(S.offsets, coef3, bp, x0p, 100)
    _assert_fused_close(xk, hk, xp, hp)


def test_kernel_chunks_beyond_its_rhs_limit(dev):
    _, max_rhs = tfc.kernel_limits()
    S, coef3, bp, x0p = _case(dev, "helm_fe", 8, max_rhs + 2)
    with pytest.raises(ValueError):
        tfc.fused_cg_stencil(S.offsets, coef3, bp, x0p, 5)
    xc, hc = tfc.fused_cg_stencil_chunked(S.offsets, coef3, bp, x0p, 5)
    xp, hp = tfc.fused_cg_stencil_plain(S.offsets, coef3, bp, x0p, 5)
    _assert_fused_close(xc, hc, xp, hp)


def test_zero_rhs_column_freezes(dev):
    S, coef3, bp, x0p = _case(dev, "helm_fe", 16, 2)
    bp[:, 1] = 0
    xk, hk = tfc.fused_cg_stencil(S.offsets, coef3, bp, x0p, 300)
    assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
    assert (xk[:, 1] == 0).all() and (hk[:, 1] == 0).all()


def test_planner_on_card_takes_the_kernel_path(dev):
    S = helm_fe(16, 5.0, eps=5.0, device=dev)
    assert tpcg_torch.plan_stencil_cg(S, 10, nb=3).path == "eager"
    plan = tpcg_torch.plan_stencil_cg(S, 10)
    assert plan.path == "l2-coef"
    before = tfc.fused_cg_stencil.launches
    x, hist = plan.solve(plane_wave_rhs(16, 5.0))
    assert tfc.fused_cg_stencil.launches == before + 1
    assert np.isfinite(x).all() and hist.shape == (11,)
    with pytest.raises(NotImplementedError):
        tpcg_torch.plan_stencil_cg(helm_fe(513, 5.0, eps=5.0, device=dev), 5)


def test_eager_path_on_card_matches_kernel_path(dev):
    S = helm_fe(24, 5.0, eps=5.0, device=dev)
    b = np.stack([plane_wave_rhs(24, 5.0)] * 2)
    xk, hk = tpcg_torch.plan_stencil_cg(S, 20, path="l2-coef").solve(b)
    xe, he = tpcg_torch.plan_stencil_cg(S, 20, path="eager").solve(b)
    assert xe.dtype == np.complex64
    np.testing.assert_allclose(xk, xe, rtol=0, atol=2e-3 * np.abs(xe).max())
    np.testing.assert_allclose(hk, he, rtol=2e-2, atol=1e-3 * he[0].max())
