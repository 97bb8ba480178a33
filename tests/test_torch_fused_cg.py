"""tpcg_torch.ops.fused_cg: the plain version against the JAX Pallas kernel
(interpret mode) and the NumPy oracle on the CPU.  The CUDA kernel against
the plain version on a card: tests/test_torch_cuda.py."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpcg import reference
from tpcg.problems import helm_fe, plane_wave_rhs, poisson
from tpcg_torch.convert import from_tpcg
from tpcg_torch.trace import counters

# the packages export a function named fused_cg that hides the module
jfc = importlib.import_module("tpcg.ops.fused_cg")
tfc = importlib.import_module("tpcg_torch.ops.fused_cg")


def _planes(a):
    return np.stack([a.real, a.imag]).astype(np.float32)


def _assert_fused_close(x, hist, x_ref, hist_ref):
    """tests/test_fused_cg.py's tolerances: x within 2e-3 max|x|, history
    within rtol 2e-2 plus 1e-3 hist[0]."""
    x_ref, hist_ref = np.asarray(x_ref), np.asarray(hist_ref)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=0,
                               atol=2e-3 * np.abs(x_ref).max())
    np.testing.assert_allclose(np.asarray(hist), hist_ref, rtol=2e-2,
                               atol=1e-3 * np.abs(hist_ref[0]).max())


def _helm_case(N, nb, x0_seed=None):
    k = 5.0
    S = helm_fe(N, k, eps=k)
    b = plane_wave_rhs(N, k)
    B = np.stack([(r + 1) * b for r in range(nb)])
    X0 = None
    if x0_seed is not None:
        rng = np.random.default_rng(x0_seed)
        X0 = 0.1 * (rng.standard_normal(B.shape)
                    + 1j * rng.standard_normal(B.shape))
    return S, B, X0


@pytest.mark.parametrize("nb,x0_seed", [(1, None), (2, None), (2, 7)])
def test_plain_matches_jax_interpret(nb, x0_seed):
    S, B, X0 = _helm_case(16, nb, x0_seed)
    xj, hj = jfc.fused_cg(S, B, x0=X0, n_iterations=25, interpret=True)
    xt, ht = tfc.fused_cg(from_tpcg(S), B, x0=X0, n_iterations=25)
    assert xt.shape == (2, nb, 16, 16) and ht.shape == (26, nb)
    assert xt.dtype == torch.float32 and ht.dtype == torch.float32
    _assert_fused_close(xt.numpy(), ht.numpy(), xj, hj)


def test_chunked_padded_last_chunk_matches_jax():
    """5 RHS in chunks of 2: the last chunk holds one RHS."""
    S, B, _ = _helm_case(12, 5)
    T = from_tpcg(S)
    coef3 = tfc.prepare_coef3(T)
    bp = torch.from_numpy(_planes(B))
    xc, hc = tfc.fused_cg_stencil_chunked(T.offsets, coef3, bp,
                                          torch.zeros_like(bp), 15, chunk=2)
    xm, hm = tfc.fused_cg_stencil_plain(T.offsets, coef3, bp,
                                        torch.zeros_like(bp), 15)
    assert xc.shape == (2, 5, 12, 12) and hc.shape == (16, 5)
    torch.testing.assert_close(xc, xm, rtol=0, atol=1e-6)
    torch.testing.assert_close(hc, hm, rtol=1e-6, atol=0)
    jb = jnp.asarray(_planes(B))
    xj, hj = jfc.fused_cg_stencil_chunked(S.offsets, jfc.prepare_coef3(S),
                                          jb, jnp.zeros_like(jb), 15,
                                          chunk=2, interpret=True)
    _assert_fused_close(xc.numpy(), hc.numpy(), xj, hj)


def test_plain_poisson_matches_numpy_oracle():
    """A real stencil goes through the same function with Ai = 0."""
    S = poisson(16)
    b = np.ones(S.n)
    x, hist = tfc.fused_cg(from_tpcg(S), b.reshape(16, 16), n_iterations=40)
    x_ref, h_ref = reference.cg(S.to_scipy(), b, n_iterations=40,
                                record_history=True)
    xf = x.numpy()
    np.testing.assert_allclose(xf[0].reshape(-1), x_ref, rtol=1e-3,
                               atol=1e-4)
    assert np.abs(xf[1]).max() == 0.0
    np.testing.assert_allclose(hist.numpy()[:, 0], h_ref, rtol=5e-2,
                               atol=1e-3)


def test_plain_edges_read_zero_whatever_the_coefficient():
    """A tap that leaves the grid reads 0 even where its coefficient is not
    0: the padded buffer, not the coefficient, makes the edge."""
    rng = np.random.default_rng(1)
    N = 9
    offsets = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (2, 2))
    coef = (rng.standard_normal((len(offsets), N, N))
            + 1j * rng.standard_normal((len(offsets), N, N)))
    coef[0] += 12.0
    from tpcg_torch.sparse import Stencil2D
    T = Stencil2D(offsets, torch.from_numpy(coef), (N, N))
    coef3 = tfc.prepare_coef3(T)
    x0 = torch.from_numpy(rng.standard_normal((2, 1, N, N)).astype(
        np.float32))
    b = torch.zeros_like(x0)
    _, hist = tfc.fused_cg_stencil_plain(offsets, coef3, b, x0, 0)
    # r0 = -A x0 with A applied by the zero-filled shifts of sparse.py
    ax = T.apply_grid(torch.complex(x0[0, 0], x0[1, 0]).to(
        torch.complex128)).numpy()
    want = np.sqrt(np.abs(np.sum(ax * ax)))
    np.testing.assert_allclose(float(hist[0, 0]), want, rtol=1e-4)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    S, B, _ = _helm_case(8, 1)
    before = counters().get("launch.fused_cg", 0)
    x1, h1 = tfc.fused_cg(from_tpcg(S), B, n_iterations=6)
    T = from_tpcg(S)
    bp = torch.from_numpy(_planes(B))
    x2, h2 = tfc.fused_cg_stencil_plain(T.offsets, tfc.prepare_coef3(T), bp,
                                        torch.zeros_like(bp), 6)
    assert counters().get("launch.fused_cg", 0) == before
    assert torch.equal(x1, x2) and torch.equal(h1, h2)


def test_rejects_bad_arguments():
    T = from_tpcg(helm_fe(6, 3.0, eps=3.0))
    coef3 = tfc.prepare_coef3(T)
    b = torch.zeros((2, 1, 6, 6))
    with pytest.raises(TypeError):
        tfc.fused_cg_stencil(T.offsets, coef3, b.double(), b.double(), 3)
    with pytest.raises(ValueError):
        tfc.fused_cg_stencil(T.offsets, coef3, b[:, :, :5], b[:, :, :5], 3)
    with pytest.raises(ValueError):
        tfc.fused_cg_stencil(T.offsets[:3], coef3, b, b, 3)
    with pytest.raises(ValueError):
        tfc.fused_cg_stencil(T.offsets, coef3.to("meta"), b.to("meta"),
                             b.to("meta"), 3)
