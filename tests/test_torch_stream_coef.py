"""tpcg_torch.ops.stream_cg_coef (the planner's ``stream-coef`` path for
non-symmetric stencils) against the JAX package's general-coefficient
kernels, run in Pallas interpret mode on the CPU.

The port's plain version (what the CUDA kernel ``csrc/stream_cg_coef.cu`` is
held against on the card) is compared with every JAX tier it replaces on the
class of ``benchmarks/exp_batchfat.py`` (helm_fe_var(N, 8, C, rho=0.5), C =
1 + 0.5 U(0, 1)) made non-symmetric by scaling coefficient plane 1 by 1.5:
v2 (``_build_k1_coef`` + ``_make_k2``), v3-coef (``_build_merged``),
v4-coef (``_build_resident``) and the fat batched kernels
(``_build_k1_coef_batched_fat`` + ``_make_k2_batched_fat``).  Tolerance: x
within 2e-3 max|x| and the history within 5e-3 relative (the JAX package's
own, tests/test_stream_cg.py), over at most 15 iterations: the two sides sum
their dot products in different orders (the JAX kernels in float32 by row
blocks, the port in float64 over whole planes), and COCG on this
non-symmetric class carries that rounding into the iterates fast (at N=48
and 20 iterations from x0 = 0 x parts by 8e-3 max|x|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpcg
import tpcg_torch
from tpcg.ops.stream_cg import (prepare_stream_coef, stream_cg_coef_planes,
                                stream_cg_coef_planes_batched_fat)
from tpcg.ops.stream_cg_v3 import stream_cg_v3_coef_planes
from tpcg.ops.stream_cg_v4 import stream_cg_v4_coef_planes
from tpcg.problems import helm_fe, helm_fe_var, plane_wave_rhs
from tpcg.sparse import Stencil2D as JaxStencil2D
from tpcg_torch.convert import coef_operands_from_tpcg, from_tpcg
from tpcg_torch.ops import stream_cg_coef as tsc
from tpcg_torch.trace import counters

K = 8.0


def _nonsym(nv, nh=None, seed=0, dtype=np.complex128):
    """helm_fe_var(max(nv, nh), 8, C, rho=0.5) on an nv x nh grid, C from a
    seed, with coefficient plane 1 scaled by 1.5: a non-symmetric stencil."""
    nh = nh or nv
    N = max(nv, nh)
    C = 1.0 + 0.5 * np.random.default_rng(seed).random((nv - 1, nh - 1))
    A = helm_fe_var(N, K, C, rho=0.5, Nhoriz=nh, Nvert=nv, dtype=dtype)
    c = np.array(np.asarray(A.coef))
    c[1] *= 1.5
    return JaxStencil2D(A.offsets, jnp.asarray(c), A.grid)


def _planes(z):
    return torch.from_numpy(np.stack([z.real, z.imag]).astype(np.float32))


def _x0(shape, seed=3):
    rng = np.random.default_rng(seed)
    return 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def _assert_close(xt, ht, xj, hj):
    xt, ht = np.asarray(xt), np.asarray(ht)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert xt.shape == xj.shape and ht.shape == hj.shape
    assert np.isfinite(xt).all() and np.isfinite(ht).all()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=2e-3 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=5e-3)


def _case(N=64, x0_seed=3):
    A = _nonsym(N)
    b = plane_wave_rhs(N, K)
    x0 = np.zeros_like(b) if x0_seed is None else _x0((N, N), x0_seed)
    coefp = tsc.prepare_stream_coef(from_tpcg(A))
    return A, coefp, _planes(b), _planes(x0)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_prepare_stream_coef_matches_jax(dtype):
    """The port's planes equal JAX's bit for bit on a non-square grid, and
    the converter carries JAX's operand across unchanged."""
    A = _nonsym(36, 40, dtype=dtype)
    jc = np.asarray(prepare_stream_coef(A))
    tc = tsc.prepare_stream_coef(from_tpcg(A))
    assert tc.dtype == torch.float32
    assert tuple(tc.shape) == (2, len(A.offsets), 36, 40)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert torch.equal(coef_operands_from_tpcg(jc), tc)
    with pytest.raises(ValueError, match="coefp"):
        coef_operands_from_tpcg(jc[0])


@pytest.mark.parametrize("nv,nh", [(32, 32), (24, 40), (31, 20)])
def test_apply_coef_planes_matches_scipy(nv, nh):
    """The operator equals A.to_scipy() @ x in complex128 to float32
    rounding on a square grid, a non-square grid and a prime height."""
    A = _nonsym(nv, nh, seed=1)
    coefp = tsc.prepare_stream_coef(from_tpcg(A))
    xp = _planes(_x0((nv, nh), seed=5))
    q = tsc.apply_coef_planes(A.offsets, coefp, xp).double().numpy()
    x = xp.double().numpy()
    ref = (A.to_scipy() @ (x[0] + 1j * x[1]).reshape(-1)).reshape(nv, nh)
    assert np.abs(q[0] + 1j * q[1] - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("x0_seed", [None, 3])
def test_plain_matches_jax_v2(x0_seed):
    """#8 + #7 (v2: ``_build_k1_coef`` + ``_make_k2``) against the plain
    version: N=64, plane wave, x0 = 0 and a seeded x0, 12 iterations."""
    A, coefp, bp, x0p = _case(x0_seed=x0_seed)
    xj, hj = stream_cg_coef_planes(
        A.offsets, A.grid, prepare_stream_coef(A), jnp.asarray(bp.numpy()),
        jnp.asarray(x0p.numpy()), 12, interpret=True)
    _assert_close(*tsc.stream_cg_coef_planes(A.offsets, coefp, bp, x0p, 12),
                  xj, hj)


@pytest.mark.parametrize("tier", ["v3_keep_r", "v3", "v4"])
def test_plain_matches_jax_tier(tier):
    """#15 (v3-coef, with and without keep_r) and #16 (v4-coef) against the
    plain version: N=64, plane wave, seeded x0, 12 iterations."""
    A, coefp, bp, x0p = _case()
    args = (A.offsets, A.grid, prepare_stream_coef(A),
            jnp.asarray(bp.numpy()), jnp.asarray(x0p.numpy()), 12)
    run = {
        "v3_keep_r": lambda: stream_cg_v3_coef_planes(*args, keep_r=True,
                                                      interpret=True),
        "v3": lambda: stream_cg_v3_coef_planes(*args, keep_r=False,
                                               interpret=True),
        "v4": lambda: stream_cg_v4_coef_planes(*args, interpret=True),
    }[tier]
    xj, hj = run()
    _assert_close(*tsc.stream_cg_coef_planes(A.offsets, coefp, bp, x0p, 12),
                  xj, hj)


def _batch(N, nb):
    """exp_batchfat.py's RHS: the plane wave times (1 + 0.1j r)."""
    bg = plane_wave_rhs(N, K)
    return np.stack([bg * (1 + 0.1j * r) for r in range(nb)])


def test_batched_plain_matches_jax_fat():
    """#12 + #13 (the fat batched kernels, nb = 3) against the batched
    plain version, each RHS to the tolerances above; on the CPU each RHS of
    the batched plain version is its single-RHS plain version bit for
    bit."""
    N, nb, iters = 48, 3, 15
    A = _nonsym(N)
    coefp = tsc.prepare_stream_coef(from_tpcg(A))
    B = _batch(N, nb)
    bp = torch.from_numpy(np.stack([B.real, B.imag]).astype(np.float32))
    x0p = torch.from_numpy(np.stack([_x0((nb, N, N)).real,
                                     _x0((nb, N, N)).imag]).astype(np.float32))
    xj, hj = stream_cg_coef_planes_batched_fat(
        A.offsets, A.grid, prepare_stream_coef(A), jnp.asarray(bp.numpy()),
        jnp.asarray(x0p.numpy()), iters, interpret=True)
    xt, ht = tsc.stream_cg_coef_planes_batched_fat(A.offsets, coefp, bp, x0p,
                                                   iters)
    assert xt.shape == (2, nb, N, N) and ht.shape == (iters + 1, nb)
    xj, hj = np.asarray(xj), np.asarray(hj)
    for c in range(nb):
        _assert_close(xt[:, c], ht[:, c], xj[:, c], hj[:, c])
        x1, h1 = tsc.stream_cg_coef_planes(A.offsets, coefp, bp[:, c],
                                           x0p[:, c], iters)
        assert torch.equal(xt[:, c], x1) and torch.equal(ht[:, c], h1)


@pytest.mark.parametrize("nb", [1, 3])
def test_forced_stream_coef_plan_matches_jax_planner(nb):
    """A forced ``stream-coef`` plan on the CPU (the plain version) against
    JAX's forced ``stream-coef`` in interpret mode (its v4-coef tier here,
    B=3 as sequential v4 solves); the port takes the general operand."""
    N, iters = 40, 12
    A = _nonsym(N)
    B = _batch(N, nb)
    B = B[0] if nb == 1 else B
    xj, hj = tpcg.stencil_cg(A, B, n_iterations=iters, path="stream-coef",
                             interpret=True)
    before = counters().get("launch.stream_coef", 0)
    xt, ht = tpcg_torch.stencil_cg(from_tpcg(A), B, n_iterations=iters,
                                   path="stream-coef")
    assert counters().get("launch.stream_coef", 0) == before
    assert xt.dtype == np.complex64 and xt.shape == np.asarray(B).shape
    _assert_close(xt, ht, xj, hj)
    plan = tpcg_torch.plan_stencil_cg(from_tpcg(A), iters, nb=nb,
                                      path="stream-coef")
    bp = _planes(np.asarray(B))
    xp, hp = plan.solve_planes(bp)
    assert xp.shape == bp.shape and hp.shape == np.asarray(ht).shape
    np.testing.assert_array_equal(hp.numpy(), ht)


def test_outward_boundary_coefficients_read_zero():
    """Random coefficients on every plane, those that point outside the
    grid included: the port multiplies them by 0, as JAX's zero halo does,
    so its operator is the in-grid matrix, and its solve follows JAX's
    v2."""
    nv, nh = 24, 32
    offsets = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1),
               (-1, 1), (-1, -1))
    rng = np.random.default_rng(11)
    c = 0.1 * (rng.standard_normal((9, nv, nh))
               + 1j * rng.standard_normal((9, nv, nh)))
    c[0] += 3.0 + 1.0j
    A = JaxStencil2D(offsets, jnp.asarray(c), (nv, nh))
    T = from_tpcg(A)
    coefp = tsc.prepare_stream_coef(T)
    x = _x0((nv, nh), seed=2)
    ref = np.zeros_like(x)
    for s, (dm, dj) in enumerate(offsets):
        for m in range(nv):
            for j in range(nh):
                if 0 <= m + dm < nv and 0 <= j + dj < nh:
                    ref[m, j] += c[s, m, j] * x[m + dm, j + dj]
    q = tsc.apply_coef_planes(offsets, coefp, _planes(x)).double().numpy()
    assert np.abs(q[0] + 1j * q[1] - ref).max() <= 1e-6 * np.abs(ref).max()
    bp = _planes(plane_wave_rhs(max(nv, nh), K)[:nv, :nh])
    x0p = torch.zeros_like(bp)
    xj, hj = stream_cg_coef_planes(offsets, (nv, nh), prepare_stream_coef(A),
                                   jnp.asarray(bp.numpy()),
                                   jnp.asarray(x0p.numpy()), 10,
                                   block_rows=8, interpret=True)
    _assert_close(*tsc.stream_cg_coef_planes(offsets, coefp, bp, x0p, 10),
                  xj, hj)


def test_pad2_stencil_matches_jax_v2():
    """A non-symmetric 13-point stencil reaching two nodes out (pad 2)
    against JAX's v2, 12 iterations from a seeded x0."""
    N = 32
    offsets = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2),
               (2, 0), (-2, 0), (1, 1), (-1, -1), (2, 1), (-1, 2))
    rng = np.random.default_rng(12)
    c = -0.2 * (1.0 + 0.3 * rng.random((len(offsets), N, N))) + 0.05j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((N, N))
    A = JaxStencil2D(offsets, jnp.asarray(c), (N, N))
    coefp = tsc.prepare_stream_coef(from_tpcg(A))
    bp = _planes(plane_wave_rhs(N, K))
    x0p = _planes(_x0((N, N), seed=4))
    xj, hj = stream_cg_coef_planes(offsets, (N, N), prepare_stream_coef(A),
                                   jnp.asarray(bp.numpy()),
                                   jnp.asarray(x0p.numpy()), 12,
                                   interpret=True)
    _assert_close(*tsc.stream_cg_coef_planes(offsets, coefp, bp, x0p, 12),
                  xj, hj)


def test_converging_system_freezes_past_convergence_as_jax():
    """A diagonally dominant non-symmetric stencil (helm_fe(16, 1) with 6
    added to its centre and plane 1 scaled by 1.5) converges within ~20
    iterations; over 300 the history reaches exactly 0 and stays there (the
    exact-zero freeze guard, evaluated every iteration), x stays finite, and
    both follow JAX's v2 run of the same length: x within 1e-5 max|x|, the
    history within 1e-3 relative while above 1e-6 of its start."""
    N = 16
    A = helm_fe(N, 1.0, eps=1.0)
    c = np.array(np.asarray(A.coef))
    c[0] += 6.0
    c[1] *= 1.5
    A = JaxStencil2D(A.offsets, jnp.asarray(c), A.grid)
    coefp = tsc.prepare_stream_coef(from_tpcg(A))
    bp = _planes(plane_wave_rhs(N, 1.0))
    x0p = torch.zeros_like(bp)
    xt, ht = tsc.stream_cg_coef_planes(A.offsets, coefp, bp, x0p, 300)
    xj, hj = stream_cg_coef_planes(A.offsets, A.grid, prepare_stream_coef(A),
                                   jnp.asarray(bp.numpy()),
                                   jnp.asarray(x0p.numpy()), 300,
                                   interpret=True)
    xt, ht = xt.numpy(), ht.numpy()
    xj, hj = np.asarray(xj), np.asarray(hj)
    for x, h in ((xt, ht), (xj, hj)):
        assert np.isfinite(x).all() and np.isfinite(h).all()
        z = np.where(h == 0)[0]
        assert 0 < len(z) and z[0] <= 40 and np.all(h[z[0]:] == 0)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-5 * np.abs(xj).max())
    live = hj > 1e-6 * hj[0]
    np.testing.assert_allclose(ht[live], hj[live], rtol=1e-3)


def test_convenience_wrapper_equals_planes_function():
    A, coefp, bp, x0p = _case(32)
    xt, ht = tsc.stream_cg_coef_planes(A.offsets, coefp, bp, x0p, 10)
    x0 = x0p[0].double().numpy() + 1j * x0p[1].double().numpy()
    xw, hw = tpcg_torch.stream_cg_coef(from_tpcg(A), plane_wave_rhs(32, K),
                                       x0, 10)
    assert torch.equal(xw, xt) and torch.equal(hw, ht)


def test_zero_rhs_stays_zero():
    A, coefp, bp, _ = _case(24)
    z = torch.zeros_like(bp)
    x, h = tsc.stream_cg_coef_planes(A.offsets, coefp, z, z, 30)
    assert torch.all(x == 0) and torch.all(h == 0)
    xb, hb = tsc.stream_cg_coef_planes_batched_fat(
        A.offsets, coefp, torch.stack([z, bp], dim=1),
        torch.zeros((2, 2) + tuple(bp.shape[1:])), 30)
    assert torch.all(xb[:, 0] == 0) and torch.all(hb[:, 0] == 0)
    assert torch.all(hb[0, 1] > 0)


def test_argument_checks():
    A, coefp, bp, x0p = _case(16)
    offs = A.offsets
    with pytest.raises(ValueError, match="coefp"):
        tsc.stream_cg_coef_planes(offs, coefp[:, :5], bp, x0p, 3)
    with pytest.raises(ValueError, match="coefp"):
        tsc.stream_cg_coef_planes(offs[:5], coefp, bp, x0p, 3)
    with pytest.raises(ValueError, match="b must be"):
        tsc.stream_cg_coef_planes(offs, coefp, bp[:, :8], x0p[:, :8], 3)
    with pytest.raises(ValueError, match=r"b must be \(2, B"):
        tsc.stream_cg_coef_planes_batched_fat(offs, coefp, bp, x0p, 3)
    with pytest.raises(TypeError):
        tsc.stream_cg_coef_planes(offs, coefp, bp.double(), x0p.double(), 3)
    with pytest.raises(ValueError, match="n_iterations"):
        tsc.stream_cg_coef_planes(offs, coefp, bp, x0p, -1)
