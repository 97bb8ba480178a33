"""tpcg_torch.ops.stream_cg (the planner's ``stream`` path) against the JAX
package's streaming kernels, run in Pallas interpret mode on the CPU.

The port's plain version (what the CUDA kernel ``csrc/stream_cg.cu`` is held
against on the card) is compared with v2 (``_build_kernels`` + ``_make_k2``),
v4 (``_build_resident``, both q modes), v5 (``_build_v5``, both direction
tiers) and the column-padded v5 route.  Tolerance: x within 2e-3 max|x| and
the history within 1e-3 relative, over at most 20 iterations with a plane
wave RHS: the two sides sum their dot products in different float32 orders
(the JAX kernels by row blocks, the port over whole planes), and COCG on the
indefinite Helmholtz matrix carries that rounding into the iterates.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpcg
import tpcg_torch
import tpcg.ops.auto as jauto
from tpcg.ops.stream_cg import prepare_stream as jax_prepare_stream
from tpcg.ops.stream_cg import stream_cg_const_planes as jax_v2
from tpcg.ops.stream_cg_v4 import stream_cg_v4_const_planes as jax_v4
from tpcg.ops.stream_cg_v5 import pad_strips
from tpcg.ops.stream_cg_v5 import stream_cg_v5_const_planes as jax_v5
from tpcg.problems import helm_fe, helm_fe_var, local_rect, plane_wave_rhs
from tpcg.sparse import Stencil2D as JaxStencil2D
from tpcg_torch.convert import from_tpcg, stream_operands_from_tpcg
from tpcg_torch.ops import auto
from tpcg_torch.ops import stream_cg as ts
from tpcg_torch.trace import counters

K = 9.0


def _planes(z):
    return torch.from_numpy(np.stack([z.real, z.imag]).astype(np.float32))


def _x0(shape, seed=3):
    rng = np.random.default_rng(seed)
    return 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def _case(N, seed=3):
    """helm_fe(N, 9, eps=9) as both packages' operands, a plane wave and a
    seeded initial guess as planes."""
    A = helm_fe(N, K, eps=K)
    b = plane_wave_rhs(N, K)
    taps, strips = ts.prepare_stream(from_tpcg(A))
    return A, taps, strips, _planes(b), _planes(_x0((N, N), seed))


def _assert_close(xt, ht, xj, hj):
    xt, ht = np.asarray(xt), np.asarray(ht)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert xt.shape == xj.shape and ht.shape == hj.shape
    assert np.isfinite(xt).all() and np.isfinite(ht).all()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=2e-3 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=1e-3)


def _port(A, taps, strips, bp, x0p, iters):
    return ts.stream_cg_const_planes(A.offsets, A.grid, taps, strips, bp, x0p,
                                     iters)


@pytest.mark.parametrize("N,nv_nh", [(64, None), (40, (24, 36))])
def test_prepare_stream_matches_jax(N, nv_nh):
    """Taps equal JAX's exactly (python floats); strips equal JAX's float32
    strips exactly, and the converter carries JAX's operands across."""
    if nv_nh is None:
        A = helm_fe(N, K, eps=K)
    else:
        A = local_rect(N, K, K, eta=K, Nvert=nv_nh[0], Nhoriz=nv_nh[1])
    jt, js = jax_prepare_stream(A)
    taps, strips = ts.prepare_stream(from_tpcg(A))
    assert taps == jt
    assert strips.dtype == torch.float32
    assert tuple(strips.shape) == (2, 2, len(A.offsets), A.grid[1])
    np.testing.assert_array_equal(strips[0].numpy(), np.asarray(js[0])[:, :, 0])
    np.testing.assert_array_equal(strips[1].numpy(), np.asarray(js[1])[:, :, 0])
    t2, s2 = stream_operands_from_tpcg(jt, js)
    assert t2 == taps and torch.equal(s2, strips)


def test_prepare_stream_refuses_variable_coefficients():
    rng = np.random.default_rng(4)
    C = 1.0 + 0.5 * rng.random((23, 23))
    A = from_tpcg(helm_fe_var(24, 12.0, C, rho=0.1))
    with pytest.raises(ValueError, match="not constant"):
        ts.prepare_stream(A)


def test_prepare_stream_refuses_non_constant_edge():
    """A constant interior with a varying left edge: the edge check raises,
    as JAX's does."""
    A = helm_fe(20, K, eps=K)
    coef = np.array(np.asarray(A.coef))
    coef[0, 1:-1, 0] *= 1.0 + 0.01 * np.arange(18)
    B = JaxStencil2D(A.offsets, jnp.asarray(coef), A.grid)
    with pytest.raises(ValueError, match="left edge"):
        jax_prepare_stream(B)
    with pytest.raises(ValueError, match="left edge"):
        ts.prepare_stream(from_tpcg(B))


@pytest.mark.parametrize("nv,nh", [(32, 32), (29, 45)])
def test_apply_const_planes_matches_scipy(nv, nh):
    """The plain operator equals A.to_scipy() @ x in complex128 to float32
    rounding, on a square and a non-square local_rect: interior, both edges,
    both strips and all four corners."""
    A = local_rect(max(nv, nh), K, K, eta=K, Nvert=nv, Nhoriz=nh)
    taps, strips = ts.prepare_stream(from_tpcg(A))
    xp = _planes(_x0((nv, nh), seed=5))
    q = ts.apply_const_planes(A.offsets, taps, strips, xp).double().numpy()
    x = xp.double().numpy()
    ref = (A.to_scipy() @ (x[0] + 1j * x[1]).reshape(-1)).reshape(nv, nh)
    err = np.abs(q[0] + 1j * q[1] - ref)
    assert err.max() <= 1e-6 * np.abs(ref).max()


def test_plain_matches_jax_v2():
    """#6 + #7: the v2 two-kernel iteration, seeded x0, 15 iterations; the
    convenience wrapper gives the same bits as the planes function."""
    A, taps, strips, bp, x0p = _case(64)
    xj, hj = jax_v2(A.offsets, A.grid, *jax_prepare_stream(A),
                    jnp.asarray(bp.numpy()), jnp.asarray(x0p.numpy()), 15,
                    interpret=True)
    xt, ht = _port(A, taps, strips, bp, x0p, 15)
    _assert_close(xt, ht, xj, hj)
    x0 = x0p[0].double().numpy() + 1j * x0p[1].double().numpy()
    b = plane_wave_rhs(64, K)
    xw, hw = tpcg_torch.stream_cg_const(from_tpcg(A), b, x0, 15)
    assert torch.equal(xw, xt) and torch.equal(hw, ht)


@pytest.mark.parametrize("keep_q", [True, False])
def test_plain_matches_jax_v4(keep_q):
    """#16: the VMEM-resident kernel with q kept or recomputed."""
    A, taps, strips, bp, x0p = _case(64)
    xj, hj = jax_v4(A.offsets, A.grid, *jax_prepare_stream(A),
                    jnp.asarray(bp.numpy()), jnp.asarray(x0p.numpy()), 15,
                    keep_q=keep_q, interpret=True)
    _assert_close(*_port(A, taps, strips, bp, x0p, 15), xj, hj)


@pytest.mark.parametrize("d_resident", [True, False])
def test_plain_matches_jax_v5(d_resident):
    """#19: the panel round-trip kernel, direction resident or not."""
    A, taps, strips, bp, x0p = _case(64)
    xj, hj = jax_v5(A.offsets, A.grid, *jax_prepare_stream(A),
                    jnp.asarray(bp.numpy()), jnp.asarray(x0p.numpy()), 15,
                    d_resident=d_resident, interpret=True)
    _assert_close(*_port(A, taps, strips, bp, x0p, 15), xj, hj)


def test_plain_at_true_width_matches_jax_column_padded_v5():
    """#19's cpos route: JAX pads the width 72 to 128 and moves the right
    edge correction to column 71; the port runs at width 72."""
    N, nh_pad = 72, 128
    A, taps, strips, bp, x0p = _case(N)
    jt, js = jax_prepare_stream(A)
    padw = ((0, 0), (0, 0), (0, nh_pad - N))
    xj, hj = jax_v5(A.offsets, (N, nh_pad), jt, pad_strips(js, nh_pad),
                    jnp.pad(jnp.asarray(bp.numpy()), padw),
                    jnp.pad(jnp.asarray(x0p.numpy()), padw), 15, qx=True,
                    cpos=N - 1, interpret=True)
    xj = np.asarray(xj)
    assert np.all(xj[..., N:] == 0)
    _assert_close(*_port(A, taps, strips, bp, x0p, 15), xj[..., :N], hj)


@pytest.mark.parametrize("nb", [1, 2])
def test_forced_stream_plan_matches_jax_planner(monkeypatch, nb):
    """A forced ``stream`` plan on the CPU (the plain version) against JAX's
    planner in interpret mode, its whole-solve threshold lowered so that it
    picks ``stream`` at N=48; B=2 runs as sequential single-RHS solves on
    both sides."""
    monkeypatch.setattr(jauto, "_VMEM_NODES", 16)
    N, iters = 48, 12
    A = helm_fe(N, K, eps=K)
    b = plane_wave_rhs(N, K)
    B = b if nb == 1 else np.stack([b, 0.5j * b + _x0((N, N), seed=9)])
    jplan = tpcg.plan_stencil_cg(A, iters, nb=nb, interpret=True)
    assert jplan.path == "stream"
    tplan = tpcg_torch.plan_stencil_cg(from_tpcg(A), iters, nb=nb,
                                       path="stream")
    assert tplan.path == "stream"
    xj, hj = jplan.solve(B)
    before = counters().get("launch.stream_const", 0)
    xt, ht = tplan.solve(B)
    assert counters().get("launch.stream_const", 0) == before
    assert xt.dtype == np.complex64
    _assert_close(xt, ht, xj, hj)
    if nb == 2:
        # each column is the single-RHS solve of its own RHS
        x1, h1 = tplan.solve(B[1])
        np.testing.assert_array_equal(x1, xt[1])
        np.testing.assert_array_equal(h1, ht[:, 1])
        bp = torch.stack([_planes(B[0]), _planes(B[1])], dim=1)
        xp, hp = tplan.solve_planes(bp)
        assert xp.shape == (2, 2, N, N) and hp.shape == (iters + 1, 2)
        np.testing.assert_array_equal(hp.numpy(), ht)


def _jax_path(S, monkeypatch):
    monkeypatch.setattr(jauto, "_VMEM_NODES", 256)
    return tpcg.plan_stencil_cg(S, 5, interpret=True).path


@pytest.mark.parametrize("case", ["helm_fe", "local_rect", "small",
                                  "helm_fe_var", "prime_height",
                                  "prime_height_var"])
def test_routing_with_a_card_matches_jax(monkeypatch, case):
    """The port's choice with a card assumed follows JAX's planner
    (thresholds lowered on both sides): ``stream`` and ``stream-coef`` where
    JAX streams, and for a height JAX row-pads (29, prime) the documented
    mapping of ``pad->stream-coef``: ``stream`` for constant taps,
    ``stream-coef`` for symmetric variable coefficients, on the unpadded
    grid."""
    monkeypatch.setattr(auto, "_L2_NODES", 256)
    rng = np.random.default_rng(4)
    S = {"helm_fe": lambda: helm_fe(24, K, eps=K),
         "local_rect": lambda: local_rect(40, K, K, eta=K, Nvert=40,
                                          Nhoriz=20),
         "small": lambda: helm_fe(12, K, eps=K),
         "helm_fe_var": lambda: helm_fe_var(
             24, 12.0, 1.0 + 0.5 * rng.random((23, 23)), rho=0.1),
         "prime_height": lambda: local_rect(29, K, K, eta=K, Nvert=29,
                                            Nhoriz=24),
         "prime_height_var": lambda: helm_fe_var(
             29, 12.0, 1.0 + 0.5 * rng.random((28, 23)), rho=0.1, Nvert=29,
             Nhoriz=24)}[case]()
    jpath = _jax_path(S, monkeypatch)
    T = from_tpcg(S)
    path, prepared = auto._pick_path(T, 1, on_cuda=True)
    if jpath == "pad->stream-coef":
        assert case.startswith("prime_height")
        assert path == ("stream" if case == "prime_height" else "stream-coef")
    else:
        assert path == {"stream": "stream", "stream-coef": "stream-coef",
                        "vmem-coef": "l2-coef"}[jpath]
    assert (prepared is not None) == (path != "l2-coef")
    assert auto._pick_path(T, 1, on_cuda=False) == ("eager", None)


def _identity_case(N, c=2.0):
    """c I on the helm_fe offsets (only the centre tap nonzero): COCG
    converges in one iteration and must then stay frozen."""
    A = helm_fe(N, K, eps=K)
    coef = np.zeros((len(A.offsets), N, N), complex)
    coef[0] = c
    return JaxStencil2D(A.offsets, jnp.asarray(coef), (N, N))


def test_freeze_matches_jax_v2():
    """The smoke's freeze run at N=16: 2 I, b = 1, 400 iterations.  Both
    sides read 0 from iteration 1 on, stay finite, and give x = b / 2."""
    N, iters = 16, 400
    S = _identity_case(N)
    jt, js = jax_prepare_stream(S)
    bp = _planes(np.ones((N, N)))
    x0p = torch.zeros_like(bp)
    xj, hj = jax_v2(S.offsets, S.grid, jt, js, jnp.asarray(bp.numpy()),
                    jnp.asarray(x0p.numpy()), iters, interpret=True)
    taps, strips = ts.prepare_stream(from_tpcg(S))
    xt, ht = _port(S, taps, strips, bp, x0p, iters)
    hj, ht = np.asarray(hj), ht.numpy()
    assert hj[0] == ht[0] == 16.0
    assert np.all(hj[1:] == 0) and np.all(ht[1:] == 0)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert np.all(xt.numpy()[0] == 0.5) and np.all(xt.numpy()[1] == 0)


def test_zero_rhs_stays_zero():
    A, taps, strips, bp, _ = _case(24)
    x, h = _port(A, taps, strips, torch.zeros_like(bp), torch.zeros_like(bp),
                 30)
    assert torch.all(x == 0) and torch.all(h == 0)


def test_argument_checks():
    A, taps, strips, bp, x0p = _case(16)
    with pytest.raises(ValueError, match="strips"):
        _port(A, taps, strips[:, :, :, :8], bp, x0p, 3)
    with pytest.raises(ValueError, match="b must be"):
        _port(A, taps, strips, bp[:, :8], x0p[:, :8], 3)
    with pytest.raises(TypeError):
        _port(A, taps, strips, bp.double(), x0p.double(), 3)
    with pytest.raises(ValueError, match="taps"):
        _port(A, taps[:5], strips, bp, x0p, 3)
    with pytest.raises(ValueError, match="n_iterations"):
        _port(A, taps, strips, bp, x0p, -1)
