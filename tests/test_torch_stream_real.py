"""tpcg_torch.ops.stream_cg_real (the planner's ``stream-real`` path) against
the JAX package's real streaming kernels, run in Pallas interpret mode on
the CPU.

The port's plain versions (what the CUDA kernel ``csrc/stream_cg_real.cu``
is held against on the card), const and coef mode, are compared with v2
(``_build_k1_real_const`` / ``_build_k1_real_coef`` + ``_make_k2_real``), v4
(``_build_resident_real``: const keep_q, recompute and q_hbm; coef), v5
(``_build_v5_real``: tiers A and B, ``qx`` on and off), the column-padded v5
route and JAX's ``pad->stream-real`` plan on a height it cannot stream.
Inputs: Poisson, the 7-point parabolic_fem-class stencil and Poisson with a
variable diagonal, a seeded RHS and a seeded x0.  Tolerance: x within
2e-3 max|x| and the history within 1e-4 relative (the JAX tests' own bound,
tests/test_stream_cg_real.py): the two sides sum their dot products in
different orders (JAX in float32 by row blocks, the port in float64).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpcg
import tpcg.ops.auto as jauto
import tpcg_torch
from tpcg.ops import stream_cg_real as jsr
from tpcg.ops.stream_cg_v4_real import (stream_cg_v4_real_coef_planes,
                                        stream_cg_v4_real_planes)
from tpcg.ops.stream_cg_v5 import pad_strips
from tpcg.ops.stream_cg_v5_real import stream_cg_v5_real_planes
from tpcg.problems import poisson
from tpcg.sparse import Stencil2D as JaxStencil2D
from tpcg_torch.convert import (coef_real_from_tpcg, from_tpcg,
                                stream_real_operands_from_tpcg)
from tpcg_torch.ops import auto
from tpcg_torch.ops import stream_cg_real as tsr
from tpcg_torch.problems import parabolic_stencil
from tpcg_torch.trace import counters


def _rect(kind, nv, nh, seed=2):
    """A real JAX stencil on an nv x nh grid: ``poisson`` (5-point), ``fe``
    (the parabolic_fem-class 7-point stencil) or ``vardiag`` (Poisson with
    c[0] += 0.3 U(0, 1), as tests/test_stream_cg_real.py:66-71)."""
    if kind == "fe" and nv == nh:
        T = parabolic_stencil(nv, device="cpu")
        return JaxStencil2D(T.offsets, jnp.asarray(T.coef.numpy()), T.grid)
    offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))
    taps = [4.0, -1.0, -1.0, -1.0, -1.0]
    if kind == "fe":
        offs += ((1, 1), (-1, -1))
        taps = [8.0] + [-1.0] * 6
    c = np.zeros((len(offs), nv, nh))
    for s, (dm, dj) in enumerate(offs):
        c[s, max(0, -dm):nv - max(0, dm), max(0, -dj):nh - max(0, dj)] = taps[s]
    if kind == "vardiag":
        c[0] += 0.3 * np.random.default_rng(seed).random((nv, nh))
    return JaxStencil2D(offs, jnp.asarray(c), (nv, nh))


def _problem(kind, N=64, seed=5):
    A = poisson(N, dtype=np.float64) if kind == "poisson" else _rect(kind, N, N)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((N, N)).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((N, N))).astype(np.float32)
    return A, torch.from_numpy(b), torch.from_numpy(x0)


def _assert_close(xt, ht, xj, hj):
    xt, ht = np.asarray(xt), np.asarray(ht)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert xt.shape == xj.shape and ht.shape == hj.shape
    assert np.isfinite(xt).all() and np.isfinite(ht).all()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=2e-3 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=1e-4)


def _port_const(A, b, x0, iters):
    taps, strips = tsr.prepare_stream_real(from_tpcg(A))
    return tsr.stream_cg_real_planes(A.offsets, A.grid, taps, strips, b, x0,
                                     iters)


def _port_coef(A, b, x0, iters):
    coefp = tsr.prepare_stream_coef_real(from_tpcg(A))
    return tsr.stream_cg_real_coef_planes(A.offsets, coefp, b, x0, iters)


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kind,grid", [("poisson", (64, 64)),
                                       ("fe", (48, 48)), ("poisson", (29, 45)),
                                       ("fe", (31, 40))])
def test_prepare_stream_real_matches_jax(kind, grid):
    """Taps equal JAX's exactly (python floats), strips bit for bit, and the
    converter carries JAX's operands across to the same values."""
    A = _rect(kind, *grid)
    jt, js = jsr.prepare_stream_real(A)
    taps, strips = tsr.prepare_stream_real(from_tpcg(A))
    assert taps == jt
    assert strips.dtype == torch.float32
    assert tuple(strips.shape) == (2, len(A.offsets), grid[1])
    np.testing.assert_array_equal(strips[0].numpy(), np.asarray(js[0])[:, 0])
    np.testing.assert_array_equal(strips[1].numpy(), np.asarray(js[1])[:, 0])
    t2, s2 = stream_real_operands_from_tpcg(jt, js)
    assert t2 == taps and torch.equal(s2, strips)


def test_variable_diagonal_takes_coef_mode_as_jax():
    """JAX's const preparation refuses a variable diagonal and so does the
    port's; the coefficient planes equal JAX's, carried or prepared."""
    A = _rect("vardiag", 40, 40)
    with pytest.raises(ValueError, match="not constant"):
        jsr.prepare_stream_real(A)
    with pytest.raises(ValueError, match="not constant"):
        tsr.prepare_stream_real(from_tpcg(A))
    mode, coefp = tsr.prepare_real(from_tpcg(A))
    assert mode == "coef" and coefp.dtype == torch.float32
    assert torch.equal(coefp, coef_real_from_tpcg(
        jsr.prepare_stream_coef_real(A)))
    assert tsr.prepare_real(from_tpcg(poisson(16)))[0] == "const"


def test_non_constant_edge_is_refused_as_jax():
    A = _rect("poisson", 20, 20)
    coef = np.array(np.asarray(A.coef))
    coef[0, 1:-1, 0] *= 1.0 + 0.01 * np.arange(18)
    B = JaxStencil2D(A.offsets, jnp.asarray(coef), A.grid)
    with pytest.raises(ValueError, match="left edge"):
        jsr.prepare_stream_real(B)
    with pytest.raises(ValueError, match="left edge"):
        tsr.prepare_stream_real(from_tpcg(B))


@pytest.mark.parametrize("kind,nv,nh", [
    ("poisson", 32, 32), ("fe", 32, 32), ("poisson", 29, 45), ("fe", 23, 40),
    ("vardiag", 31, 24)])
def test_operators_match_scipy(kind, nv, nh):
    """Both plain operators equal A.to_scipy() @ x in float64 to float32
    rounding on square, non-square and prime-height grids: interior, edges,
    strips and corners (const mode where the stencil allows it)."""
    A = _rect(kind, nv, nh)
    T = from_tpcg(A)
    x = np.random.default_rng(5).standard_normal((nv, nh)).astype(np.float32)
    ref = (A.to_scipy() @ x.reshape(-1).astype(np.float64)).reshape(nv, nh)
    xt = torch.from_numpy(x)
    qs = [tsr.apply_coef_real(T.offsets, tsr.prepare_stream_coef_real(T), xt)]
    if kind != "vardiag":
        taps, strips = tsr.prepare_stream_real(T)
        qs.append(tsr.apply_const_real(T.offsets, taps, strips, xt))
    for q in qs:
        err = np.abs(q.double().numpy() - ref).max()
        assert err <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("kind,mode", [("poisson", "const"),
                                       ("poisson", "coef"), ("fe", "const"),
                                       ("fe", "coef"), ("vardiag", "coef")])
def test_plain_matches_jax_v2(kind, mode):
    """#14: the v2 two-kernel iteration, seeded RHS and x0, 30 iterations."""
    A, b, x0 = _problem(kind)
    if mode == "const":
        xj, hj = jsr.stream_cg_real_planes(A.offsets, A.grid,
                                           *jsr.prepare_stream_real(A), _j(b),
                                           _j(x0), 30, interpret=True)
        xt, ht = _port_const(A, b, x0, 30)
    else:
        xj, hj = jsr.stream_cg_real_coef_planes(
            A.offsets, A.grid, jsr.prepare_stream_coef_real(A), _j(b), _j(x0),
            30, interpret=True)
        xt, ht = _port_coef(A, b, x0, 30)
    _assert_close(xt, ht, xj, hj)
    if kind == "poisson":
        # SPD: 30 iterations reduce the residual
        assert ht[-1] < 0.2 * ht[0]


@pytest.mark.parametrize("tier", ["keep_q", "recompute", "q_hbm"])
def test_plain_matches_jax_v4_const(tier):
    """#17, const taps: q kept resident, recomputed, or round-tripped."""
    A, b, x0 = _problem("poisson")
    xj, hj = stream_cg_v4_real_planes(
        A.offsets, A.grid, *jsr.prepare_stream_real(A), _j(b), _j(x0), 15,
        keep_q=tier == "keep_q", q_hbm=tier == "q_hbm", interpret=True)
    _assert_close(*_port_const(A, b, x0, 15), xj, hj)


@pytest.mark.parametrize("kind", ["poisson", "vardiag"])
def test_plain_matches_jax_v4_coef(kind):
    """#17, coefficient planes (keep_q)."""
    A, b, x0 = _problem(kind)
    xj, hj = stream_cg_v4_real_coef_planes(
        A.offsets, A.grid, jsr.prepare_stream_coef_real(A), _j(b), _j(x0), 15,
        interpret=True)
    _assert_close(*_port_coef(A, b, x0, 15), xj, hj)


@pytest.mark.parametrize("d_resident,qx", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_plain_matches_jax_v5(d_resident, qx):
    """#20: the panel round-trip kernel, tier A (direction resident) and
    tier B, with and without the one-apply qx variant."""
    A, b, x0 = _problem("poisson")
    xj, hj = stream_cg_v5_real_planes(
        A.offsets, A.grid, *jsr.prepare_stream_real(A), _j(b), _j(x0), 15,
        d_resident=d_resident, qx=qx, interpret=True)
    _assert_close(*_port_const(A, b, x0, 15), xj, hj)


@pytest.mark.parametrize("qx", [False, True])
def test_plain_at_true_width_matches_jax_column_padded_v5(qx):
    """#20's cpos route, forced as tests/test_stream_cg_v5_real.py:101-123
    forces it: JAX pads the width 72 to 128 and moves the right edge
    correction to column 71; the port runs at width 72."""
    N, nh_pad = 72, 128
    A, b, x0 = _problem("poisson", N)
    jt, js = jsr.prepare_stream_real(A)
    padw = ((0, 0), (0, nh_pad - N))
    xj, hj = stream_cg_v5_real_planes(
        A.offsets, (N, nh_pad), jt, pad_strips(js, nh_pad),
        jnp.pad(_j(b), padw), jnp.pad(_j(x0), padw), 15, block_rows=8,
        d_resident=True, qx=qx, cpos=N - 1, chunk=7, interpret=True)
    xj = np.asarray(xj)
    assert np.all(xj[:, N:] == 0)
    _assert_close(*_port_const(A, b, x0, 15), xj[:, :N], hj)


def test_unpadded_plan_matches_jax_row_padded_plan(monkeypatch):
    """A height JAX cannot stream (29, prime): its planner row-pads to 128
    (``pad->stream-real``, coef mode on the padded operator); the port's
    ``stream-real`` plan runs the unpadded grid, in const mode."""
    monkeypatch.setattr(jauto, "_REAL_STREAM_NODES", 16)
    A = _rect("poisson", 29, 24)
    rng = np.random.default_rng(8)
    b = rng.standard_normal((29, 24)).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((29, 24))).astype(np.float32)
    jplan = tpcg.plan_stencil_cg(A, 20, interpret=True)
    assert jplan.path == "pad->stream-real"
    tplan = tpcg_torch.plan_stencil_cg(from_tpcg(A), 20, path="stream-real")
    xj, hj = jplan.solve(b, x0)
    xt, ht = tplan.solve(b, x0)
    assert xt.dtype == np.float32
    _assert_close(xt, ht, xj, hj)


def _rhs_forms(N, rng):
    b1 = rng.standard_normal((N, N))
    b2 = rng.standard_normal((2, N, N))
    return {"grid": b1, "flat": b1.reshape(-1), "batch": b2,
            "batch_of_one": b1[None]}


@pytest.mark.parametrize("form", ["grid", "flat", "batch", "batch_of_one"])
def test_forced_plan_solve_matches_jax_planner(monkeypatch, form):
    """The slice end to end on the CPU: ``plan_stencil_cg(...,
    path="stream-real").solve`` (the plain versions) against JAX's planner
    in interpret mode, its real-streaming threshold lowered so that it picks
    ``stream-real`` at N=32: real float32 x of JAX's shape, the history of
    JAX's shape; B=2 runs as sequential single-RHS solves on both sides."""
    monkeypatch.setattr(jauto, "_REAL_STREAM_NODES", 16)
    N, iters = 32, 30
    A = poisson(N, dtype=np.float64)
    b = _rhs_forms(N, np.random.default_rng(3))[form]
    jplan = tpcg.plan_stencil_cg(A, iters, interpret=True)
    assert jplan.path == "stream-real"
    tplan = tpcg_torch.plan_stencil_cg(from_tpcg(A), iters,
                                       path="stream-real")
    assert tplan.path == "stream-real"
    xj, hj = jplan.solve(b)
    before = counters().get("launch.stream_real", 0)
    xt, ht = tplan.solve(b)
    assert counters().get("launch.stream_real", 0) == before
    assert xt.dtype == np.float32 == np.asarray(xj).dtype
    _assert_close(xt, ht, xj, hj)
    # CG converges on Poisson
    res = np.linalg.norm(A.to_scipy() @ xt.reshape(-1, N * N).T
                         - b.reshape(-1, N * N).T) / np.linalg.norm(b)
    assert res < 0.05


def test_two_rhs_solve_equals_two_single_solves():
    N = 24
    T = from_tpcg(_rect("fe", N, N))
    rng = np.random.default_rng(4)
    B = rng.standard_normal((2, N, N))
    X0 = 0.1 * rng.standard_normal((2, N, N))
    plan = tpcg_torch.plan_stencil_cg(T, 25, nb=2, path="stream-real")
    xb, hb = plan.solve(B, X0)
    assert xb.shape == (2, N, N) and hb.shape == (26, 2)
    for c in range(2):
        x1, h1 = plan.solve(B[c], X0[c])
        np.testing.assert_array_equal(x1, xb[c])
        np.testing.assert_array_equal(h1, hb[:, c])
    # the device-resident surface: (B, Nv, Nh) and (Nv, Nh) planes
    bp = torch.from_numpy(B.astype(np.float32))
    x0p = torch.from_numpy(X0.astype(np.float32))
    xp, hp = plan.solve_planes(bp, x0p)
    assert xp.shape == (2, N, N) and hp.shape == (26, 2)
    np.testing.assert_array_equal(xp.numpy(), xb)
    x1p, h1p = plan.solve_planes(bp[1], x0p[1])
    assert x1p.shape == (N, N) and h1p.shape == (26,)
    np.testing.assert_array_equal(x1p.numpy(), xb[1])


@pytest.mark.parametrize("kind,grid", [("poisson", (1024, 1024)),
                                       ("poisson", (1031, 1024)),
                                       ("fe", (1024, 1100)),
                                       ("vardiag", (1024, 1024)),
                                       ("poisson", (1000, 1000))])
def test_routing_with_a_card(kind, grid):
    """On a faked CUDA stencil, real grids from 1024^2 nodes plan
    ``stream-real`` at any height (1031 is prime: JAX row-pads it) and any
    width (1100 is not a multiple of 128: JAX column-pads or falls to a
    slower tier), in const mode where JAX's const preparation succeeds and
    coef mode where it raises; below 1024^2 nodes they stay ``eager``."""
    A = _rect(kind, *grid)
    T = from_tpcg(A)
    # enough of a Stencil2D on a CUDA device for the planner's choice, which
    # happens before anything moves to the device
    fake = types.SimpleNamespace(grid=T.grid, coef=T.coef, offsets=T.offsets,
                                 device=torch.device("cuda", 0))
    path, prepared = auto._pick_path(fake, 1, on_cuda=True)
    if grid[0] * grid[1] < 1024 * 1024:
        assert path == "eager"
        return
    assert path == "stream-real"
    try:
        jsr.prepare_stream_real(A)
        jax_mode = "const"
    except ValueError:
        jax_mode = "coef"
    assert prepared[0] == jax_mode == ("coef" if kind == "vardiag"
                                       else "const")
    assert tpcg_torch.plan_stencil_cg(fake, 5).path == "stream-real"


def test_freeze_matches_jax_v2():
    """2 I, b = 1, 400 iterations: converges in one iteration and stays
    frozen and finite on both sides, x = b / 2."""
    N, iters = 16, 400
    A = poisson(N, dtype=np.float64)
    coef = np.zeros_like(np.asarray(A.coef))
    coef[0] = 2.0
    S = JaxStencil2D(A.offsets, jnp.asarray(coef), A.grid)
    b = torch.ones((N, N))
    x0 = torch.zeros_like(b)
    xj, hj = jsr.stream_cg_real_planes(S.offsets, S.grid,
                                       *jsr.prepare_stream_real(S), _j(b),
                                       _j(x0), iters, interpret=True)
    xt, ht = _port_const(S, b, x0, iters)
    hj, ht = np.asarray(hj), ht.numpy()
    assert hj[0] == ht[0] == 16.0
    assert np.all(hj[1:] == 0) and np.all(ht[1:] == 0)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert torch.all(xt == 0.5)


def test_zero_rhs_stays_zero():
    A, b, _ = _problem("fe", 24)
    for port in (_port_const, _port_coef):
        x, h = port(A, torch.zeros_like(b), torch.zeros_like(b), 30)
        assert torch.all(x == 0) and torch.all(h == 0)


def test_wrapper_equals_the_planes_functions():
    A, b, x0 = _problem("vardiag", 24)
    T = from_tpcg(A)
    xw, hw = tsr.stream_cg_real(T, b.numpy(), x0.numpy(), 12)
    xc, hc = _port_coef(A, b, x0, 12)
    assert torch.equal(xw, xc) and torch.equal(hw, hc)
    P = from_tpcg(poisson(24))
    xw, hw = tsr.stream_cg_real(P, b.numpy(), x0.numpy(), 12)
    xc, hc = _port_const(poisson(24), b, x0, 12)
    assert torch.equal(xw, xc) and torch.equal(hw, hc)


def test_argument_checks():
    A, b, x0 = _problem("poisson", 16)
    taps, strips = tsr.prepare_stream_real(from_tpcg(A))
    args = (A.offsets, A.grid)
    with pytest.raises(ValueError, match="strips"):
        tsr.stream_cg_real_planes(*args, taps, strips[:, :, :8], b, x0, 3)
    with pytest.raises(ValueError, match="b must be"):
        tsr.stream_cg_real_planes(*args, taps, strips, b[:8], x0[:8], 3)
    with pytest.raises(TypeError):
        tsr.stream_cg_real_planes(*args, taps, strips, b.double(),
                                  x0.double(), 3)
    with pytest.raises(ValueError, match="taps"):
        tsr.stream_cg_real_planes(*args, taps[:2], strips, b, x0, 3)
    with pytest.raises(ValueError, match="n_iterations"):
        tsr.stream_cg_real_planes(*args, taps, strips, b, x0, -1)
    coefp = tsr.prepare_stream_coef_real(from_tpcg(A))
    with pytest.raises(ValueError, match="coefp"):
        tsr.stream_cg_real_coef_planes(A.offsets, coefp[:3], b, x0, 3)
    with pytest.raises(ValueError, match="real stencil"):
        tsr.prepare_stream_real(tpcg_torch.problems.helm_fe(
            8, 3.0, eps=3.0, device="cpu"))
