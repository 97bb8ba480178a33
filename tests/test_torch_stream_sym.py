"""tpcg_torch.ops.stream_cg_sym (the planner's ``stream-coef`` path for
symmetric stencils) against the JAX package's kernels, run in Pallas
interpret mode on the CPU.

The port's plain version (what the CUDA kernel ``csrc/stream_cg_sym.cu`` is
held against on the card) is compared with every JAX tier it replaces on a
symmetric ``helm_fe_var``: v4-sym (``_build_resident_sym``: keep_q,
recompute and q_hbm), v5-sym (``_build_v5_sym``: both direction tiers, and
qx), v2-coef (``_build_k1_coef`` + ``_make_k2``) and v3-coef
(``_build_merged``, coefficient variant).  Tolerance: x within 2e-3 max|x|
and the history within 1e-3 relative, over at most 20 iterations with a
plane wave RHS: the two sides sum their dot products in different float32
orders (the JAX kernels by row blocks, the port over whole planes), and COCG
on the indefinite Helmholtz matrix carries that rounding into the iterates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpcg
import tpcg_torch
import tpcg.ops.auto as jauto
from tpcg.ops.stream_cg import prepare_stream_coef, stream_cg_coef_planes
from tpcg.ops.stream_cg_v3 import stream_cg_v3_coef_planes
from tpcg.ops.stream_cg_v4_sym import prepare_stream_sym as jax_prepare_sym
from tpcg.ops.stream_cg_v4_sym import reconstruct_coef as jax_reconstruct
from tpcg.ops.stream_cg_v4_sym import stream_cg_v4_sym_planes as jax_v4_sym
from tpcg.ops.stream_cg_v5_sym import stream_cg_v5_sym_planes as jax_v5_sym
from tpcg.problems import helm_fe, helm_fe_var, plane_wave_rhs
from tpcg.sparse import Stencil2D as JaxStencil2D
from tpcg_torch.convert import from_tpcg, sym_operands_from_tpcg
from tpcg_torch.ops import auto
from tpcg_torch.ops import stream_cg_sym as tss
from tpcg_torch.trace import counters

K = 12.0


def _var(N, nv=None, nh=None, seed=7, dtype=np.complex128):
    """helm_fe_var(N, 12, C, rho=0.1) on an nv x nh grid, C from a seed (the
    JAX package's own test problem)."""
    nv, nh = nv or N, nh or N
    C = 1.0 + 0.5 * np.random.default_rng(seed).random((nv - 1, nh - 1))
    return helm_fe_var(N, K, C, rho=0.1, Nhoriz=nh, Nvert=nv, dtype=dtype)


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
    np.testing.assert_allclose(ht, hj, rtol=1e-3)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_prepare_stream_sym_matches_jax(dtype):
    """Half offsets equal, half planes bit-equal, on a non-square grid;
    ``reconstruct_coef`` gives JAX's full planes bit for bit, which are the
    stencil's own float32 planes; the converter carries JAX's operands
    across."""
    A = _var(40, nv=36, nh=40, dtype=dtype)
    jh, jc = jax_prepare_sym(A)
    th, tc = tss.prepare_stream_sym(from_tpcg(A))
    assert th == [tuple(o) for o in jh]
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (2, 4, 36, 40)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    full = tss.reconstruct_coef(A.offsets, th, tc).numpy()
    np.testing.assert_array_equal(
        full, np.asarray(jax_reconstruct(A.offsets, jh, jc, A.grid)))
    np.testing.assert_array_equal(full, np.asarray(prepare_stream_coef(A)))
    h2, c2 = sym_operands_from_tpcg(jh, jc)
    assert h2 == th and torch.equal(c2, tc)


def _broken(kind):
    A = _var(24)
    c = np.array(np.asarray(A.coef))
    offsets = tuple(tuple(o) for o in A.offsets)
    if kind == "nonsymmetric":
        c[1] *= 1.5
    elif kind == "missing_mirror":
        # drop W = (0, -1): E = (0, 1) has no mirror
        keep = [i for i, o in enumerate(offsets) if o != (0, -1)]
        c, offsets = c[keep], tuple(offsets[i] for i in keep)
    else:
        keep = [i for i, o in enumerate(offsets) if o != (0, 0)]
        c, offsets = c[keep], tuple(offsets[i] for i in keep)
    return JaxStencil2D(offsets, jnp.asarray(c), A.grid)


@pytest.mark.parametrize("kind,match", [("nonsymmetric", "not symmetric"),
                                        ("missing_mirror", "no mirror"),
                                        ("no_centre", "centre")])
def test_prepare_stream_sym_refuses_as_jax_does(kind, match):
    B = _broken(kind)
    with pytest.raises(ValueError, match=match):
        jax_prepare_sym(B)
    with pytest.raises(ValueError, match=match):
        tss.prepare_stream_sym(from_tpcg(B))


@pytest.mark.parametrize("nv,nh", [(32, 32), (24, 40), (31, 20)])
def test_apply_sym_planes_matches_scipy(nv, nh):
    """The half-plane operator equals A.to_scipy() @ x in complex128 to
    float32 rounding on a square grid, a non-square grid and a prime
    height: the mirrored terms read 0 past every edge."""
    A = _var(max(nv, nh), nv=nv, nh=nh, seed=1)
    half, cplanes = tss.prepare_stream_sym(from_tpcg(A))
    xp = _planes(_x0((nv, nh), seed=5))
    q = tss.apply_sym_planes(half, cplanes, xp).double().numpy()
    x = xp.double().numpy()
    ref = (A.to_scipy() @ (x[0] + 1j * x[1]).reshape(-1)).reshape(nv, nh)
    assert np.abs(q[0] + 1j * q[1] - ref).max() <= 1e-6 * np.abs(ref).max()


def _case(N=64, x0_seed=3):
    A = _var(N)
    b = plane_wave_rhs(N, K)
    x0 = np.zeros_like(b) if x0_seed is None else _x0((N, N), x0_seed)
    half, cplanes = tss.prepare_stream_sym(from_tpcg(A))
    return A, half, cplanes, _planes(b), _planes(x0)


@pytest.mark.parametrize("tier", ["v4_keep_q", "v4_recompute", "v4_q_hbm",
                                  "v5_d_resident", "v5_d_streamed", "v5_qx",
                                  "v2_coef", "v3_coef"])
def test_plain_matches_jax_tier(tier):
    """#18 (v4-sym, each q mode), #21 (v5-sym, both direction tiers, qx),
    #8 + #7 (v2-coef) and #15 (v3-coef) against the port's plain version:
    helm_fe_var N=64, plane wave, seeded x0, 15 iterations."""
    A, half, cplanes, bp, x0p = _case()
    jh, jc = jax_prepare_sym(A)
    b, x0 = jnp.asarray(bp.numpy()), jnp.asarray(x0p.numpy())
    args = (A.offsets, A.grid)
    run = {
        "v4_keep_q": lambda: jax_v4_sym(*args, jh, jc, b, x0, 15,
                                        keep_q=True, interpret=True),
        "v4_recompute": lambda: jax_v4_sym(*args, jh, jc, b, x0, 15,
                                           keep_q=False, interpret=True),
        "v4_q_hbm": lambda: jax_v4_sym(*args, jh, jc, b, x0, 15, keep_q=False,
                                       q_hbm=True, interpret=True),
        "v5_d_resident": lambda: jax_v5_sym(*args, jh, jc, b, x0, 15,
                                            d_resident=True, interpret=True),
        "v5_d_streamed": lambda: jax_v5_sym(*args, jh, jc, b, x0, 15,
                                            d_resident=False, interpret=True),
        "v5_qx": lambda: jax_v5_sym(*args, jh, jc, b, x0, 15, qx=True,
                                    interpret=True),
        "v2_coef": lambda: stream_cg_coef_planes(
            *args, prepare_stream_coef(A), b, x0, 15, interpret=True),
        "v3_coef": lambda: stream_cg_v3_coef_planes(
            *args, prepare_stream_coef(A), b, x0, 15, interpret=True),
    }[tier]
    xj, hj = run()
    _assert_close(*tss.stream_cg_sym_planes(half, cplanes, bp, x0p, 15),
                  xj, hj)


def test_convenience_wrapper_equals_planes_function():
    A, half, cplanes, bp, x0p = _case(32)
    xt, ht = tss.stream_cg_sym_planes(half, cplanes, bp, x0p, 10)
    x0 = x0p[0].double().numpy() + 1j * x0p[1].double().numpy()
    xw, hw = tpcg_torch.stream_cg_sym(from_tpcg(A), plane_wave_rhs(32, K), x0,
                                      10)
    assert torch.equal(xw, xt) and torch.equal(hw, ht)


@pytest.mark.parametrize("nb", [1, 2])
def test_forced_stream_coef_plan_matches_jax_planner(nb):
    """A forced ``stream-coef`` plan on the CPU (the plain version) against
    JAX's forced ``stream-coef`` in interpret mode (its v4-sym tier here);
    B=2 runs as sequential single-RHS solves on both sides, and each column
    is its own single solve bit for bit."""
    N, iters = 48, 12
    A = _var(N)
    b = plane_wave_rhs(N, K)
    B = b if nb == 1 else np.stack([b, 0.5j * b + _x0((N, N), seed=9)])
    xj, hj = tpcg.stencil_cg(A, B, n_iterations=iters, path="stream-coef",
                             interpret=True)
    plan = tpcg_torch.plan_stencil_cg(from_tpcg(A), iters, nb=nb,
                                      path="stream-coef")
    assert plan.path == "stream-coef"
    before = counters().get("launch.stream_sym", 0)
    xt, ht = plan.solve(B)
    assert counters().get("launch.stream_sym", 0) == before
    assert xt.dtype == np.complex64
    _assert_close(xt, ht, xj, hj)
    if nb == 2:
        for c in range(2):
            x1, h1 = plan.solve(B[c])
            np.testing.assert_array_equal(x1, xt[c])
            np.testing.assert_array_equal(h1, ht[:, c])
        bp = torch.stack([_planes(B[0]), _planes(B[1])], dim=1)
        xp, hp = plan.solve_planes(bp)
        assert xp.shape == (2, 2, N, N) and hp.shape == (iters + 1, 2)
        np.testing.assert_array_equal(hp.numpy(), ht)


def test_forced_stream_coef_refuses_a_nonsymmetric_stencil():
    """The symmetric kernel refuses a non-symmetric stencil: a forced
    ``stream-coef`` plan then takes the general kernel's full planes
    (``tpcg_torch.ops.stream_cg_coef``), its plain version here, which no
    launch of the symmetric kernel's wrapper serves."""
    T = from_tpcg(_broken("nonsymmetric"))
    with pytest.raises(ValueError, match="not symmetric"):
        tss.prepare_stream_sym(T)
    plan = tpcg_torch.plan_stencil_cg(T, 5, path="stream-coef")
    assert plan.path == "stream-coef"
    before = counters().get("launch.stream_sym", 0)
    x, h = plan.solve(plane_wave_rhs(24, K))
    assert counters().get("launch.stream_sym", 0) == before
    xg, hg = tpcg_torch.stream_cg_coef(T, plane_wave_rhs(24, K), None, 5)
    np.testing.assert_array_equal(h, hg.numpy())
    np.testing.assert_array_equal(x, (xg[0] + 1j * xg[1]).numpy())


def test_slice_end_to_end_matches_jax_planner(monkeypatch):
    """The benchmark configuration's family at N=40 (omega 40, C from seed 0,
    plane wave): the port's default choice on a card is stream-coef, and
    that plan (its plain version here) matches JAX's planner, which picks
    stream-coef too once its whole-solve threshold is lowered."""
    monkeypatch.setattr(jauto, "_VMEM_NODES", 16)
    N, iters = 40, 20
    C = 1.0 + 0.5 * np.random.default_rng(0).random((N - 1, N - 1))
    A = helm_fe_var(N, 40.0, C, rho=0.1)
    b = plane_wave_rhs(N, 40.0)
    jplan = tpcg.plan_stencil_cg(A, iters, interpret=True)
    assert jplan.path == "stream-coef"
    T = from_tpcg(A)
    monkeypatch.setattr(auto, "_L2_NODES", 16)
    path, (half, cplanes) = auto._pick_path(T, 1, on_cuda=True)
    assert path == "stream-coef"
    xt, ht = tpcg_torch.plan_stencil_cg(T, iters, path=path).solve(b)
    _assert_close(xt, ht, *jplan.solve(b))


def test_freeze_on_twice_the_identity():
    """2 I on the helm_fe offsets (symmetric: every off-centre plane 0), b = 1,
    400 iterations: the history reads 0 from iteration 1 on, everything stays
    finite, and x = b / 2."""
    N = 16
    A = helm_fe(N, 5.0, eps=5.0)
    coef = np.zeros((len(A.offsets), N, N), complex)
    coef[0] = 2.0
    S = from_tpcg(JaxStencil2D(A.offsets, jnp.asarray(coef), (N, N)))
    half, cplanes = tss.prepare_stream_sym(S)
    bp = _planes(np.ones((N, N)))
    x, h = tss.stream_cg_sym_planes(half, cplanes, bp, torch.zeros_like(bp),
                                    400)
    assert torch.isfinite(x).all() and torch.isfinite(h).all()
    assert h[0] == 16.0 and torch.all(h[1:] == 0)
    assert torch.all(x[0] == 0.5) and torch.all(x[1] == 0)


def test_zero_rhs_stays_zero():
    _, half, cplanes, bp, _ = _case(24)
    x, h = tss.stream_cg_sym_planes(half, cplanes, torch.zeros_like(bp),
                                    torch.zeros_like(bp), 30)
    assert torch.all(x == 0) and torch.all(h == 0)


def test_argument_checks():
    _, half, cplanes, bp, x0p = _case(16)
    with pytest.raises(ValueError, match="cplanes"):
        tss.stream_cg_sym_planes(half, cplanes[:, :3], bp, x0p, 3)
    with pytest.raises(ValueError, match="half_offsets"):
        tss.stream_cg_sym_planes(half[1:] + half[:1], cplanes, bp, x0p, 3)
    with pytest.raises(ValueError, match="b must be"):
        tss.stream_cg_sym_planes(half, cplanes, bp[:, :8], x0p[:, :8], 3)
    with pytest.raises(TypeError):
        tss.stream_cg_sym_planes(half, cplanes, bp.double(), x0p.double(), 3)
    with pytest.raises(ValueError, match="n_iterations"):
        tss.stream_cg_sym_planes(half, cplanes, bp, x0p, -1)
