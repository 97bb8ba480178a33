"""tpcg_torch.ops.auto: the planner's choices, the solve surface against
tpcg.plan_stencil_cg, and the slice end to end."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import tpcg
import tpcg_torch
from tpcg.problems import helm_fe, plane_wave_rhs, poisson
from tpcg_torch.convert import from_tpcg
from tpcg_torch.ops import auto

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _fake_cuda_stencil(grid, dtype, coef=None, offsets=((0, 0),) * 7):
    """Enough of a Stencil2D on a CUDA device for the planner's choice,
    which happens before anything moves to the device.  Without ``coef``
    the coefficients are on the meta device, for choices that do not read
    them."""
    if coef is None:
        coef = torch.empty((7,) + grid, dtype=dtype, device="meta")
    return types.SimpleNamespace(grid=grid, coef=coef,
                                 device=torch.device("cuda", 0),
                                 offsets=offsets)


def test_planner_on_cpu_takes_the_plain_path():
    for S in (helm_fe(12, 4.0, eps=4.0), poisson(12)):
        plan = tpcg_torch.plan_stencil_cg(from_tpcg(S), 5)
        assert plan.path == "eager"
    plan = tpcg_torch.plan_stencil_cg(from_tpcg(helm_fe(12, 4.0, eps=4.0)),
                                      5, path="l2-coef")
    assert plan.path == "l2-coef"


@pytest.mark.parametrize("grid,dtype,jax_tier", [
    ((24, 24), torch.complex128, "stream-coef"),
    ((29, 24), torch.complex64, "stream-coef"),
    ((1024, 1024), torch.float64, "stream-real"),
    ((24, 24), torch.complex128, "non-symmetric"),
])
def test_planner_on_cuda_refuses_tiers_not_ported(monkeypatch, grid, dtype,
                                                  jax_tier):
    """Past the whole-solve size (its threshold lowered here): a symmetric
    variable-coefficient complex grid, where JAX takes stream-coef (and
    pad->stream-coef for the prime height 29), plans ``stream-coef`` on the
    unpadded grid with the half planes; a real grid from JAX's
    real-streaming size (Poisson, 1024^2) plans ``stream-real`` in const
    mode; a non-symmetric variable-coefficient grid, which JAX sends to its
    general-coefficient kernels, plans ``stream-coef`` with the full
    coefficient planes (the general kernel's operand).  No tier is refused
    any longer."""
    monkeypatch.setattr(auto, "_L2_NODES", 256)
    if not dtype.is_complex:
        T = tpcg_torch.problems.poisson(grid[0], device="cpu")
        fake = _fake_cuda_stencil(grid, dtype, T.coef.to(dtype), T.offsets)
        plan = tpcg_torch.plan_stencil_cg(fake, 10)
        assert plan.path == jax_tier and plan.grid == grid
        assert auto._pick_path(fake, 1, on_cuda=True)[1][0] == "const"
        return
    nv, nh = grid
    C = 1.0 + 0.5 * np.random.default_rng(4).random((nv - 1, nh - 1))
    T = tpcg_torch.problems.helm_fe_var(nv, 12.0, C, rho=0.1, Nhoriz=nh,
                                        Nvert=nv, device="cpu")
    coef = T.coef.to(dtype)
    if jax_tier == "non-symmetric":
        coef[1] *= 1.5
    fake = _fake_cuda_stencil(grid, dtype, coef, T.offsets)
    plan = tpcg_torch.plan_stencil_cg(fake, 10)
    assert plan.path == "stream-coef" and plan.grid == grid
    path, prepared = auto._pick_path(fake, 3, on_cuda=True)
    assert path == "stream-coef"
    if jax_tier == "non-symmetric":
        assert torch.is_tensor(prepared)
        assert torch.equal(prepared, tpcg_torch.ops.prepare_stream_coef(fake))
        assert tuple(prepared.shape) == (2, len(T.offsets)) + grid
    else:
        half, cplanes = prepared
        assert half[0] == (0, 0) and cplanes.shape[1] == len(half)


@pytest.mark.parametrize("path", ["vmem-const", "stream", "stream-coef",
                                  "stream-real"])
def test_explicit_unported_path_raises(path):
    """The JAX name ``vmem-const`` raises the "unknown path" ValueError that
    ``vmem-coef`` raises (the port's names are ``l2-const`` and
    ``l2-coef``); forcing ``stream`` on a variable-coefficient stencil
    raises ``prepare_stream``'s ValueError, as JAX's planner does, and
    forcing ``stream-real`` on a complex stencil a ValueError.  Forcing
    ``stream-coef`` on a non-symmetric stencil, which JAX sends to its
    general-coefficient kernels, plans the port's general kernel (its plain
    version here) and raises no more."""
    S = from_tpcg(helm_fe(8, 3.0, eps=3.0))
    if path in ("stream", "stream-coef"):
        C = 1.0 + 0.5 * np.random.default_rng(4).random((7, 7))
        S = tpcg_torch.problems.helm_fe_var(8, 3.0, C, rho=0.1, device="cpu")
    if path == "stream-coef":
        S.coef[1] *= 1.5
    match = {"vmem-const": "unknown path", "stream": "not constant",
             "stream-real": "real stencil"}.get(path)
    if match is None:
        plan = tpcg_torch.plan_stencil_cg(S, 5, path=path)
        x, hist = plan.solve(np.ones((8, 8), complex))
        assert plan.path == "stream-coef" and x.shape == (8, 8)
        assert np.isfinite(x).all() and hist.shape == (6,)
    else:
        with pytest.raises(ValueError, match=match):
            tpcg_torch.plan_stencil_cg(S, 5, path=path)
    with pytest.raises(ValueError, match="unknown path"):
        tpcg_torch.plan_stencil_cg(S, 5, path="vmem-coef")
    with pytest.raises(ValueError):
        tpcg_torch.plan_stencil_cg(S, 5, path="xla")


def _rhs_forms(N, rng):
    n = N * N
    b1 = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    b3 = rng.standard_normal((3, N, N)) + 1j * rng.standard_normal((3, N, N))
    return {"grid": b1, "flat": b1.reshape(-1), "batch": b3,
            "flat_batch": b3.reshape(-1), "stacked": b3.reshape(3, n),
            "batch_of_one": b1[None]}


@pytest.mark.parametrize("form", ["grid", "flat", "batch", "flat_batch",
                                  "stacked", "batch_of_one"])
def test_solve_shapes_match_jax_xla_path(form):
    N = 10
    S = helm_fe(N, 4.0, eps=4.0)
    b = _rhs_forms(N, np.random.default_rng(5))[form]
    x0 = 0.01 * b
    xj, hj = tpcg.plan_stencil_cg(S, 20, path="xla").solve(b, x0)
    xt, ht = tpcg_torch.plan_stencil_cg(from_tpcg(S), 20).solve(b, x0)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert xt.shape == xj.shape and ht.shape == hj.shape
    assert xt.dtype == xj.dtype
    np.testing.assert_allclose(xt, xj, rtol=1e-10,
                               atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=1e-10)


def test_real_stencil_solve_matches_jax():
    S = poisson(12)
    b = np.cos(np.arange(S.n) * 0.2).reshape(12, 12)
    xj, hj = tpcg.stencil_cg(S, b, n_iterations=30, path="xla")
    xt, ht = tpcg_torch.stencil_cg(from_tpcg(S), b, n_iterations=30)
    assert xt.dtype == np.asarray(xj).dtype and xt.shape == (12, 12)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-10)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-10)


def test_slice_end_to_end_n32():
    """The headline problem family at N=32 over 50 iterations: the default
    plan (float64 on the CPU) against JAX's default, and the kernel path
    (its plain version on the CPU, float32) against JAX's vmem-coef kernel
    in interpret mode."""
    N, k = 32, 5.0
    S = helm_fe(N, k, eps=k)
    b = plane_wave_rhs(N, k)
    T = tpcg_torch.problems.helm_fe(N, k, eps=k, device="cpu")
    xj, hj = tpcg.stencil_cg(S, b, n_iterations=50)
    xt, ht = tpcg_torch.stencil_cg(T, b, n_iterations=50)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-10)

    jplan = tpcg.plan_stencil_cg(S, 50, path="vmem-coef", interpret=True)
    tplan = tpcg_torch.plan_stencil_cg(T, 50, path="l2-coef")
    xj, hj = jplan.solve(b)
    xt, ht = tplan.solve(b)
    assert xt.dtype == np.complex64 and xt.shape == (N, N)
    assert ht.shape == (51,)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=2e-3 * np.abs(xj).max())
    np.testing.assert_allclose(ht, hj, rtol=2e-2, atol=1e-3 * hj[0])
    # the float32 kernel path lands near the float64 one
    x64, _ = tpcg_torch.stencil_cg(T, b, n_iterations=50)
    assert np.abs(xt - x64).max() <= 2e-3 * np.abs(x64).max()


@pytest.mark.parametrize("path", ["l2-coef", "eager"])
def test_solve_planes_shapes(path):
    N = 8
    T = from_tpcg(helm_fe(N, 3.0, eps=3.0))
    plan = tpcg_torch.plan_stencil_cg(T, 7, path=path)
    b = plane_wave_rhs(N, 3.0)
    bp = torch.from_numpy(np.stack([b.real, b.imag]).astype(np.float32))
    x, hist = plan.solve_planes(bp)
    assert x.shape == (2, N, N) and hist.shape == (8,)
    xb, hb = plan.solve_planes(torch.stack([bp, 2 * bp], dim=1))
    assert xb.shape == (2, 2, N, N) and hb.shape == (8, 2)
    # the eager plan on the CPU solves in float64, the planes in float32
    xs, _ = plan.solve(b)
    np.testing.assert_allclose(xs, (x[0] + 1j * x[1]).numpy(), rtol=0,
                               atol=1e-4 * np.abs(xs).max())


def test_eager_real_stencil_solve_planes_takes_real_planes():
    """On ``eager`` a real stencil's solve_planes takes real (Nv, Nh) or
    (B, Nv, Nh) planes through block_cg, the surface of stream-real, and
    gives solve's x; a (2, 64, 64) tensor is two real RHS, not one complex
    RHS."""
    S = tpcg_torch.problems.poisson(64, device="cpu")
    plan = tpcg_torch.plan_stencil_cg(S, 30)
    assert plan.path == "eager" and plan.real_planes
    b = np.random.default_rng(0).standard_normal((2, 64, 64))
    xs, hs = plan.solve(b)
    x1, h1 = plan.solve_planes(torch.from_numpy(b[0]))
    assert x1.shape == (64, 64) and h1.shape == (31,)
    np.testing.assert_allclose(x1.numpy(), xs[0], rtol=1e-12, atol=1e-12)
    x2, h2 = plan.solve_planes(torch.from_numpy(b))
    assert x2.shape == (2, 64, 64) and h2.shape == (31, 2)
    np.testing.assert_allclose(x2.numpy(), xs, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(h2.numpy(), hs, rtol=1e-12)


def test_import_pulls_in_no_jax():
    code = ("import sys, tpcg_torch, tpcg_torch.ops, tpcg_torch.convert, "
            "tpcg_torch.api, tpcg_torch.io, tpcg_torch.cli, "
            "tpcg_torch.ops.stream_cg_dia, tpcg_torch.ops.fused_cg_dia, "
            "tpcg_torch.ops.stream_cg, tpcg_torch.ops.fused_cg_const, "
            "tpcg_torch.ops.stream_cg_sym, tpcg_torch.ops.stream_cg_real, "
            "tpcg_torch.ops.stream_cg_coef, "
            "tpcg_torch.device, tpcg_torch.ops.route_spmv, "
            "tpcg_torch.ops.routing, tpcg_torch.native.routing_native, "
            "tpcg_torch.native.mtx_native; "
            "tpcg_torch.native.mtx_native.available(); "
            "tpcg_torch.native.routing_native.available(); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'tpcg.')) or m == 'tpcg'); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
