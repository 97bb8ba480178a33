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

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _fake_cuda_stencil(grid, dtype):
    """Enough of a Stencil2D on a CUDA device for the planner's choice,
    which happens before anything touches the coefficients' data."""
    coef = torch.empty((7,) + grid, dtype=dtype, device="meta")
    return types.SimpleNamespace(grid=grid, coef=coef,
                                 device=torch.device("cuda", 0),
                                 offsets=((0, 0),) * 7)


def test_planner_on_cpu_takes_the_plain_path():
    for S in (helm_fe(12, 4.0, eps=4.0), poisson(12)):
        plan = tpcg_torch.plan_stencil_cg(from_tpcg(S), 5)
        assert plan.path == "eager"
    plan = tpcg_torch.plan_stencil_cg(from_tpcg(helm_fe(12, 4.0, eps=4.0)),
                                      5, path="l2-coef")
    assert plan.path == "l2-coef"


@pytest.mark.parametrize("grid,dtype,jax_tier", [
    ((1024, 1024), torch.complex128, "stream-coef"),
    ((600, 520), torch.complex64, "stream-coef"),
    ((1024, 1024), torch.float64, "stream-real"),
])
def test_planner_on_cuda_refuses_tiers_not_ported(grid, dtype, jax_tier):
    with pytest.raises(NotImplementedError, match=jax_tier):
        tpcg_torch.plan_stencil_cg(_fake_cuda_stencil(grid, dtype), 10)


@pytest.mark.parametrize("path", ["vmem-const", "stream", "stream-coef",
                                  "stream-real"])
def test_explicit_unported_path_raises(path):
    S = from_tpcg(helm_fe(8, 3.0, eps=3.0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpcg_torch.plan_stencil_cg(S, 5, path=path)
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
    T = tpcg_torch.problems.helm_fe(N, k, eps=k)
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


def test_import_pulls_in_no_jax():
    code = ("import sys, tpcg_torch, tpcg_torch.ops, tpcg_torch.convert, "
            "tpcg_torch.api, tpcg_torch.io, tpcg_torch.cli, "
            "tpcg_torch.ops.stream_cg_dia, tpcg_torch.ops.fused_cg_dia, "
            "tpcg_torch.native.mtx_native; "
            "tpcg_torch.native.mtx_native.available(); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'tpcg.')) or m == 'tpcg'); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
