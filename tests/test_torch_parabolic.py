"""The parabolic_fem class on the stencil planner, on the CPU: the planner's
rule for real grids (``auto._pick_path`` on a stencil that says it is on a
card), the stand-in's diagonal against the benchmark's plain reference,
the ``stream-real`` path's plain version against float64 CG, and the
planner's spans, counters and copies (``tpcg_torch.trace``), which the
benchmark's cell ``parabolic_fem.stencil_calls`` reads.  The card's side is
in ``tests/test_torch_cuda.py``."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import tpcg_torch
from tpcg_torch import trace
from tpcg_torch.device import download, upload
from tpcg_torch.ops import auto
from tpcg_torch.problems import helm_fe, parabolic_stencil, plane_wave_rhs
from tpcg_torch.sparse import Stencil2D

from bench_torch.reference import parabolic as ref
from bench_torch.reference.cg import cg

CPU = torch.profiler.ProfilerActivity.CPU
CPU_TEST = {"Ng": 48, "diag": 6.0}         # the cell's cpu_test size


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def _on_card(S, dtype=torch.float32):
    """``S`` as the planner sees a stencil on a CUDA device; the choice and
    the kernel's operands are made before anything moves there."""
    return types.SimpleNamespace(grid=S.grid, coef=S.coef.to(dtype),
                                 device=torch.device("cuda", 0),
                                 offsets=S.offsets)


def _fe(nv, nh):
    """parabolic_stencil's 7-point FE pattern, diagonal 6, on an nv x nh
    grid: taps that leave the grid zeroed."""
    S = parabolic_stencil(2, device="cpu")
    c = np.zeros((7, nv, nh), np.float32)
    for s, (dm, dj) in enumerate(S.offsets):
        c[s, max(0, -dm):nv - max(0, dm), max(0, -dj):nh - max(0, dj)] = (
            6.0 if s == 0 else -1.0)
    return Stencil2D(S.offsets, torch.from_numpy(c), (nv, nh))


@pytest.mark.parametrize("grid,dtype,path", [
    ((725, 725), torch.float32, "stream-real"),   # parabolic_fem
    ((8, 8), torch.float32, "stream-real"),       # the smallest swept
    ((8, 300), torch.float32, "stream-real"),
    ((7, 300), torch.float32, "eager"),           # under the swept sides
    ((1000, 1000), torch.float64, "eager"),       # float64: JAX's 1024^2
    ((1024, 1024), torch.float64, "stream-real"),
])
def test_real_grids_on_the_card(grid, dtype, path):
    S = _fe(*grid)
    if grid == (725, 725):
        assert torch.equal(S.coef, parabolic_stencil(725, device="cpu",
                                                     diag=6.0).coef)
    got, prepared = auto._pick_path(_on_card(S, dtype), 1, on_cuda=True)
    assert got == path
    if path == "stream-real":
        assert prepared[0] == "const"
    # off the card every grid plans the plain path
    assert auto._pick_path(S, 1, on_cuda=False)[0] == "eager"


def test_the_cpu_plans_eager():
    S = parabolic_stencil(48, device="cpu", diag=6.0)
    assert tpcg_torch.plan_stencil_cg(S, 5).path == "eager"


@pytest.mark.parametrize("Ng", [5, 17, 48])
@pytest.mark.parametrize("diag", [6.0, 8.0])
def test_stand_in_equals_the_benchmark_reference(Ng, diag):
    """parabolic_stencil's matrix times random blocks equals the benchmark's
    plain operator (which builds nothing of the program) to float64's
    rounding; the default diagonal is still bench_fig5.py's 8."""
    S = (parabolic_stencil(Ng, device="cpu", diag=diag) if diag != 8.0
         else parabolic_stencil(Ng, device="cpu"))
    A = S.to_scipy()
    assert np.all(A.diagonal() == diag)
    u = np.random.default_rng(Ng).standard_normal((3, Ng * Ng))
    y, = ref.operator({"Ng": Ng, "diag": diag}, torch.float64, "cpu").apply(
        torch.from_numpy(u))
    want = (A @ u.T).T
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


def test_stream_real_plain_against_float64_cg():
    """The forced stream-real plan (the kernel's plain version on the CPU)
    at the cell's CPU size, 300 iterations: the history within 1e-4 of
    float64 CG's over the first 20 iterations, and the final float64
    relative residual at float32's level."""
    Ng = CPU_TEST["Ng"]
    S = parabolic_stencil(Ng, device="cpu", diag=6.0)
    b = np.random.default_rng(3).standard_normal((Ng, Ng)).astype(np.float32)
    plan = tpcg_torch.plan_stencil_cg(S, 300, path="stream-real")
    x, h = plan.solve(b)
    assert x.dtype == np.float32 and h.shape == (301,)
    op = ref.operator(CPU_TEST, torch.float64, "cpu")
    bt = torch.from_numpy(b.astype(np.float64).reshape(1, -1))
    _, h64 = cg(op, bt, 20)
    np.testing.assert_allclose(h[:21], h64[:, 0].numpy(), rtol=1e-4)
    r = bt - op.apply(torch.from_numpy(x.astype(np.float64).reshape(1, -1)))[0]
    assert float(r.norm() / bt.norm()) < 1e-4
    assert h[-1] > 0


def _profiled(fn):
    with torch.profiler.profile(activities=[CPU]):
        return fn()


@pytest.mark.parametrize("path", ["eager", "stream-real"])
def test_stencil_cg_spans_and_counters(path):
    """stencil_cg is span ``tpcg.stencil_cg`` holding ``tpcg.plan`` and
    ``tpcg.solve``, the plan counted by its path; on the CPU nothing is
    copied, so no upload, wait or download span."""
    S = parabolic_stencil(16, device="cpu", diag=6.0)
    b = np.ones((16, 16), np.float32)
    x, h = _profiled(lambda: tpcg_torch.stencil_cg(S, b, n_iterations=5,
                                                   path=path))
    recs = trace.records()
    top, plan, solve = recs[:3]
    assert [r.name for r in recs] == [
        "tpcg.stencil_cg", "tpcg.plan", "tpcg.solve", "tpcg.pack",
        "tpcg.pack"]
    assert top.parent is None and plan.parent == solve.parent == top.id
    assert [r.parent for r in recs[3:]] == [solve.id, solve.id]
    assert top.start_ns <= plan.start_ns <= plan.end_ns <= solve.start_ns
    assert solve.end_ns <= top.end_ns
    assert trace.counters() == {"plan." + path: 1} == plan.counts
    assert x.shape == (16, 16) and h.shape == (6,)
    # untraced: the same answer, nothing recorded
    trace.clear()
    x2, h2 = tpcg_torch.stencil_cg(S, b, n_iterations=5, path=path)
    assert trace.records() == []
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(h, h2)


def _spy(monkeypatch):
    """Count the bytes through the planner's copy layer as a card would
    (on the CPU ``device.upload`` and ``download`` copy nothing and count
    nothing)."""
    def up(t, device, dtype=None):
        out = upload(t, device, dtype)
        trace.count("h2d_bytes", out.nbytes)
        return out

    def down(t):
        out = download(t)
        trace.count("d2h_bytes", out.nbytes)
        return out
    monkeypatch.setattr(auto, "upload", up)
    monkeypatch.setattr(auto, "download", down)


@pytest.mark.parametrize("kind,path,b_node_bytes", [
    ("real", "eager", 4), ("real", "stream-real", 4),
    ("complex", "eager", 16), ("complex", "l2-coef", 8),
    ("complex", "stream", 8)])
@pytest.mark.parametrize("x0", [False, True])
def test_every_path_copies_through_the_copy_layer(monkeypatch, kind, path,
                                                  b_node_bytes, x0):
    """On every planner path solve's b (and x0) go up through
    ``device.upload`` and x and the history come down through
    ``device.download``: the bytes counted are b's in the path's dtype,
    and the x and history returned."""
    _spy(monkeypatch)
    N, it = 12, 6
    if kind == "real":
        S = parabolic_stencil(N, device="cpu", diag=6.0)
        b = np.random.default_rng(1).standard_normal((N, N)).astype(
            np.float32)
    else:
        S = helm_fe(N, 5.0, eps=5.0, device="cpu")
        b = plane_wave_rhs(N, 5.0)
    plan = tpcg_torch.plan_stencil_cg(S, it, path=path)
    x, h = plan.solve(b, 0.5 * b if x0 else None)
    c = trace.counters()
    assert c["h2d_bytes"] == (2 if x0 else 1) * b_node_bytes * N * N
    assert c["d2h_bytes"] == x.nbytes + h.nbytes
    assert x.shape == (N, N) and h.shape == (it + 1,)


def test_traced_bench_run_reads_the_planner_spans():
    """The cell parabolic_fem.stencil_calls at its CPU size, traced: correct,
    and the planner's metrics read; on the CPU the plan is eager, nothing
    crosses devices and no kernel runs, so the roofline finds nothing."""
    from bench_torch import run, spec
    cell = spec.cell("parabolic_fem.stencil_calls")
    cell = dataclasses.replace(
        cell, config={**cell.config, **cell.config["cpu_test"]})
    result, _ = run.measure(cell, 2**32 + 9, 0.3, True, torch.device("cpu"))
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert got["plan_ms.host"]["value"] > 0
    assert got["copy_mb.host"]["value"] == 0
    assert got["launches.host"]["value"] == 0
    assert "stream_cg_real_roofline.host" not in got
    tops = [r for r in trace.records() if r.parent is None]
    assert [r.name for r in tops] == ["tpcg.stencil_cg"] * (
        result["attempted"] + 1)
    assert trace.counters()["plan.eager"] == result["attempted"] + 2
