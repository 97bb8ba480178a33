"""The CUDA kernel of tpcg_torch against its plain PyTorch version, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernel has no CPU mode.  The file imports no JAX, so that it also runs on a
machine that has a card and no JAX; tests/conftest.py imports JAX, so run
it there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import contextlib
import ctypes
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import tpcg_torch
from tpcg_torch.problems import helm_fe, plane_wave_rhs, poisson
from tpcg_torch import trace
from tpcg_torch.ops import _tiles
from tpcg_torch.trace import counters

# the package exports a function named fused_cg that hides the module
tfc = importlib.import_module("tpcg_torch.ops.fused_cg")

pytestmark = pytest.mark.cuda


def _counted(name):
    """The counter ``name`` of ``tpcg_torch.trace`` (0 before its first
    count)."""
    return counters().get(name, 0)


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
    before = _counted("launch.fused_cg")
    xk, hk = tfc.fused_cg_stencil(S.offsets, coef3, bp, x0p, iters)
    assert _counted("launch.fused_cg") == before + 1
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
    before = _counted("launch.fused_cg")
    x, hist = plan.solve(plane_wave_rhs(16, 5.0))
    assert _counted("launch.fused_cg") == before + 1
    assert np.isfinite(x).all() and hist.shape == (11,)
    # past the whole-solve size: a constant-tap grid takes the streaming
    # kernel, at a prime height too (JAX row-pads it; the kernel reads any
    # height)
    assert tpcg_torch.plan_stencil_cg(
        helm_fe(513, 5.0, eps=5.0, device=dev), 5).path == "stream"
    assert tpcg_torch.plan_stencil_cg(
        helm_fe(521, 5.0, eps=5.0, device=dev), 5).path == "stream"


def test_eager_path_on_card_matches_kernel_path(dev):
    S = helm_fe(24, 5.0, eps=5.0, device=dev)
    b = np.stack([plane_wave_rhs(24, 5.0)] * 2)
    xk, hk = tpcg_torch.plan_stencil_cg(S, 20, path="l2-coef").solve(b)
    xe, he = tpcg_torch.plan_stencil_cg(S, 20, path="eager").solve(b)
    assert xe.dtype == np.complex64
    np.testing.assert_allclose(xk, xe, rtol=0, atol=2e-3 * np.abs(xe).max())
    np.testing.assert_allclose(hk, he, rtol=2e-2, atol=1e-3 * he[0].max())


# ---- banded DIA kernels (csrc/stream_cg_dia.cu, csrc/fused_cg_dia.cu) ----
# x within 2e-3 max|x| and the history on its live entries (h > 1e-6 h[0])
# within rel 1e-2: float32 kernels against their plain versions over at
# most 100 iterations, the tolerances of the stencil kernel's checks; the
# systems are diagonally dominant and underflow mid-run, where two
# summation orders cross zero an iteration apart.

tsd = importlib.import_module("tpcg_torch.ops.stream_cg_dia")
tfd = importlib.import_module("tpcg_torch.ops.fused_cg_dia")


def _assert_dia_close(xk, hk, xp, hp):
    xk, hk, xp, hp = (t.cpu().numpy() for t in (xk, hk, xp, hp))
    assert np.isfinite(xk).all() and np.isfinite(hk).all()
    np.testing.assert_allclose(xk, xp, rtol=0, atol=2e-3 * np.abs(xp).max())
    live = hp > 1e-6 * hp[0]
    assert np.all(np.abs(hk[live] - hp[live]) <= 1e-2 * hp[live])


def _dia(A, dtype, dev):
    import scipy.sparse as sp
    from tpcg_torch.sparse import DiaMatrix
    return DiaMatrix.from_scipy(sp.csr_matrix(A.astype(dtype)), device=dev)


def _small_band(cplx, n=777, offs=(0, 1, 3, 40)):
    from tpcg_torch.problems import banded_complex
    A = banded_complex(n, offs, seed=2)
    return A if cplx else A.real


def _rhs(n, nb, cplx, dev, seed=1):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((2 if cplx else 1, nb, n)).astype(np.float32)
    t = torch.from_numpy(b).to(dev)
    return t if cplx else t[0]


def _run_twice(fn, *args):
    xk, hk = fn(*args)
    xk2, hk2 = fn(*args)
    assert torch.equal(xk, xk2) and torch.equal(hk, hk2)
    return xk, hk


@contextlib.contextmanager
def _dia_layout(cluster):
    """Kernel A's launches inside take ``dia_layout(cluster=cluster)``: 0
    the cooperative grid, C one cluster of C blocks, None the rule (an
    explicit ``cluster=`` of the wrapper's fallback still wins)."""
    layout = tsd.dia_layout
    if cluster is not None:
        tsd.dia_layout = lambda *a, cluster=cluster: layout(*a,
                                                            cluster=cluster)
    try:
        yield
    finally:
        tsd.dia_layout = layout


# kernel A's two modes: the layout rule (cluster mode on the small bands
# of the freeze and latch tests) and the cooperative grid forced
DIA_MODES = ((None, "cluster"), (0, "cooperative"))


@pytest.mark.parametrize("cplx,nb", [(False, 1), (False, 3), (True, 1),
                                     (True, 2)])
def test_stream_dia_kernel_matches_plain_small(dev, cplx, nb):
    D = _dia(_small_band(cplx), np.complex64 if cplx else np.float32, dev)
    if cplx:
        offs, vals = tsd.prepare_dia_rows_cplx(D)
        wrap, plain = tsd.stream_cg_dia_rows_cplx, \
            tsd.stream_cg_dia_rows_cplx_plain
    else:
        offs, vals = tsd.prepare_dia_rows(D)
        wrap, plain = tsd.stream_cg_dia_rows, tsd.stream_cg_dia_rows_plain
    launches = "launch.stream_dia_cplx" if cplx else "launch.stream_dia"
    b = _rhs(D.n, nb, cplx, dev)
    x0 = 0.1 * _rhs(D.n, nb, cplx, dev, seed=2)
    before = _counted(launches)
    xk, hk = _run_twice(wrap, offs, vals, b, x0, 40)
    assert _counted(launches) == before + 2
    xp, hp = plain(offs, vals, b, x0, 40)
    for c in range(nb):
        _assert_dia_close(xk[..., c, :], hk[:, c], xp[..., c, :], hp[:, c])


def test_fused_dia_kernel_matches_plain_small(dev):
    # the CPU-side fit rule is this card's limit: 8 rows per thread, and
    # the shared memory a block may use (dynamic part + the static 512 B)
    rows, dyn = tfd.kernel_limits()
    assert rows == tfd._MAX_ROWS
    assert dyn + tfd._STATIC_SMEM == _tiles.BLOCK_SHARED
    D = _dia(_small_band(True, n=300, offs=(0, 2, 150)), np.complex64, dev)
    offs, vals = tsd.prepare_dia_rows_cplx(D)
    b = _rhs(D.n, 3, True, dev)
    x0 = 0.1 * _rhs(D.n, 3, True, dev, seed=2)
    before = _counted("launch.fused_dia")
    xk, hk = _run_twice(tfd.fused_cg_dia_rows_cplx, offs, vals, b, x0, 40)
    assert _counted("launch.fused_dia") == before + 2
    xp, hp = tfd.fused_cg_dia_rows_cplx_plain(offs, vals, b, x0, 40)
    for c in range(3):
        _assert_dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])


def _main_path_case(name, dev):
    """The Fig. 5 classes at full size: (DiaMatrix on dev, cplx)."""
    from tpcg_torch.problems import (banded_complex, banded_spd,
                                     parabolic_stencil)
    if name == "m_t1":
        return _dia(banded_spd(97578, 50), np.float32, dev), False
    if name == "parabolic":
        return parabolic_stencil(725, device=dev).to_dia(), False
    if name == "mhd1280b":
        return _dia(banded_complex(1280, tuple(range(0, 9)), seed=2),
                    np.complex64, dev), True
    return _dia(helm_fe(128, 12.0, eps=12.0).to_scipy(), np.complex64,
                dev), True


@pytest.mark.parametrize("name,nb", [("m_t1", 1), ("m_t1", 8),
                                     ("parabolic", 1), ("mhd1280b", 1),
                                     ("helm_fem", 1)])
def test_dia_kernels_match_plain_at_main_path_shapes(dev, name, nb):
    """100 iterations at the shapes the entry points give each kernel:
    m_t1 (B=1 and B=8) and parabolic through the real streaming kernel,
    mhd1280b through the fused kernel, helm_fem as a CSR matrix through the
    complex streaming kernel.  Each RHS of a batch is its own seeded draw,
    so a kernel that mixed RHS indices would disagree; helm_fem takes its
    class's plane wave (a random RHS on that indefinite matrix is the
    witness case of test_stream_dia_cplx_indefinite_random_rhs)."""
    D, cplx = _main_path_case(name, dev)
    if name == "helm_fem":
        w = plane_wave_rhs(128, 12.0).reshape(1, -1)
        b = torch.from_numpy(np.stack([w.real, w.imag]).astype(
            np.float32)).to(dev)
    else:
        b = _rhs(D.n, nb, cplx, dev, seed=3)
    if name == "mhd1280b":
        offs, vals = tsd.prepare_dia_rows_cplx(D)
        wrap, plain = tfd.fused_cg_dia_rows_cplx, \
            tfd.fused_cg_dia_rows_cplx_plain
    elif cplx:
        offs, vals = tsd.prepare_dia_rows_cplx(D)
        wrap, plain = tsd.stream_cg_dia_rows_cplx, \
            tsd.stream_cg_dia_rows_cplx_plain
    else:
        offs, vals = tsd.prepare_dia_rows(D)
        wrap, plain = tsd.stream_cg_dia_rows, tsd.stream_cg_dia_rows_plain
    x0 = torch.zeros_like(b)
    xk, hk = _run_twice(wrap, offs, vals, b, x0, 100)
    xp, hp = plain(offs, vals, b, x0, 100)
    for c in range(nb):
        _assert_dia_close(xk[..., c, :], hk[:, c], xp[..., c, :], hp[:, c])


def test_stream_dia_cplx_indefinite_random_rhs(dev):
    """helm_fem as a DIA matrix (indefinite, complex symmetric) with two
    seeded random RHS, through the complex streaming kernel.  Held for 20
    iterations: there two float32 plain versions (row-DIA and Karatsuba
    planes) agree within 1.4e-4 max|x| on the CPU, while at 100 iterations
    the second RHS lies near a breakdown and they differ by 14% (PERF.md,
    Findings)."""
    D = _main_path_case("helm_fem", dev)[0]
    offs, vals = tsd.prepare_dia_rows_cplx(D)
    b = _rhs(D.n, 2, True, dev, seed=7)
    x0 = torch.zeros_like(b)
    xk, hk = _run_twice(tsd.stream_cg_dia_rows_cplx, offs, vals, b, x0, 20)
    xp, hp = tsd.stream_cg_dia_rows_cplx_plain(offs, vals, b, x0, 20)
    for c in range(2):
        _assert_dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])


def test_stream_dia_chunks_past_its_rhs_limit(dev):
    """Nine RHS on the cooperative grid: two launches of 5 and 4
    (balanced, no zero padding), each RHS equal to its single-RHS launch
    bit for bit.  (Cluster mode, this band's rule, takes them in one
    launch: test_stream_dia_clusters_side_by_side.)"""
    max_rhs, _ = tsd.kernel_limits()
    assert max_rhs == 8
    D = _dia(_small_band(False), np.float32, dev)
    offs, vals = tsd.prepare_dia_rows(D)
    b = _rhs(D.n, 9, False, dev)
    x0 = torch.zeros_like(b)
    before = _counted("launch.stream_dia")
    with _dia_layout(0):
        xk, hk = tsd.stream_cg_dia_rows(offs, vals, b, x0, 30)
        assert _counted("launch.stream_dia") == before + 2
        with pytest.raises(ValueError):
            tsd._launch(offs, vals[None], b[None], x0[None], 30)
        x1, h1 = tsd.stream_cg_dia_rows(offs, vals, b[4:5], x0[4:5], 30)
    xp, hp = tsd.stream_cg_dia_rows_plain(offs, vals, b, x0, 30)
    for c in range(9):
        _assert_dia_close(xk[c], hk[:, c], xp[c], hp[:, c])
    assert torch.equal(x1[0], xk[4]) and torch.equal(h1[:, 0], hk[:, 4])


def _window_case(name, dev):
    """(DiaMatrix on dev, cplx) of the window tests: m_t1 at full size; a
    symmetric band of half-width 6000 at n = 20,000, whose window passes a
    block's shared memory at 8 RHS (400 KB) and fits at 1 (50 KB); at
    n = 70,001 (tiles of 544 rows, the last of 369) a band that reaches 700
    rows ahead and 1500 behind, so a window spans parts of five tiles and
    the first and last tiles' windows run into the zero border, real and
    complex."""
    import scipy.sparse as sp
    if name == "m_t1":
        return _main_path_case("m_t1", dev)
    if name == "wide":
        n, offs, sym = 20_000, (6000,), True
    elif name == "ragged":
        # cluster mode: 10 tiles of 512 rows, the last of 392
        n, offs, sym = 5000, (1, 64), True
    elif name.startswith("far"):
        # cluster mode: 6 tiles of 512 rows, a halo of 1100 rows, so a
        # block's window takes rows of up to three blocks each side
        n, offs, sym = 3000, (1, 5, 700, -3, -1100), False
    else:
        n, offs, sym = 70_001, (1, 5, 700, -3, -1100, -1500), False
    rng = np.random.default_rng(5)
    cplx = name in ("edges_cplx", "far_cplx")
    diags = [rng.standard_normal(n - abs(o)) * 0.1
             + (1j * rng.standard_normal(n - abs(o)) * 0.1 if cplx else 0)
             for o in offs]
    A = sp.diags(diags, offs, shape=(n, n))
    A = (A + A.T if sym else A) + sp.eye(n) * (20.0 + (5j if cplx else 0))
    return _dia(A, np.complex64 if cplx else np.float32, dev), cplx


@pytest.mark.parametrize("name,nb,staged", [
    ("m_t1", 8, True), ("wide", 8, False), ("wide", 1, True),
    ("edges", 3, True), ("edges_cplx", 2, True)])
def test_stream_dia_window_matches_plain(dev, name, nb, staged):
    """The staged window and the direct read against the plain version over
    100 iterations, twice bit-equal, with the counter ``staged.*`` moving
    only on launches that staged: m_t1 at 8 RHS (143 KB a block); a band too
    wide for the window at 8 RHS and one that fits at 1; tiles whose halo
    crosses the first and last tiles and a ragged last tile."""
    D, cplx = _window_case(name, dev)
    if cplx:
        offs, vals = tsd.prepare_dia_rows_cplx(D)
        wrap, plain = tsd.stream_cg_dia_rows_cplx, \
            tsd.stream_cg_dia_rows_cplx_plain
    else:
        offs, vals = tsd.prepare_dia_rows(D)
        wrap, plain = tsd.stream_cg_dia_rows, tsd.stream_cg_dia_rows_plain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = tsd.dia_layout(D.n, offs, nb, 2 if cplx else 1, sms)
    assert lay.staged == staged
    kernel = "stream_dia_cplx" if cplx else "stream_dia"
    b = _rhs(D.n, nb, cplx, dev, seed=3)
    x0 = 0.1 * _rhs(D.n, nb, cplx, dev, seed=4)
    before = [_counted(k + kernel) for k in ("launch.", "staged.")]
    xk, hk = _run_twice(wrap, offs, vals, b, x0, 100)
    assert [_counted(k + kernel) for k in ("launch.", "staged.")] == [
        before[0] + 2, before[1] + 2 * staged]
    xp, hp = plain(offs, vals, b, x0, 100)
    for c in range(nb):
        _assert_dia_close(xk[..., c, :], hk[:, c], xp[..., c, :], hp[:, c])


@pytest.mark.parametrize("name", ["m_t1", "wide", "far"])
def test_stream_dia_rhs_bits_do_not_depend_on_the_launch(dev, name):
    """RHS 4 of an 8-RHS launch equals its 1-RHS launch bit for bit: at
    m_t1 both launches stage their window; on the wide band the 8-RHS
    launch reads d from L2 and the 1-RHS launch stages it, the same
    values; on the far band both run as one cluster of 6 blocks."""
    D, _ = _window_case(name, dev)
    offs, vals = tsd.prepare_dia_rows(D)
    b = _rhs(D.n, 8, False, dev, seed=6)
    x0 = torch.zeros_like(b)
    x8, h8 = tsd.stream_cg_dia_rows(offs, vals, b, x0, 60)
    x1, h1 = tsd.stream_cg_dia_rows(offs, vals, b[4:5], x0[4:5], 60)
    assert torch.equal(x1[0], x8[4]) and torch.equal(h1[:, 0], h8[:, 4])


def _oras_block(dev):
    """The helm_oras_m4 cell's subdomain block (66 x 66 nodes, n 4,356, 7
    diagonals, complex) as kernel A's (offsets, values) on dev."""
    prec = tpcg_torch.plan_hsolver(_oras_cfg(), dev).prec
    return prec.offsets, prec.values


@pytest.mark.parametrize("name,nrhs,k", [
    ("oras", 16, None), ("oras", 16, 3), ("far", 3, None), ("far", 9, None),
    ("far", 9, 2), ("far", 13, None), ("far", 13, 6)])
def test_stream_dia_clusters_side_by_side(dev, name, nrhs, k):
    """A batch in cluster mode is one launch of G clusters side by side
    (``launch.*`` and ``cluster.*`` +1, ``cluster_grid.*`` +G), and each
    of its RHS equals its own 1-RHS launch bit for bit, x and history: the
    ORAS block's 16 RHS (9 blocks a cluster) and the far band's 3, 9 and
    13 (6 blocks), at the rule's k RHS a cluster and at a k forced so that
    the last cluster is short (16 = 5 x 3 + 1, 9 = 4 x 2 + 1, 13 = 2 x 6 +
    1), the complex 3 and real 6 keeping x, r and q in memory."""
    if name == "oras":
        offs, vals = _oras_block(dev)
        n = vals.shape[2]
        b = _rhs(n, nrhs, True, dev, seed=6)
        solve = tsd.stream_cg_dia_rows_cplx
        kernel, planes = "stream_dia_cplx", 2
    else:
        D, _ = _window_case(name, dev)
        offs, vals = tsd.prepare_dia_rows(D)
        n = D.n
        b = _rhs(n, nrhs, False, dev, seed=6)
        solve = tsd.stream_cg_dia_rows
        kernel, planes = "stream_dia", 1
    x0 = 0.1 * _rhs(n, nrhs, planes == 2, dev, seed=7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = tsd.dia_layout(n, offs, 1, planes, sms)
    assert lay.cluster
    rule = tsd.cluster_split
    split = rule(nrhs, lambda kk: tsd._grid_of(dev, offs, n, planes, kk,
                                               lay)[1])
    if k is not None:
        split = (k, -(-nrhs // k))
        tsd.cluster_split = lambda nb, active: split
    keys = [p + kernel for p in ("launch.", "cluster.", "cluster_grid.")]
    before = [_counted(key) for key in keys]
    try:
        xk, hk = solve(offs, vals, b, x0, 60)
    finally:
        tsd.cluster_split = rule
    assert [_counted(key) - c for key, c in zip(keys, before)] == [
        1, 1, split[1]]
    for c in range(nrhs):
        x1, h1 = solve(offs, vals, b[..., c:c + 1, :], x0[..., c:c + 1, :],
                       60)
        assert torch.equal(x1[..., 0, :], xk[..., c, :]), c
        assert torch.equal(h1[:, 0], hk[:, c]), c


def test_stream_dia_cooperative_band_keeps_its_chunks(dev):
    """m_t1's band (the cooperative grid, staged) with 16 RHS is still two
    launches of 8, with no cluster counted."""
    D, _ = _window_case("m_t1", dev)
    offs, vals = tsd.prepare_dia_rows(D)
    b = _rhs(D.n, 16, False, dev, seed=6)
    keys = ["launch.stream_dia", "staged.stream_dia", "cluster.stream_dia",
            "cluster_grid.stream_dia"]
    before = [_counted(key) for key in keys]
    xk, hk = tsd.stream_cg_dia_rows(offs, vals, b, torch.zeros_like(b), 10)
    assert [_counted(key) - c for key, c in zip(keys, before)] == [2, 2, 0,
                                                                   0]
    assert torch.isfinite(xk).all() and hk.shape == (11, 16)


def test_stream_dia_layout_is_the_kernels(dev):
    """dia_layout's shared-memory rule against the kernel's own: at the
    widest band whose window the rule stages, the C side accepts the
    staged launch of every instance it was asked for; one row wider, the
    rule reads from L2.  And the tiles are the card's: at most one an SM."""
    lib = tsd._build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 200_000
    with torch.cuda.device(dev):
        for planes, nb in ((1, 1), (1, 8), (2, 1), (2, 8)):
            lo, hi = 1, n        # staged at lo, not at hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                staged = tsd.dia_layout(n, (0, mid, -mid), nb, planes,
                                        sms).staged
                lo, hi = (mid, hi) if staged else (lo, mid)
            pad = lo
            assert not tsd.dia_layout(n, (0, pad + 1, -pad - 1), nb, planes,
                                      sms).staged
            lay = tsd.dia_layout(n, (0, pad, -pad), nb, planes, sms)
            assert lay.tiles <= sms
            grid, active = ctypes.c_int(), ctypes.c_int()
            tsd._build.check(lib.tpcg_stream_dia_grid(
                planes - 1, nb, n, 3, pad, lay.tile_rows, 1, 0,
                ctypes.byref(grid), ctypes.byref(active)),
                "tpcg_stream_dia_grid")
            assert grid.value == lay.tiles and active.value == 0


def test_stream_dia_cluster_rule_is_the_kernels(dev):
    """The cluster rule against the kernel's own limits: at the widest band
    of n = 20,000 that the rule runs as one cluster, the C side accepts
    the cluster launch of 8 RHS (the rule's size) and the card holds such
    a cluster; one row wider the rule takes the cooperative grid; and where
    the Python mirror puts a block's bytes past the block's shared memory,
    the C side refuses the cluster launch."""
    lib = tsd._build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 20_000
    with torch.cuda.device(dev):
        for planes in (1, 2):
            lo, hi = 1, n        # cluster at lo, not at hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lay = tsd.dia_layout(n, (0, mid, -mid), 1, planes, sms)
                lo, hi = (mid, hi) if lay.cluster else (lo, mid)
            lay = tsd.dia_layout(n, (0, lo, -lo), 8, planes, sms)
            assert lay.cluster == lay.tiles <= tsd.MAX_CLUSTER
            grid, active = ctypes.c_int(), ctypes.c_int()
            tsd._build.check(lib.tpcg_stream_dia_grid(
                planes - 1, 8, n, 3, lo, lay.tile_rows, 0, lay.cluster,
                ctypes.byref(grid), ctypes.byref(active)),
                "tpcg_stream_dia_grid")
            assert grid.value == lay.cluster and active.value >= 1
            wider = tsd.dia_layout(n, (0, lo + 1, -lo - 1), 8, planes, sms)
            assert not wider.cluster
            past = lo + 1
            while tsd.cluster_smem(lay.tile_rows, (0, past, -past), 8,
                                   planes) <= _tiles.BLOCK_SHARED:
                past += 1
            assert lib.tpcg_stream_dia_grid(
                planes - 1, 8, n, 3, past, lay.tile_rows, 0, lay.cluster,
                ctypes.byref(grid), ctypes.byref(active)) != 0


@pytest.mark.parametrize("name,nb,cluster", [
    ("helm_fem", 1, None), ("helm_fem", 2, None), ("helm_fem", 1, 8),
    ("small", 3, None), ("ragged", 2, None), ("far", 1, None),
    ("far_cplx", 2, None), ("far", 3, 4)])
def test_stream_dia_cluster_matches_plain(dev, name, nb, cluster):
    """Cluster mode against the plain version over 100 iterations, twice
    bit-equal, with the counter ``cluster.*`` moving on each launch and
    ``staged.*`` on none: helm_fe(128) (1 plane wave, and 2 RHS, the second
    the first times 1 + 0.1j r) as one cluster of 16 blocks (the rule) and
    of 8; a small real band (2 blocks); 10 tiles, the last ragged; a halo
    of 1100 rows past the tiles of 512, real and complex, and as 4 blocks
    of 768."""
    if name == "helm_fem":
        D, cplx = _main_path_case("helm_fem", dev)
        w = plane_wave_rhs(128, 12.0).reshape(-1)
        r = np.random.default_rng(9).standard_normal(w.shape)
        w = np.stack([w, w * (1 + 0.1j * r)][:nb])
        b = torch.from_numpy(np.stack([w.real, w.imag]).astype(
            np.float32)).to(dev)
        x0 = torch.zeros_like(b)
    else:
        if name == "small":
            D, cplx = _dia(_small_band(False), np.float32, dev), False
        else:
            D, cplx = _window_case(name, dev)
        b = _rhs(D.n, nb, cplx, dev, seed=3)
        x0 = 0.1 * _rhs(D.n, nb, cplx, dev, seed=4)
    if cplx:
        offs, vals = tsd.prepare_dia_rows_cplx(D)
        wrap, plain = tsd.stream_cg_dia_rows_cplx, \
            tsd.stream_cg_dia_rows_cplx_plain
    else:
        offs, vals = tsd.prepare_dia_rows(D)
        wrap, plain = tsd.stream_cg_dia_rows, tsd.stream_cg_dia_rows_plain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = tsd.dia_layout(D.n, offs, nb, 2 if cplx else 1, sms,
                         cluster=cluster)
    assert lay.cluster and not lay.staged
    assert cluster is None or lay.cluster == cluster
    kernel = "stream_dia_cplx" if cplx else "stream_dia"
    keys = [k + kernel for k in ("launch.", "cluster.", "staged.")]
    before = [_counted(k) for k in keys]
    with _dia_layout(cluster):
        xk, hk = _run_twice(wrap, offs, vals, b, x0, 100)
    assert [_counted(k) for k in keys] == [before[0] + 2, before[1] + 2,
                                           before[2]]
    xp, hp = plain(offs, vals, b, x0, 100)
    for c in range(nb):
        _assert_dia_close(xk[..., c, :], hk[:, c], xp[..., c, :], hp[:, c])


@pytest.mark.parametrize("cluster,mode", DIA_MODES)
def test_dia_zero_rhs_column_freezes(dev, cluster, mode):
    """A zero RHS column stays x = 0 with a zero history beside a live one
    over 300 iterations, in kernel A's cluster mode (the rule on this band)
    and its cooperative grid, and in kernel B."""
    moved = _counted("cluster.stream_dia") + _counted(
        "cluster.stream_dia_cplx")
    for cplx in (False, True):
        D = _dia(_small_band(cplx), np.complex64 if cplx else np.float32,
                 dev)
        b = _rhs(D.n, 2, cplx, dev)
        b[..., 1, :] = 0
        x0 = torch.zeros_like(b)
        runs = [(tsd.stream_cg_dia_rows_cplx if cplx
                 else tsd.stream_cg_dia_rows,
                 tsd.prepare_dia_rows_cplx(D) if cplx
                 else tsd.prepare_dia_rows(D))]
        if cplx:
            runs.append((tfd.fused_cg_dia_rows_cplx,
                         tsd.prepare_dia_rows_cplx(D)))
        for wrap, (offs, vals) in runs:
            with _dia_layout(cluster):
                xk, hk = wrap(offs, vals, b, x0, 300)
            assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
            assert (xk[..., 1, :] == 0).all() and (hk[:, 1] == 0).all()
    moved = _counted("cluster.stream_dia") + _counted(
        "cluster.stream_dia_cplx") - moved
    assert moved == (2 if mode == "cluster" else 0)


@pytest.mark.parametrize("cluster,mode", DIA_MODES)
def test_dia_kernels_denormal_and_identity_freeze(dev, cluster, mode):
    """tests/test_fused_cg_dia.py's two freeze systems on the card: the
    weakly dominant band run 400 iterations past convergence stays finite
    and, once its history reads 0, stays 0 (both complex kernels); 2 I
    freezes after one iteration with x = b / 2.  Kernel A in cluster mode
    (the rule on both systems) and as a cooperative grid."""
    moved = _counted("cluster.stream_dia_cplx")
    import scipy.sparse as sp
    from tpcg_torch.problems import banded_complex
    n = 1280
    A = banded_complex(n, tuple(range(0, 9)), seed=2)
    A = A - sp.eye(n) * (A.diagonal()[0] - (1.2 + 0.25j) * 2) * 0.5
    D = _dia(A, np.complex64, dev)
    offs, vals = tsd.prepare_dia_rows_cplx(D)
    rng = np.random.default_rng(4)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = torch.from_numpy(np.stack([bc.real, bc.imag])[:, None]
                         .astype(np.float32)).to(dev)
    x0 = torch.zeros_like(b)
    for wrap in (tfd.fused_cg_dia_rows_cplx, tsd.stream_cg_dia_rows_cplx):
        with _dia_layout(cluster):
            xk, hk = wrap(offs, vals, b, x0, 400)
        h = hk[:, 0].cpu().numpy()
        assert np.isfinite(h).all() and torch.isfinite(xk).all()
        z = np.where(h == 0)[0]
        assert len(z) and np.all(h[z[0]:] == 0)
    D = _dia(sp.eye(256, format="csr") * (2.0 + 0.0j), np.complex64, dev)
    offs, vals = tsd.prepare_dia_rows_cplx(D)
    b = torch.zeros((2, 1, 256), device=dev)
    b[0] = 1.0
    for wrap in (tfd.fused_cg_dia_rows_cplx, tsd.stream_cg_dia_rows_cplx):
        with _dia_layout(cluster):
            xk, hk = wrap(offs, vals, b, torch.zeros_like(b), 8)
        h = hk[:, 0].cpu().numpy()
        assert h[1] < 1e-5 * h[0] and np.all(h[1:] == h[1])
        assert torch.allclose(xk, b / 2.0, atol=1e-6)
    moved = _counted("cluster.stream_dia_cplx") - moved
    assert moved == (2 if mode == "cluster" else 0)


def test_api_cg_launches_each_dia_kernel(dev):
    """The entry points on the card: real band -> streaming real kernel,
    the mhd geometry -> fused kernel, a complex band past the fused rule
    -> streaming complex kernel; an unstructured matrix, real or complex,
    and routing= -> the CSR kernel (csrc/route_spmv.cu) alone."""
    import scipy.sparse as sp
    from tpcg_torch.problems import banded_complex
    kernels = ("launch.stream_dia", "launch.fused_dia",
               "launch.stream_dia_cplx")
    cases = [(banded_complex(777, (0, 1, 3, 40)).real.astype(np.float32),
              "launch.stream_dia"),
             (banded_complex(1280, tuple(range(0, 9)), seed=2)
              .astype(np.complex64), "launch.fused_dia"),
             (banded_complex(1280, tuple(range(0, 13)), seed=2)
              .astype(np.complex64), "launch.stream_dia_cplx")]
    for A, expect in cases:
        A = sp.csr_matrix(A)
        n = A.shape[0]
        b = np.ones(2 * n, dtype=A.dtype)
        before = [_counted(k) for k in kernels]
        x = tpcg_torch.cg(n, A.nnz, A.data, b, A.indptr, A.indices,
                          n_rhs=2, n_iterations=60, device=dev)
        moved = [k for k, b0 in zip(kernels, before) if _counted(k) != b0]
        assert moved == [expect] and _counted(expect) == before[
            kernels.index(expect)] + 1
        res = A.astype(np.complex128) @ x[:n] - b[:n]
        assert np.linalg.norm(res) <= 1e-3 * np.linalg.norm(b[:n])
    rng = np.random.default_rng(11)
    R = sp.csr_matrix((rng.standard_normal(400), (np.repeat(np.arange(100), 4),
                       rng.integers(0, 100, 400))), shape=(100, 100))
    R = sp.csr_matrix(R + R.T + 8 * sp.eye(100), dtype=np.float32)
    bR = np.ones(100, np.float32)
    from tpcg_torch.ops.routing import build_routing_spmv
    route = "launch.route_spmv"
    for solve in (lambda: tpcg_torch.cg(100, R.nnz, R.data, bR, R.indptr,
                                        R.indices, n_iterations=60,
                                        device=dev),
                  lambda: tpcg_torch.cg_matrix(R.astype(np.complex64), bR,
                                               n_iterations=60, device=dev),
                  lambda: tpcg_torch.cg_matrix(
                      R, bR, n_iterations=60,
                      routing=build_routing_spmv(R), device=dev)):
        before = [_counted(k) for k in kernels] + [_counted(route)]
        x = solve()
        assert [_counted(k) for k in kernels] == before[:-1]
        assert _counted(route) == before[-1] + 61
        res = R.astype(np.complex128) @ x - bR
        assert np.linalg.norm(res) <= 1e-3 * np.linalg.norm(bR)


def _traced(call):
    """``call()`` under the profiler with the trace's state cleared first;
    returns its result, the records and the counters, after checking that
    each record brackets its host event in the profiler's timeline (the
    clock the benchmark's readers rely on)."""
    trace.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = call()
    recs = trace.records()
    events = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                     ev.name())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith(trace.PREFIX)
                    and ev.device_type() == torch.autograd.DeviceType.CPU)
    assert len(events) == len(recs)
    for r in recs:
        s, e, _ = next(ev for ev in events if ev[2] == r.name
                       and r.start_ns <= ev[0] <= ev[1] <= r.end_ns)
        assert (r.end_ns - r.start_ns) - (e - s) < 1_000_000, r.name
    return out, recs, trace.counters()


def _launched(c):
    return {k: v for k, v in c.items() if k.startswith("launch.")}


def test_api_cg_copies_and_launches_of_one_csr_call(dev):
    """One tpcg_torch.cg call on helm_fe(128) as CSR arrays (the
    helm_fem.csr_calls cell at 20 iterations): the values, b and the
    offsets go up and x and the history come down, to the byte, around one
    launch of the complex streaming kernel; the spans of the call nest as
    its layers run, a wait for the card before each blocking copy."""
    A = helm_fe(128, 12.0, eps=12.0, device="cpu").to_scipy().tocsr()
    A = A.astype(np.complex64)
    A.sort_indices()
    n, iters = A.shape[0], 20
    coo = A.tocoo()
    ndiag = len(np.unique(coo.col - coo.row))
    b = plane_wave_rhs(128, 12.0).reshape(-1).astype(np.complex64)
    (x, h), recs, c = _traced(lambda: tpcg_torch.cg(
        n, A.nnz, A.data, b, A.indptr, A.indices, n_iterations=iters,
        record_history=True, device=dev))
    assert c["h2d_bytes"] == ndiag * n * 8 + n * 8 + ndiag * 4
    assert c["d2h_bytes"] == n * 8 + (iters + 1) * 4
    assert _launched(c) == {"launch.stream_dia_cplx": 1}
    # helm_fem's band runs as one cluster, which stages nothing
    assert c["cluster.stream_dia_cplx"] == 1
    assert "staged.stream_dia_cplx" not in c
    assert [r.name for r in recs] == [
        "tpcg.cg", "tpcg.convert", "tpcg.convert.dia", "tpcg.wait",
        "tpcg.upload", "tpcg.pack", "tpcg.prepare", "tpcg.wait",
        "tpcg.upload", "tpcg.launch.stream_dia_cplx", "tpcg.wait",
        "tpcg.upload", "tpcg.wait", "tpcg.download", "tpcg.download",
        "tpcg.pack"]
    assert recs[0].counts == c
    assert {r.call for r in recs} == {recs[0].id}
    assert np.isfinite(x).all() and h.shape == (iters + 1, 1)


def test_api_cg_matrix_copies_and_launches_of_one_block_call(dev):
    """One cg_matrix call on a DiaMatrix kept on the card with 16 RHS
    (the m_t1.block16 cell at n = 4000 and 200 iterations): b up, the
    offsets up for each of the two launches of 8 RHS, x and the history
    down, to the byte."""
    from tpcg_torch.problems import banded_spd
    D = _dia(banded_spd(4000, 50), np.float32, dev)
    n, nrhs, iters, ndiag = D.n, 16, 200, len(D.offsets)
    b = np.random.default_rng(5).standard_normal(n * nrhs).astype(np.float32)
    (x, h), recs, c = _traced(lambda: tpcg_torch.cg_matrix(
        D, b, n_rhs=nrhs, n_iterations=iters, record_history=True))
    assert c["h2d_bytes"] == nrhs * n * 4 + 2 * ndiag * 4
    assert c["d2h_bytes"] == nrhs * n * 4 + (iters + 1) * nrhs * 4
    assert _launched(c) == {"launch.stream_dia": 2}
    assert c["staged.stream_dia"] == 2
    # the m_t1 shape keeps the cooperative grid
    assert not [k for k in c if k.startswith("cluster.")]
    launch = ["tpcg.launch.stream_dia", "tpcg.wait", "tpcg.upload"]
    assert [r.name for r in recs] == [
        "tpcg.cg_matrix", "tpcg.pack", "tpcg.prepare", "tpcg.wait",
        "tpcg.upload", *launch, *launch, "tpcg.wait", "tpcg.download",
        "tpcg.download", "tpcg.pack"]
    # the second launch's offsets wait for the first launch and the
    # downloads for the second, each in a span of its own: a copy's span
    # holds the copy alone
    waits = [r.end_ns - r.start_ns for r in recs if r.name == "tpcg.wait"]
    assert max(waits[:2]) < min(waits[2:])
    assert recs[0].counts == c
    assert x.shape == (n * nrhs,) and h.shape == (iters + 1, nrhs)


# ---- streaming constant-tap kernel (csrc/stream_cg.cu) ----
# x within 2e-3 max|x| and the history on its live entries within rel 1e-2
# (the DIA checks' tolerances): the kernel applies A bit for bit as the plain
# version does and differs only in the order of its float32 dot products;
# over at most 100 iterations with a smooth RHS that stays far inside these
# limits.

tsc = importlib.import_module("tpcg_torch.ops.stream_cg")


def _stream_case(dev, nv, nh, x0_seed=None, k=12.0):
    """local_rect(max(nv, nh), k) cut to nv x nh (helm_fe when square), the
    plane wave of the square grid cut to size, and a seeded 0.1 N(0, 1)
    initial guess (or zero)."""
    from tpcg_torch.problems import local_rect
    N = max(nv, nh)
    S = local_rect(N, k, k, eta=k, Nvert=nv, Nhoriz=nh, device=dev)
    taps, strips = tsc.prepare_stream(S)
    b = plane_wave_rhs(N, k)[:nv, :nh]
    x0 = np.zeros_like(b)
    if x0_seed is not None:
        rng = np.random.default_rng(x0_seed)
        x0 = 0.1 * (rng.standard_normal(b.shape)
                    + 1j * rng.standard_normal(b.shape))

    def planes(z):
        return torch.from_numpy(
            np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    return S, taps, strips, planes(b), planes(x0)


# the smoke's geometries: square, non-square, an odd height, a width that is
# not a multiple of 128, an odd width (513 x 1027) and a grid whose blocks
# take uneven numbers of tiles (700 x 901) (40 iterations, seeded x0), and
# helm_fe at the first two main-path sizes (100 iterations, plane wave)
@pytest.mark.parametrize("nv,nh,seed,iters", [
    (256, 256, 1, 40), (300, 700, 2, 40), (1031, 1024, 3, 40),
    (600, 1000, 4, 40), (1024, 1024, None, 100), (2048, 2048, None, 100),
    (513, 1027, 5, 40), (700, 901, 6, 40)])
def test_stream_kernel_matches_plain(dev, nv, nh, seed, iters):
    S, taps, strips, bp, x0p = _stream_case(dev, nv, nh, seed)
    before = _counted("launch.stream_const")
    xk, hk = _run_twice(tsc.stream_cg_const_planes, S.offsets, S.grid, taps,
                        strips, bp, x0p, iters)
    assert _counted("launch.stream_const") == before + 2
    xp, hp = tsc.stream_cg_const_planes_plain(S.offsets, S.grid, taps, strips,
                                              bp, x0p, iters)
    _assert_dia_close(xk, hk, xp, hp)


def test_stream_kernel_applies_the_operator(dev):
    """Zero iterations give r0 = b - A x0 only: x = x0 and hist[0] from the
    plain operator's residual, on a grid with all four corners in play."""
    S, taps, strips, bp, x0p = _stream_case(dev, 37, 45, x0_seed=5)
    x, h = tsc.stream_cg_const_planes(S.offsets, S.grid, taps, strips, bp,
                                      x0p, 0)
    assert torch.equal(x, x0p)
    r = bp - tsc.apply_const_planes(S.offsets, taps, strips, x0p)
    dl = torch.stack([torch.sum(r[0] * r[0] - r[1] * r[1]),
                      2.0 * torch.sum(r[0] * r[1])])
    h0 = torch.sqrt(torch.sqrt(dl[0] ** 2 + dl[1] ** 2))
    assert torch.allclose(h[0], h0, rtol=1e-5)


def _stream_plan_launches(S, nb):
    """Launches of a ``stream`` plan for nb RHS: one per chunk of the
    planner's rule (``auto._stream_chunk``; None is the kernel's limit)."""
    from tpcg_torch.ops import auto
    chunk = auto._stream_chunk(*S.grid) or tsc.kernel_limits()[2]
    return -(-nb // chunk)


def test_stream_plan_batch_columns_equal_single_launches(dev):
    """B=3 through the plan: one launch per chunk of the planner's rule,
    each column bit-equal to its single-RHS launch, and the counter moves
    through plan.solve too."""
    S, taps, strips, bp, _ = _stream_case(dev, 520, 520)
    rng = np.random.default_rng(6)
    cols = [bp] + [bp + 0.1 * torch.from_numpy(
        rng.standard_normal(bp.shape).astype(np.float32)).to(dev)
        for _ in range(2)]
    B = torch.stack(cols, dim=1)
    plan = tpcg_torch.plan_stencil_cg(S, 30, nb=3)
    assert plan.path == "stream"
    before = _counted("launch.stream_const")
    xb, hb = plan.solve_planes(B)
    assert _counted("launch.stream_const") == \
        before + _stream_plan_launches(S, 3)
    for c in range(3):
        x1, h1 = plan.solve_planes(cols[c])
        assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)
    b = plane_wave_rhs(520, 12.0)
    before = _counted("launch.stream_const")
    x, hist = plan.solve(b)
    assert _counted("launch.stream_const") == before + 1
    assert np.isfinite(x).all() and hist.shape == (31,)
    np.testing.assert_array_equal(hist, hb[:, 0].cpu().numpy())


def test_stream_kernel_freezes(dev):
    """2 I on the helm_fe offsets converges in one iteration; over 400
    iterations the kernel reads 0 from iteration 1, as the plain version
    does, stays finite, and gives x = b / 2."""
    from tpcg_torch.sparse import Stencil2D
    N = 64
    A = helm_fe(N, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    S = Stencil2D(A.offsets, coef, A.grid)
    taps, strips = tsc.prepare_stream(S)
    bp = torch.zeros((2, N, N), device=dev)
    bp[0] = 1.0
    x0p = torch.zeros_like(bp)
    xk, hk = tsc.stream_cg_const_planes(S.offsets, S.grid, taps, strips, bp,
                                        x0p, 400)
    xp, hp = tsc.stream_cg_const_planes_plain(S.offsets, S.grid, taps,
                                              strips, bp, x0p, 400)
    assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
    assert hk[0] == hp[0] and torch.all(hk[1:] == 0) and torch.all(hp[1:] == 0)
    assert torch.equal(xk, xp) and torch.all(xk[0] == 0.5)


# ---- several RHS in one launch of csrc/stream_cg.cu (NB = 1..8) ----

def _stream_batch(dev, nv, nh, nb, seed):
    """nb RHS as (2, nb, nv, nh) planes: the (b, x0) pair of
    :func:`_stream_case` (seeded x0) times 1 + 0.1j r, r = 0..nb-1, so that
    every RHS is as well conditioned as the single-RHS checks' pair
    (independent random x0 draws put some RHS near a float32 breakdown,
    where two sum orders part past these tolerances: PERF.md, PR 9)."""
    S, taps, strips, bp, x0p = _stream_case(dev, nv, nh, x0_seed=seed)
    s_r = torch.tensor([1.0 + 0.1j * r for r in range(nb)],
                       dtype=torch.complex64, device=dev)[:, None, None]

    def scaled(p):
        z = torch.complex(p[0], p[1])[None] * s_r
        return torch.stack([z.real, z.imag]).contiguous()
    return S, taps, strips, scaled(bp), scaled(x0p)


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nv,nh,seed", [(256, 256, 1), (300, 700, 2),
                                        (1031, 1024, 3), (600, 1000, 4),
                                        (513, 1027, 5)])
def test_stream_batched_kernel_matches_plain(dev, nv, nh, seed, nb):
    """One launch of NB RHS against the plain version, 40 iterations,
    seeded x0: square, non-square, odd height, a width that is not a
    multiple of 128 and an odd width; two launches bit-equal."""
    S, taps, strips, bp, x0p = _stream_batch(dev, nv, nh, nb, seed)
    args = (S.offsets, S.grid, taps, strips, bp, x0p, 40)
    before = _counted("launch.stream_const")
    xk, hk = _run_twice(tsc.stream_cg_const_planes_batched, *args)
    assert _counted("launch.stream_const") == before + 2
    xp, hp = tsc.stream_cg_const_planes_batched_plain(*args)
    for c in range(nb):
        _assert_dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])


@pytest.mark.parametrize("nb", [2, 4, 8])
def test_stream_batched_rhs_equal_their_single_launches(dev, nb):
    """Each RHS of an NB launch gives the bits of its own NB = 1 launch: the
    grid and each RHS's partial sums do not depend on NB."""
    S, taps, strips, bp, x0p = _stream_batch(dev, 1031, 1024, nb, 3)
    xb, hb = tsc.stream_cg_const_planes_batched(S.offsets, S.grid, taps,
                                                strips, bp, x0p, 40)
    for c in range(nb):
        x1, h1 = tsc.stream_cg_const_planes(S.offsets, S.grid, taps, strips,
                                            bp[:, c].contiguous(),
                                            x0p[:, c].contiguous(), 40)
        assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)
    assert len({tsc.grid_blocks(1031, 1024, 1, k) for k in range(1, 9)}) == 1


@pytest.mark.parametrize("nb", [3, 8])
@pytest.mark.parametrize("nv,nh", [(513, 1027), (700, 901)])
def test_stream_odd_width_uneven_tiles_equal_single_launches(dev, nv, nh, nb):
    """At an odd width whose rows the kernel pads to a multiple of 32 floats,
    on a grid whose blocks take uneven numbers of tiles (so the mbarrier
    ring's parity runs on unevenly across blocks), each RHS of an NB launch
    gives its NB = 1 launch's bits, and a repeat gives the same bits."""
    S, taps, strips, bp, x0p = _stream_batch(dev, nv, nh, nb, 7)
    lay = tsc.stream_layout(nv, nh, 1)
    blocks = tsc.grid_blocks(nv, nh, 1, nb)
    assert nh % 4 and lay.pitch % 32 == 0
    assert lay.tiles > blocks and lay.tiles % blocks
    xb, hb = _run_twice(tsc.stream_cg_const_planes_batched, S.offsets,
                        S.grid, taps, strips, bp, x0p, 30)
    for c in range(nb):
        x1, h1 = tsc.stream_cg_const_planes(S.offsets, S.grid, taps, strips,
                                            bp[:, c].contiguous(),
                                            x0p[:, c].contiguous(), 30)
        assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("nb", [1, 3, 10])
def test_stream_plan_launches_by_batch(dev, monkeypatch, nb, batched):
    """A ``stream`` plan at B = 1, 3 and 10, with the planner's rule as it
    is (one launch a RHS at 520 x 520) and with its boundary lowered so
    that the RHS share launches: the launches the rule names (B = 10 in two
    chunks of at most 8), every column its single-RHS launch's bits."""
    from tpcg_torch.ops import auto
    if batched:
        monkeypatch.setattr(auto, "_STREAM_BATCH_MIN_NODES", 1)
    S, taps, strips, bp, x0p = _stream_batch(dev, 520, 520, nb, 5)
    assert _stream_plan_launches(S, nb) == (-(-nb // 8) if batched else nb)
    plan = tpcg_torch.plan_stencil_cg(S, 20, nb=nb)
    assert plan.path == "stream"
    before = _counted("launch.stream_const")
    xb, hb = plan.solve_planes(bp, x0p)
    assert _counted("launch.stream_const") == \
        before + _stream_plan_launches(S, nb)
    for c in (0, nb - 1):
        x1, h1 = tsc.stream_cg_const_planes(S.offsets, S.grid, taps, strips,
                                            bp[:, c].contiguous(),
                                            x0p[:, c].contiguous(), 20)
        assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)


def test_stream_batched_limits(dev):
    """Past the kernel's limits a launch raises ValueError: a chunk of 9
    RHS, 17 taps, a tap 9 nodes out."""
    S, taps, strips, bp, x0p = _stream_batch(dev, 64, 64, 9, 1)
    max_taps, max_pad, max_rhs = tsc.kernel_limits()
    assert (max_taps, max_pad, max_rhs) == (16, 8, 8)
    with pytest.raises(ValueError, match="RHS a launch"):
        tsc.stream_cg_const_planes_batched(S.offsets, S.grid, taps, strips,
                                           bp, x0p, 3, chunk=9)
    x, h = tsc.stream_cg_const_planes_batched(S.offsets, S.grid, taps,
                                              strips, bp, x0p, 3)
    assert x.shape == bp.shape and h.shape == (4, 9)
    offs = [(0, j) for j in range(-8, 9)]          # 17 taps
    many = tuple(t + (0.0,) * (17 - len(t)) for t in taps)
    with pytest.raises(ValueError, match="taps"):
        tsc.stream_cg_const_planes_batched(
            offs, S.grid, many, torch.zeros((2, 2, 17, 64), device=dev), bp,
            x0p, 3)
    far = list(S.offsets[:-1]) + [(0, 9)]
    with pytest.raises(ValueError, match="taps"):
        tsc.stream_cg_const_planes_batched(far, S.grid, taps, strips, bp,
                                           x0p, 3)


def test_stream_batched_kernel_freezes(dev):
    """2 I at NB = 3 over 400 iterations: every RHS reads 0 from iteration
    1, stays finite and equals its plain version."""
    from tpcg_torch.sparse import Stencil2D
    N = 64
    A = helm_fe(N, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    S = Stencil2D(A.offsets, coef, A.grid)
    taps, strips = tsc.prepare_stream(S)
    bp = torch.zeros((2, 3, N, N), device=dev)
    bp[0] = torch.arange(1, 4, device=dev, dtype=torch.float32)[:, None, None]
    args = (S.offsets, S.grid, taps, strips, bp, torch.zeros_like(bp), 400)
    xk, hk = tsc.stream_cg_const_planes_batched(*args)
    xp, hp = tsc.stream_cg_const_planes_batched_plain(*args)
    assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
    assert torch.all(hk[1:] == 0) and torch.all(hp[1:] == 0)
    assert torch.equal(xk, xp) and torch.equal(xk[0], bp[0] / 2)


@pytest.mark.parametrize("cluster,mode", DIA_MODES)
def test_stream_dia_latch_resumes_as_jax(dev, cluster, mode):
    """Kernel A on the exact latch system of tests/test_torch_dia_cg.py
    (JAX's 256-iteration latch): frozen at iteration 2, restarted at 256,
    r = 0 exactly at 260; x = (0, 1, -2, 4) and the history of the plain
    version, real and complex, in cluster mode (one block, the rule) and as
    a cooperative grid."""
    import scipy.sparse as sp
    A = sp.diags([[1.0, -1.0, 1.0], [-1.0, -1.0, 1.0, 1.0],
                  [1.0, -1.0, 1.0]], [-1, 0, 1], format="csr")
    for dtype, solve, kernel in (
            (np.float32, tsd.stream_cg_dia, "cluster.stream_dia"),
            (np.complex64, tsd.stream_cg_dia_cplx,
             "cluster.stream_dia_cplx")):
        b = np.array([1.0, 1.0, 1.0, 2.0], dtype)
        before = _counted(kernel)
        with _dia_layout(cluster):
            xk, hk = solve(_dia(A, dtype, dev), b, n_iterations=600)
        assert _counted(kernel) == before + (mode == "cluster")
        xp, hp = solve(_dia(A, dtype, "cpu"), b, n_iterations=600)
        assert torch.equal(xk.cpu(), xp) and torch.equal(hk.cpu(), hp)
        np.testing.assert_array_equal(xp.numpy(), [0.0, 1.0, -2.0, 4.0])
        assert hp[257] != hp[0] and torch.all(hp[260:] == 0)


# ---- streaming symmetric variable-coefficient kernel (csrc/stream_cg_sym.cu)
# The tolerances of the constant-tap kernel's checks above: the kernel
# applies the half-plane operator bit for bit as the plain version does and
# differs only in the order of its float32 dot products.

tss = importlib.import_module("tpcg_torch.ops.stream_cg_sym")


def _sym_case(dev, nv, nh, x0_seed=None, omega=40.0):
    """helm_fe_var(max(nv, nh), omega, C, rho=0.1) on an nv x nh grid (C =
    1 + 0.5 U(0, 1) from seed 0, the benchmark configuration's draw), its
    half planes, the square grid's plane wave cut to size, and a seeded
    0.1 N(0, 1) initial guess (or zero)."""
    from tpcg_torch.problems import helm_fe_var
    N = max(nv, nh)
    C = 1.0 + 0.5 * np.random.default_rng(0).random((nv - 1, nh - 1))
    S = helm_fe_var(N, omega, C, rho=0.1, Nhoriz=nh, Nvert=nv, device=dev)
    half, cplanes = tss.prepare_stream_sym(S)
    b = plane_wave_rhs(N, omega)[:nv, :nh]
    x0 = np.zeros_like(b)
    if x0_seed is not None:
        rng = np.random.default_rng(x0_seed)
        x0 = 0.1 * (rng.standard_normal(b.shape)
                    + 1j * rng.standard_normal(b.shape))

    def planes(z):
        return torch.from_numpy(
            np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    return S, half, cplanes, planes(b), planes(x0)


# the smoke's geometries (40 iterations, seeded x0), and the first main-path
# size and the unstreamable height 2049 (100 iterations, plane wave)
@pytest.mark.parametrize("nv,nh,seed,iters", [
    (256, 256, 1, 40), (300, 700, 2, 40), (1031, 1024, 3, 40),
    (600, 1000, 4, 40), (1024, 1024, None, 100), (2049, 2049, None, 100)])
def test_sym_kernel_matches_plain(dev, nv, nh, seed, iters):
    S, half, cplanes, bp, x0p = _sym_case(dev, nv, nh, seed)
    before = _counted("launch.stream_sym")
    xk, hk = _run_twice(tss.stream_cg_sym_planes, half, cplanes, bp, x0p,
                        iters)
    assert _counted("launch.stream_sym") == before + 2
    xp, hp = tss.stream_cg_sym_planes_plain(half, cplanes, bp, x0p, iters)
    _assert_dia_close(xk, hk, xp, hp)


def test_sym_kernel_applies_the_operator(dev):
    """Zero iterations give r0 = b - A x0 only: x = x0 and hist[0] from the
    plain operator's residual, on a grid with every edge in play."""
    S, half, cplanes, bp, x0p = _sym_case(dev, 37, 45, x0_seed=5)
    x, h = tss.stream_cg_sym_planes(half, cplanes, bp, x0p, 0)
    assert torch.equal(x, x0p)
    r = bp - tss.apply_sym_planes(half, cplanes, x0p)
    dl = torch.stack([torch.sum(r[0] * r[0] - r[1] * r[1]),
                      2.0 * torch.sum(r[0] * r[1])])
    h0 = torch.sqrt(torch.sqrt(dl[0] ** 2 + dl[1] ** 2))
    assert torch.allclose(h[0], h0, rtol=1e-5)


def test_sym_plan_batch_columns_equal_single_launches(dev):
    """B=3 through a stream-coef plan: three launches, each column bit-equal
    to its single-RHS launch."""
    S, half, cplanes, bp, _ = _sym_case(dev, 520, 520)
    rng = np.random.default_rng(6)
    cols = [bp] + [bp + 0.1 * torch.from_numpy(
        rng.standard_normal(bp.shape).astype(np.float32)).to(dev)
        for _ in range(2)]
    plan = tpcg_torch.plan_stencil_cg(S, 30, nb=3)
    assert plan.path == "stream-coef"
    before = _counted("launch.stream_sym")
    xb, hb = plan.solve_planes(torch.stack(cols, dim=1))
    assert _counted("launch.stream_sym") == before + 3
    for c in range(3):
        x1, h1 = tss.stream_cg_sym_planes(half, cplanes, cols[c],
                                          torch.zeros_like(bp), 30)
        assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)


def test_sym_kernel_freezes(dev):
    """2 I on the helm_fe offsets: over 400 iterations the kernel reads 0
    from iteration 1, as the plain version does, stays finite, and gives
    x = b / 2."""
    from tpcg_torch.sparse import Stencil2D
    N = 64
    A = helm_fe(N, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    half, cplanes = tss.prepare_stream_sym(Stencil2D(A.offsets, coef, A.grid))
    bp = torch.zeros((2, N, N), device=dev)
    bp[0] = 1.0
    x0p = torch.zeros_like(bp)
    xk, hk = tss.stream_cg_sym_planes(half, cplanes, bp, x0p, 400)
    xp, hp = tss.stream_cg_sym_planes_plain(half, cplanes, bp, x0p, 400)
    assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
    assert hk[0] == hp[0] and torch.all(hk[1:] == 0) and torch.all(hp[1:] == 0)
    assert torch.equal(xk, xp) and torch.all(xk[0] == 0.5)


def test_planner_on_card_takes_the_sym_path(dev):
    """Symmetric variable coefficients past the whole-solve size take
    stream-coef through the symmetric kernel, at the height 2049 too (JAX
    row-pads it); a non-symmetric stencil takes stream-coef through the
    general kernel (``csrc/stream_cg_coef.cu``), not the symmetric one."""
    from tpcg_torch.sparse import Stencil2D
    S = _sym_case(dev, 2049, 600)[0]
    plan = tpcg_torch.plan_stencil_cg(S, 5)
    assert plan.path == "stream-coef"
    b = plane_wave_rhs(2049, 40.0)[:, :600]
    sym0, gen0 = _counted("launch.stream_sym"), _coef_launches()
    plan.solve(b)
    assert (_counted("launch.stream_sym"), _coef_launches()) == (
        sym0 + 1, gen0)
    coef = S.coef.clone()
    coef[1] *= 1.5
    plan = tpcg_torch.plan_stencil_cg(Stencil2D(S.offsets, coef, S.grid), 5)
    assert plan.path == "stream-coef"
    x, _ = plan.solve(b)
    torch.cuda.synchronize()
    assert np.isfinite(x).all()
    assert (_counted("launch.stream_sym"), _coef_launches()) == (
        sym0 + 1, gen0 + 1)


# odd widths whose rows the kernel pads (513 x 1027: pitch 1056) and grids
# whose blocks take uneven numbers of tiles (700 x 901; 513 x 1027 too)
@pytest.mark.parametrize("nv,nh,seed", [(513, 1027, 7), (700, 901, 8)])
def test_sym_kernel_odd_width_and_uneven_tiles(dev, nv, nh, seed):
    S, half, cplanes, bp, x0p = _sym_case(dev, nv, nh, seed)
    xk, hk = _run_twice(tss.stream_cg_sym_planes, half, cplanes, bp, x0p, 40)
    xp, hp = tss.stream_cg_sym_planes_plain(half, cplanes, bp, x0p, 40)
    _assert_dia_close(xk, hk, xp, hp)


def _sym_limit_stencil(dev, nv, nh, seed):
    """A symmetric stencil at the kernel's limits: 31 offsets within 8
    nodes, (8, -8) among them, so 16 half planes; diagonally dominant
    (centre 4 + 0.5j + 0.1 U, the half planes -0.1 (1 + 0.3 U) + 0.02j),
    each mirrored plane plane_{-s}(n) = plane_s(n - s)."""
    from tpcg_torch.sparse import Stencil2D
    rng = np.random.default_rng(seed)
    pos = [(dm, dj) for dm in range(0, 9) for dj in range(-8, 9)
           if (dm, dj) > (0, 0) and (dm, dj) != (8, -8)]
    pick = rng.choice(len(pos), size=14, replace=False)
    half = [(0, 0), (8, -8)] + [pos[i] for i in pick]
    c = -0.1 * (1.0 + 0.3 * rng.random((16, nv, nh))) + 0.02j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((nv, nh))
    c = torch.from_numpy(c)
    mirrors = [tss._shift(c[t], dm, dj) for t, (dm, dj) in
               enumerate(half) if t > 0]
    offsets = tuple(half) + tuple((-dm, -dj) for dm, dj in half[1:])
    return Stencil2D(offsets, torch.cat([c, torch.stack(mirrors)]).to(dev),
                     (nv, nh))


def test_sym_kernel_takes_pad8_with_16_half_planes(dev):
    """The kernel's limits at once, pad 8 and 16 half planes (31 offsets),
    on an odd grid with x0 != 0: the layout narrows its tile to fit a block,
    the kernel follows the plain version over 16 iterations (the history
    falls by 1e5 by then) and two launches agree bit for bit."""
    nv, nh = 157, 203
    S = _sym_limit_stencil(dev, nv, nh, 3)
    half, cplanes = tss.prepare_stream_sym(S)
    assert len(S.offsets) == 31 and len(half) == 16
    lay = tss.sym_layout(nv, nh, 8, 16)
    assert lay.blocks_per_sm >= 1 and lay.tile_cols in (64, 128)
    rng = np.random.default_rng(41)
    bp = torch.from_numpy(
        rng.standard_normal((2, nv, nh)).astype(np.float32)).to(dev)
    x0p = 0.1 * torch.flip(bp, dims=(2,))
    xk, hk = _run_twice(tss.stream_cg_sym_planes, half, cplanes, bp, x0p, 16)
    xp, hp = tss.stream_cg_sym_planes_plain(half, cplanes, bp, x0p, 16)
    _assert_dia_close(xk, hk, xp, hp)


def test_sym_kernel_does_not_spill(dev):
    """The kernel builds without spills (-Xptxas -v)."""
    from tpcg_torch.ops import _build
    _build.load()
    name, seen = "", []
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line and "stream_cg_sym_kernel" in name:
            seen.append(line.strip())
    assert len(seen) == 1
    assert "0 bytes spill stores" in seen[0] and \
        "0 bytes spill loads" in seen[0], seen[0]


def test_sym_plan_copies_half_planes_once(dev):
    """A B=3 stream-coef plan copies the half planes to the kernel's pitch
    once, when it is made, keeps that copy alone on the card, and solves
    with three launches that read it; each column is bit-equal to its own
    launch."""
    S, half, cplanes, bp, _ = _sym_case(dev, 513, 1027)
    rng = np.random.default_rng(9)
    cols = [bp] + [bp + 0.1 * torch.from_numpy(
        rng.standard_normal(bp.shape).astype(np.float32)).to(dev)
        for _ in range(2)]
    copies = _counted("copy.pad_sym_planes")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    plan = tpcg_torch.plan_stencil_cg(S, 30, nb=3)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - held
    assert plan.path == "stream-coef"
    assert _counted("copy.pad_sym_planes") == copies + 1
    # the padded copy, and not also the unpadded half planes
    pitch = tss.sym_layout(513, 1027, 1, len(half)).pitch
    assert 4 * cplanes.numel() * pitch // 1027 <= held \
        < 4 * cplanes.numel() * (1 + pitch / 1027)
    before = _counted("launch.stream_sym")
    xb, hb = plan.solve_planes(torch.stack(cols, dim=1))
    assert _counted("launch.stream_sym") == before + 3
    assert _counted("copy.pad_sym_planes") == copies + 1
    plan.solve_planes(torch.stack(cols, dim=1))
    assert _counted("copy.pad_sym_planes") == copies + 1
    for c in range(3):
        x1, h1 = tss.stream_cg_sym_planes(half, cplanes, cols[c],
                                          torch.zeros_like(bp), 30)
        assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)


# ---- streaming general-coefficient kernel (csrc/stream_cg_coef.cu), 1..8 RHS
# The tolerances of the streaming kernels' checks above: the kernel applies
# the operator bit for bit as the plain version does and, as the sym kernel,
# sums its dot products in float64 in another order.

tgc = importlib.import_module("tpcg_torch.ops.stream_cg_coef")


def _coef_launches():
    return _counted("launch.stream_coef")


def _coef_case(dev, nv, nh, nb=1, x0_seed=None):
    """helm_fe_var(max(nv, nh), 8, C, rho=0.5) on an nv x nh grid (C = 1 +
    0.5 U(0, 1) from seed 0), made non-symmetric by scaling plane 1 by 1.5;
    its planes; nb RHS, the plane wave times (1 + 0.1j r) cut to size
    (2, nb, nv, nh); a seeded 0.1 N(0, 1) initial guess (or zero)."""
    from tpcg_torch.problems import helm_fe_var
    from tpcg_torch.sparse import Stencil2D
    N = max(nv, nh)
    C = 1.0 + 0.5 * np.random.default_rng(0).random((nv - 1, nh - 1))
    A = helm_fe_var(N, 8.0, C, rho=0.5, Nhoriz=nh, Nvert=nv, device=dev)
    coef = A.coef.clone()
    coef[1] *= 1.5
    S = Stencil2D(A.offsets, coef, A.grid)
    bg = plane_wave_rhs(N, 8.0)[:nv, :nh]
    B = np.stack([bg * (1 + 0.1j * r) for r in range(nb)])
    X0 = np.zeros_like(B)
    if x0_seed is not None:
        rng = np.random.default_rng(x0_seed)
        X0 = 0.1 * (rng.standard_normal(B.shape)
                    + 1j * rng.standard_normal(B.shape))

    def planes(z):
        return torch.from_numpy(
            np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    return S, tgc.prepare_stream_coef(S), planes(B), planes(X0)


# odd heights and widths, a width past one tile, and x0 != 0
@pytest.mark.parametrize("nv,nh,seed", [(256, 256, 1), (301, 517, 2),
                                        (1031, 1024, 3), (37, 45, None)])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 8])
def test_coef_kernel_matches_plain(dev, nv, nh, seed, nb):
    """Each NB instance against the plain version, 40 iterations: two
    launches bit-equal, each RHS within the tolerances above."""
    S, coefp, bp, x0p = _coef_case(dev, nv, nh, nb, seed)
    before = _coef_launches()
    xk, hk = _run_twice(tgc.stream_cg_coef_planes_batched_fat, S.offsets,
                        coefp, bp, x0p, 40)
    assert _coef_launches() == before + 2
    xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(S.offsets, coefp, bp,
                                                         x0p, 40)
    for c in range(nb):
        _assert_dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])


def test_coef_kernel_takes_a_pad2_stencil(dev):
    """A non-symmetric 13-point stencil two nodes out (pad 2), odd grid, x0
    != 0, NB = 1 and 4, against the plain version over 30 iterations."""
    from tpcg_torch.sparse import Stencil2D
    nv, nh = 203, 311
    offsets = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2),
               (2, 0), (-2, 0), (1, 1), (-1, -1), (2, 1), (-1, 2))
    rng = np.random.default_rng(12)
    c = -0.2 * (1.0 + 0.3 * rng.random((len(offsets), nv, nh))) + 0.05j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((nv, nh))
    S = Stencil2D(offsets, torch.from_numpy(c).to(dev), (nv, nh))
    coefp = tgc.prepare_stream_coef(S)
    for nb in (1, 4):
        z = rng.standard_normal((2, nb, nv, nh)).astype(np.float32)
        bp = torch.from_numpy(z).to(dev)
        x0p = 0.1 * torch.flip(bp, dims=(2,))
        xk, hk = tgc.stream_cg_coef_planes_batched_fat(offsets, coefp, bp,
                                                       x0p, 30)
        xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(offsets, coefp,
                                                             bp, x0p, 30)
        for r in range(nb):
            _assert_dia_close(xk[:, r], hk[:, r], xp[:, r], hp[:, r])


def test_coef_kernel_applies_the_operator(dev):
    """Zero iterations give r0 = b - A x0 only: x = x0 and hist[0] from the
    plain operator's residual, with coefficients pointing outside the grid
    on every edge (they read 0)."""
    S, coefp, bp, x0p = _coef_case(dev, 37, 45, 2, x0_seed=5)
    coefp = coefp + 0.25          # every plane nonzero, the edges included
    x, h = tgc.stream_cg_coef_planes_batched_fat(S.offsets, coefp, bp, x0p, 0)
    assert torch.equal(x, x0p)
    for c in range(2):
        r = bp[:, c] - tgc.apply_coef_planes(S.offsets, coefp, x0p[:, c])
        dl = torch.stack([torch.sum(r[0].double() ** 2 - r[1].double() ** 2),
                          2.0 * torch.sum(r[0].double() * r[1].double())])
        h0 = torch.sqrt(torch.sqrt(dl[0] ** 2 + dl[1] ** 2)).float()
        assert torch.allclose(h[0, c], h0, rtol=1e-5)


def test_coef_nb_instance_against_single_rhs_launches(dev):
    """Each RHS of an NB launch against its own NB = 1 launch, 40
    iterations: bit-equal (the tile, the rings and the grid are the one-RHS
    launch's whatever NB, so each RHS's float64 partial sums are cut the
    same way)."""
    for nv, nh, nb in ((300, 700, 2), (300, 700, 8), (1024, 1024, 4)):
        S, coefp, bp, x0p = _coef_case(dev, nv, nh, nb, x0_seed=7)
        xb, hb = tgc.stream_cg_coef_planes_batched_fat(S.offsets, coefp, bp,
                                                       x0p, 40)
        assert len({tgc.grid_blocks(nv, nh, 1, k, len(S.offsets))
                    for k in range(1, 9)}) == 1
        for c in range(nb):
            x1, h1 = tgc.stream_cg_coef_planes(S.offsets, coefp, bp[:, c],
                                               x0p[:, c], 40)
            assert torch.equal(xb[:, c], x1) and torch.equal(hb[:, c], h1)


@pytest.mark.parametrize("nb", [1, 2, 8])
@pytest.mark.parametrize("nv,nh", [(513, 1027), (700, 901)])
def test_coef_odd_width_uneven_tiles(dev, nv, nh, nb):
    """At an odd width whose rows the kernel pads to a multiple of 32 floats,
    on a grid whose blocks take uneven numbers of tiles (so the rings'
    mbarrier parities run on unevenly across blocks): each RHS against the
    plain version over 40 iterations, two launches bit-equal, and each RHS
    of an NB launch bit-equal to its NB = 1 launch."""
    S, coefp, bp, x0p = _coef_case(dev, nv, nh, nb, x0_seed=11)
    noff = len(S.offsets)
    lay = tgc.coef_layout(nv, nh, 1, nb, noff)
    blocks = tgc.grid_blocks(nv, nh, 1, nb, noff)
    assert nh % 4 and lay.pitch % 32 == 0
    assert lay.tiles > blocks and lay.tiles % blocks
    xk, hk = _run_twice(tgc.stream_cg_coef_planes_batched_fat, S.offsets,
                        coefp, bp, x0p, 40)
    xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(S.offsets, coefp, bp,
                                                         x0p, 40)
    for c in range(nb):
        _assert_dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])
        if nb > 1:
            x1, h1 = tgc.stream_cg_coef_planes(S.offsets, coefp, bp[:, c],
                                               x0p[:, c], 40)
            assert torch.equal(xk[:, c], x1) and torch.equal(hk[:, c], h1)


def _far_stencil(dev, nv, nh, pad, noff, seed):
    """A non-symmetric stencil of noff distinct offsets within pad nodes,
    (0, 0) first and (pad, -pad) among them, diagonally dominant (centre
    4 + 0.5j + 0.1 U, the others -0.1 (1 + 0.3 U) + 0.02j)."""
    from tpcg_torch.sparse import Stencil2D
    rng = np.random.default_rng(seed)
    ring = [(dm, dj) for dm in range(-pad, pad + 1)
            for dj in range(-pad, pad + 1)
            if (dm, dj) not in ((0, 0), (pad, -pad))]
    pick = rng.choice(len(ring), size=noff - 2, replace=False)
    offsets = ((0, 0), (pad, -pad)) + tuple(ring[i] for i in pick)
    c = -0.1 * (1.0 + 0.3 * rng.random((len(offsets), nv, nh))) + 0.02j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((nv, nh))
    return Stencil2D(offsets, torch.from_numpy(c).to(dev), (nv, nh))


@pytest.mark.parametrize("nb", [1, 3, 8])
def test_coef_kernel_takes_pad8_with_32_offsets(dev, nb):
    """The kernel's limits at once, pad 8 and 32 offsets, on an odd grid
    with x0 != 0: the layout keeps 8 RHS a launch and fits a block; each
    RHS against the plain version over 20 iterations, two launches
    bit-equal."""
    nv, nh = 157, 203
    S = _far_stencil(dev, nv, nh, 8, 32, 3)
    assert len(S.offsets) == 32
    coefp = tgc.prepare_stream_coef(S)
    lay = tgc.coef_layout(nv, nh, 8, nb, 32)
    assert lay.rhs_per_launch == 8 and lay.blocks_per_sm >= 1
    rng = np.random.default_rng(40 + nb)
    bp = torch.from_numpy(
        rng.standard_normal((2, nb, nv, nh)).astype(np.float32)).to(dev)
    x0p = 0.1 * torch.flip(bp, dims=(3,))
    xk, hk = _run_twice(tgc.stream_cg_coef_planes_batched_fat, S.offsets,
                        coefp, bp, x0p, 20)
    xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(S.offsets, coefp, bp,
                                                         x0p, 20)
    for c in range(nb):
        _assert_dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])


def test_coef_instances_do_not_spill(dev):
    """Every NB instance of the kernel builds without spills (-Xptxas -v)."""
    from tpcg_torch.ops import _build
    _build.load()
    name, seen = "", {}
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line and "stream_cg_coef_kernel" in name:
            seen[name] = line.strip()
    assert len(seen) == 8
    for name, line in seen.items():
        assert "0 bytes spill stores" in line and \
            "0 bytes spill loads" in line, (name, line)


def test_coef_plan_launches_once_per_chunk(dev):
    """Through a stream-coef plan: B=1 one launch of the NB = 1 instance,
    B=3 one launch, B=10 two launches (8 + 2); each column follows the
    plain version."""
    S, coefp, bp, _ = _coef_case(dev, 520, 520, 10)
    for nb, launches in ((1, 1), (3, 1), (10, 2)):
        plan = tpcg_torch.plan_stencil_cg(S, 30, nb=nb)
        assert plan.path == "stream-coef"
        before = _coef_launches()
        x, h = plan.solve_planes(bp[:, 0] if nb == 1 else bp[:, :nb])
        assert _coef_launches() == before + launches
        xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(
            S.offsets, coefp, bp[:, :nb], torch.zeros_like(bp[:, :nb]), 30)
        if nb == 1:
            x, h = x[:, None], h[:, None]
        for c in range(nb):
            _assert_dia_close(x[:, c], h[:, c], xp[:, c], hp[:, c])


def test_coef_wrapper_refuses_past_its_limits(dev):
    """A stencil past the kernel's offsets or pad raises ValueError before
    any launch; the limits are the ones the kernel states."""
    max_off, max_pad, max_nb = tgc.kernel_limits()
    assert (max_off, max_pad, max_nb) == (32, 8, 8)
    bp = torch.ones((2, 20, 20), device=dev)
    far = ((0, 0), (0, max_pad + 1))
    many = tuple((0, 0) for _ in range(max_off + 1))
    before = _coef_launches()
    for offsets in (far, many):
        coefp = torch.ones((2, len(offsets), 20, 20), device=dev)
        with pytest.raises(ValueError, match="kernel takes at most"):
            tgc.stream_cg_coef_planes(offsets, coefp, bp, bp, 3)
    assert _coef_launches() == before


def test_coef_kernel_freezes(dev):
    """2 I as full planes on the helm_fe offsets, b = 1, 2, 3: over 400
    iterations every RHS of an NB = 3 launch reads 0 from iteration 1, as
    the plain version does, stays finite, and gives x = b / 2."""
    from tpcg_torch.sparse import Stencil2D
    N = 64
    A = helm_fe(N, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    coefp = tgc.prepare_stream_coef(Stencil2D(A.offsets, coef, A.grid))
    bp = torch.zeros((2, 3, N, N), device=dev)
    bp[0] = torch.arange(1, 4, device=dev, dtype=torch.float32)[:, None, None]
    x0p = torch.zeros_like(bp)
    xk, hk = tgc.stream_cg_coef_planes_batched_fat(A.offsets, coefp, bp, x0p,
                                                   400)
    xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(A.offsets, coefp, bp,
                                                         x0p, 400)
    assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
    assert torch.equal(hk[0], hp[0]) and torch.all(hk[1:] == 0)
    assert torch.all(hp[1:] == 0)
    assert torch.equal(xk, xp) and torch.equal(xk[0], bp[0] / 2)


# ---- streaming real kernel (csrc/stream_cg_real.cu), both modes
# The tolerances of the streaming kernels' checks above: the kernel applies
# each operator bit for bit as the plain version does, and both sum their
# dot products in float64.

tsr = importlib.import_module("tpcg_torch.ops.stream_cg_real")


def _real_stencil(dev, kind, nv, nh):
    """A real nv x nh stencil: ``poisson`` (5-point, diagonal 4),
    ``fe`` (the parabolic_fem-class 7-point stencil, diagonal 8) or
    ``vardiag`` (Poisson, c[0] += 0.3 U(0, 1) from seed 2); taps that leave
    the grid are zero."""
    from tpcg_torch.sparse import Stencil2D
    offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))
    taps = [4.0, -1.0, -1.0, -1.0, -1.0]
    if kind == "fe":
        offs += ((1, 1), (-1, -1))
        taps = [8.0] + [-1.0] * 6
    c = np.zeros((len(offs), nv, nh))
    for s, (dm, dj) in enumerate(offs):
        c[s, max(0, -dm):nv - max(0, dm), max(0, -dj):nh - max(0, dj)] = taps[s]
    if kind == "vardiag":
        c[0] += 0.3 * np.random.default_rng(2).random((nv, nh))
    return Stencil2D(offs, torch.from_numpy(c).to(dev), (nv, nh))


def _real_rhs(dev, nv, nh, seed):
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal((nv, nh)).astype(np.float32))
    x0 = torch.from_numpy((0.1 * rng.standard_normal((nv, nh))).astype(
        np.float32))
    return b.to(dev), x0.to(dev)


def _real_run(S, prepared, b, x0, iters, plain=False):
    mode, operand = prepared
    if mode == "const":
        fn = tsr.stream_cg_real_planes_plain if plain else \
            tsr.stream_cg_real_planes
        return fn(S.offsets, S.grid, *operand, b, x0, iters)
    fn = tsr.stream_cg_real_coef_planes_plain if plain else \
        tsr.stream_cg_real_coef_planes
    return fn(S.offsets, operand, b, x0, iters)


# the smoke's geometries, both modes, 40 iterations from a seeded x0
@pytest.mark.parametrize("nv,nh,seed", [(256, 256, 1), (300, 700, 2),
                                        (1031, 1024, 3), (600, 1000, 4)])
@pytest.mark.parametrize("kind,mode", [("poisson", "const"),
                                       ("fe", "const"), ("vardiag", "coef")])
def test_real_kernel_matches_plain(dev, nv, nh, seed, kind, mode):
    S = _real_stencil(dev, kind, nv, nh)
    prepared = tsr.prepare_real(S)
    assert prepared[0] == mode
    b, x0 = _real_rhs(dev, nv, nh, seed)
    before = _counted("launch.stream_real")
    xk, hk = _run_twice(_real_run, S, prepared, b, x0, 40)
    assert _counted("launch.stream_real") == before + 2
    xp, hp = _real_run(S, prepared, b, x0, 40, plain=True)
    _assert_dia_close(xk, hk, xp, hp)


def test_real_kernel_applies_the_operator(dev):
    """Zero iterations give r0 = b - A x0 only, in both modes: x = x0 and
    hist[0] from the plain operator's residual, on a grid with all four
    corners in play."""
    S = _real_stencil(dev, "fe", 37, 45)
    b, x0 = _real_rhs(dev, 37, 45, 5)
    for prepared in (tsr.prepare_real(S),
                     ("coef", tsr.prepare_stream_coef_real(S))):
        x, h = _real_run(S, prepared, b, x0, 0)
        xp, hp = _real_run(S, prepared, b, x0, 0, plain=True)
        assert torch.equal(x, x0) and torch.allclose(h, hp, rtol=1e-6)


def test_real_plan_batch_columns_equal_single_launches(dev):
    """B=3 through a stream-real plan: three launches, each column bit-equal
    to its single-RHS launch; solve returns real float32 x."""
    S = _real_stencil(dev, "poisson", 1024, 1024)
    plan = tpcg_torch.plan_stencil_cg(S, 30, nb=3)
    assert plan.path == "stream-real"
    cols = [_real_rhs(dev, 1024, 1024, s)[0] for s in range(3)]
    before = _counted("launch.stream_real")
    xb, hb = plan.solve_planes(torch.stack(cols))
    assert _counted("launch.stream_real") == before + 3
    for c in range(3):
        x1, h1 = plan.solve_planes(cols[c])
        assert torch.equal(xb[c], x1) and torch.equal(hb[:, c], h1)
    x, hist = plan.solve(cols[0].cpu().numpy())
    assert x.dtype == np.float32 and x.shape == (1024, 1024)
    np.testing.assert_array_equal(hist, hb[:, 0].cpu().numpy())


@pytest.mark.parametrize("mode", ["const", "coef"])
def test_real_kernel_freezes(dev, mode):
    """2 I converges in one iteration; over 400 iterations the kernel reads
    0 from iteration 1, as the plain version does, stays finite, and gives
    x = b / 2."""
    from tpcg_torch.sparse import Stencil2D
    A = poisson(64, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    S = Stencil2D(A.offsets, coef, A.grid)
    prepared = (tsr.prepare_real(S) if mode == "const"
                else ("coef", tsr.prepare_stream_coef_real(S)))
    b = torch.ones((64, 64), device=dev)
    xk, hk = _real_run(S, prepared, b, torch.zeros_like(b), 400)
    xp, hp = _real_run(S, prepared, b, torch.zeros_like(b), 400, plain=True)
    assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
    assert hk[0] == hp[0] and torch.all(hk[1:] == 0) and torch.all(hp[1:] == 0)
    assert torch.equal(xk, xp) and torch.all(xk == 0.5)


def test_planner_on_card_takes_the_real_path(dev):
    """Real grids from 1024^2 nodes take stream-real, at a prime height and
    an unaligned width too: const mode for Poisson and the FE stencil, coef
    mode for a variable diagonal; smaller ones stay eager.  Poisson
    converges: 1000 iterations at N=1024 reach a float64 relative residual
    of 1e-2 (float64 CG: 9.0e-04)."""
    pick = importlib.import_module("tpcg_torch.ops.auto")._pick_path
    for kind, nv, nh, mode in (("poisson", 1031, 1024, "const"),
                               ("fe", 1024, 1100, "const"),
                               ("vardiag", 1024, 1024, "coef")):
        path, prepared = pick(_real_stencil(dev, kind, nv, nh), 1,
                              on_cuda=True)
        assert (path, prepared[0]) == ("stream-real", mode)
    assert tpcg_torch.plan_stencil_cg(
        _real_stencil(dev, "poisson", 1000, 1000), 5).path == "eager"
    S = poisson(1024, device=dev)
    b = np.random.default_rng(1).standard_normal((1024, 1024))
    x, _ = tpcg_torch.plan_stencil_cg(S, 1000).solve(b)
    r = b.reshape(-1) - S.to_scipy() @ x.astype(np.float64).reshape(-1)
    assert np.linalg.norm(r) <= 1e-2 * np.linalg.norm(b)


def _parabolic_fem(dev, Ng=725):
    """parabolic_fem's stand-in at its published size, diagonal 6, and the
    seeded standard-normal RHS of the checks below."""
    from tpcg_torch.problems import parabolic_stencil
    S = parabolic_stencil(Ng, device=dev, diag=6.0)
    b = np.random.default_rng(0).standard_normal((Ng, Ng)).astype(np.float32)
    return S, b


def test_planner_takes_stream_real_at_parabolic_fem(dev):
    """A float32 real grid below 1024^2 nodes plans stream-real on the card
    (the H100's rule, auto._REAL_F32_MIN_SIDE): parabolic_fem at 725^2, one
    launch of the kernel a solve, x and the history as the kernel's plain
    version's over 100 iterations, and <r, r> not yet 0 at iteration 5000
    (the diagonal 6 keeps CG working; with 8 it underflows by ~100)."""
    S, b = _parabolic_fem(dev)
    plan = tpcg_torch.plan_stencil_cg(S, 5000)
    assert plan.path == "stream-real"
    bp = torch.from_numpy(b).to(dev)
    before = _counted("launch.stream_real")
    x, h = plan.solve_planes(bp)
    assert _counted("launch.stream_real") == before + 1
    assert torch.isfinite(x).all() and 0 < float(h[-1]) < 1e-3 * float(h[0])
    xk, hk = tpcg_torch.plan_stencil_cg(S, 100).solve_planes(bp)
    taps, strips = tsr.prepare_real(S)[1]
    xp, hp = tsr.stream_cg_real_planes_plain(S.offsets, S.grid, taps, strips,
                                             bp, torch.zeros_like(bp), 100)
    _assert_dia_close(xk, hk, xp, hp)


def test_stencil_cg_copies_and_launches_of_one_call(dev):
    """One stencil_cg call on parabolic_fem (the parabolic_fem.stencil_calls
    cell at 20 iterations): b up, x and the history down, to the byte,
    around one launch of the real streaming kernel; the plan and the solve
    are spans of the call, the plan counted by its path."""
    S, b = _parabolic_fem(dev)
    iters = 20
    (x, h), recs, c = _traced(lambda: tpcg_torch.stencil_cg(
        S, b, n_iterations=iters))
    assert c["h2d_bytes"] == b.nbytes
    assert c["d2h_bytes"] == x.nbytes + h.nbytes == b.nbytes + (iters + 1) * 4
    assert _launched(c) == {"launch.stream_real": 1}
    assert c["plan.stream-real"] == 1
    assert [r.name for r in recs] == [
        "tpcg.stencil_cg", "tpcg.plan", "tpcg.solve", "tpcg.pack",
        "tpcg.wait", "tpcg.upload", "tpcg.launch.stream_real", "tpcg.wait",
        "tpcg.download", "tpcg.download", "tpcg.pack"]
    assert recs[0].counts == c
    assert {r.call for r in recs} == {recs[0].id}
    assert x.shape == (725, 725) and h.shape == (iters + 1,)


# odd widths whose rows the kernel pads (513 x 1027: pitch 1056) and grids
# whose blocks take uneven numbers of tiles (700 x 901; 513 x 1027 too), in
# both modes
@pytest.mark.parametrize("nv,nh,seed", [(513, 1027, 7), (700, 901, 8)])
@pytest.mark.parametrize("kind,mode", [("poisson", "const"),
                                       ("vardiag", "coef")])
def test_real_kernel_odd_width_and_uneven_tiles(dev, nv, nh, seed, kind,
                                                mode):
    S = _real_stencil(dev, kind, nv, nh)
    prepared = tsr.prepare_real(S)
    assert prepared[0] == mode
    b, x0 = _real_rhs(dev, nv, nh, seed)
    xk, hk = _run_twice(_real_run, S, prepared, b, x0, 40)
    xp, hp = _real_run(S, prepared, b, x0, 40, plain=True)
    _assert_dia_close(xk, hk, xp, hp)


def _real_limit_stencil(dev, nv, nh, seed, coef):
    """A real stencil at the kernel's limits: 16 taps within 8 nodes,
    (8, -8) among them; centre 4, the others from -0.2, -0.15, -0.1 (equal
    taps form groups in const mode).  Const mode: constant planes (a tap
    that leaves the grid reads 0 there); coef mode: each plane times
    1 + 0.3 U(0, 1)."""
    from tpcg_torch.sparse import Stencil2D
    rng = np.random.default_rng(seed)
    pos = [(dm, dj) for dm in range(-8, 9) for dj in range(-8, 9)
           if (dm, dj) not in ((0, 0), (8, -8))]
    pick = rng.choice(len(pos), size=14, replace=False)
    offsets = ((0, 0), (8, -8)) + tuple(pos[i] for i in pick)
    c = np.empty((16, nv, nh))
    c[0] = 4.0
    for s in range(1, 16):
        c[s] = (-0.2, -0.15, -0.1)[s % 3]
    if coef:
        c *= 1.0 + 0.3 * rng.random(c.shape)
    return Stencil2D(offsets, torch.from_numpy(c).to(dev), (nv, nh))


@pytest.mark.parametrize("mode", ["const", "coef"])
def test_real_kernel_takes_pad8_with_16_taps(dev, mode):
    """The kernel's limits at once, pad 8 and 16 taps, in both modes, on an
    odd grid with x0 != 0: the layout fits a block, the kernel follows the
    plain version over 16 iterations and two launches agree bit for bit."""
    nv, nh = 157, 203
    S = _real_limit_stencil(dev, nv, nh, 3, mode == "coef")
    prepared = tsr.prepare_real(S)
    assert prepared[0] == mode
    assert tsr.kernel_limits() == (16, 8)
    lay = tsr.real_layout(nv, nh, 8, 16, mode == "coef")
    assert lay.blocks_per_sm >= 1 and lay.col_halo == 8
    b = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (nv, nh)).astype(np.float32)).to(dev)
    x0 = 0.1 * torch.flip(b, dims=(1,))
    xk, hk = _run_twice(_real_run, S, prepared, b, x0, 16)
    xp, hp = _real_run(S, prepared, b, x0, 16, plain=True)
    _assert_dia_close(xk, hk, xp, hp)


def test_real_kernel_does_not_spill(dev):
    """The three instances of the kernel (coef mode, const mode streaming
    and const mode resident, whose x, r and q of 6 nodes a thread sit in
    registers) build without spills (-Xptxas -v)."""
    from tpcg_torch.ops import _build
    _build.load()
    name, seen = "", []
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line and "stream_cg_real_kernel" in name:
            seen.append(line.strip())
    assert len(seen) == 3
    for line in seen:
        assert "0 bytes spill stores" in line and \
            "0 bytes spill loads" in line, line


def _resident_layout(dev, n, noff):
    """The resident layout of an n x n const-mode grid (pad 1) on this card,
    or None."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return tsr.resident_layout(n, n, 1, noff, sms, *tsr.resident_limits())


def _resident_limit(dev):
    """The largest N whose N x N grid (5 taps, pad 1) takes the resident
    layout on this card."""
    return max(n for n in range(8, 2049)
               if _resident_layout(dev, n, 5) is not None)


def test_resident_limits_are_the_layout_tests(dev):
    """The kernel's resident limits, tallest tile and blocks an SM, are the
    ones tests/test_torch_stream_real_layout.py's rule runs with."""
    assert tsr.resident_limits() == (12, 3)


# parabolic_fem's operator and Poisson at 725^2, the smallest grid, a grid
# below 512^2, 1023^2 (past the limit at 132 SMs), and the sizes each side
# of the resident limit
@pytest.mark.parametrize("kind,size,seed", [
    ("parabolic", 725, 1), ("poisson", 725, 2), ("poisson", 8, 3),
    ("fe", 511, 4), ("poisson", 1023, 5), ("poisson", "limit", 6),
    ("poisson", "limit+1", 7)])
def test_resident_kernel_bit_equal_to_plain(dev, kind, size, seed):
    """Const mode in the one-wave resident layout (one tile a block, x, r
    and q in registers) follows cg_real_plain bit for bit over 100
    iterations from a seeded x0, x and the history, as the streaming
    layout does past the resident limit."""
    limit = _resident_limit(dev)
    n = {"limit": limit, "limit+1": limit + 1}.get(size, size)
    if kind == "parabolic":
        S = _parabolic_fem(dev, n)[0]
    else:
        S = _real_stencil(dev, kind, n, n)
    prepared = tsr.prepare_real(S)
    assert prepared[0] == "const"
    lay, blocks = tsr.card_layout(n, n, 1, len(S.offsets), False, dev)
    assert lay.resident == (_resident_layout(dev, n, len(S.offsets))
                            is not None)
    if size in ("limit", "limit+1"):
        assert lay.resident == (size == "limit")
    assert blocks == lay.tiles if lay.resident else blocks <= lay.tiles
    b, x0 = _real_rhs(dev, n, n, seed)
    before = _counted("resident.stream_real")
    xk, hk = _run_twice(_real_run, S, prepared, b, x0, 100)
    assert _counted("resident.stream_real") == before + 2 * lay.resident
    xp, hp = _real_run(S, prepared, b, x0, 100, plain=True)
    assert torch.equal(hk, hp)
    assert torch.equal(xk, xp)


def test_stencil_cg_counts_resident_launches(dev):
    """``resident.stream_real`` counts 1 a stencil_cg call on parabolic_fem
    at 725^2 (one launch, one tile a block) and 0 at 2048^2, whose tiles
    pass what the card holds at once (the streaming layout)."""
    for n, resident in ((725, 1), (2048, 0)):
        S, b = _parabolic_fem(dev, n)
        for _ in range(2):
            launches = _counted("launch.stream_real")
            count = _counted("resident.stream_real")
            tpcg_torch.stencil_cg(S, b, n_iterations=20)
            assert _counted("launch.stream_real") == launches + 1
            assert _counted("resident.stream_real") == count + resident


def test_real_plan_copies_coef_planes_once(dev):
    """A B=3 coef-mode stream-real plan copies the coefficient planes to the
    kernel's pitch once, when it is made, keeps that copy alone on the card,
    and solves with three launches that read it; each column is bit-equal
    to its own launch."""
    nv, nh = 1031, 1100
    S = _real_stencil(dev, "vardiag", nv, nh)
    cols = [_real_rhs(dev, nv, nh, s)[0] for s in range(3)]
    copies = _counted("copy.pad_real_planes")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    plan = tpcg_torch.plan_stencil_cg(S, 30, nb=3)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - held
    assert plan.path == "stream-real"
    assert _counted("copy.pad_real_planes") == copies + 1
    # the padded copy, and not also the unpadded planes
    noff = len(S.offsets)
    pitch = tsr.real_layout(nv, nh, 1, noff, True).pitch
    assert 4 * noff * nv * pitch <= held < 4 * noff * nv * (nh + pitch)
    before = _counted("launch.stream_real")
    xb, hb = plan.solve_planes(torch.stack(cols))
    assert _counted("launch.stream_real") == before + 3
    assert _counted("copy.pad_real_planes") == copies + 1
    plan.solve_planes(torch.stack(cols))
    assert _counted("copy.pad_real_planes") == copies + 1
    coefp = tsr.prepare_stream_coef_real(S)
    for c in range(3):
        x1, h1 = tsr.stream_cg_real_coef_planes(S.offsets, coefp, cols[c],
                                                torch.zeros_like(cols[c]), 30)
        assert torch.equal(xb[c], x1) and torch.equal(hb[:, c], h1)


# ---- the whole-solve kernel's const instance (csrc/fused_cg.cu, l2-const)
# The tolerances of the coefficient instance's checks (tests/test_fused_cg.py).

tcc = importlib.import_module("tpcg_torch.ops.fused_cg_const")


@pytest.mark.parametrize("name,N,nb,x0_kind,k,iters", [
    ("helm_fe", 16, 1, "0", 5.0, 25), ("helm_fe", 33, 3, "wave", 5.0, 25),
    ("helm_fe", 12, 1, "random", 4.0, 15),
    ("helm_fe", 512, 2, "random", 12.0, 25),
    ("poisson", 16, 3, "0", 0.0, 25)])
def test_const_kernel_matches_plain(dev, name, N, nb, x0_kind, k, iters):
    S, _, bp, x0p = _case(dev, name, N, nb, x0_kind, k)
    cr, ci, strips = tcc.prepare_const(S)
    before = _counted("launch.fused_const")
    xk, hk = _run_twice(tcc.fused_cg_const_planes, S.offsets, S.grid, cr, ci,
                        strips, bp, x0p, iters)
    assert _counted("launch.fused_const") == before + 2
    xp, hp = tcc.fused_cg_const_planes_plain(S.offsets, S.grid, cr, ci,
                                             strips, bp, x0p, iters)
    _assert_fused_close(xk, hk, xp, hp)


@pytest.mark.parametrize("N", [128, 512])
def test_l2_const_plan_matches_plain_over_100_iterations(dev, N):
    """The forced l2-const path at the main path's shapes: x and the
    history over 100 iterations against the plain version; batches past
    the kernel's RHS limit split into launches."""
    S, _, bp, x0p = _case(dev, "helm_fe", N, 1, k=12.0)
    plan = tpcg_torch.plan_stencil_cg(S, 100, path="l2-const")
    xk, hk = plan.solve_planes(bp, x0p)
    xp, hp = tcc.fused_cg_const_planes_plain(S.offsets, S.grid,
                                             *tcc.prepare_const(S), bp, x0p,
                                             100)
    _assert_fused_close(xk, hk, xp, hp)
    assert tpcg_torch.plan_stencil_cg(S, 5).path == "l2-coef"


# ---- the unstructured SpMV kernel (csrc/route_spmv.cu) ----
# y within 1e-5 max|y| of the plain version (the kernel sums a row's
# products across 32 lanes and a shuffle tree, the plain version in row
# order); two launches bit-equal (no atomics).

trs = importlib.import_module("tpcg_torch.ops.route_spmv")


def _route_matrix(name):
    """The smoke's geometries: the 1138_bus class, random_spd(5000, 100),
    empty rows beside one row of 5,000 nonzeros, and the CSR matrix rebuilt
    from routing tables."""
    import scipy.sparse as sp
    from tpcg_torch.ops.routing import build_routing_spmv, routed_to_csr
    from tpcg_torch.problems import irregular_spd, random_spd
    if name == "1138_bus":
        return irregular_spd(1138, 3.56, seed=0)
    if name == "random":
        return random_spd(5000, 100, seed=1)
    if name == "skewed":
        rng = np.random.default_rng(3)
        n = 6000
        rows = np.concatenate([np.zeros(5000, np.int64),
                               rng.integers(1, n, 3000) // 2 * 2])
        return sp.csr_matrix((rng.standard_normal(len(rows)),
                              (rows, rng.integers(0, n, len(rows)))),
                             shape=(n, n))
    return routed_to_csr(build_routing_spmv(irregular_spd(700, 5, seed=4)))


def _launches_for(ncols):
    return ncols // 8 + bin(ncols % 8).count("1")


@pytest.mark.parametrize("name", ["1138_bus", "random", "skewed", "tables"])
@pytest.mark.parametrize("kind", ["real", "complex", "real-complex-rhs"])
def test_route_kernel_matches_plain(dev, name, kind):
    A = _route_matrix(name)
    D = tpcg_torch.DeviceRouted.from_scipy(
        A.astype(np.complex64 if kind == "complex" else np.float32),
        device=dev)
    n = D.n
    rng = np.random.default_rng(5)
    for nrhs in (1, 2, 4, 5, 8, 13):
        if kind == "real":
            x = torch.from_numpy(rng.standard_normal(
                (n, nrhs)).astype(np.float32)).to(dev)
            yp = trs.routed_matvec_plain(D.row_ptr, D.col, D.val, x)

            def run():
                return trs.routed_matvec_block(D.row_ptr, D.col, D.val, x)
            per_call = _launches_for(nrhs)
        else:
            x = torch.from_numpy(rng.standard_normal(
                (2, n, nrhs)).astype(np.float32)).to(dev)
            if kind == "complex":
                yp = trs.routed_matvec_plain(D.row_ptr, D.col, D.val, x)
            else:
                yp = torch.stack([trs.routed_matvec_plain(
                    D.row_ptr, D.col, D.val, x[p]) for p in range(2)])
            P = trs.routed_pair(D)

            def run():
                return P.matvec(x)
            per_call = _launches_for(nrhs if kind == "complex" else 2 * nrhs)
        before = _counted("launch.route_spmv")
        y1, y2 = run(), run()
        torch.cuda.synchronize()
        assert _counted("launch.route_spmv") == before + 2 * per_call
        assert torch.equal(y1, y2)
        err = float((y1 - yp).abs().max())
        assert err <= 1e-5 * float(yp.abs().max()), (nrhs, err)
    if name == "skewed":
        assert not bool(y1[..., 1::2, :].any())   # the empty rows


def test_route_wrapper_refuses_overflow_and_aliasing_on_card(dev):
    D = tpcg_torch.DeviceRouted.from_scipy(_route_matrix("1138_bus"),
                                           device=dev)
    x = torch.ones(D.n, 2, device=dev)
    huge = torch.zeros(1, dtype=torch.int32, device=dev).expand(2**31)
    before = _counted("launch.route_spmv")
    with pytest.raises(ValueError, match="int32"):
        trs.routed_matvec_block(D.row_ptr, huge, D.val, x)
    with pytest.raises(ValueError, match="storage"):
        trs.routed_matvec_block(D.row_ptr, D.col, D.val, x, out=x)
    assert _counted("launch.route_spmv") == before
    out = torch.empty_like(x)
    assert trs.routed_matvec_block(D.row_ptr, D.col, D.val, x,
                                   out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, D.matvec(x))


def test_route_plain_is_deterministic_on_card(dev):
    """The plain SpMV sums each row in one fixed order on the card too: two
    runs are bit-equal, real and complex, on the skewed geometry (one row of
    5,000 nonzeros beside empty rows) and the random-routed class."""
    for name in ("skewed", "random"):
        A = _route_matrix(name)
        rng = np.random.default_rng(9)
        for cplx in (False, True):
            D = tpcg_torch.DeviceRouted.from_scipy(
                A.astype(np.complex64 if cplx else np.float32), device=dev)
            shape = (2, D.n, 4) if cplx else (D.n, 4)
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
            y1 = trs.routed_matvec_plain(D.row_ptr, D.col, D.val, x)
            y2 = trs.routed_matvec_plain(D.row_ptr, D.col, D.val, x)
            torch.cuda.synchronize()
            assert torch.equal(y1, y2), (name, cplx)


def _oras_cfg(**kw):
    """The helm_oras_m4 cell's configuration (M 4, W 34, k 20, CGMaxIT 256,
    complex64), with ``kw`` changed."""
    return tpcg_torch.HelmholtzConfig(**{
        **dict(k=20.0, M_subd=4, W_subd=34, cg_max_it=256, verbose=0), **kw})


def test_oras_subsolve_kernel_matches_plain(dev):
    """The batched subdomain solve of the helm_oras_m4 cell (16 subdomains
    of 66 x 66, one launch of kernel A complex, clusters side by side)
    against its plain
    twin on the CPU over 100 iterations, on the first preconditioner
    application's input: x within 2e-3 max|x|."""
    plan = tpcg_torch.plan_hsolver(_oras_cfg(cg_max_it=100), dev)
    prec = plan.prec
    b = torch.from_numpy(plan.decomp.crop_grid(plan.b)).to(dev,
                                                         torch.complex64)
    r = b - plan.matvec(plan.x0)
    zb = torch.view_as_real(r.reshape(16, -1)).permute(2, 0, 1).contiguous()
    before = _counted("launch.stream_dia_cplx")
    xk = prec.subsolve(zb)
    torch.cuda.synchronize()
    assert _counted("launch.stream_dia_cplx") - before == 1
    sdia = importlib.import_module("tpcg_torch.ops.stream_cg_dia")
    zc = zb.cpu()
    xp, _ = sdia.stream_cg_dia_rows_cplx(prec.offsets, prec.values.cpu(), zc,
                                         torch.zeros_like(zc), 100)
    xk = xk.cpu().numpy()
    assert np.isfinite(xk).all()
    np.testing.assert_allclose(xk, xp.numpy(), rtol=0,
                               atol=2e-3 * np.abs(xp.numpy()).max())


def test_hsolver_on_card_matches_cpu_complex128(dev):
    """The whole ORAS-FGMRES solve on the card (kernel A subdomain solves,
    complex64) against the port's complex128 solve on the CPU at the CPU
    tests' size (M 2, W 8, k 20, CGMaxIT 64): the same iteration count to
    tol 1e-6, the first 5 residual estimates within 1e-3 of the first (the
    float32 subdomain solves move the later ones by up to ~2e-3 of their
    own size)."""
    cfg = _oras_cfg(M_subd=2, W_subd=8, cg_max_it=64)
    rc = tpcg_torch.hsolver(cfg, device=dev)
    r128 = tpcg_torch.hsolver(dataclasses.replace(cfg, dtype="complex128"),
                              device="cpu")
    assert rc.converged and rc.iterations == r128.iterations
    h128 = r128.residual_norms[:5]
    np.testing.assert_allclose(rc.residual_norms[:5], h128, rtol=0,
                               atol=1e-3 * h128[0])


def test_hsolve_spans_and_counters_of_one_call(dev):
    """One hsolve call at the helm_oras_m4 cell's size, 3 FGMRES iterations:
    3 Arnoldi steps and 3 preconditioner applications of 16 subdomain RHS,
    one launch of kernel A each, G clusters side by side; b up once with
    each launch's offsets,
    the dots of each step and x down, to the byte; the precond and arnoldi
    spans inside the call's tpcg.hsolve, each halo span inside one of them
    but the initial residual's."""
    plan = tpcg_torch.plan_hsolver(_oras_cfg(), dev)
    b = plane_wave_rhs(165, 20.0).astype(np.complex64)
    it = 3
    trace.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        x, h = tpcg_torch.hsolve(plan, b, n_iterations=it)
    recs, c = trace.records(), trace.counters()
    assert x.shape == (165, 165) and h.shape == (it + 1,)
    assert np.isfinite(x).all() and np.isfinite(h).all()
    assert (c["fgmres.iterations"], c["precond.applies"],
            c["subsolve.rhs"]) == (it, it, 16 * it)
    assert _launched(c) == {"launch.stream_dia_cplx": it}
    assert c["cluster.stream_dia_cplx"] == it
    # G clusters side by side a launch, as the card holds them
    offs, vals = plan.prec.offsets, plan.prec.values
    n = vals.shape[2]
    lay = tsd.dia_layout(n, offs, 1, 2, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    _, g = tsd.cluster_split(16, lambda k: tsd._grid_of(dev, offs, n, 2, k,
                                                        lay)[1])
    assert c["cluster_grid.stream_dia_cplx"] == it * g
    state = 16 * 66 * 66 * 8
    assert c["h2d_bytes"] == state + it * 7 * 4
    # ||r0|| (float32), then each step's k + 1 dots and h_sub (complex64)
    assert c["d2h_bytes"] == 4 + sum((k + 2) * 8 for k in range(it)) + state
    assert recs[0].name == "tpcg.hsolve" and recs[0].counts == c
    assert {r.call for r in recs} == {recs[0].id}
    names = [r.name for r in recs]
    assert names.count("tpcg.precond") == it
    assert names.count("tpcg.arnoldi") == it
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name in ("tpcg.precond", "tpcg.arnoldi"):
            assert r.parent == recs[0].id
    halo = [by_id[r.parent].name for r in recs if r.name == "tpcg.halo"]
    assert halo == ["tpcg.hsolve"] + ["tpcg.precond", "tpcg.arnoldi"] * it
