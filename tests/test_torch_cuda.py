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
    b = _rhs(D.n, nb, cplx, dev)
    x0 = 0.1 * _rhs(D.n, nb, cplx, dev, seed=2)
    before = wrap.launches
    xk, hk = _run_twice(wrap, offs, vals, b, x0, 40)
    assert wrap.launches == before + 2
    xp, hp = plain(offs, vals, b, x0, 40)
    for c in range(nb):
        _assert_dia_close(xk[..., c, :], hk[:, c], xp[..., c, :], hp[:, c])


def test_fused_dia_kernel_matches_plain_small(dev):
    # the CPU-side fit rule is this card's limit: 8 rows per thread, and
    # the shared memory a block may use (dynamic part + the static 512 B)
    rows, dyn = tfd.kernel_limits()
    assert rows == tfd._MAX_ROWS
    assert dyn + tfd._STATIC_SMEM == tfd.SMEM_PER_BLOCK
    D = _dia(_small_band(True, n=300, offs=(0, 2, 150)), np.complex64, dev)
    offs, vals = tsd.prepare_dia_rows_cplx(D)
    b = _rhs(D.n, 3, True, dev)
    x0 = 0.1 * _rhs(D.n, 3, True, dev, seed=2)
    before = tfd.fused_cg_dia_rows_cplx.launches
    xk, hk = _run_twice(tfd.fused_cg_dia_rows_cplx, offs, vals, b, x0, 40)
    assert tfd.fused_cg_dia_rows_cplx.launches == before + 2
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
    """Nine RHS: two launches of 5 and 4 (balanced, no zero padding), each
    RHS equal to its single-RHS launch bit for bit."""
    max_rhs, _ = tsd.kernel_limits()
    assert max_rhs == 8
    D = _dia(_small_band(False), np.float32, dev)
    offs, vals = tsd.prepare_dia_rows(D)
    b = _rhs(D.n, 9, False, dev)
    x0 = torch.zeros_like(b)
    before = tsd.stream_cg_dia_rows.launches
    xk, hk = tsd.stream_cg_dia_rows(offs, vals, b, x0, 30)
    assert tsd.stream_cg_dia_rows.launches == before + 2
    with pytest.raises(ValueError):
        tsd._launch(offs, vals[None], b[None], x0[None], 30)
    xp, hp = tsd.stream_cg_dia_rows_plain(offs, vals, b, x0, 30)
    for c in range(9):
        _assert_dia_close(xk[c], hk[:, c], xp[c], hp[:, c])
    x1, h1 = tsd.stream_cg_dia_rows(offs, vals, b[4:5], x0[4:5], 30)
    assert torch.equal(x1[0], xk[4]) and torch.equal(h1[:, 0], hk[:, 4])


def test_dia_zero_rhs_column_freezes(dev):
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
            xk, hk = wrap(offs, vals, b, x0, 300)
            assert torch.isfinite(xk).all() and torch.isfinite(hk).all()
            assert (xk[..., 1, :] == 0).all() and (hk[:, 1] == 0).all()


def test_dia_kernels_denormal_and_identity_freeze(dev):
    """tests/test_fused_cg_dia.py's two freeze systems on the card: the
    weakly dominant band run 400 iterations past convergence stays finite
    and, once its history reads 0, stays 0 (both complex kernels); 2 I
    freezes after one iteration with x = b / 2."""
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
        xk, hk = wrap(offs, vals, b, torch.zeros_like(b), 8)
        h = hk[:, 0].cpu().numpy()
        assert h[1] < 1e-5 * h[0] and np.all(h[1:] == h[1])
        assert torch.allclose(xk, b / 2.0, atol=1e-6)


def test_api_cg_launches_each_dia_kernel(dev):
    """The entry points on the card: real band -> streaming real kernel,
    the mhd geometry -> fused kernel, a complex band past the fused rule
    -> streaming complex kernel; an unstructured matrix and routing=
    raise."""
    import scipy.sparse as sp
    from tpcg_torch.problems import banded_complex
    counters = (tsd.stream_cg_dia_rows, tfd.fused_cg_dia_rows_cplx,
                tsd.stream_cg_dia_rows_cplx)
    cases = [(banded_complex(777, (0, 1, 3, 40)).real.astype(np.float32),
              tsd.stream_cg_dia_rows),
             (banded_complex(1280, tuple(range(0, 9)), seed=2)
              .astype(np.complex64), tfd.fused_cg_dia_rows_cplx),
             (banded_complex(1280, tuple(range(0, 13)), seed=2)
              .astype(np.complex64), tsd.stream_cg_dia_rows_cplx)]
    for A, expect in cases:
        A = sp.csr_matrix(A)
        n = A.shape[0]
        b = np.ones(2 * n, dtype=A.dtype)
        before = [c.launches for c in counters]
        x = tpcg_torch.cg(n, A.nnz, A.data, b, A.indptr, A.indices,
                          n_rhs=2, n_iterations=60, device=dev)
        moved = [c for c, b0 in zip(counters, before) if c.launches != b0]
        assert moved == [expect] and expect.launches == before[
            counters.index(expect)] + 1
        res = A.astype(np.complex128) @ x[:n] - b[:n]
        assert np.linalg.norm(res) <= 1e-3 * np.linalg.norm(b[:n])
    rng = np.random.default_rng(11)
    R = sp.csr_matrix((rng.standard_normal(400), (np.repeat(np.arange(100), 4),
                       rng.integers(0, 100, 400))), shape=(100, 100))
    R = sp.csr_matrix(R + R.T + 8 * sp.eye(100), dtype=np.float32)
    bR = np.ones(100, np.float32)
    with pytest.raises(NotImplementedError, match="item 13"):
        tpcg_torch.cg(100, R.nnz, R.data, bR, R.indptr, R.indices,
                      n_iterations=5, device=dev)
    with pytest.raises(NotImplementedError, match="item 13"):
        tpcg_torch.cg_matrix(R, bR, n_iterations=5, routing="tables.npz",
                             device=dev)
