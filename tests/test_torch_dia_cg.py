"""The plain versions of the port's banded-DIA kernels against the JAX
kernels (Pallas in interpret mode, as the JAX tests run them on the CPU),
and the port alone against the JAX tests' freeze contracts.

Tolerances (those of tests/test_fused_cg_dia.py:78-101, where the JAX
package holds its two complex DIA kernels against each other): residual
histories on their live entries (h > 1e-6 h[0], the f32-meaningful range;
these diagonally dominant systems underflow mid-run, and two summation
orders cross that boundary an iteration apart) within rel 1e-3, and x
within 1e-4 max|x|.  Both sides are float32 with different summation
orders, so they agree to rounding, not bit for bit.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpcg.ops.fused_cg_dia as jfd
import tpcg.ops.stream_cg_dia as jsd
from tpcg.sparse import DiaMatrix as JDia
from tpcg_torch.ops import _tiles
from tpcg_torch.sparse import DiaMatrix

tfd = importlib.import_module("tpcg_torch.ops.fused_cg_dia")
tsd = importlib.import_module("tpcg_torch.ops.stream_cg_dia")

# (n, offsets) of tests/test_fused_cg_dia.py: the mhd1280b geometry, a
# wrap-depth-2 band at odd n, and a band wider than half the matrix
CASES = [(1280, tuple(range(0, 9))), (777, (0, 1, 3, 40)), (300, (0, 2, 150))]
ITERS = 40


def banded_complex(n, offs, seed=0):
    """tests/test_fused_cg_dia.py::_banded_complex: complex symmetric,
    diagonally dominant."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        v = ((rng.standard_normal(len(i))
              + 1j * rng.standard_normal(len(i))) * 0.1
             if off else np.full(len(i), 2.0 * len(offs) + 0.5j))
        rows.append(i)
        cols.append(i + off)
        vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return (A + A.T) * 0.5


def banded_real(n, offs, seed=0):
    """The real part of :func:`banded_complex`, symmetric positive definite
    (diagonal 2 ndiag against off-diagonals of 0.1 N(0, 1))."""
    return sp.csr_matrix(banded_complex(n, offs, seed).real)


def both(A, dtype):
    """One scipy matrix as the JAX and the port DiaMatrix."""
    A = sp.csr_matrix(A.astype(dtype))
    return JDia.from_scipy(A), DiaMatrix.from_scipy(A, device="cpu")


def cvec(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def assert_close(xt, ht, xj, hj):
    xt, ht = np.asarray(xt), np.asarray(ht)
    xj, hj = np.asarray(xj), np.asarray(hj)
    assert ht.shape == hj.shape and xt.shape == xj.shape
    assert np.isfinite(ht).all() and np.isfinite(xt).all()
    live = hj > 1e-6 * hj[0]
    assert live.sum() >= 4
    rel = np.abs(ht[live] - hj[live]) / hj[live]
    assert rel.max() < 1e-3, rel.max()
    assert np.abs(xt - xj).max() < 1e-4 * np.abs(xj).max()


@pytest.mark.parametrize("n,offs", CASES)
def test_fused_dia_cplx_matches_jax(n, offs):
    J, T = both(banded_complex(n, offs, seed=2), np.complex64)
    b = cvec(np.random.default_rng(1), n)
    xj, hj = jfd.fused_cg_dia_cplx(J, b, n_iterations=ITERS, interpret=True)
    xt, ht = tfd.fused_cg_dia_cplx(T, b, n_iterations=ITERS)
    assert xt.dtype == torch.complex64
    assert_close(xt, ht, xj, hj)


@pytest.mark.parametrize("n,offs", CASES)
def test_stream_dia_cplx_matches_jax(n, offs):
    J, T = both(banded_complex(n, offs, seed=3), np.complex64)
    rng = np.random.default_rng(4)
    b, x0 = cvec(rng, n), 0.1 * cvec(rng, n)
    xj, hj = jsd.stream_cg_dia_cplx(J, b, x0=x0, n_iterations=ITERS,
                                    interpret=True)
    xt, ht = tsd.stream_cg_dia_cplx(T, b, x0=x0, n_iterations=ITERS)
    assert_close(xt, ht, xj, hj)


@pytest.mark.parametrize("n,offs,nrhs", [(1280, tuple(range(0, 9)), 1),
                                         (777, (0, 1, 3, 40), 3),
                                         (300, (0, 2, 150), 1)])
def test_stream_dia_block_matches_jax(n, offs, nrhs):
    """Real kernel, a single RHS and an nb=3 batch (one value fetch for
    three RHS in both packages)."""
    J, T = both(banded_real(n, offs, seed=5), np.float32)
    B = np.random.default_rng(6).standard_normal((n, nrhs)).astype(
        np.float32)
    Xj, Hj = jsd.stream_cg_dia_block(J, B, n_iterations=ITERS,
                                     interpret=True)
    Xt, Ht = tsd.stream_cg_dia_block(T, B, n_iterations=ITERS)
    assert Xt.dtype == torch.float32
    for c in range(nrhs):
        assert_close(Xt[:, c], Ht[:, c], np.asarray(Xj)[:, c],
                     np.asarray(Hj)[:, c])


def test_stream_dia_ragged_rhs_count():
    """Nine RHS where a launch takes eight: JAX pads its tail block with
    zero RHS; the port splits into balanced chunks 5 + 4 and pads nothing.
    Every column agrees with JAX and with its single-RHS solve."""
    n, offs, nrhs = 777, (0, 1, 3, 40), 9
    J, T = both(banded_real(n, offs, seed=7), np.float32)
    B = np.random.default_rng(8).standard_normal((n, nrhs)).astype(
        np.float32)
    assert list(tsd._balanced(nrhs, 8)) == [(0, 5), (5, 9)]
    assert list(tsd._balanced(5, 2)) == [(0, 2), (2, 4), (4, 5)]
    Xj, Hj = jsd.stream_cg_dia_block(J, B, n_iterations=ITERS,
                                     interpret=True)
    offsets, values = tsd.prepare_dia_rows(T)
    b = torch.from_numpy(B.T.copy())
    Xt, Ht = tsd.stream_cg_dia_rows(offsets, values, b, torch.zeros_like(b),
                                    ITERS)
    assert Xt.shape == (nrhs, n) and Ht.shape == (ITERS + 1, nrhs)
    for c in range(nrhs):
        assert_close(Xt[c], Ht[:, c], np.asarray(Xj)[:, c],
                     np.asarray(Hj)[:, c])
        xs, hs = tsd.stream_cg_dia(T, B[:, c], n_iterations=ITERS)
        np.testing.assert_allclose(Xt[c].numpy(), xs.numpy(), rtol=0,
                                   atol=1e-6 * np.abs(xs.numpy()).max())


def test_fused_dia_fit_rule_this_card():
    """mhd1280b geometry fits one block's shared memory (about 174 KB of
    values and 31 KB of state); 25 diagonals at the same n do not, nor does
    a row count past the kernel's 8 rows per thread."""
    from types import SimpleNamespace
    mhd = SimpleNamespace(n=1280, offsets=tuple(range(-8, 9)))
    need = tfd.fused_dia_smem_bytes(mhd.n, mhd.offsets)
    assert need == 4 * (2 * 17 * 1280 + 4 * 1280 + 2 * (1280 + 16)) \
        + 4 * 17 + 512
    assert need <= _tiles.BLOCK_SHARED == 232_448
    assert tfd.fused_dia_cplx_fits(mhd)
    assert not tfd.fused_dia_cplx_fits(
        SimpleNamespace(n=1280, offsets=tuple(range(-12, 13))))
    assert not tfd.fused_dia_cplx_fits(SimpleNamespace(n=9000, offsets=(0,)))


def test_stream_dia_fit_rule_this_card():
    """The Fig. 5 banded classes fit the streaming kernels; more diagonals
    than the kernel's shared-memory tap list, or a padded direction past
    32-bit indices, do not."""
    from types import SimpleNamespace
    mt1 = SimpleNamespace(n=97578, offsets=tuple(
        [0] + [o for k in range(1, 51) for o in (37 * k, -37 * k)]))
    para = SimpleNamespace(n=525625, offsets=(0, 1, -1, 725, -725, 726,
                                              -726))
    mhd = SimpleNamespace(n=1280, offsets=tuple(range(-8, 9)))
    assert tsd.dia_stream_fits(mt1) and tsd.dia_stream_fits(para)
    assert tsd.dia_stream_cplx_fits(mhd)
    assert not tsd.dia_stream_fits(
        SimpleNamespace(n=100_000, offsets=tuple(range(4097))))
    assert tsd.dia_stream_fits(
        SimpleNamespace(n=2**31 - 101, offsets=tuple(range(-50, 51))))
    assert not tsd.dia_stream_fits(
        SimpleNamespace(n=2**31 - 100, offsets=tuple(range(-50, 51))))
    assert not tsd.dia_stream_cplx_fits(
        SimpleNamespace(n=2**31, offsets=(0,)))


def test_fused_dia_denormal_freeze():
    """tests/test_fused_cg_dia.py::test_fused_dia_denormal_freeze on the
    port alone: 400 iterations of a weakly dominant band that converges
    below the f32 |delta|^2 range; the history stays finite, and once it
    reads zero it stays zero.  The streaming complex kernel's plain version
    tracks it on the live entries."""
    n = 1280
    A = banded_complex(n, tuple(range(0, 9)), seed=2)
    A = A - sp.eye(n) * (A.diagonal()[0] - (1.2 + 0.25j) * 2) * 0.5
    T = DiaMatrix.from_scipy(sp.csr_matrix(A.astype(np.complex64)),
                             device="cpu")
    b = cvec(np.random.default_rng(4), n)
    x, hist = tfd.fused_cg_dia_cplx(T, b, n_iterations=400)
    hist = hist.numpy()
    assert np.isfinite(hist).all() and torch.isfinite(x).all()
    z = np.where(hist == 0)[0]
    assert len(z) and np.all(hist[z[0]:] == 0.0)
    xs, hs = tsd.stream_cg_dia_cplx(T, b, n_iterations=400)
    hs = hs.numpy()
    assert np.isfinite(hs).all() and torch.isfinite(xs).all()
    live = hs > 1e-6 * hs[0]
    assert np.max(np.abs(hist[live] - hs[live]) / hs[live]) < 1e-3


def test_identity_freezes_after_one_iteration():
    """tests/test_fused_cg_dia.py::test_fused_dia_converged_freeze: 2 I
    converges in one iteration; the history then stays at its value and x
    at b / 2, in both complex kernels' plain versions."""
    n = 256
    T = DiaMatrix.from_scipy(sp.eye(n, dtype=np.complex64, format="csr")
                             * (2.0 + 0.0j), device="cpu")
    b = np.ones(n, np.complex64)
    for solve in (tfd.fused_cg_dia_cplx, tsd.stream_cg_dia_cplx):
        x, hist = solve(T, b, n_iterations=8)
        hist = hist.numpy()
        assert hist[1] < 1e-5 * hist[0]
        assert np.all(hist[1:] == hist[1])
        np.testing.assert_allclose(x.numpy(), b / 2.0, atol=1e-6)


def test_stream_dia_x0_and_freeze():
    """tests/test_stream_cg_dia.py::test_stream_dia_x0_and_freeze's real
    case on the port: nonzero x0, 120 iterations far past convergence;
    everything finite and the f64 residual below 1e-5."""
    n, iters = 2000, 120
    rng = np.random.default_rng(0)
    offs = [0] + [o for k in range(1, 4) for o in (k, -k)]
    rows, cols, vals = [], [], []
    for off in offs:                        # tests/test_stream_cg_dia.py
        i = np.arange(max(0, -off), min(n, n - off))      # ::banded_spd
        rows.append(i)
        cols.append(i + off)
        vals.append(np.full(len(i), 12.0) if off == 0
                    else rng.standard_normal(len(i)) * 0.3)
    As = sp.csr_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, n))
    As = ((As + As.T) * 0.5).tocsr()
    T = DiaMatrix.from_scipy(As.astype(np.float32), device="cpu")
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n).astype(np.float32)
    x0 = 0.1 * rng.standard_normal(n).astype(np.float32)
    x, h = tsd.stream_cg_dia(T, b, x0=x0, n_iterations=iters)
    assert torch.isfinite(h).all() and torch.isfinite(x).all()
    r = np.linalg.norm(As @ x.numpy().astype(np.float64) - b) \
        / np.linalg.norm(b)
    assert r < 1e-5, r
    # a frozen RHS holds its delta: the history is constant from the freeze
    h = h.numpy()
    z = np.where(np.diff(h) == 0)[0]
    assert len(z) and np.all(h[z[0]:] == h[z[0]])


def test_zero_rhs_column_freezes_at_zero():
    """A zero RHS with a zero guess has delta0 == 0: the column freezes at
    once, beside a live column, in both kernels' plain versions."""
    n = 300
    Tr = DiaMatrix.from_scipy(banded_real(n, (0, 2, 150)).astype(np.float32),
                              device="cpu")
    B = np.zeros((n, 2), np.float32)
    B[:, 0] = 1.0
    X, H = tsd.stream_cg_dia_block(Tr, B, n_iterations=30)
    assert (X[:, 1] == 0).all() and (H[:, 1] == 0).all()
    assert H[0, 0] > 0 and torch.isfinite(X).all()
    Tc = DiaMatrix.from_scipy(
        sp.csr_matrix(banded_complex(n, (0, 2, 150)).astype(np.complex64)),
        device="cpu")
    Bc = B.astype(np.complex64)
    for solve in (tfd.fused_cg_dia_cplx_block, tsd.stream_cg_dia_cplx_block):
        X, H = solve(Tc, Bc, n_iterations=30)
        assert (X[:, 1] == 0).all() and (H[:, 1] == 0).all()
        assert torch.isfinite(X).all() and H[0, 0] > 0


def latch_system():
    """A real indefinite tridiagonal system on which float32 CG is exact:
    diagonal (-1, -1, 1, 1), off-diagonals (1, -1, 1), b = (1, 1, 1, 2),
    x0 = 0 (found by a search over small integer bands).  Every value of
    the recurrence is a short dyadic fraction, so any order of the sums
    gives the same bits.  At iteration 2 <d, A d> is exactly 0 while
    delta is not, and d is not r; for d = r, <r, A r> is not 0."""
    A = sp.diags([[1.0, -1.0, 1.0], [-1.0, -1.0, 1.0, 1.0], [1.0, -1.0, 1.0]],
                 [-1, 0, 1], format="csr")
    return A, np.array([1.0, 1.0, 1.0, 2.0])


@pytest.mark.parametrize("cplx", [False, True])
def test_freeze_latch_resumes_every_256_iterations_as_jax(cplx):
    """Kernel A's freeze latch against JAX's, over 600 iterations: both
    freeze at iteration 2 (<d, q> == 0, delta not 0), hold until the
    iteration-256 call boundary, restart from d = r there, and reach r = 0
    exactly at iteration 260 (x = (0, 1, -2, 4)), where they freeze for
    good.  Exact arithmetic on both sides: x and the history are equal."""
    A, b = latch_system()
    dtype = np.complex64 if cplx else np.float32
    Aj, At = both(A, dtype)
    bb = b.astype(dtype)
    if cplx:
        xj, hj = jsd.stream_cg_dia_cplx(Aj, bb, n_iterations=600,
                                        interpret=True)
        xt, ht = tsd.stream_cg_dia_cplx(At, bb, n_iterations=600)
    else:
        xj, hj = jsd.stream_cg_dia(Aj, bb, n_iterations=600, interpret=True)
        xt, ht = tsd.stream_cg_dia(At, bb, n_iterations=600)
    xj, hj, xt, ht = (np.asarray(v) for v in (xj, hj, xt, ht))
    np.testing.assert_array_equal(xt, np.array([0.0, 1.0, -2.0, 4.0]))
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(ht, hj)
    assert np.all(ht[:257] == ht[0]) and ht[257] != ht[0]
    assert np.all(ht[260:] == 0) and ht[259] > 0


def test_freeze_latch_in_a_batch_as_jax():
    """The latch system as two columns, b and 2 b, through the batched
    entry points (JAX's fat batch kernel, the port's batched plain
    version), 600 iterations: each column freezes at iteration 2 and
    resumes at 256 on its own flag, as in JAX; exact, so equal."""
    A, b = latch_system()
    Aj, At = both(A, np.float32)
    B = np.stack([b, 2.0 * b], axis=1).astype(np.float32)
    xj, hj = jsd.stream_cg_dia_block(Aj, B, n_iterations=600, interpret=True)
    xt, ht = tsd.stream_cg_dia_block(At, B, n_iterations=600)
    xj, hj, xt, ht = (np.asarray(v) for v in (xj, hj, xt, ht))
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(xt[:, 1], 2.0 * xt[:, 0])
    np.testing.assert_array_equal(xt[:, 0], [0.0, 1.0, -2.0, 4.0])
