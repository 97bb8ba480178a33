"""tpcg_torch.api against tpcg.api on the CPU, and the card branch of the
port's dispatch forced on the CPU.

On the CPU both packages run eager block CG on the same DIA / ELL
container in the operands' dtype, so float64 results agree to rtol 1e-9
(summation order only).  The card branch is forced by patching the port's
one device predicate, ``api._on_card``, as tests/test_stream_cg_dia_cplx.py
forces JAX's backend: the kernels' wrappers then get CPU tensors and run
their plain versions, and a spy records which wrapper ran.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import tpcg
import tpcg_torch
from tpcg.problems import helm_fe
from tpcg_torch import api
from tpcg_torch.ops import fused_cg_dia as tfd
from tpcg_torch.ops import route_spmv as trs
from tpcg_torch.ops import stream_cg_dia as tsd


def spd(n=40, seed=0):
    """tests/test_api.py::spd."""
    Q = sp.random(n, n, density=0.1, random_state=seed, format="csr")
    return sp.csr_matrix(Q @ Q.T + sp.eye(n) * n)


def csr_args(A):
    return A.nnz, A.data, A.indptr, A.indices


def banded_cplx_sym(n, half_band, seed=0):
    """tests/test_stream_cg_dia_cplx.py::banded_cplx_sym."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    offs = [0] + [o for k in range(1, half_band + 1) for o in (k, -k)]
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        if off == 0:
            v = np.full(len(i), 4.0 * half_band + 0.0j) \
                + 0.5j * rng.standard_normal(len(i))
        else:
            v = (rng.standard_normal(len(i))
                 + 1j * rng.standard_normal(len(i))) * 0.2
        rows.append(i)
        cols.append(i + off)
        vals.append(v.astype(np.complex64))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def test_cg_csr_single_rhs():
    A = spd()
    b = np.random.default_rng(1).standard_normal(40)
    xj = tpcg.cg(40, *csr_args(A)[:2], b, *csr_args(A)[2:], n_iterations=30)
    xt = tpcg_torch.cg(40, *csr_args(A)[:2], b, *csr_args(A)[2:],
                       n_iterations=30, device="cpu")
    assert xt.dtype == np.float64
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-9)


def test_cg_column_major_multi_rhs():
    A = spd(36, seed=2)
    n, nrhs = 36, 3
    b = np.zeros(n * nrhs)
    for r in range(nrhs):
        b[r * n:(r + 1) * n] = (r + 1) * 5.0
    nnz, data, ptr, idx = csr_args(A)
    xj, hj = tpcg.cg(n, nnz, data, b, ptr, idx, n_rhs=nrhs, n_iterations=25,
                     record_history=True)
    xt, ht = tpcg_torch.cg(n, nnz, data, b, ptr, idx, n_rhs=nrhs,
                           n_iterations=25, record_history=True, device="cpu")
    assert xt.shape == (n * nrhs,) and ht.shape == (26, nrhs)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-9)
    # these constant RHS converge to ~1e-33 by iteration 25: below 1e-12
    # of hist[0] the history is float64 rounding noise of either order
    hj = np.asarray(hj)
    np.testing.assert_allclose(ht, hj, rtol=1e-9, atol=1e-12 * hj[0].max())


def test_cg_complex_helm_fe():
    A = helm_fe(N=8, k=4.0, eps=4.0).to_scipy()
    n = 64
    b = (np.random.default_rng(3).standard_normal(n)
         + 1j * np.random.default_rng(4).standard_normal(n))
    nnz, data, ptr, idx = csr_args(A)
    xj, hj = tpcg.cg(n, nnz, data, b, ptr, idx, n_iterations=20,
                     record_history=True)
    xt, ht = tpcg_torch.cg(n, nnz, data, b, ptr, idx, n_iterations=20,
                           record_history=True, device="cpu")
    assert xt.dtype == np.complex128
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-9)
    np.testing.assert_allclose(ht, np.asarray(hj), rtol=1e-9)


def test_cg_float32_dtype():
    A = spd(32, seed=5).astype(np.float32)
    b = np.ones(32, dtype=np.float32)
    xj = tpcg.cg(32, *csr_args(A)[:2], b, *csr_args(A)[2:], n_iterations=10)
    xt = tpcg_torch.cg(32, *csr_args(A)[:2], b, *csr_args(A)[2:],
                       n_iterations=10, device="cpu")
    assert xt.dtype == np.float32 == np.asarray(xj).dtype
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-5)


def test_cg_matrix_wrapper_and_initial_guess():
    A = spd(30, seed=6)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(30)
    x0 = 0.1 * rng.standard_normal(30)
    xj = tpcg.cg_matrix(A, b, x=x0, n_iterations=20)
    xt = tpcg_torch.cg_matrix(A, b, x=x0, n_iterations=20, device="cpu")
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-9)


def test_rcm_shuffled_band_takes_the_same_perm():
    """A shuffled tridiagonal matrix: both packages reorder it with scipy's
    RCM into the same band, and cg_matrix agrees."""
    from tpcg.sparse import to_device_matrix as jtdm
    A = sp.csr_matrix(sp.diags([-np.ones(99), 4 * np.ones(100),
                                -np.ones(99)], [-1, 0, 1]))
    rng = np.random.default_rng(8)
    p = rng.permutation(100)
    Ashuf = sp.csr_matrix(A[p][:, p])
    Mj, pj = jtdm(Ashuf, reorder=True)
    Mt, pt = tpcg_torch.to_device_matrix(Ashuf, reorder=True,
                                          device="cpu")
    assert isinstance(Mt, tpcg_torch.DiaMatrix) and pt is not None
    np.testing.assert_array_equal(pt, pj)
    assert Mt.offsets == tuple(Mj.offsets)
    b = rng.standard_normal(100)
    xj = tpcg.cg_matrix(Ashuf, b, n_iterations=60)
    xt = tpcg_torch.cg_matrix(Ashuf, b, n_iterations=60, device="cpu")
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-9, atol=1e-12)


def test_unstructured_on_cpu_runs_ell_like_jax():
    rng = np.random.default_rng(11)
    n, per_row = 96, 4
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, n * per_row)
    A = sp.csr_matrix((rng.standard_normal(n * per_row) * 0.1,
                       (rows, cols)), shape=(n, n))
    A = sp.csr_matrix((A + A.T) * 0.5 + sp.eye(n) * per_row)
    # what cg asks for on the CPU (route_fallback only on a card, as JAX
    # asks only on a TPU); asked for, the routed operand comes on any device
    M, perm = tpcg_torch.to_device_matrix(A, reorder=True, device="cpu")
    assert isinstance(M, tpcg_torch.EllMatrix) and perm is None
    M, perm = tpcg_torch.to_device_matrix(A, reorder=True,
                                          route_fallback=True, device="cpu")
    assert isinstance(M, tpcg_torch.DeviceRouted) and perm is None
    b = rng.standard_normal(n)
    xj = tpcg.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:], n_iterations=30)
    xt = tpcg_torch.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:],
                       n_iterations=30, device="cpu")
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-9)


@pytest.fixture
def card_branch(monkeypatch):
    """Force the card branch of the dispatch and record which kernel
    wrapper runs (each runs its plain version on these CPU tensors)."""
    monkeypatch.setattr(api, "_on_card", lambda device: True)
    order = []
    for mod, name in ((tfd, "fused_cg_dia_cplx_block"),
                      (tsd, "stream_cg_dia_cplx_block"),
                      (tsd, "stream_cg_dia_block"),
                      (trs, "routed_matvec_block")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            order.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return order


def test_card_branch_complex_band_fused_then_streaming(card_branch,
                                                       monkeypatch):
    """The mhd geometry goes to the fused kernel; when its fit rule refuses,
    to the streaming complex kernel; solutions match scipy."""
    n, iters, nrhs = 1280, 40, 2
    As = banded_cplx_sym(n, 4, seed=8)
    rng = np.random.default_rng(9)
    B = (rng.standard_normal((n, nrhs))
         + 1j * rng.standard_normal((n, nrhs))).astype(np.complex64)
    b = B.T.reshape(-1)
    x = tpcg_torch.cg(n, *csr_args(As)[:2], b, *csr_args(As)[2:],
                      n_rhs=nrhs, n_iterations=iters, device="cpu")
    assert card_branch == ["fused_cg_dia_cplx_block"]
    assert x.dtype == np.complex64
    X = x.reshape(nrhs, n).T
    for c in range(nrhs):
        xs = spla.spsolve(As.astype(np.complex128).tocsc(),
                          B[:, c].astype(np.complex128))
        np.testing.assert_allclose(X[:, c], xs, rtol=0,
                                   atol=1e-3 * np.abs(xs).max())
    card_branch.clear()
    monkeypatch.setattr(tfd, "fused_dia_cplx_fits", lambda *a, **k: False)
    x2 = tpcg_torch.cg_matrix(As, b, n_iterations=iters, device="cpu")
    assert card_branch == ["stream_cg_dia_cplx_block"]
    np.testing.assert_allclose(x2, x, rtol=0, atol=2e-4 * np.abs(x).max())


def test_card_branch_real_band_streaming(card_branch):
    n, iters, nrhs = 2000, 60, 2
    rng = np.random.default_rng(6)
    As = sp.csr_matrix(banded_cplx_sym(n, 4, seed=5).real).astype(np.float32)
    b = rng.standard_normal(n * nrhs).astype(np.float32)
    x = tpcg_torch.cg(n, *csr_args(As)[:2], b, *csr_args(As)[2:],
                      n_rhs=nrhs, n_iterations=iters, device="cpu")
    assert card_branch == ["stream_cg_dia_block"]
    assert x.dtype == np.float32
    X, B = x.reshape(nrhs, n).T, b.reshape(nrhs, n).T
    for c in range(nrhs):
        xs = spla.spsolve(As.astype(np.float64).tocsc(),
                          B[:, c].astype(np.float64))
        np.testing.assert_allclose(X[:, c], xs, rtol=0,
                                   atol=1e-3 * np.abs(xs).max())


def test_card_branch_float64_and_complex_rhs_stay_eager(card_branch):
    """float64, and a real matrix with a complex RHS, take the eager path
    on the card, where JAX also takes XLA; no kernel wrapper runs."""
    n = 300
    As = sp.csr_matrix(banded_cplx_sym(n, 2, seed=1).real, dtype=np.float64)
    b = np.random.default_rng(2).standard_normal(n)
    x = tpcg_torch.cg(n, *csr_args(As)[:2], b, *csr_args(As)[2:],
                      n_iterations=30, device="cpu")
    bc = (b + 1j * b[::-1]).astype(np.complex64)
    xc = tpcg_torch.cg_matrix(As.astype(np.float32), bc, n_iterations=30,
                              device="cpu")
    assert card_branch == []
    assert x.dtype == np.float64 and xc.dtype == np.complex64
    xs = spla.spsolve(As.tocsc(), bc.astype(np.complex128))
    np.testing.assert_allclose(xc, xs, rtol=0, atol=1e-3 * np.abs(xs).max())


def test_card_branch_refuses_unstructured_and_routing(card_branch,
                                                     monkeypatch, tmp_path):
    """The card branch no longer refuses an unstructured matrix or
    routing=: real, complex and routed solves all run through the CSR
    kernel's wrapper (its plain version on these CPU tensors), never the
    ELL gather, and match scipy; an EllMatrix container given to cg_matrix
    runs through it too."""
    from tpcg_torch.ops.routing import build_routing_spmv

    def no_gather(*a, **k):
        raise AssertionError("the ELL gather ran on the card branch")
    monkeypatch.setattr(tpcg_torch.EllMatrix, "matvec", no_gather)
    rng = np.random.default_rng(11)
    n, per_row = 96, 4
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, n * per_row)
    A = sp.csr_matrix((rng.standard_normal(n * per_row) * 0.1,
                       (rows, cols)), shape=(n, n))
    A = sp.csr_matrix((A + A.T) * 0.5 + sp.eye(n) * per_row,
                      dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xs = spla.spsolve(A.astype(np.float64).tocsc(), b.astype(np.float64))
    R = build_routing_spmv(A)
    path = str(tmp_path / "tables.npz")
    R.save(path)
    E = tpcg_torch.EllMatrix.from_scipy(A, device="cpu")
    for solve in (lambda: tpcg_torch.cg(n, *csr_args(A)[:2], b,
                                        *csr_args(A)[2:], n_iterations=40,
                                        device="cpu"),
                  lambda: tpcg_torch.cg_matrix(A.astype(np.complex64), b,
                                               n_iterations=40, device="cpu"),
                  lambda: tpcg_torch.cg(n, *csr_args(A)[:2], b,
                                        *csr_args(A)[2:], n_iterations=40,
                                        routing=path, device="cpu"),
                  lambda: tpcg_torch.cg_matrix(E, b, n_iterations=40)):
        x = solve()
        assert set(card_branch) == {"routed_matvec_block"}
        card_branch.clear()
        np.testing.assert_allclose(x, xs, rtol=0,
                                   atol=1e-3 * np.abs(xs).max())
    M, _ = tpcg_torch.to_device_matrix(A, route_fallback=True, device="cpu")
    assert isinstance(M, tpcg_torch.DeviceRouted)


_DEFAULTS = {
    "cg": lambda **kw: tpcg_torch.cg(30, *csr_args(spd(30))[:2], np.ones(30),
                                     *csr_args(spd(30))[2:], n_iterations=3,
                                     **kw),
    "cg_matrix": lambda **kw: tpcg_torch.cg_matrix(spd(30), np.ones(30),
                                                   n_iterations=3, **kw),
    "helm_fe": lambda **kw: tpcg_torch.problems.helm_fe(8, 3.0, eps=3.0, **kw),
    "helm_fe_var": lambda **kw: tpcg_torch.problems.helm_fe_var(
        8, 3.0, np.ones((7, 7)), rho=0.1, **kw),
    "local_rect": lambda **kw: tpcg_torch.problems.local_rect(
        8, 3.0, 3.0, eta=3.0, Nvert=5, Nhoriz=8, **kw),
    "assemble_helmholtz_fe": lambda **kw:
        tpcg_torch.problems.assemble_helmholtz_fe(
            0.1, np.full((4, 4), 9.0 + 1j), np.full((4, 4), 3.0), **kw),
    "poisson": lambda **kw: tpcg_torch.problems.poisson(8, **kw),
    "parabolic_stencil": lambda **kw:
        tpcg_torch.problems.parabolic_stencil(8, **kw),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULTS))
def test_default_device_is_the_card(monkeypatch, entry):
    """The entry points and the problem constructors default to the CUDA
    device: without a card, a call that names no device raises and returns
    no CPU result; with ``device="cpu"`` it runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULTS[entry]()
    out = _DEFAULTS[entry](device="cpu")
    if entry.startswith("cg"):
        assert isinstance(out, np.ndarray) and np.isfinite(out).all()
    else:
        assert out.device.type == "cpu"


_CONSTRUCTORS = {
    "to_device_matrix": lambda **kw: tpcg_torch.to_device_matrix(spd(30),
                                                                 **kw),
    "DiaMatrix.from_scipy": lambda **kw: tpcg_torch.DiaMatrix.from_scipy(
        spd(30), **kw),
    "EllMatrix.from_scipy": lambda **kw: tpcg_torch.EllMatrix.from_scipy(
        spd(30), **kw),
    "EllMatrix.from_csr_arrays": lambda **kw:
        tpcg_torch.EllMatrix.from_csr_arrays(30, *_csr_parts(spd(30)), **kw),
    "to_planes": lambda **kw: tpcg_torch.ops.cplx.to_planes(
        np.ones(6) + 1j, **kw),
}


def _csr_parts(A):
    A = sp.csr_matrix(A)
    return A.data, A.indptr, A.indices


@pytest.mark.parametrize("ctor", sorted(_CONSTRUCTORS))
def test_constructor_default_device_is_the_card(monkeypatch, ctor):
    """The containers' constructors and ``to_planes`` default to the CUDA
    device as the entry points do: without a card, a call that names no
    device raises and is not moved to the CPU silently; with
    ``device="cpu"`` it builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _CONSTRUCTORS[ctor]()
    out = _CONSTRUCTORS[ctor](device="cpu")
    assert out.device.type == "cpu"
