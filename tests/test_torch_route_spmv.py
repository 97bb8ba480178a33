"""tpcg_torch's unstructured-matrix slice against JAX's routing-network path.

The host tables (``tpcg_torch.ops.routing``) are copies of JAX's numpy code
and must give its arrays bit for bit; tables written by either package load
in the other.  The device product (``tpcg_torch.ops.route_spmv``) runs its
plain version on these CPU tensors and is held to JAX's routed kernel in
Pallas interpret mode (as tests/test_routing.py runs it) within
1e-5 max|y|: the two sum a row's products in different orders.  The slice
end to end forces the card branch (``api._on_card`` patched, as
tests/test_torch_api.py does) against ``tpcg.cg`` / ``cg_matrix`` with
``jax.default_backend`` patched to "tpu" (the pattern of tests/test_api.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpcg
import tpcg.api as japi
from tpcg.ops import routing as jr
from tpcg.ops.cplx import to_planes as jto_planes
from tpcg.ops.route_spmv import DeviceRouted as JDeviceRouted
from tpcg.ops.route_spmv import pack_masks as jpack
from tpcg.ops.route_spmv import routed_pair as jrouted_pair
import tpcg_torch
from tpcg_torch import api
from tpcg_torch.convert import routed_from_tpcg
from tpcg_torch.ops import route_spmv as trs
from tpcg_torch.ops import routing as tr


def _unstructured(n, per_row, seed, cplx=False, spd=False):
    """per_row random columns a row (tests/test_api.py's construction);
    ``spd``: symmetrised and made diagonally dominant."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, n * per_row)
    v = rng.standard_normal(n * per_row) * 0.1
    if cplx:
        v = v + 1j * rng.standard_normal(n * per_row) * 0.1
    A = sp.csr_matrix((v, (rows, cols)), shape=(n, n))
    if spd:
        A = (A + A.T) * 0.5 + sp.eye(n) * (per_row + (0.5j if cplx else 0))
    return sp.csr_matrix(A).astype(np.complex64 if cplx else np.float32)


@pytest.fixture
def on_tpu(monkeypatch):
    """JAX's accelerator branch on the CPU (its kernel in interpret mode),
    and the port's card branch (its plain version)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(api, "_on_card", lambda device: True)


# ---- host tables ----

@pytest.mark.parametrize("m", [2, 8, 64, 512])
def test_benes_masks_match_jax(m):
    rng = np.random.default_rng(m)
    for _ in range(3):
        perm = rng.permutation(m)
        masks = tr.benes_masks(perm)
        np.testing.assert_array_equal(masks, jr.benes_masks(perm))
        x = np.arange(m)
        np.testing.assert_array_equal(tr.apply_benes_numpy(masks, x),
                                      x[perm])
    assert tr.benes_strides(m) == jr.benes_strides(m)


@pytest.mark.parametrize("n,per_row,cplx", [(300, 7, False), (130, 5, True)])
def test_layers_and_numpy_tables_match_jax(n, per_row, cplx):
    A = sp.coo_matrix(_unstructured(n, per_row, seed=n, cplx=cplx))
    rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
    for (tr_rows, tr_idx), (jr_rows, jr_idx) in zip(
            tr.assign_layers(rows, cols, n, seed=3),
            jr.assign_layers(rows, cols, n, seed=3), strict=True):
        np.testing.assert_array_equal(tr_rows, jr_rows)
        np.testing.assert_array_equal(tr_idx, jr_idx)
    R = tr.build_routing_spmv(A, native=False)
    J = jr.build_routing_spmv(A, native=False)
    assert R.n == J.n and R.vals.dtype == J.vals.dtype
    np.testing.assert_array_equal(R.masks, J.masks)
    np.testing.assert_array_equal(R.vals, J.vals)


def test_pack_unpack_round_trip():
    A = _unstructured(200, 4, seed=2)
    masks = tr.build_routing_spmv(A, native=False).masks
    packed = tr.pack_masks(masks)
    np.testing.assert_array_equal(packed, jpack(masks))
    back = tr.unpack_masks(packed, tr.benes_strides(masks.shape[2]))
    np.testing.assert_array_equal(back, masks)


def test_tables_load_in_either_package(tmp_path):
    A = _unstructured(180, 5, seed=6, cplx=True)
    R = tr.build_routing_spmv(A)
    R.save(str(tmp_path / "port.npz"))
    J = jr.RoutedSpmv.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(J.masks, R.masks)
    np.testing.assert_array_equal(J.vals, R.vals)
    jr.build_routing_spmv(A).save(str(tmp_path / "jax.npz"))
    T = tr.RoutedSpmv.load(str(tmp_path / "jax.npz"))
    J = jr.RoutedSpmv.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(T.masks, J.masks)
    assert T.n == J.n == 180
    x = np.random.default_rng(0).standard_normal(180)
    np.testing.assert_allclose(T.matvec_numpy(x), A @ x, rtol=1e-5,
                               atol=1e-5 * np.abs(A @ x).max())


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("cplx", [False, True])
def test_routed_to_csr_gives_back_the_matrix(native, cplx):
    from tpcg_torch.native import routing_native
    if native and not routing_native.available():
        pytest.skip("g++ build of tpcg/native/routing_builder.cpp failed")
    A = _unstructured(333, 6, seed=9, cplx=cplx)
    A.sum_duplicates()
    C = tr.routed_to_csr(tr.build_routing_spmv(A, native=native))
    assert C.dtype == A.dtype and C.shape == A.shape
    assert (C != A).nnz == 0


# ---- the device product ----

@pytest.mark.parametrize("n", [50, 400, 500])
@pytest.mark.parametrize("nrhs", [1, 3, 6])
def test_plain_matvec_matches_jax_kernel(n, nrhs):
    """n=50 lies below one 128-lane row of JAX's routed vector."""
    A = _unstructured(n, 5, seed=n)
    J = JDeviceRouted(jr.build_routing_spmv(A), interpret=True)
    X = np.random.default_rng(nrhs).standard_normal(
        (n, nrhs)).astype(np.float32)
    want = np.asarray(J.matvec(jnp.asarray(X)))
    D = tpcg_torch.DeviceRouted.from_scipy(A, device="cpu")
    got = D.matvec(torch.from_numpy(X)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, nrhs)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cplx", [True, False])
def test_planes_operator_matches_jax_routed_pair(cplx):
    """Complex values: one launch of the complex instance against JAX's
    three Karatsuba passes; real values with complex planes: the real
    instance on 2 nrhs columns against JAX's real_only pair."""
    n, nrhs = 260, 3
    A = _unstructured(n, 6, seed=4, cplx=cplx)
    R = jr.build_routing_spmv(A)
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((n, nrhs))
         + 1j * rng.standard_normal((n, nrhs))).astype(np.complex64)
    want = np.asarray(jrouted_pair(R, interpret=True).matvec(jto_planes(X)))
    P = trs.routed_pair(tr.RoutedSpmv(R.masks, R.vals, R.n), device="cpu")
    got = P.matvec(torch.from_numpy(np.stack([X.real, X.imag]))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # a single (2, n) RHS keeps its shape
    one = P.matvec(torch.from_numpy(np.stack([X.real[:, 0], X.imag[:, 0]])))
    np.testing.assert_allclose(one.numpy(), got[..., 0], rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_plain_version_on_empty_rows_and_a_long_row():
    """Rows with no nonzero give 0; one row holds 5,000 nonzeros."""
    rng = np.random.default_rng(2)
    n = 6000
    rows = np.concatenate([np.zeros(5000, np.int64),
                           rng.integers(1, n, 3000) // 2 * 2])
    cols = rng.integers(0, n, len(rows))
    A = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, n)).astype(np.float32)
    D = tpcg_torch.DeviceRouted.from_scipy(A, device="cpu")
    X = rng.standard_normal((n, 2)).astype(np.float32)
    y = D.matvec(torch.from_numpy(X)).numpy()
    want = A.astype(np.float64) @ X
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not y[1::2].any()


@pytest.mark.parametrize("cplx", [False, True])
def test_plain_version_sums_each_row_in_order(cplx):
    """Each row is summed from 0 in the order of its nonzeros, one float32
    addition at a time, on rows of 0 to 40 nonzeros: bit for bit the
    sequential sum, written out here row by row."""
    rng = np.random.default_rng(4)
    n = 300
    lengths = rng.integers(0, 41, n)
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.integers(0, n, len(rows))
    vals = rng.standard_normal((2, len(rows))).astype(np.float32)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                               .astype(np.int32))
    col = torch.from_numpy(cols.astype(np.int32))
    x = rng.standard_normal((2, n, 3)).astype(np.float32)
    if cplx:
        y = trs.routed_matvec_plain(row_ptr, col, torch.from_numpy(vals),
                                    torch.from_numpy(x)).numpy()
    else:
        y = trs.routed_matvec_plain(row_ptr, col, torch.from_numpy(vals[0]),
                                    torch.from_numpy(x[0])).numpy()
    want = np.zeros((2, n, 3), np.float32)
    for r in range(n):
        for k in range(row_ptr[r], row_ptr[r + 1]):
            vr, vi, c = vals[0, k], vals[1, k], cols[k]
            if cplx:
                want[0, r] += vr * x[0, c] - vi * x[1, c]
                want[1, r] += vr * x[1, c] + vi * x[0, c]
            else:
                want[0, r] += vr * x[0, c]
    np.testing.assert_array_equal(y, want if cplx else want[0])


def test_wrapper_refuses_overflow_aliasing_and_bad_operands():
    D = tpcg_torch.DeviceRouted.from_scipy(_unstructured(40, 3, seed=1),
                                           device="cpu")
    x = torch.ones(40, 2)
    with pytest.raises(ValueError, match="int32"):
        trs.check_int32(2**31 - 1, 10)
    with pytest.raises(ValueError, match="int32"):
        trs.check_int32(100, 2**31)
    huge = torch.zeros(1, dtype=torch.int32).expand(2**31)
    with pytest.raises(ValueError, match="int32"):
        trs.routed_matvec_block(D.row_ptr, huge, D.val, x)
    with pytest.raises(ValueError, match="storage"):
        trs.routed_matvec_block(D.row_ptr, D.col, D.val, x, out=x)
    with pytest.raises(ValueError, match="float32"):
        trs.routed_matvec_block(D.row_ptr, D.col, D.val, x.double())
    with pytest.raises(ValueError, match="do not match"):
        trs.routed_matvec_block(D.row_ptr, D.col, D.val, torch.ones(41, 2))
    out = torch.empty(40, 2)
    y = trs.routed_matvec_block(D.row_ptr, D.col, D.val, x, out=out)
    assert y is out and torch.equal(out, D.matvec(x))


def test_routed_from_tpcg_carries_jax_operands():
    A = _unstructured(150, 4, seed=8)
    R = jr.build_routing_spmv(A)
    X = np.random.default_rng(3).standard_normal((150, 2)).astype(np.float32)
    want = A.astype(np.float64) @ X
    for obj in (R, JDeviceRouted(R, interpret=True)):
        D = routed_from_tpcg(obj)
        assert isinstance(D, tpcg_torch.DeviceRouted) and D.n == 150
        got = D.matvec(torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ---- the slice end to end, card branch forced ----

def _hist_close(ht, hj, rel):
    ht, hj = np.asarray(ht).reshape(-1), np.asarray(hj).reshape(-1)
    assert ht.shape == hj.shape
    np.testing.assert_allclose(ht, hj, rtol=rel, atol=1e-6 * hj[0])


@pytest.mark.parametrize("nrhs", [1, 3])
def test_cg_real_unstructured_matches_jax(on_tpu, nrhs):
    n = 96
    A = _unstructured(n, 4, seed=11, spd=True)
    b = np.random.default_rng(nrhs).standard_normal(n * nrhs).astype(
        np.float32)
    args = (n, A.nnz, A.data, b, A.indptr, A.indices)
    xj, hj = tpcg.cg(*args, n_rhs=nrhs, n_iterations=25,
                     record_history=True)
    xt, ht = tpcg_torch.cg(*args, n_rhs=nrhs, n_iterations=25,
                           record_history=True, device="cpu")
    assert xt.dtype == np.float32 and ht.shape == (26, nrhs)
    _hist_close(ht, hj, 1e-4)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-4 * np.abs(xj).max())


def test_cg_complex_unstructured_matches_jax(on_tpu):
    """Complex symmetric: the pre-cliff history within 5e-3 of JAX's
    (tests/test_api.py:131-134), both converged at the end."""
    n = 96
    A = _unstructured(n, 4, seed=12, cplx=True, spd=True)
    rng = np.random.default_rng(5)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    args = (n, A.nnz, A.data, b, A.indptr, A.indices)
    _, hj = tpcg.cg(*args, n_iterations=30, record_history=True)
    xt, ht = tpcg_torch.cg(*args, n_iterations=30, record_history=True,
                           device="cpu")
    h, hj = ht.reshape(-1), np.asarray(hj).reshape(-1)
    pre = hj > 1e-3 * hj[0]
    assert (np.abs(h[pre] - hj[pre]) / hj[pre]).max() < 5e-3
    assert h[-1] / h[0] < 1e-5 and hj[-1] / hj[0] < 1e-5
    assert xt.dtype == np.complex64


def test_cg_matrix_real_matrix_complex_rhs_matches_jax(on_tpu):
    n, nrhs = 96, 2
    A = _unstructured(n, 4, seed=13, spd=True)
    rng = np.random.default_rng(6)
    b = (rng.standard_normal(n * nrhs)
         + 1j * rng.standard_normal(n * nrhs)).astype(np.complex64)
    xj, hj = tpcg.cg_matrix(A, b, n_iterations=25, record_history=True)
    xt, ht = tpcg_torch.cg_matrix(A, b, n_iterations=25,
                                  record_history=True, device="cpu")
    assert xt.dtype == np.complex64
    _hist_close(ht, hj, 1e-4)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("form", ["path", "object"])
def test_routing_tables_match_jax(on_tpu, tmp_path, form):
    """routing= from a path and from a RoutedSpmv, real and complex RHS;
    to_device_matrix is not called; a size mismatch raises ValueError."""
    n = 96
    A = _unstructured(n, 4, seed=14, spd=True)
    R = tr.build_routing_spmv(A)
    path = str(tmp_path / "r.npz")
    R.save(path)
    tables = path if form == "path" else R
    jtables = path if form == "path" else jr.RoutedSpmv.load(path)

    def boom(*a, **k):
        raise AssertionError("to_device_matrix called despite routing=")
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n).astype(np.float32)
    args = (n, A.nnz, A.data, b, A.indptr, A.indices)
    xj, hj = tpcg.cg(*args, n_iterations=25, routing=jtables,
                     record_history=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "to_device_matrix", boom)
        xt, ht = tpcg_torch.cg(*args, n_iterations=25, routing=tables,
                               record_history=True, device="cpu")
        bc = (b + 1j * rng.standard_normal(n)).astype(np.complex64)
        xtc = tpcg_torch.cg_matrix(A, bc, n_iterations=25, routing=tables,
                                   device="cpu")
    _hist_close(ht, hj, 1e-4)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-4 * np.abs(xj).max())
    xjc = japi.cg_matrix(A, bc, n_iterations=25, routing=jtables)
    assert xtc.dtype == np.complex64
    np.testing.assert_allclose(xtc, xjc, rtol=0,
                               atol=1e-4 * np.abs(xjc).max())
    with pytest.raises(ValueError, match="routing tables"):
        tpcg_torch.cg(n - 1, A.nnz, A.data, b[:-1], A.indptr, A.indices,
                      n_iterations=2, routing=tables, device="cpu")
