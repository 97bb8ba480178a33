"""tpcg_torch.io and tpcg_torch.cli against tpcg.io and tpcg.cli on the
same Matrix Market files."""
import os
import re

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

import tpcg.cli as jcli
from tpcg.io import load_matrix_market as jload
from tpcg_torch import cli as tcli
from tpcg_torch.io import load_matrix_market
from tpcg_torch.io.mtx import read_matrix_market
from tpcg_torch.native import mtx_native


@pytest.fixture(scope="module")
def mtx_dir(tmp_path_factory):
    """tests/test_io.py's files: symmetric, hermitian and general."""
    d = tmp_path_factory.mktemp("mtx")
    A = sp.random(60, 60, density=0.1, random_state=1, format="coo")
    scipy.io.mmwrite(str(d / "sym.mtx"), A + A.T, symmetry="symmetric")
    C = sp.random(40, 40, density=0.1, random_state=2, format="coo")
    C = C + 1j * sp.random(40, 40, density=0.1, random_state=3,
                           format="coo")
    scipy.io.mmwrite(str(d / "herm.mtx"), C + C.conj().T)
    G = sp.random(50, 50, density=0.08, random_state=4, format="coo")
    scipy.io.mmwrite(str(d / "gen.mtx"), G)
    return d


@pytest.mark.parametrize("name,dtype", [("sym.mtx", None),
                                        ("sym.mtx", np.float32),
                                        ("herm.mtx", None),
                                        ("herm.mtx", np.complex64),
                                        ("gen.mtx", None),
                                        ("gen.mtx", np.float32)])
def test_load_matrix_market_matches_jax(mtx_dir, name, dtype):
    path = str(mtx_dir / name)
    want = jload(path, dtype=dtype)
    got = load_matrix_market(path, dtype=dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.has_sorted_indices
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_native_reader_is_built_from_the_repo_source(mtx_dir):
    assert mtx_native.SRC.name == "mtx_reader.cpp"
    assert mtx_native.available()
    A, reader = read_matrix_market(str(mtx_dir / "herm.mtx"))
    assert reader == "native"
    assert abs(A - A.conj().T).max() < 1e-12      # hermitian expansion
    ref = sp.csr_matrix(scipy.io.mmread(str(mtx_dir / "herm.mtx")))
    assert abs(A - ref).max() < 1e-14


def test_garbage_falls_back_to_scipy_which_raises(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("this is not a matrix market file\n1 2 3\n")
    assert mtx_native.load(str(p)) is None
    with pytest.raises(Exception):
        load_matrix_market(str(p))


def _final_residuals(out):
    return [float(v) for v in
            re.findall(r"rhs \d+: final residual ([0-9.e+-]+)", out)]


# complex at 8 iterations: eager complex64 COCG on this small system
# converges within ~10 and then breaks down to NaN in both packages (only
# the exact-zero freeze guard), see tests/test_stream_cg_dia_cplx.py
@pytest.mark.parametrize("n_rhs,cplx,iters", [(2, 0, 40), (1, 1, 8)])
def test_cli_cg_matches_jax_on_cpu(tmp_path, capsys, n_rhs, cplx, iters):
    n = 60
    Q = sp.random(n, n, density=0.1, random_state=0, format="csr")
    A = sp.csr_matrix(Q @ Q.T + n * sp.eye(n))
    if cplx:
        A = sp.csr_matrix(A + 0.5j * sp.eye(n))
    mtx = tmp_path / "a.mtx"
    scipy.io.mmwrite(str(mtx), A)
    args = ["cg", str(mtx), str(n_rhs), str(cplx), str(iters)]
    assert jcli.main(args) == 0
    want = _final_residuals(capsys.readouterr().out)
    assert tcli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _final_residuals(out)
    assert "reader=native" in out and len(got) == n_rhs == len(want)
    # both run float32 / complex64 eager CG on the CPU; the residuals of
    # these well-conditioned systems agree to float32 summation order
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-5 * max(want + [1e-30]))


def test_cli_refuses_missing_device_and_unported_commands(tmp_path, capsys,
                                                          monkeypatch):
    mtx = tmp_path / "a.mtx"
    scipy.io.mmwrite(str(mtx), sp.eye(8, format="csr") * 2.0)
    monkeypatch.setattr(tcli.torch.cuda, "is_available", lambda: False)
    assert tcli.main(["cg", str(mtx), "1", "0", "5"]) == 1
    assert "not available" in capsys.readouterr().err
    assert tcli.main(["cg", str(mtx), "1", "0", "5", "--device",
                      "cuda:0"]) == 1
    # every subcommand is ported: helmholtz refuses the absent card, and
    # wrong arguments are a usage error
    assert tcli.main(["helmholtz", "2", "6", "2"]) == 1
    assert "not available" in capsys.readouterr().err
    assert tcli.main(["route", "2", "6", "2"]) == 1
    assert "Usage" in capsys.readouterr().err
    assert tcli.main(["cg", str(tmp_path / "missing.mtx"), "1", "0", "5",
                      "--device", "cpu"]) == 1
    assert os.path.exists(mtx)


def test_cli_route_writes_tables_jax_loads(tmp_path, capsys):
    """``cli route`` writes JAX's .npz layout: tpcg's RoutedSpmv.load reads
    it and its product is the matrix's; the port's routing= solve on the
    file matches the CSR solve; a missing file exits 1."""
    from tpcg.ops.routing import RoutedSpmv as JRoutedSpmv
    import tpcg_torch
    rng = np.random.default_rng(5)
    n = 150
    A = sp.csr_matrix((rng.standard_normal(4 * n),
                       (np.repeat(np.arange(n), 4),
                        rng.integers(0, n, 4 * n))), shape=(n, n))
    A = sp.csr_matrix(A + A.T + 8 * sp.eye(n))
    mtx, out = tmp_path / "u.mtx", tmp_path / "u.npz"
    scipy.io.mmwrite(str(mtx), A)
    assert tcli.main(["route", str(mtx), str(out)]) == 0
    assert "layers" in capsys.readouterr().out
    R = JRoutedSpmv.load(str(out))
    x = rng.standard_normal(n)
    np.testing.assert_allclose(R.matvec_numpy(x), A @ x, rtol=1e-5,
                               atol=1e-5 * np.abs(A @ x).max())
    A32 = A.astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xr = tpcg_torch.cg(n, A32.nnz, A32.data, b, A32.indptr, A32.indices,
                       n_iterations=20, routing=str(out), device="cpu")
    xc = tpcg_torch.cg_matrix(A32, b, n_iterations=20, device="cpu")
    np.testing.assert_allclose(xr, xc, rtol=0, atol=1e-5 * np.abs(xc).max())
    assert tcli.main(["route", str(tmp_path / "missing.mtx"),
                      str(out)]) == 1
