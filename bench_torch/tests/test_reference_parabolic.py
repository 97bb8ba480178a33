"""The ``parabolic`` class's plain reference and accounting against the
program on the CPU at small sizes: the operator equals the matrix of the
program's ``parabolic_stencil``, float64 CG with it equals the program's
``block_cg``, and the counts are the assembled matrix's.  (The reference
itself imports nothing of the program.)"""
import numpy as np
import pytest
import torch

from bench_torch import spec
from bench_torch.accounting import h100, parabolic as acc
from bench_torch.reference import parabolic as ref
from bench_torch.reference.cg import cg


def _program(Ng, diag):
    from tpcg_torch.problems import parabolic_stencil
    return parabolic_stencil(Ng, device="cpu", diag=diag)


@pytest.mark.parametrize("Ng", [5, 17, 48])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_operator_equals_the_program_matrix(Ng, dtype):
    A = _program(Ng, 6.0).to_scipy()
    u = np.random.default_rng(Ng).standard_normal((3, Ng * Ng))
    y, = ref.operator({"Ng": Ng, "diag": 6.0}, dtype, "cpu").apply(
        torch.from_numpy(u).to(dtype))
    want = (A @ u.T).T
    tol = 1e-14 if dtype == torch.float64 else 3e-2
    assert y.shape == (3, Ng * Ng) and y.dtype == dtype
    assert np.abs(y.double().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("Ng", [5, 17, 48])
def test_counts_are_the_assembled_matrix(Ng):
    cfg = {"Ng": Ng}
    A = _program(Ng, 6.0).to_scipy()
    A.eliminate_zeros()
    assert acc.n(cfg) == A.shape[0] and acc.nnz(cfg) == A.nnz
    assert acc.ops_per_iteration(cfg) == 2 * A.nnz + 10 * A.shape[0]


def test_the_cell_is_operations_bound_in_the_l2():
    """parabolic_fem at 725^2: 7 taps and x, r, d (6.3 MB) fit the L2, so a
    request reads b and writes x and the history once; its least time is
    its Table II operations over the float32 peak, 0.9406 ms."""
    cfg = spec.cell("parabolic_fem.stencil_calls").config
    assert acc.nnz(cfg) == 3_673_577 == cfg["nnz"]
    n = 525_625
    assert acc.operator_bytes(cfg) + 3 * 4 * n <= h100.L2_BYTES
    nbytes = h100.request_bytes(acc, cfg, 1)
    assert nbytes == 7 * 4 + 2 * 4 * n + 4 * 5001
    ops = h100.request_ops(acc, cfg, 1)
    assert ops == 5000 * (2 * 3_673_577 + 10 * n)
    assert round(h100.least_seconds(ops, nbytes) * 1e3, 4) == 0.9406


def test_cg_float64_equals_the_program_block_cg():
    from tpcg_torch.cg import block_cg
    Ng, it = 17, 25
    S = _program(Ng, 6.0)
    S = type(S)(S.offsets, S.coef.double(), S.grid)
    b = np.random.default_rng(4).standard_normal((2, Ng * Ng))
    x, h = cg(ref.operator({"Ng": Ng, "diag": 6.0}, torch.float64, "cpu"),
              torch.from_numpy(b), it)
    res = block_cg(S, torch.from_numpy(b.T.copy()), n_iterations=it)
    assert np.abs(x.numpy().T - res.x.numpy()).max() <= \
        1e-10 * np.abs(x.numpy()).max()
    assert np.allclose(h.numpy(), res.residual_history.numpy(), rtol=1e-8)
