"""tpcg_torch.parallel (the ORAS-FGMRES Helmholtz solver) against
tpcg.parallel on the CPU, with the same numpy inputs.

The JAX package runs its complex path (``use_planes=False``,
``prec_kernel="xla"``: ``block_cg`` subdomain solves); the port runs kernel
A's plain twin (float32 planes for complex64, the same recurrence in
float64 for complex128).  Sizes stay at M = 2, W = 8 (21 x 21 nodes):
the cell's M = 4, W = 34 runs on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpcg.parallel import Decomposition as JDecomposition
from tpcg.parallel import fgmres as jfgmres
from tpcg.parallel import hsolver as jhsolver
from tpcg.parallel import make_partition as jmake_partition
from tpcg.utils.config import HelmholtzConfig as JConfig

import tpcg_torch
from tpcg_torch import cli as tcli
from tpcg_torch.parallel import Decomposition, fgmres, make_partition
from tpcg_torch.problems import helm_fe, plane_wave_rhs

SMALL = dict(M_subd=2, W_subd=8, use_cg=2)


@pytest.mark.parametrize("M,W,OL,strict", [(2, 8, 3, True), (2, 8, 3, False),
                                           (3, 10, 4, True), (4, 34, 16, True),
                                           (3, 7, 2, False), (1, 9, 3, True)])
def test_partition_tables_match_jax(M, W, OL, strict):
    p, j = make_partition(M, W, OL, strict), jmake_partition(M, W, OL, strict)
    for f in ("M", "N", "OL", "short_w", "sdsz"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("row0", "col0", "urow", "ucol", "unique_mask"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), f)


def _pair(M, W, OL):
    return (Decomposition(make_partition(M, W, OL)),
            JDecomposition(jmake_partition(M, W, OL)))


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("M,W,OL", [(2, 8, 3), (3, 10, 4), (4, 12, 5)])
def test_exchange_matvec_and_reductions_match_jax(M, W, OL):
    """ol_update (restricted or not, averaging or not), ring_overwrite,
    ax_op, norm, wdot and to_global equal JAX's on seeded complex128
    fields, to 1e-12."""
    d, j = _pair(M, W, OL)
    x = _field(d.grid_shape, 1)
    xt = torch.from_numpy(x)
    for restricted in (True, False):
        for averaging in (True, False):
            _close(d.ol_update(xt, restricted, averaging).numpy(),
                   j.ol_update(jnp.asarray(x), restricted, averaging))
    _close(d.ring_overwrite(xt).numpy(), j.ring_overwrite(jnp.asarray(x)))
    S = helm_fe(d.part.N, 20.0, 20.0, device="cpu")
    coef = d.crop_stencil(S.coef.numpy())
    _close(d.ax_op(torch.from_numpy(coef), S.offsets, xt).numpy(),
           j.ax_op(jnp.asarray(coef), S.offsets, jnp.asarray(x)))
    _close(float(d.norm(xt)), float(j.norm(jnp.asarray(x))))
    V = _field((5,) + d.grid_shape, 2)
    _close(d.wdot(torch.from_numpy(V), xt).numpy(),
           j.wdot(jnp.asarray(V), jnp.asarray(x)))
    _close(d.to_global(xt), j.to_global(x))
    np.testing.assert_array_equal(d.crop_grid(np.arange(d.part.N ** 2)
                                              .reshape(d.part.N, -1)),
                                  j.crop_grid(np.arange(d.part.N ** 2)
                                              .reshape(d.part.N, -1)))


def test_fgmres_history_matches_jax():
    """FGMRES alone on a seeded complex system with a diagonal right
    preconditioner: the same residual history and x as JAX's, complex128,
    to 1e-10; a fixed number of steps gives exactly that many + 1 rows."""
    rng = np.random.default_rng(3)
    n = 40
    A = (np.eye(n) * 4 + 0.1 * (rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n))))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    At, dt = torch.from_numpy(A), torch.from_numpy(dinv)
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    got = fgmres(lambda v: At @ v, torch.from_numpy(b), M=lambda z: dt * z,
                 x0=torch.zeros(n, dtype=torch.complex128), tol=1e-9,
                 krylsize=30)
    want = jfgmres(lambda v: Aj @ v, jnp.asarray(b), M=lambda z: dj * z,
                   x0=jnp.zeros(n, jnp.complex128), tol=1e-9, krylsize=30)
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_allclose(got.residual_norms, want.residual_norms,
                               rtol=1e-10, atol=1e-10 * want.residual_norms[0])
    _close(got.x.numpy(), want.x, 1e-10)
    fixed = fgmres(lambda v: At @ v, torch.from_numpy(b), krylsize=30,
                   n_steps=4)
    assert len(fixed.residual_norms) == 5 and fixed.iterations == 4
    np.testing.assert_allclose(fixed.residual_norms[:3],
                               got.residual_norms[:3], rtol=0.5)


@pytest.fixture(scope="module", params=[6.0, 20.0], ids=["k6", "k20"])
def solves(request):
    """The whole solve at M = 2, W = 8, UseCG = 2 (k = 6 at 256 subdomain
    iterations; k = 20 at CGMaxIT = 64), both packages, both dtypes."""
    kw = dict(k=request.param, verbose=0, **SMALL)
    if request.param == 20.0:
        kw["cg_max_it"] = 64
    out = {}
    for dt in ("complex128", "complex64"):
        out[dt] = (tpcg_torch.hsolver(tpcg_torch.HelmholtzConfig(dtype=dt,
                                                                 **kw),
                                      device="cpu"),
                   jhsolver(JConfig(dtype=dt, use_planes=False,
                                    prec_kernel="xla", **kw)))
    return kw, out


def test_hsolver_matches_jax_complex128(solves):
    _, out = solves
    got, want = out["complex128"]
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    x, xj = got.x.numpy(), np.asarray(want.x)
    _close(x, xj, 1e-8)
    # the true residual is ~1e-5 of |b|: x's 1e-8 moves it further
    assert got.true_residual == pytest.approx(want.true_residual, rel=1e-4)


def test_hsolver_matches_jax_complex64(solves):
    _, out = solves
    got, want = out["complex64"]
    assert got.converged and abs(got.iterations - want.iterations) <= 1
    x, xj = got.x.numpy(), np.asarray(want.x)
    _close(x, xj, 1e-3)


def test_hsolver_solves_the_global_problem(solves):
    """x (complex128, to tol 1e-6) against a dense complex128 solve of the
    plain reference operator (``bench_torch/reference/helm_oras.py``, the
    global FE operator applied matrix-free on re/im planes) at the same
    size: the relative error and |b - A x| / |b| stay where tol 1e-6 puts
    them."""
    from bench_torch.reference.helm_oras import operator
    kw, out = solves
    res = out["complex128"][0]
    N = res.decomp.part.N
    op = operator(dict(N=N, k=kw["k"], beta=1.0), torch.float64, "cpu")
    eye = torch.eye(N * N, dtype=torch.float64).reshape(-1, N, N)
    cr, ci = op.apply(eye, torch.zeros_like(eye))     # columns of A
    A = torch.complex(cr, ci).reshape(N * N, N * N).T
    b = torch.from_numpy(plane_wave_rhs(N, kw["k"]).reshape(-1))
    xs = torch.linalg.solve(A, b).numpy()
    x = res.decomp.to_global(res.x).reshape(-1)
    assert np.abs(x - xs).max() <= 1e-4 * np.abs(xs).max()
    r = np.linalg.norm(b.numpy() - A.numpy() @ x) / np.linalg.norm(b.numpy())
    assert r <= 1e-5


@pytest.mark.parametrize("it", [0, 1, 3, 7])
def test_hsolve_runs_exactly_the_iterations_asked_for(it):
    """hsolve on a plan: (N, N) x in the plan's dtype and it + 1 rows of
    history, whether or not tol was reached; the rows are those of the
    solve to tol."""
    cfg = tpcg_torch.HelmholtzConfig(k=20.0, cg_max_it=64, verbose=0,
                                     **SMALL)
    plan = tpcg_torch.plan_hsolver(cfg, "cpu")
    x, h = tpcg_torch.hsolve(plan, plan.b, n_iterations=it)
    assert x.shape == (21, 21) and x.dtype == np.complex64
    assert h.shape == (it + 1,) and h.dtype == np.float64
    x_tol, h_tol = tpcg_torch.hsolve(plan, plan.b)
    assert len(h_tol) == 8
    np.testing.assert_allclose(h, h_tol[:it + 1], rtol=1e-6)
    if it == 7:
        np.testing.assert_array_equal(x, x_tol)


@pytest.mark.parametrize("change", [
    dict(gmres_ver="wgmres"), dict(robin=0), dict(var_coeff=True),
    dict(use_marmousi=True), dict(oshape_d=True), dict(use_cg=0),
    dict(use_cg=1), dict(use_cg=5), dict(use_cg=6), dict(as_prec=0)])
def test_modes_left_out_raise(change):
    cfg = tpcg_torch.HelmholtzConfig(verbose=0, **{**SMALL, **change})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpcg_torch.plan_hsolver(cfg, "cpu")


def test_card_refuses_a_state_other_than_complex64():
    """The subdomain solve's kernel is float32: a complex128 plan on a CUDA
    device is refused before anything reaches the card, and names the
    CPU that runs it."""
    cfg = tpcg_torch.HelmholtzConfig(verbose=0, dtype="complex128", **SMALL)
    with pytest.raises(NotImplementedError, match="float32.*device='cpu'"):
        tpcg_torch.plan_hsolver(cfg, "cuda")


def test_cli_helmholtz_runs_on_the_cpu(capsys):
    """``helmholtz M_s W_s UseCG CGMaxIT --device cpu`` solves the small
    problem and reports it; a mode left out says why and the sweep goes
    on."""
    assert tcli.main(["helmholtz", "2", "8", "2,0", "64", "--device",
                      "cpu"]) == 0
    out = capsys.readouterr().out
    assert "####it: 7" in out and "Aver. time per iter:" in out
    assert "use_cg=0" in out and "ROADMAP" in out


def test_poisson_and_zero_guess_match_jax():
    """The Poisson debug problem (impedance blocks, ones RHS) from a zero
    guess, complex128: JAX's iterations and x.  (At CGMaxIT 64 the two
    packages' histories part by tens of % past iteration ~30: FGMRES's
    basis loses orthogonality on this ill-suited preconditioner, and
    rounding decides where; at the default 256 they agree to 2e-5.)"""
    kw = dict(use_poisson=True, guess=0, verbose=0, **SMALL)
    got = tpcg_torch.hsolver(tpcg_torch.HelmholtzConfig(
        dtype="complex128", **kw), device="cpu")
    want = jhsolver(JConfig(dtype="complex128", use_planes=False,
                            prec_kernel="xla", **kw))
    assert got.iterations == want.iterations
    _close(got.x.numpy(), np.asarray(want.x), 1e-8)


def test_random_guess_matches_jax():
    kw = dict(guess=2, seed=4, k=6.0, verbose=0, **SMALL)
    cfg = tpcg_torch.HelmholtzConfig(dtype="complex128", **kw)
    got = tpcg_torch.hsolver(cfg, device="cpu")
    want = jhsolver(JConfig(dtype="complex128", use_planes=False,
                            prec_kernel="xla", **kw))
    assert got.iterations == want.iterations
    _close(got.x.numpy(), np.asarray(want.x), 1e-8)
    assert dataclasses.replace(cfg, guess=1).guess == 1
