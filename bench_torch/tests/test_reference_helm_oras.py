"""The ``helm_oras`` class's plain reference against the program on the CPU,
at the configuration's ``cpu_test`` size: the reference operator equals the
global operator that the program's decomposition applies (``ax_op`` on the
cropped assembly, on states consistent across the overlaps), and the pool's
plane waves equal the program's ``plane_wave_rhs``.  (The reference itself
imports nothing of the program.)"""
import numpy as np
import torch

from bench_torch import spec
from bench_torch.accounting import helm_oras as acc
from bench_torch.reference.helm_oras import operator
from bench_torch.rhs.plane_wave import pool

CELL = "helm_oras_m4.source_calls"


def _small():
    cfg = spec.cell(CELL).config
    return {**cfg, **cfg["cpu_test"]}


def test_operator_equals_the_program_operator():
    """The global operator on a random global field: the reference's
    element-by-element apply, the program's assembled matrix, and the
    program's distributed matvec on the field's subdomain crops (taken back
    to the global grid) agree to rounding."""
    import tpcg_torch
    from tpcg_torch.problems import helm_fe
    cfg = _small()
    hcfg = tpcg_torch.HelmholtzConfig(
        k=cfg["k"], beta=cfg["beta"], M_subd=cfg["M_subd"],
        W_subd=cfg["W_subd"], cg_max_it=cfg["cg_max_it"], dtype="complex128",
        verbose=0)
    plan = tpcg_torch.plan_hsolver(hcfg, "cpu")
    N = cfg["N"]
    assert plan.decomp.part.N == N and plan.decomp.part.sdsz == cfg["sdsz"]
    rng = np.random.default_rng(5)
    u = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    yr, yi = operator(cfg, torch.float64, "cpu").apply(
        torch.from_numpy(u.real)[None], torch.from_numpy(u.imag)[None])
    want = (yr + 1j * yi)[0].numpy()
    S = helm_fe(N, cfg["k"], cfg["k"] ** cfg["beta"], device="cpu")
    assert np.abs(S.to_scipy() @ u.reshape(-1) - want.reshape(-1)).max() \
        <= 1e-13 * np.abs(want).max()
    y = plan.matvec(torch.from_numpy(plan.decomp.crop_grid(u))).numpy()
    got = plan.decomp.to_global(y)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # every subdomain's copy of a shared point agrees with the first one's
    assert np.abs(plan.decomp.crop_grid(got) - y).max() \
        <= 1e-12 * np.abs(want).max()


def test_pool_is_the_program_plane_wave_and_counts_hold():
    from tpcg_torch.problems import plane_wave_rhs
    cfg = _small()
    traffic = spec.cell(CELL).traffic
    p = pool(cfg, traffic, 2**33 + 9)
    b = p[3]
    assert b.shape == (1, cfg["N"], cfg["N"]) and b.dtype == np.complex64
    t = p.angles[3]
    want = plane_wave_rhs(cfg["N"], cfg["k"], (np.cos(t), np.sin(t)))
    assert np.abs(b[0] - want).max() <= 1e-6 * np.abs(want).max()
    assert (acc.n(cfg), acc.nnz(cfg)) == (cfg["n"], cfg["nnz"])


def test_subdomain_block_count_is_the_assembled_blocks():
    """``accounting/helm_oras.py``'s subdomain nonzeros are those of the
    assembled ``local_rect`` block at the cell's size (29,966 at 66 x 66),
    and an iteration's operations are 256 x 16 x 413,968 + 8 x 189,257."""
    from tpcg_torch.problems import local_rect
    cfg = spec.cell(CELL).config
    S = cfg["sdsz"]
    blk = local_rect(cfg["N"], cfg["k"], cfg["k"], eta=cfg["k"], Nhoriz=S,
                     Nvert=S, device="cpu").to_scipy()
    blk.eliminate_zeros()
    nnz_s = (acc.subdomain_ops(cfg) - 40 * S * S) // 8
    assert blk.nnz == nnz_s == 29_966
    assert acc.ops_per_iteration(cfg) == 1_697_126_984
