"""The ORAS-FGMRES Helmholtz solver on one device (counterpart of
``tpcg/parallel/hsolver.py``).

== ``HSolver`` with the ``gmres`` dispatcher
(``p_h-PY_C-CL-multi-GPU.py:3341-3505, 3294-3338``):

1. the equal-size partition (grid expanded by 2*OL, :3397-3402);
2. the global FE Helmholtz operator, cropped to every subdomain's box;
3. the ORAS preconditioner: impedance blocks (``local_rect``, Robin = 1),
   one batched subdomain solve (UseCG = 2; ``schwarz.py``);
4. FGMRES (``fgmres.py``) from the reference's initial guess;
5. the true residual ``||A x - b||`` checked after the solve (:3316-3337).

Three entries:

* :func:`plan_hsolver` does the set-up once: the decomposition, the cropped
  global operator and the subdomain block on the device (on a card the
  block's row-DIA planes that kernel A reads), and x0;
* :func:`hsolve` solves one global RHS on a plan: numpy (N, N) in and out,
  with the FGMRES residual estimates;
* :func:`hsolver` is the one-shot solve of the reference's plane-wave
  problem, with JAX's result fields.

State is (M, M, S, S) on the plan's device: the subdomain axes are a batch
axis of one device, where the reference spreads them over MPI ranks.
Not here (each raises ``NotImplementedError``): ``wgmres`` (ROADMAP queue 3
item 2), Robin = 0, the variable-coefficient and Marmousi fields, O-shape
masking, no preconditioner (``as_prec`` 0) and UseCG modes other than 2
(queue 1 item 12, slice a's remainder), and the process mesh (item 12,
slice b).  On a card the state is complex64: the subdomain solve's kernel
is float32.

Spans (``tpcg_torch.trace``): ``tpcg.plan_hsolver`` around set-up, a call
of its own, and ``tpcg.hsolve`` around a solve, with ``tpcg.precond``,
``tpcg.arnoldi`` and ``tpcg.halo`` inside.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import trace
from ..device import download, resolve_device, upload, wait
from ..problems.helmholtz import helm_fe, local_rect
from ..problems.poisson import poisson
from ..problems.rhs import plane_wave_rhs
from ..utils.config import HelmholtzConfig
from .fgmres import fgmres
from .halo import Decomposition
from .partition import make_partition
from .schwarz import SchwarzPrec

_ROADMAP = "ROADMAP queue 1 item 12"


def _refuse(cfg: HelmholtzConfig, device: torch.device):
    """Raise ``NotImplementedError`` for what the port does not run yet,
    and for a state other than complex64 on a card (the subdomain solve's
    kernel is float32)."""
    if device.type == "cuda" and cfg.dtype != "complex64":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r} on {device}: the subdomain solve's kernel "
            f"(csrc/stream_cg_dia.cu) is float32, so a card runs complex64; "
            f"run complex128 with device='cpu'")
    left = []
    if cfg.gmres_ver != "fgmres":
        left.append(f"gmres_ver={cfg.gmres_ver!r} (ROADMAP queue 3 item 2; "
                    f"{_ROADMAP})")
    if cfg.robin != 1:
        left.append(f"robin={cfg.robin} ({_ROADMAP})")
    if cfg.var_coeff or cfg.use_marmousi:
        left.append(f"var_coeff / use_marmousi ({_ROADMAP})")
    if cfg.oshape_d:
        left.append(f"oshape_d ({_ROADMAP})")
    if cfg.as_prec != 1:
        left.append(f"as_prec={cfg.as_prec}: only 1, one-level ORAS, is "
                    f"ported ({_ROADMAP})")
    elif cfg.use_cg != 2:
        left.append(f"use_cg={cfg.use_cg}: only 2, the batched subdomain "
                    f"solve, is ported ({_ROADMAP})")
    if left:
        raise NotImplementedError("not ported to tpcg_torch yet: "
                                  + "; ".join(left))


def _dtype(cfg: HelmholtzConfig) -> torch.dtype:
    # the reference pipeline is complex throughout, the Poisson debug
    # problem included
    return torch.complex64 if cfg.dtype == "complex64" else torch.complex128


def build_operator(cfg: HelmholtzConfig, decomp: Decomposition):
    """The global operator on the expanded grid (host, complex128) cropped
    to (noff, M, M, S, S) coefficients, its offsets, and the global RHS
    of the reference's problem (N, N)."""
    N = decomp.part.N
    if cfg.use_poisson:
        S = poisson(N, device="cpu")
        b = np.ones((N, N), dtype=np.float64)
    else:
        S = helm_fe(N, cfg.k, cfg.epsilon, device="cpu")
        b = plane_wave_rhs(N, cfg.k)
    return decomp.crop_stencil(S.coef.numpy()), S.offsets, b


def build_preconditioner(cfg: HelmholtzConfig, decomp: Decomposition,
                         device):
    """The shared impedance subdomain block (``as_prec``'s first-call set-up,
    ``p_h-PY_C-CL-multi-GPU.py:1848-1906``, Robin = 1) on ``device``."""
    N, S = decomp.part.N, decomp.part.sdsz
    npdt = np.complex64 if cfg.dtype == "complex64" else np.complex128
    return local_rect(N, cfg.k, cfg.eps1, eta=cfg.k, L=1.0, Nhoriz=S,
                      Nvert=S, dtype=npdt, device=device)


def generate_random_guess(decomp: Decomposition, dtype, device, seed=0):
    """A consistent random initial guess: random values made consistent
    across overlaps by an averaging ``OL_update`` (``Generate_random``,
    ``p_h-PY_C-CL-multi-GPU.py:2749-2763``)."""
    rng = np.random.default_rng(seed)
    shape = decomp.grid_shape
    x = torch.from_numpy(rng.random(shape) + 1j * rng.random(shape))
    return decomp.ol_update(x.to(device, dtype), restricted=True,
                            averaging=True)


@dataclasses.dataclass
class HSolverPlan:
    """What :func:`plan_hsolver` sets up once for many solves."""
    cfg: HelmholtzConfig
    decomp: Decomposition
    device: torch.device
    dtype: torch.dtype
    coef: torch.Tensor          # (noff, M, M, S, S) cropped global operator
    offsets: tuple
    prec: SchwarzPrec
    x0: Optional[torch.Tensor]  # (M, M, S, S), None for a zero guess
    b: np.ndarray               # the reference problem's global RHS

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.decomp.ax_op(self.coef, self.offsets, x)


def plan_hsolver(cfg: HelmholtzConfig, device=None) -> HSolverPlan:
    """Set up the solver of ``cfg`` on ``device`` (default: the CUDA device,
    raising without one; ``device="cpu"`` for the CPU), in span
    ``tpcg.plan_hsolver``."""
    device = resolve_device(device)
    _refuse(cfg, device)
    dtype = _dtype(cfg)
    with trace.span("plan_hsolver"):
        part = make_partition(cfg.M_subd, cfg.W_subd, cfg.overlap)
        decomp = Decomposition(part)
        coef, offsets, b = build_operator(cfg, decomp)
        coef = upload(torch.from_numpy(coef), device, dtype)
        prec = SchwarzPrec(decomp, build_preconditioner(cfg, decomp, device),
                           cg_iterations=cfg.cg_max_it,
                           restricted=cfg.restricted_as,
                           averaging=bool(cfg.averaging))
        if cfg.guess == 1:
            x0 = torch.ones(decomp.grid_shape, dtype=dtype, device=device)
        elif cfg.guess == 2:
            x0 = generate_random_guess(decomp, dtype, device, cfg.seed)
        else:
            x0 = None
    return HSolverPlan(cfg, decomp, device, dtype, coef, offsets, prec, x0, b)


def _solve(plan: HSolverPlan, b: torch.Tensor, n_iterations=None,
           callback: Optional[Callable] = None):
    """FGMRES on the plan for stacked b (M, M, S, S) on its device."""
    cfg, decomp = plan.cfg, plan.decomp
    return fgmres(plan.matvec, b, M=plan.prec, x0=plan.x0, tol=cfg.tol,
                  krylsize=cfg.restart, norm=decomp.norm, wdot=decomp.wdot,
                  n_steps=n_iterations, callback=callback)


def hsolve(plan: HSolverPlan, b, n_iterations: Optional[int] = None):
    """Solve ``A x = b`` on a plan, in span ``tpcg.hsolve``.

    b : the global RHS, an (N, N) grid (numpy, complex or real).
    n_iterations : None runs FGMRES to ``cfg.tol``, as the reference does;
        an integer runs exactly that many Arnoldi steps (capped at
        ``cfg.restart``), with no early exit.
    Returns ``(x, history)``: x the global (N, N) numpy grid in the plan's
    complex dtype, history the FGMRES residual estimates, float64,
    ``iterations + 1`` rows.
    """
    decomp = plan.decomp
    with trace.span("hsolve"):
        bs = decomp.crop_grid(np.asarray(b))
        bt = upload(torch.from_numpy(bs), plan.device, plan.dtype)
        res = _solve(plan, bt, n_iterations)
        wait(plan.device)
        x = decomp.to_global(download(res.x))
    return x, np.asarray(res.residual_norms, dtype=np.float64)


@dataclasses.dataclass
class HSolverResult:
    x: torch.Tensor             # (M, M, S, S) on the plan's device
    iterations: int
    residual_norms: List[float]
    true_residual: float
    converged: bool
    decomp: Decomposition
    wall_time: float
    time_per_it: float


def hsolver(cfg: HelmholtzConfig, device=None,
            callback: Optional[Callable] = None) -> HSolverResult:
    """The one-shot solve of the reference's problem (plane-wave RHS, or
    ones for Poisson) to ``cfg.tol``, on ``device`` (default: the CUDA
    device).  ``callback(res)`` gets each residual estimate."""
    plan = plan_hsolver(cfg, device)
    decomp = plan.decomp
    b = upload(torch.from_numpy(decomp.crop_grid(plan.b)), plan.device,
               plan.dtype)
    t0 = time.time()
    res = _solve(plan, b, callback=callback)
    wall = time.time() - t0

    # the true residual after the solve (:3316-3337)
    true_res = float(decomp.norm(plan.matvec(res.x) - b))
    ref = float(decomp.norm(b if plan.x0 is None
                            else plan.matvec(plan.x0) - b))
    if true_res > cfg.tol * ref and cfg.verbose:
        print("############ did it converge to the solution????  <--------")
        print("#### norm(A*x-b)=", true_res, "tol=", cfg.tol)
        print("#### tol*||r0||=", cfg.tol * ref)
    return HSolverResult(x=res.x, iterations=res.iterations,
                         residual_norms=res.residual_norms,
                         true_residual=true_res, converged=res.converged,
                         decomp=decomp, wall_time=wall,
                         time_per_it=wall / max(res.iterations, 1))
