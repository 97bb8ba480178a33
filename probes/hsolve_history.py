"""The ORAS-FGMRES solver on the card against its complex128 run on the CPU,
and its time on the card.

    python3 probes/hsolve_history.py [--M 4] [--W 34] [--cg 256] [--k 20]
        [--rows 10] [--fixed 18] [--repeats 5]
        [--sweep K [--around T --width D]] [--angles T1,T2,...]

1. ``tpcg_torch.hsolver`` to tol 1e-6 on the card (complex64, kernel A's
   subdomain solves) and on the CPU (complex128, the same recurrence in
   float64): iteration counts, the first ``--rows`` residual estimates of
   each and their relative gap, the relative gap of the two x, and each x's
   relative residual ``|b - A x| / |b|`` against the global operator in
   complex128;
2. ``hsolve(plan, b, n_iterations=--fixed)`` on the card ``--repeats`` times
   (host clock around a synchronised call), and one preconditioner
   application and one Arnoldi matvec timed by CUDA events.

With ``--sweep K``, only: ``hsolve(n_iterations=--fixed)`` on the card for
K plane waves of directions (cos t, sin t), t evenly spaced on [0, 2 pi),
each x's relative residual against the global operator (complex128), and
their quantiles and the worst directions: the tail that a limit on the
benchmark's ``rel_residual`` must leave room for.  ``--around T --width D``
spaces the K directions on [T - D, T + D] instead.  ``--angles`` solves
the given directions at ``--fixed`` iterations on the card twice, on the
CPU in complex64 (kernel A's plain twin) and in complex128, and prints
each relative residual and the last rows of each history.

Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import tpcg_torch  # noqa: E402
from tpcg_torch.problems import helm_fe  # noqa: E402


def _rel_residual(cfg, decomp, x_stacked, b_global):
    """|b - A x| / |b| on the global grid, complex128 on the CPU."""
    N = decomp.part.N
    A = helm_fe(N, cfg.k, cfg.epsilon, device="cpu")
    x = torch.from_numpy(decomp.to_global(x_stacked).astype(np.complex128))
    b = torch.from_numpy(b_global.astype(np.complex128))
    return float(torch.linalg.vector_norm(b - A.apply_grid(x))
                 / torch.linalg.vector_norm(b))


def _ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wave(N, k, t):
    from tpcg_torch.problems import plane_wave_rhs
    return plane_wave_rhs(N, k, (np.cos(t), np.sin(t))).astype(np.complex64)


def _rel(A, b, x):
    b = torch.from_numpy(b.astype(np.complex128))
    r = b - A.apply_grid(torch.from_numpy(x.astype(np.complex128)))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def angles_report(cfg, dev, angles, fixed) -> int:
    plans = {"card": tpcg_torch.plan_hsolver(cfg, dev),
             "cpu64": tpcg_torch.plan_hsolver(cfg, "cpu"),
             "cpu128": tpcg_torch.plan_hsolver(
                 dataclasses.replace(cfg, dtype="complex128"), "cpu")}
    N = plans["card"].decomp.part.N
    A = helm_fe(N, cfg.k, cfg.epsilon, device="cpu")
    for t in angles:
        b = _wave(N, cfg.k, t)
        for name in ("card", "card", "cpu64", "cpu128"):
            x, h = tpcg_torch.hsolve(plans[name], b, n_iterations=fixed)
            print(f"t = {t:.9f} {name:6s}: |b - A x| / |b| "
                  f"{_rel(A, b, x):.6e}; history[-4:] "
                  + " ".join(f"{v:.4e}" for v in h[-4:]), flush=True)
    return 0


def sweep(cfg, dev, K, fixed, around=None, width=None) -> int:
    plan = tpcg_torch.plan_hsolver(cfg, dev)
    N = plan.decomp.part.N
    A = helm_fe(N, cfg.k, cfg.epsilon, device="cpu")
    angles = (2 * np.pi * np.arange(K) / K if around is None
              else np.linspace(around - width, around + width, K))
    rel = []
    t0 = time.perf_counter()
    for t in angles:
        b = _wave(N, cfg.k, t)
        x, _ = tpcg_torch.hsolve(plan, b, n_iterations=fixed)
        rel.append(_rel(A, b, x))
    rel = np.array(rel)
    q = np.quantile(rel, [0, 0.25, 0.5, 0.75, 0.9, 0.99, 1])
    print(f"sweep of {K} directions, {fixed} iterations, "
          f"{time.perf_counter() - t0:.1f} s: |b - A x| / |b| quantiles "
          "0/25/50/75/90/99/100%: " + " ".join(f"{v:.3e}" for v in q))
    for i in np.argsort(rel)[::-1][:10]:
        print(f"  t = {angles[i]:.9f} rad: {rel[i]:.6e}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--M", type=int, default=4)
    ap.add_argument("--W", type=int, default=34)
    ap.add_argument("--cg", type=int, default=256)
    ap.add_argument("--k", type=float, default=20.0)
    ap.add_argument("--rows", type=int, default=10)
    ap.add_argument("--fixed", type=int, default=18)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--sweep", type=int, default=0)
    ap.add_argument("--around", type=float, default=None)
    ap.add_argument("--width", type=float, default=0.01)
    ap.add_argument("--angles", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda:0")
    cfg = tpcg_torch.HelmholtzConfig(k=args.k, M_subd=args.M, W_subd=args.W,
                                     cg_max_it=args.cg, verbose=0)
    if args.angles:
        return angles_report(cfg, dev, [float(t) for t in
                                        args.angles.split(",")], args.fixed)
    if args.sweep:
        return sweep(cfg, dev, args.sweep, args.fixed, args.around,
                     args.width)
    t = time.perf_counter()
    rc = tpcg_torch.hsolver(cfg, device=dev)
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    r128 = tpcg_torch.hsolver(dataclasses.replace(cfg, dtype="complex128"),
                              device="cpu")
    t_cpu = time.perf_counter() - t
    plan = tpcg_torch.plan_hsolver(cfg, dev)
    b = plan.b
    hc, h128 = np.array(rc.residual_norms), np.array(r128.residual_norms)
    k = min(args.rows, len(hc), len(h128))
    print(f"M={args.M} W={args.W} N={plan.decomp.part.N} "
          f"sdsz={plan.decomp.part.sdsz} CGMaxIT={args.cg} k={args.k}")
    print(f"card complex64: {rc.iterations} iterations to tol "
          f"{cfg.tol:g}, converged {rc.converged}, last estimate "
          f"{hc[-1]:.6e}, true residual {rc.true_residual:.6e}, "
          f"{t_card:.3f} s with set-up")
    print(f"cpu complex128: {r128.iterations} iterations, converged "
          f"{r128.converged}, last estimate {h128[-1]:.6e}, true residual "
          f"{r128.true_residual:.6e}, {t_cpu:.3f} s with set-up")
    for i in range(k):
        print(f"  row {i:2d}: card {hc[i]:.9e} cpu {h128[i]:.9e} "
              f"rel gap {abs(hc[i] - h128[i]) / h128[i]:.3e}")
    xc, x128 = rc.x.cpu().numpy(), r128.x.numpy()
    print(f"max|x_card - x_cpu| / max|x_cpu| "
          f"{np.abs(xc - x128).max() / np.abs(x128).max():.3e}")
    print(f"global |b - A x| / |b|: card {_rel_residual(cfg, plan.decomp, xc, b):.6e}"
          f" cpu {_rel_residual(cfg, plan.decomp, x128, b):.6e}")

    bb = b.astype(np.complex64)
    times = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x, h = tpcg_torch.hsolve(plan, bb, n_iterations=args.fixed)
        times.append(1e3 * (time.perf_counter() - t))
    print(f"hsolve n_iterations={args.fixed}: ms "
          + " ".join(f"{v:.3f}" for v in times)
          + f"; last estimate {h[-1]:.6e}")
    z = torch.from_numpy(plan.decomp.crop_grid(b)).to(dev, torch.complex64)
    print(f"one preconditioner application {_ms(lambda: plan.prec(z), 10):.3f}"
          f" ms; one global matvec {_ms(lambda: plan.matvec(z), 50):.3f} ms;"
          f" one ol_update {_ms(lambda: plan.decomp.ol_update(z), 50):.3f}"
          f" ms")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev)} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
