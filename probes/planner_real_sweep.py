"""Probe: the stencil planner's two paths for a real float32 grid on the
card, ``eager`` (plain PyTorch ``block_cg``) against ``stream-real`` (one
launch of ``csrc/stream_cg_real.cu``), by grid size: the numbers behind
``auto._pick_path``'s rule for real stencils.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 probes/planner_real_sweep.py [--iters 5000] [--reps 3]

For the parabolic_fem-class 7-point FE stencil ``parabolic_stencil(N,
diag=6.0)`` at N = 8, 16, 32, 64, 128, 256, 512, 725 and 1023, and for
Poisson (``problems.poisson``, float32) at N = 256 and 725, one RHS (seeded
standard normal, x0 = 0): first a gate, the kernel against its plain
version over 100 iterations (x within 2e-3 max|x|, the history within
rtol 2e-2; the streaming kernels' tolerances), then the whole solve of
``--iters`` iterations on device operands (``plan.solve_planes``) through
each path in turns, timed by CUDA events, median and range of ``--reps``
in us an iteration, and their ratio.  At N = 725 it also times kernel A
(``csrc/stream_cg_dia.cu``, the planner's other candidate) on the same
operator as a DIA matrix (``to_dia()``, 1 RHS), and the one-shot host call
``stencil_cg(S, b)`` (plan, upload, solve, download) on both planner
paths.  The first line is the card's name and power limit.
"""
import argparse
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import tpcg_torch  # noqa: E402
from tpcg_torch.ops import stream_cg_dia as tsd  # noqa: E402
from tpcg_torch.ops import stream_cg_real as tsr  # noqa: E402
from tpcg_torch.problems import parabolic_stencil, poisson  # noqa: E402

CASES = ([("fe", n) for n in (8, 16, 32, 64, 128, 256, 512, 725, 1023)]
         + [("poisson", 256), ("poisson", 725)])


def _stencil(kind, n, dev):
    if kind == "fe":
        return parabolic_stencil(n, device=dev, diag=6.0)
    return poisson(n, dtype=np.float32, device=dev)


def _timed(run):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3          # us


def _gate(S, b):
    prepared = tsr.prepare_real(S)
    assert prepared[0] == "const", prepared[0]
    x0 = torch.zeros_like(b)
    xk, hk = tsr.solve_real_planes(S.offsets, prepared, b, x0, 100)
    xp, hp = tsr.stream_cg_real_planes_plain(S.offsets, S.grid,
                                             *prepared[1], b, x0, 100)
    xk, hk, xp, hp = (t.cpu().numpy() for t in (xk, hk, xp, hp))
    dx = float(np.abs(xk - xp).max() / np.abs(xp).max())
    dh = float(np.max(np.abs(hk - hp) / np.abs(hp).clip(1e-30)))
    ok = dx <= 2e-3 and np.allclose(hk, hp, rtol=2e-2, atol=1e-3 * hp[0])
    return ok, dx, dh


def _stats(ts, iters):
    us = [t / iters for t in ts]
    return statistics.median(us), min(us), max(us)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    it = args.iters
    for kind, n in CASES:
        try:
            _case(kind, n, dev, it, args.reps)
        except Exception as exc:                    # the next size runs
            print(f"{kind} N={n}: {type(exc).__name__}: {exc}", flush=True)
        torch.cuda.empty_cache()


def _case(kind, n, dev, it, reps):
    S = _stencil(kind, n, dev)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, n)).astype(np.float32)).to(dev)
    ok, dx, dh = _gate(S, b)
    plans = {p: tpcg_torch.plan_stencil_cg(S, it, path=p)
             for p in ("eager", "stream-real")}
    for p in plans.values():
        p.solve_planes(b)                          # warm-up
    torch.cuda.synchronize()
    times = {p: [] for p in plans}
    for rep in range(reps):
        order = list(plans) if rep % 2 == 0 else list(plans)[::-1]
        for p in order:
            times[p].append(_timed(lambda: plans[p].solve_planes(b)))
    e, k = (_stats(times[p], it) for p in ("eager", "stream-real"))
    print(f"{kind} N={n} {it} it: gate {'ok' if ok else 'FAILED'} "
          f"(x {dx:.2e}, hist {dh:.2e}); us an iteration: eager "
          f"{e[0]:.3f} [{e[1]:.3f}, {e[2]:.3f}], stream-real "
          f"{k[0]:.3f} [{k[1]:.3f}, {k[2]:.3f}], eager / stream-real "
          f"{e[0] / k[0]:.2f}", flush=True)
    if kind == "fe" and n == 725:
        _kernel_a(S, b, it, reps)
        _one_shot(S, b, it, reps)


def _kernel_a(S, b, it, reps):
    """Kernel A on the same operator as a DIA matrix, 1 RHS, against
    stream-real's launch, in turns."""
    offs, vals = tsd.prepare_dia_rows(S.to_dia())
    prepared = tsr.prepare_real(S)
    bd = b.reshape(1, -1).contiguous()
    x0d, x0 = torch.zeros_like(bd), torch.zeros_like(b)
    runs = {"kernel A": lambda: tsd.stream_cg_dia_rows(offs, vals, bd, x0d,
                                                       it),
            "stream-real": lambda: tsr.solve_real_planes(
                S.offsets, prepared, b, x0, it)}
    for r in runs.values():
        r()
    times = {k: [] for k in runs}
    for rep in range(reps):
        for k in (runs if rep % 2 == 0 else list(runs)[::-1]):
            times[k].append(_timed(runs[k]))
    a, s = (_stats(times[k], it) for k in ("kernel A", "stream-real"))
    print(f"fe N=725 {it} it, one launch on device operands: kernel A "
          f"{a[0]:.3f} [{a[1]:.3f}, {a[2]:.3f}], stream-real {s[0]:.3f} "
          f"[{s[1]:.3f}, {s[2]:.3f}] us an iteration, kernel A / "
          f"stream-real {a[0] / s[0]:.2f}", flush=True)


def _one_shot(S, b, it, reps):
    """``stencil_cg(S, b)`` host to host, each path forced, in turns: ms a
    call on the host clock."""
    bh = b.cpu().numpy()
    times = {"eager": [], "stream-real": []}
    for p in times:
        tpcg_torch.stencil_cg(S, bh, n_iterations=it, path=p)
    for rep in range(reps):
        for p in (times if rep % 2 == 0 else list(times)[::-1]):
            t = time.perf_counter()
            tpcg_torch.stencil_cg(S, bh, n_iterations=it, path=p)
            times[p].append((time.perf_counter() - t) * 1e3)
    print(f"fe N=725 {it} it, stencil_cg host to host, ms a call: "
          + ", ".join(f"{p} {statistics.median(v):.3f} [{min(v):.3f}, "
                      f"{max(v):.3f}]" for p, v in times.items()),
          flush=True)


if __name__ == "__main__":
    main()
