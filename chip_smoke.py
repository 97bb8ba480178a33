"""Smoke run of the PyTorch/CUDA port (``tpcg_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:
  1. require a CUDA device and print its name and power limit;
  2. build (or load) the CUDA kernel library from ``tpcg_torch/csrc`` and
     print the build seconds and the compiler's register report;
  3. compare the kernel ``fused_cg_stencil`` with its plain PyTorch version
     on the card: helm_fe at N=16 and N=33 (an odd size, for the edges),
     at N=12 with tests/test_fused_cg.py's random initial guess, and at
     N=512 (several nodes per thread) with a random initial guess; Poisson
     at N=16; B=1 to 3, 15 or 25 iterations; x within 2e-3 * max|x|, the
     history within rtol 2e-2 plus 1e-3 * hist[0] (the tolerances of
     tests/test_fused_cg.py); two runs of the kernel must agree bit for bit;
  4. the main path: helm_fe(128, 12, eps=12) and plane_wave_rhs(128, 12)
     through ``plan_stencil_cg(...).solve``, which must take the kernel path
     and launch the kernel.  Over 100 iterations at this shape the kernel's
     x and history must match ``fused_cg_stencil_plain`` within the
     tolerances of phase 3, and its history the plain ``block_cg_planes``
     on the card to max rel 1e-2 (the gate).  The 5000-iteration solve must
     be finite with float64 relative residual ||b - A x|| / ||b|| <= 1e-3.
     Then the median time of the solve (CUDA events, after a warm-up), its
     GFLOPS by report Table II (8 nnz + 16 n + 24 n per iteration), and the
     time of one run of the plain version;
  5. the same at N=512, the top of the kernel path's range, 1000 iterations
     (the solve must be finite; its residual is printed beside those of two
     plain float32 versions and a complex128 solve);
  6. a JSON line of the kernels, the card line, and the result line.

It drives only ``tpcg_torch`` and imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

K_WAVE = 12.0


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def incoming_wave(N, k):
    """exp(i k a.x) with a = (1, 1)/sqrt2 on the unit-square grid: a smooth
    nonzero initial guess."""
    t = np.linspace(0.0, 1.0, N)
    return np.exp(1j * k * (t[:, None] + t[None, :]) / np.sqrt(2.0))


def random_guess(shape, seed):
    """Complex standard normal initial guess, as tests/test_fused_cg.py
    draws it."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def planes(Z, dev):
    """(B, Nv, Nh) complex numpy -> (2, B, Nv, Nh) float32 planes on dev."""
    return torch.from_numpy(
        np.stack([Z.real, Z.imag]).astype(np.float32)).to(dev)


def fused_close(xk, hk, xp, hp):
    """tests/test_fused_cg.py's tolerances: x within 2e-3 * max|x|, the
    history within rtol 2e-2 plus 1e-3 * hist[0].  Returns (ok, max|x err|,
    x limit, history excess over its tolerance)."""
    err = float((xk - xp).abs().max())
    lim = 2e-3 * float(xp.abs().max())
    excess = float(((hk - hp).abs()
                    - (2e-2 * hp.abs() + 1e-3 * hp[0].abs())).max())
    ok = (bool(torch.isfinite(xk).all() and torch.isfinite(hk).all())
          and err <= lim and excess <= 0)
    return ok, err, lim, excess


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps):
    """Median device time of fn() in ms (CUDA events, after one warm-up),
    and fn's last result."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def phase_build():
    from tpcg_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s -> {lib.relative_to(_build._PKG.parent)}")
    log = lib.with_suffix(".log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  nvcc:", line.strip())


def phase_compare(dev):
    """Kernel vs plain version on the card; returns the max |x err|."""
    from tpcg_torch.ops.fused_cg import (fused_cg_stencil,
                                         fused_cg_stencil_plain,
                                         prepare_coef3)
    from tpcg_torch.problems import helm_fe, plane_wave_rhs, poisson
    # (problem, N, k, B, x0, iterations); "random" at N=12, k=4, 15
    # iterations is tests/test_fused_cg.py's initial-guess case, and N=512
    # at k=12 runs the grid-stride loops with several nodes per thread
    cases = [("helm_fe", 16, 5.0, 1, "0", 25),
             ("helm_fe", 16, 5.0, 3, "wave", 25),
             ("helm_fe", 33, 5.0, 3, "0", 25),
             ("helm_fe", 33, 5.0, 1, "wave", 25),
             ("helm_fe", 12, 4.0, 1, "random", 15),
             ("helm_fe", 512, 12.0, 2, "random", 25),
             ("poisson", 16, 0.0, 1, "0", 25),
             ("poisson", 16, 0.0, 3, "0", 25)]
    worst = 0.0
    for name, N, k, nb, x0_kind, iters in cases:
        if name == "helm_fe":
            S = helm_fe(N, k, eps=k, device=dev)
            b1 = plane_wave_rhs(N, k)
        else:
            S = poisson(N, device=dev)
            b1 = np.ones((N, N), dtype=complex)
        B = np.stack([(r + 1) * b1 for r in range(nb)])
        X0 = np.zeros_like(B)
        if x0_kind == "wave":
            X0 = np.stack([0.1 * (r + 1) * incoming_wave(N, k)
                           for r in range(nb)])
        elif x0_kind == "random":
            X0 = random_guess(B.shape, seed=0)
        coef3 = prepare_coef3(S)
        b, x0 = planes(B, dev), planes(X0, dev)
        xk, hk = fused_cg_stencil(S.offsets, coef3, b, x0, iters)
        xk2, hk2 = fused_cg_stencil(S.offsets, coef3, b, x0, iters)
        xp, hp = fused_cg_stencil_plain(S.offsets, coef3, b, x0, iters)
        torch.cuda.synchronize()
        ok, err, lim, excess = fused_close(xk, hk, xp, hp)
        same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
        print(f"compare {name} N={N} B={nb} x0={x0_kind} {iters} it:"
              f" max|x err| {err:.3e} (limit {lim:.3e}),"
              f" hist excess over tolerance {excess:.3e},"
              f" repeat bit-equal {same}")
        if not (ok and same):
            fail(f"kernel disagrees with its plain version ({name} N={N})")
        worst = max(worst, err)
    return worst


def phase_main(dev, N, iters, check_residual):
    """Main path at N; returns timings and the main-path launch count.

    Where the residual is not checked (the 1000-iteration run at N=512 does
    not converge), it is printed beside those of two plain float32 versions
    and of a complex128 solve: past a few hundred iterations any two float32
    reduction orders of COCG on this indefinite matrix give different
    iterates, so these residuals show the spread, not a tolerance."""
    import tpcg_torch
    from tpcg_torch.cg import block_cg
    from tpcg_torch.ops.cplx import block_cg_planes, make_pair_operator
    from tpcg_torch.ops.fused_cg import (fused_cg_stencil,
                                         fused_cg_stencil_plain,
                                         prepare_coef3)
    from tpcg_torch.problems import helm_fe, plane_wave_rhs

    A = helm_fe(N, K_WAVE, eps=K_WAVE, device=dev)
    bg = plane_wave_rhs(N, K_WAVE)
    n = N * N
    nnz = int(torch.count_nonzero(A.coef))

    fused_cg_stencil.launches = 0
    plan = tpcg_torch.plan_stencil_cg(A, iters)
    x, hist = plan.solve(bg)
    torch.cuda.synchronize()
    launches = fused_cg_stencil.launches
    print(f"main N={N}: n={n} nnz={nnz} path={plan.path} "
          f"kernel launches={launches}")
    if plan.path != "l2-coef" or launches < 1:
        fail(f"main path did not go through the kernel (path {plan.path}, "
             f"{launches} launches)")

    # 100 iterations at the main path's shape: x and the history against
    # the kernel's plain version, and the history gate against the plain
    # planes oracle
    coef3 = prepare_coef3(A)
    bp = planes(bg[None], dev)
    x0p = torch.zeros_like(bp)
    xk, hk = tpcg_torch.plan_stencil_cg(A, 100).solve_planes(bp[:, 0])
    xp, hp = fused_cg_stencil_plain(A.offsets, coef3, bp, x0p, 100)
    ok, err, lim, excess = fused_close(xk, hk, xp[:, 0], hp[:, 0])
    print(f"check N={N} 100 it vs fused_cg_stencil_plain: max|x err| "
          f"{err:.3e} (limit {lim:.3e}), hist excess over tolerance "
          f"{excess:.3e}")
    if not ok:
        fail(f"kernel disagrees with its plain version at N={N}")
    hs = block_cg_planes(make_pair_operator(A), bp.reshape(2, n),
                         n_iterations=100).residual_history[:, 0]
    rel = float(((hk - hs).abs() / (hs.abs() + 1e-30)).max())
    print(f"gate N={N}: max rel history diff over 100 iterations {rel:.3e}"
          " (limit 1e-2)")
    if not (bool(torch.isfinite(hk).all()) and rel <= 1e-2):
        fail(f"100-iteration gate failed at N={N}: max rel {rel:.3e}")

    A64 = A.to_scipy()
    b64 = bg.reshape(-1)

    def rel_residual(xc):
        xc = np.asarray(xc).astype(np.complex128).reshape(-1)
        return float(np.linalg.norm(b64 - A64 @ xc) / np.linalg.norm(b64))

    def complex_of(xpl):
        xpl = xpl.reshape(2, n).cpu().numpy()
        return xpl[0] + 1j * xpl[1]

    res = rel_residual(x)
    finite = bool(np.isfinite(hist).all() and np.isfinite(x).all())
    print(f"solve N={N} {iters} it: finite={finite} hist[0]={hist[0]:.4e} "
          f"hist[-1]={hist[-1]:.4e} rel residual (f64) {res:.3e}")
    if not finite:
        fail(f"non-finite solve at N={N}")
    if check_residual and res > 1e-3:
        fail(f"relative residual {res:.3e} > 1e-3 at N={N}")

    ms, _ = median_ms(lambda: plan.solve_planes(bp[:, 0]), reps=5)
    # one timed run of the plain version (warmed by the 100-iteration run)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    xp, _ = fused_cg_stencil_plain(A.offsets, coef3, bp, x0p, iters)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    xp = complex_of(xp)
    print(f"solve N={N} {iters} it, plain fused_cg_stencil_plain: rel "
          f"residual (f64) {rel_residual(xp):.3e}")
    if not check_residual:
        xs = complex_of(block_cg_planes(make_pair_operator(A), bp.reshape(
            2, n), n_iterations=iters).x)
        b128 = torch.from_numpy(b64.astype(np.complex64)).to(
            dev, torch.complex128)
        x128 = block_cg(A, b128, n_iterations=iters).x.cpu().numpy()
        print(f"spread N={N} {iters} it: rel residual (f64) of plain "
              f"block_cg_planes (f32) {rel_residual(xs):.3e}, of complex128 "
              f"block_cg {rel_residual(x128):.3e}; max|x| distance / max|x| "
              f"between the two plain f32 versions "
              f"{np.abs(xp - xs).max() / np.abs(xs).max():.3e}, kernel vs "
              f"fused_cg_stencil_plain "
              f"{np.abs(x.reshape(-1) - xp).max() / np.abs(xp).max():.3e}")
    gflops = iters * (8 * nnz + 16 * n + 24 * n) / (ms * 1e-3) / 1e9
    print(f"time N={N} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, {gflops:.2f} GFLOPS Table II); "
          f"plain fused_cg_stencil_plain {plain_ms:.3f} ms (one run)")
    return dict(ms=ms, plain_ms=plain_ms, launches=launches)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    import tpcg_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card}")
    phase_build()
    max_err = phase_compare(dev)
    head = phase_main(dev, 128, 5000, check_residual=True)
    phase_main(dev, 512, 1000, check_residual=False)
    print(json.dumps({"kernels": [{
        "name": "fused_cg_stencil", "route": "cuda",
        "source": "tpcg_torch/csrc/fused_cg.cu",
        "replaces": "tpcg/ops/fused_cg.py:215",
        "launches": head["launches"], "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
