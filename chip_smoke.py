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
  6. the banded-DIA kernels (``stream_cg_dia_rows`` real and complex,
     ``fused_cg_dia_rows_cplx``) against their plain versions on the card:
     the CPU tests' geometries (tests/test_torch_dia_cg.py), a real B=3
     batch, complex B=2 through the streaming and the fused kernel, and the
     two freeze systems of tests/test_fused_cg_dia.py; x within 2e-3 max|x|,
     the history on its live entries (h > 1e-6 h[0]) within rel 1e-2, two
     launches bit-equal;
  7. the banded Fig. 5 classes through the entry points, each with the
     launch counts set to 0 just before and read just after: mhd1280b
     (complex, 1 RHS, 5000 iterations) written to a .mtx and solved by
     ``python -m tpcg_torch.cli cg`` in this process (fused kernel); m_t1
     (real, 200 iterations, B=1 and B=8) and parabolic_fem (real, 200
     iterations) through ``tpcg_torch.cg`` with CSR arrays (streaming real
     kernel); helm_fem as a CSR matrix (complex, 5000 iterations) through
     ``tpcg_torch.cg`` (streaming complex kernel: the fused kernel's rule
     refuses it).  For each: the kernel whose count moved, a 100-iteration
     gate against the plain version, the float64 relative residual of the
     final solve (<= 1e-3), the median of 5 CUDA-event timings of the
     device-resident solve, GFLOPS by report Table II, and one timed run of
     the plain version.  helm_fem also takes two seeded random RHS, held to
     the plain version over 20 iterations, and prints over 100 iterations
     the spread of the kernel, two plain float32 versions and complex128
     on one of them;
  8. a JSON line of the kernels, the card line, and the result line.

It drives only ``tpcg_torch`` and imports nothing of JAX.
"""
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    # one line per kernel: entry name, spills, registers and shared memory
    name = spill = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            print(f"  ptxas {name}: {spill}; {line.split(':', 1)[1].strip()}")
        elif "error" in line:
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

    reset_counts()
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


def dia_close(xk, hk, xp, hp):
    """The DIA kernels' tolerances: x within 2e-3 * max|x|, the history on
    its live entries (h > 1e-6 h[0]; these systems underflow mid-run, where
    two summation orders cross zero an iteration apart) within rel 1e-2.
    Returns (ok, max|x err|, x limit, max rel history diff)."""
    err = float((xk - xp).abs().max())
    lim = 2e-3 * float(xp.abs().max())
    live = hp > 1e-6 * hp[0]
    rel = float(((hk - hp).abs()[live] / hp[live]).max())
    ok = (bool(torch.isfinite(xk).all() and torch.isfinite(hk).all())
          and err <= lim and rel <= 1e-2)
    return ok, err, lim, rel


def dia_kernels():
    """name -> (wrapper with its launch count, plain version, route info)."""
    from tpcg_torch.ops import fused_cg_dia as fd
    from tpcg_torch.ops import stream_cg_dia as sd
    return {
        "stream_cg_dia": (sd.stream_cg_dia_rows, sd.stream_cg_dia_rows_plain,
                          "tpcg_torch/csrc/stream_cg_dia.cu",
                          "tpcg/ops/stream_cg_dia.py:194"),
        "stream_cg_dia_cplx": (sd.stream_cg_dia_rows_cplx,
                               sd.stream_cg_dia_rows_cplx_plain,
                               "tpcg_torch/csrc/stream_cg_dia.cu",
                               "tpcg/ops/stream_cg_dia.py:515"),
        "fused_cg_dia_cplx": (fd.fused_cg_dia_rows_cplx,
                              fd.fused_cg_dia_rows_cplx_plain,
                              "tpcg_torch/csrc/fused_cg_dia.cu",
                              "tpcg/ops/fused_cg_dia.py:62"),
    }


def dia_operands(A, cplx, dev):
    """scipy matrix -> (offsets, row-DIA value planes on dev)."""
    import scipy.sparse as sp
    from tpcg_torch.ops import stream_cg_dia as sd
    from tpcg_torch.sparse import DiaMatrix
    D = DiaMatrix.from_scipy(
        sp.csr_matrix(A.astype(np.complex64 if cplx else np.float32)),
        device=dev)
    return (sd.prepare_dia_rows_cplx if cplx else sd.prepare_dia_rows)(D)


def rhs_planes(n, nb, cplx, dev, seed):
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.standard_normal(
        (2 if cplx else 1, nb, n)).astype(np.float32)).to(dev)
    return b if cplx else b[0]


def phase_dia_compare(dev):
    """The DIA kernels against their plain versions on the card; returns
    the max |x err| of each kernel."""
    import scipy.sparse as sp
    from tpcg_torch.problems import banded_complex
    kernels = dia_kernels()
    worst = dict.fromkeys(kernels, 0.0)
    # (kernel, n, offsets, B, iterations): tests/test_torch_dia_cg.py's
    # geometries, a real B=3 batch and complex B=2 through both kernels
    geoms = [(1280, tuple(range(0, 9))), (777, (0, 1, 3, 40)),
             (300, (0, 2, 150))]
    cases = [(k, n, offs, 1, 40) for k in kernels for n, offs in geoms]
    cases += [("stream_cg_dia", 777, (0, 1, 3, 40), 3, 40),
              ("stream_cg_dia_cplx", 1280, tuple(range(0, 9)), 2, 40),
              ("fused_cg_dia_cplx", 1280, tuple(range(0, 9)), 2, 40)]
    for name, n, offs, nb, iters in cases:
        wrap, plain = kernels[name][:2]
        cplx = name != "stream_cg_dia"
        A = banded_complex(n, offs, seed=2)
        offsets, vals = dia_operands(A if cplx else A.real, cplx, dev)
        b = rhs_planes(n, nb, cplx, dev, seed=1)
        x0 = 0.1 * rhs_planes(n, nb, cplx, dev, seed=2)
        xk, hk = wrap(offsets, vals, b, x0, iters)
        xk2, hk2 = wrap(offsets, vals, b, x0, iters)
        xp, hp = plain(offsets, vals, b, x0, iters)
        torch.cuda.synchronize()
        same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
        for c in range(nb):
            ok, err, lim, rel = dia_close(xk[..., c, :], hk[:, c],
                                          xp[..., c, :], hp[:, c])
            print(f"compare {name} n={n} ndiag={len(offsets)} "
                  f"B={nb} rhs {c} {iters} it: max|x err| {err:.3e} (limit "
                  f"{lim:.3e}), hist max rel {rel:.3e} (limit 1e-2), repeat "
                  f"bit-equal {same}")
            if not (ok and same):
                fail(f"{name} disagrees with its plain version (n={n})")
            worst[name] = max(worst[name], err)

    # the two freeze systems of tests/test_fused_cg_dia.py, both complex
    # kernels: a weakly dominant band 400 iterations past convergence, and
    # 2 I, which converges in one iteration
    n = 1280
    A = banded_complex(n, tuple(range(0, 9)), seed=2)
    A = A - sp.eye(n) * (A.diagonal()[0] - (1.2 + 0.25j) * 2) * 0.5
    weak = (dia_operands(A, True, dev), 400)
    ident = (dia_operands(sp.eye(256, format="csr") * (2.0 + 0.0j), True,
                          dev), 8)
    for name in ("fused_cg_dia_cplx", "stream_cg_dia_cplx"):
        wrap = kernels[name][0]
        for (offsets, vals), iters in (weak, ident):
            m = vals.shape[2]
            b = rhs_planes(m, 1, True, dev, seed=4)
            if iters == 8:            # 2 I x = 1, as the JAX test has it
                b = torch.zeros_like(b)
                b[0] = 1.0
            xk, hk = wrap(offsets, vals, b, torch.zeros_like(b), iters)
            h = hk[:, 0].cpu().numpy()
            z = np.where(h == 0)[0]
            frozen = len(z) > 0 and bool(np.all(h[z[0]:] == 0))
            if iters == 8:            # 2 I: constant from iteration 1
                frozen = bool(h[1] < 1e-5 * h[0] and np.all(h[1:] == h[1]))
            finite = bool(torch.isfinite(xk).all() and np.isfinite(h).all())
            print(f"freeze {name} n={m} {iters} it: finite {finite}, frozen "
                  f"{frozen} (first zero at {z[0] if len(z) else None}, "
                  f"hist[1] {h[1]:.3e}, hist[-1] {h[-1]:.3e})")
            if not (finite and frozen):
                fail(f"{name} did not freeze ({iters} iterations, n={m})")
    return worst


def reset_counts():
    from tpcg_torch.ops.fused_cg import fused_cg_stencil
    wrappers = [fused_cg_stencil] + [k[0] for k in dia_kernels().values()]
    for w in wrappers:
        w.launches = 0


def moved_counts():
    from tpcg_torch.ops.fused_cg import fused_cg_stencil
    counts = {"fused_cg_stencil": fused_cg_stencil.launches}
    counts.update({k: v[0].launches for k, v in dia_kernels().items()})
    return {k: v for k, v in counts.items() if v}


def csr_args(A):
    return A.nnz, A.data, A.indptr, A.indices


def rel_residual64(A, X, B):
    """float64 ||B - A X|| / ||B|| over all columns."""
    X = np.asarray(X).astype(np.complex128)
    B = np.asarray(B).astype(np.complex128)
    return float(np.linalg.norm(B - A.astype(np.complex128) @ X)
                 / np.linalg.norm(B))


def phase_fig5_class(dev, label, A, nrhs, iters, kernel, route, also=None,
                     B=None):
    """One banded Fig. 5 class through an entry point; returns its numbers.

    route "cli": A is written to a .mtx in a temp directory and solved by
    the CLI (complex, b_r = (r+1) * 5, as main.c); route "api": the CSR
    arrays go to tpcg_torch.cg (b: ``B`` (n, nrhs), else seeded normal
    columns).  ``also`` names a second kernel timed on the same operands,
    off the main path."""
    import scipy.io
    import scipy.sparse as sp
    import tpcg_torch
    from tpcg_torch import cli
    wrap, plain = dia_kernels()[kernel][:2]
    cplx = np.iscomplexobj(A.data)
    A = sp.csr_matrix(A.astype(np.complex64 if cplx else np.float32))
    A.eliminate_zeros()
    n = A.shape[0]
    if route == "cli":
        B = np.stack([np.full(n, (r + 1) * 5.0, A.dtype)
                      for r in range(nrhs)], axis=1)
    elif B is None:
        rng = np.random.default_rng(7)
        B = rng.standard_normal((n, nrhs)).astype(np.float32)
        if cplx:
            B = (B + 1j * rng.standard_normal((n, nrhs))).astype(A.dtype)
    b = B.T.reshape(-1)
    with tempfile.TemporaryDirectory() as tmp:
        if route == "cli":
            path = os.path.join(tmp, f"{label}.mtx")
            scipy.io.mmwrite(path, A)
            out = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["cg", path, str(nrhs), "1", str(iters),
                               "--device", str(dev)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = moved_counts()
            for line in out.getvalue().splitlines():
                print(f"  cli: {line}")
            if rc != 0 or "reader=" not in out.getvalue():
                fail(f"{label}: the CLI failed (exit {rc})")
            reader = out.getvalue().split("reader=")[1].split()[0]
            print(f"{label}: Matrix Market reader that ran: {reader}")
    if route == "cli":
        # the CLI prints residual norms, not x: the same solve through the
        # API it calls gives x for the float64 residual
        x = tpcg_torch.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:],
                          n_rhs=nrhs, n_iterations=iters, device=dev)
    else:
        reset_counts()
        t0 = time.perf_counter()
        x = tpcg_torch.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:],
                          n_rhs=nrhs, n_iterations=iters, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = moved_counts()
    launches = counts.get(kernel, 0)
    print(f"{label}: n={n} nnz={A.nnz} B={nrhs} {iters} it via {route}: "
          f"kernel launches {counts} in {wall:.3f} s (host clock, "
          "conversion and transfers included)")
    if set(counts) != {kernel} or launches < 1:
        fail(f"{label}: expected only {kernel} to launch, got {counts}")
    X = x.reshape(nrhs, n).T
    res = rel_residual64(A, X, B)
    finite = bool(np.isfinite(X).all())
    print(f"{label}: finite {finite}, relative residual (f64) {res:.3e} "
          "(limit 1e-3)")
    if not finite or res > 1e-3:
        fail(f"{label}: relative residual {res:.3e}")

    # device-resident operands: the 100-iteration gate and the timings
    offsets, vals = dia_operands(A, cplx, dev)
    bp = torch.from_numpy(np.stack([B.real.T, B.imag.T]) if cplx
                          else np.ascontiguousarray(B.T)).to(dev,
                                                             torch.float32)
    x0 = torch.zeros_like(bp)
    xk, hk = wrap(offsets, vals, bp, x0, 100)
    xp, hp = plain(offsets, vals, bp, x0, 100)
    torch.cuda.synchronize()
    worst, worst_lim, worst_rel, ok = 0.0, 0.0, 0.0, True
    for c in range(nrhs):
        ok_c, err, lim, rel = dia_close(xk[..., c, :], hk[:, c],
                                        xp[..., c, :], hp[:, c])
        ok = ok and ok_c
        worst, worst_lim = max(worst, err), max(worst_lim, lim)
        worst_rel = max(worst_rel, rel)
    print(f"{label}: gate 100 it vs plain: max|x err| {worst:.3e} (limit "
          f"2e-3 max|x| = {worst_lim:.3e}), hist max rel {worst_rel:.3e} "
          "(limit 1e-2)")
    if not ok:
        fail(f"{label}: 100-iteration gate failed")
    ms, _ = median_ms(lambda: wrap(offsets, vals, bp, x0, iters), reps=5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain(offsets, vals, bp, x0, iters)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    nnz = A.nnz
    flop = (8 * nnz + 40 * n) if cplx else (2 * nnz + 10 * n)
    gflops = nrhs * iters * flop / (ms * 1e-3) / 1e9
    print(f"time {label} B={nrhs} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, {gflops:.2f} GFLOPS Table II, all "
          f"RHS); plain {plain_ms:.3f} ms (one run, {iters} it)")
    if also:
        other = dia_kernels()[also][0]
        ms2, _ = median_ms(lambda: other(offsets, vals, bp, x0, iters),
                           reps=5)
        print(f"time {label} B={nrhs} {iters} it: {also} (off the main "
              f"path) {ms2:.3f} ms ({ms2 * 1e3 / iters:.3f} us/it)")
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=worst)


def phase_helm_random(dev):
    """helm_fem (indefinite) with seeded random RHS through the complex
    streaming kernel: two RHS held to the plain version over 20 iterations,
    then the witness for why the class's own gate uses its plane wave: over
    100 iterations the seed-7 RHS lies near a breakdown, where the kernel,
    two plain float32 versions (row-DIA and Karatsuba planes) and a
    complex128 solve are printed side by side.  Returns the max |x err| of
    the 20-iteration check."""
    from tpcg_torch.cg import block_cg
    from tpcg_torch.ops.cplx import block_cg_planes, make_pair_operator
    from tpcg_torch.problems import helm_fe
    wrap, plain = dia_kernels()["stream_cg_dia_cplx"][:2]
    S = helm_fe(128, K_WAVE, eps=K_WAVE, device=dev)
    offsets, vals = dia_operands(S.to_scipy(), True, dev)
    n = vals.shape[2]
    b = rhs_planes(n, 2, True, dev, seed=7)
    x0 = torch.zeros_like(b)
    xk, hk = wrap(offsets, vals, b, x0, 20)
    xp, hp = plain(offsets, vals, b, x0, 20)
    torch.cuda.synchronize()
    worst = 0.0
    for c in range(2):
        ok, err, lim, rel = dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])
        print(f"helm_fem random B=2 rhs {c} 20 it: max|x err| {err:.3e} "
              f"(limit {lim:.3e}), hist max rel {rel:.3e} (limit 1e-2)")
        if not ok:
            fail("stream_cg_dia_cplx disagrees with its plain version on "
                 "helm_fem with a random RHS")
        worst = max(worst, err)
    b = rhs_planes(n, 1, True, dev, seed=7)
    x0 = torch.zeros_like(b)
    xk, _ = wrap(offsets, vals, b, x0, 100)
    xp, _ = plain(offsets, vals, b, x0, 100)
    xs = block_cg_planes(make_pair_operator(S), b[:, 0],
                         n_iterations=100).x
    x128 = block_cg(S, torch.complex(b[0, 0].double(), b[1, 0].double()),
                    n_iterations=100).x.reshape(-1)
    xk, xp = torch.complex(xk[0, 0], xk[1, 0]), torch.complex(xp[0, 0],
                                                               xp[1, 0])
    xs = torch.complex(xs[0], xs[1]).reshape(-1)
    m = float(x128.abs().max())

    def dist(u, v):
        return float((u.to(torch.complex128) - v).abs().max()) / m
    print(f"spread helm_fem random B=1 (seed 7) 100 it, max|x| distance / "
          f"max|x|: kernel vs plain {dist(xk, xp):.3e}, plain row-DIA vs "
          f"plain planes {dist(xp, xs):.3e}, plain row-DIA vs complex128 "
          f"{dist(xp, x128):.3e}, kernel vs complex128 {dist(xk, x128):.3e}")
    return worst


def phase_fig5(dev):
    """The banded Fig. 5 classes through the entry points."""
    from tpcg_torch.problems import (banded_complex, banded_spd, helm_fe,
                                     parabolic_stencil, plane_wave_rhs)
    out = {}
    out["mhd1280b"] = phase_fig5_class(
        dev, "mhd1280b", banded_complex(1280, tuple(range(0, 9)), seed=2),
        1, 5000, "fused_cg_dia_cplx", "cli", also="stream_cg_dia_cplx")
    mt1 = banded_spd(97578, 50)
    n, nd = mt1.shape[0], 101
    for nb in (1, 8):
        state = 4 * nb * (5 * n + n + 2 * 1850)
        print(f"m_t1 B={nb}: values {4 * nd * n / 1e6:.1f} MB + state "
              f"{state / 1e6:.1f} MB = {(4 * nd * n + state) / 1e6:.1f} MB "
              "against the 50 MB L2")
        out[f"m_t1 B={nb}"] = phase_fig5_class(dev, "m_t1", mt1, nb, 200,
                                               "stream_cg_dia", "api")
    out["parabolic"] = phase_fig5_class(
        dev, "parabolic_fem", parabolic_stencil(725).to_dia().to_scipy(), 1,
        200, "stream_cg_dia", "api")
    # the class's own RHS, as in phases 4-5: over 100 iterations a random
    # RHS on this indefinite matrix lies near a breakdown of f32 COCG
    # (phase_helm_random prints the witness)
    out["helm_fem"] = phase_fig5_class(
        dev, "helm_fem", helm_fe(128, K_WAVE, eps=K_WAVE).to_scipy(), 1,
        5000, "stream_cg_dia_cplx", "api",
        B=plane_wave_rhs(128, K_WAVE).reshape(-1, 1).astype(np.complex64))
    out["helm_fem"]["err"] = max(out["helm_fem"]["err"],
                                 phase_helm_random(dev))
    return out


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
    dia_err = phase_dia_compare(dev)
    fig5 = phase_fig5(dev)
    kernels = [{
        "name": "fused_cg_stencil", "route": "cuda",
        "source": "tpcg_torch/csrc/fused_cg.cu",
        "replaces": "tpcg/ops/fused_cg.py:215",
        "launches": head["launches"], "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"]}]
    # each kernel's headline cell, and the classes whose path launched it
    for name, cell, paths in (
            ("stream_cg_dia", "m_t1 B=1", ("m_t1 B=1", "m_t1 B=8",
                                           "parabolic")),
            ("stream_cg_dia_cplx", "helm_fem", ("helm_fem",)),
            ("fused_cg_dia_cplx", "mhd1280b", ("mhd1280b",))):
        _, _, source, replaces = dia_kernels()[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(fig5[p]["launches"] for p in paths),
            "max_abs_err": max([dia_err[name]]
                               + [fig5[p]["err"] for p in paths]),
            "ms": fig5[cell]["ms"], "plain_ms": fig5[cell]["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
