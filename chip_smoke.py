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
  8. the streaming constant-tap kernel (``stream_cg_const_planes``) against
     its plain version on the card, 40 iterations, seeded x0: a square
     grid, a non-square grid, an odd height (1031 x 1024), a width that
     is not a multiple of 128, an odd width (513 x 1027, rows padded to
     1056 floats) and a grid whose blocks take uneven numbers of tiles
     (700 x 901) (x within 2e-3 max|x|, the live history within rel 1e-2,
     two launches bit-equal); a 2-RHS ``stream`` plan whose columns
     equal their single-RHS launches bit for bit (whether the plan batches
     them or not); 2 I over 400 iterations,
     which must freeze at the iteration its plain version freezes and stay
     finite;
  9. the planner's ``stream`` path at full size: helm_fe(N, 12, eps=12) on
     the card through ``plan_stencil_cg(...).solve`` at N=1024 x 5000
     iterations, N=2048, 2896 and 4096 x 1000, N=1024 with B=2 x 1000 and
     N=2049 x 1000 (an odd width),
     each with the launch counts set to 0 just before and read just after
     (the path must be ``stream`` and only ``stream_cg`` may move, as often
     as the planner's rule for several RHS says).  For
     each: the host seconds of the assembly and of ``prepare_stream``, a
     100-iteration gate of the kernel against its plain version on the plane
     wave (the tolerances of phase 8), the float64 relative residual of the
     final x (finite; printed, not gated), the median of 5 CUDA-event
     timings of the device-resident solve, GFLOPS by report Table II, the
     plain version's time over the gate, and the kernel's bound;
 10. the streaming symmetric-coefficient kernel (``stream_cg_sym_planes``,
     ``csrc/stream_cg_sym.cu``) against its plain version on the card, as
     phase 8: helm_fe_var(N, 40, C, rho=0.1) cut to 256 x 256, 300 x 700,
     1031 x 1024, 600 x 1000, the odd width 513 x 1027 and the uneven tiles
     of 700 x 901 (C = 1 + 0.5 U(0, 1) from seed 0), 40 iterations, seeded
     x0; a symmetric 31-offset pad-8 stencil (16 half planes, the kernel's
     limits), 16 iterations; a 2-RHS ``stream-coef`` plan (one copy of the
     half planes at the kernel's pitch, each column bit-equal to its own
     launch); 2 I over 400 iterations; the kernel's registers (it may not
     spill) and ``sym_layout`` at pads 1, 2 and 8;
 11. the planner's ``stream-coef`` path at full size, as phase 9: the
     variable-coefficient benchmark configuration helm_fe_var(N, 40, C,
     rho=0.1) and plane_wave_rhs(N, 40) (benchmarks/exp_stream4sym.py:28-38,
     exp_stream5sym.py:45-54) at N=1024 (with the complex128 spread line),
     2048, 2049 (a height JAX row-pads), 2896 and 4096 x 1000 iterations,
     and N=1024 with B=2; only ``stream_cg_sym`` may move; each also prints
     the rates of the kernel's own bytes (``sym_layout``) and of the 80 B
     floor; row 18's cell (N=4096) against the kernel's time before its
     redesign (PERF.md, row 18);
 12. the streaming real kernel (``stream_cg_real_planes``, const and coef
     mode, ``csrc/stream_cg_real.cu``) against its plain version on the
     card, as phase 8: Poisson and the 7-point FE stencil (const mode) and
     Poisson with a variable diagonal (coef mode) cut to 256 x 256,
     300 x 700, 1031 x 1024, 600 x 1000, the odd width 513 x 1027 and the
     uneven tiles of 700 x 901, 40 iterations from a seeded x0 and RHS;
     the parabolic_fem cell's operator (``parabolic_stencil(725,
     diag=6)``) and Poisson at 725 x 725, which run the one-wave resident
     layout, 100 iterations, x and the history gated bit-equal to the plain
     version; a 16-tap pad-8 stencil (the kernel's limits) in both modes,
     16 iterations; a 2-RHS ``stream-real`` plan; 2 I over 400 iterations
     in both modes; the kernel's registers (no instance may spill) and
     ``card_layout`` at 2048 x 2048, pads 1, 2 and 8;
 13. the planner's ``stream-real`` path at full size, as phase 9: Poisson
     (``problems.poisson``) and a seeded normal RHS at N=1024 x 5000 (it
     converges: the float64 relative residual is gated at 1e-3), 2048, 2049
     (a height JAX row-pads), 2896 (a width JAX column-pads) and 4096 x 1000
     and B=2 at N=1024; ``parabolic_stencil(2048)`` x 1000 (the 7-point FE
     class); Poisson with the variable diagonal c[0] += 0.3 U(0, 1) (coef
     mode) at N=1024 x 5000 (gated as Poisson) and 4096 x 1000; beside
     N=2048 the coef kernel on Poisson's own planes, off the main path
     (JAX's benchmarks/exp_realstream.py:34-74 configuration); the
     parabolic_fem cell's operator at N=725 x 5000, each launch counted by
     ``resident.stream_real``.  Only ``stream_cg_real`` may move; each
     prints the rates of the kernel's own bytes (``card_layout``) and of the
     24 B floor (plus 4 B a tap in coef mode); row 14's cell (N=4096)
     against the kernel's time before its redesign (PERF.md, row 14);
 14. the ``l2-const`` path (forced, as in JAX): helm_fe(N, 12, eps=12) at
     N=128 x 5000 and N=512 x 1000, B=1 and B=2 (plane waves), with phase
     4's gates against the plain version (the residual gated at N=128, B=1)
     and the ``l2-coef`` kernel's time on the same RHS beside it;
 15. the unstructured SpMV kernel (``route_spmv``, ``csrc/route_spmv.cu``)
     against its plain version on the card: the 1138_bus class
     (``irregular_spd(1138, 3.56)``), ``random_spd(5000, 100)``, empty rows
     beside one row of 5,000 nonzeros, and the CSR matrix ``routed_to_csr``
     rebuilds from tables ``build_routing_spmv`` made; nrhs 1, 2, 4, 5, 8,
     13; real, complex, and a real matrix with complex planes; y within
     1e-5 max|y| (another sum order), two launches bit-equal;
 16. the unstructured classes through the entry points, each with the
     launch counts set to 0 just before and read just after (only
     ``route_spmv`` may move): the 1138_bus class written to a .mtx and
     solved by ``python -m tpcg_torch.cli cg`` in this process, 1 RHS x
     5000 iterations; the ``random-routed`` class (``random_spd(97578,
     100, seed=1)``, nnz 19,593,022) through ``tpcg_torch.cg`` with CSR
     arrays at B=1 and B=4 x 200 iterations, and its complex symmetric
     variant at B=1; ``routing=`` with the tables the port's ``cli route``
     wrote for the 1138_bus class, whose x over 100 iterations must match
     the CSR call's within 1e-5 max|x|.  For each class: host seconds of
     generation, conversion (RCM included) and upload, and of the entry
     point; the float64 relative residual, gated at 1e-3 (where the history
     blows up past convergence, the blow-up is printed and the residual of
     the solve stopped at the history's lowest entry is gated); a
     100-iteration gate of the solve against the same ``block_cg`` over the
     plain SpMV on the card (``dia_close``); the median of 5 CUDA-event
     timings of the device-resident solve and its GFLOPS by Table II; one
     SpMV of the kernel, of the plain version and of the library call
     (``torch.sparse_csr_tensor(...) @ X``, cuSPARSE, timed here and called
     nowhere in the port), each the median of 5 timings of 20 products,
     beside its bound;
 17. the streaming general-coefficient kernel (``stream_cg_coef_planes``
     and ``stream_cg_coef_planes_batched_fat``, ``csrc/stream_cg_coef.cu``)
     against its plain version on the card: benchmarks/exp_batchfat.py's
     class helm_fe_var(N, 8, C, rho=0.5) made non-symmetric (plane 1 times
     1.5) cut to 256 x 256 (NB=1), 301 x 517 (2), 1031 x 1024 (3), 600 x
     1000 (4), 37 x 45 (5), 300 x 700 and 1024 x 1024 (8), 40 iterations
     from a seeded x0; a 13-point pad-2 stencil at NB=1 and 4; a 32-offset
     pad-8 stencil (the kernel's limits) at NB=1 and 8, 20 iterations; each
     RHS of NB=2, 4 and 8 launches, among them the odd width 513 x 1027
     and the uneven tiles of 700 x 901, against the plain version and,
     bit for bit, against its own NB=1 launch; 2 I over 400 iterations at
     NB=3 (x within 2e-3 max|x|, the live history within rel 1e-2, two
     launches bit-equal); the eight instances' registers (none may spill)
     and ``coef_layout`` at pads 1, 2 and 8;
 18. the planner's ``stream-coef`` path on that non-symmetric class at full
     size, as phase 9 (only ``stream_cg_coef`` may move, one launch per
     chunk of at most 8 RHS): N=1024 x 1000 at B=1 and 2, N=2048 x 500 at
     B=1, 2, 4 and 8, N=2049 x 500 and N=4096 x 1000 (B=1), with RHS the
     plane wave plane_wave_rhs(N, 8) times (1 + 0.1j r)
     (exp_batchfat.py:57-58); each prints us/it and us per RHS-iteration,
     GFLOPS by Table II, the kernel's own bytes (``coef_layout``) and the
     bytes floor (48 B a RHS and 8 B a coefficient plane a node) with their
     rates, the launches, the float64 relative residual and a 100-iteration
     gate of every RHS against the plain version; row 8's cell (N=4096)
     against the kernel's time before its redesign (PERF.md, row 8); then the
     general kernel called on the symmetric class at N=2048 x 500, where
     COCG converges, against the symmetric kernel (x within 2e-3 max|x|,
     both residuals printed, both kernels timed and the ratio printed);
 19. the constant-tap kernel with several RHS a launch
     (``stream_cg_const_planes_batched``, the NB = 1..8 instances of
     ``csrc/stream_cg.cu``) against its plain version on the card: phase
     8's geometries at NB = 1..8, 40 iterations, RHS r phase 8's (b, x0)
     pair times 1 + 0.1j r (x within 2e-3 max|x|, the live history within
     rel 1e-2), two launches bit-equal; each RHS of every launch against its own NB = 1
     launch, bit for bit; the instances' registers and spills (the NB = 1
     instance must not spill), the layout and blocks an SM; row 6's cell
     (phase 9's N=4096 x 1000 time) against the kernel's time before its
     redesign (PERF.md, row 6);
 20. the planner's ``stream`` path with several RHS at full width:
     helm_fe(N, 12, eps=12) with RHS the plane wave times (1 + 0.1j r), as
     phase 18 builds its batch, at N=1024 x 1000 (B=1, 2, 4, 8), 1448 x 500
     (B=4: one RHS's state past the L2), 2048 x 500 (B=1, 2, 4, 8), 2100 x
     500 (B=1, 4: JAX's v3-const and batched grid),
     2500 x 500 (B=4: JAX's v2 and batched grid) and 4096 x 500 (B=2), each
     with the launch counts set to 0 just before and read just after (only
     ``stream_cg`` may move, one launch per chunk of the planner's rule);
     the float64 relative residual of every RHS (printed, not gated), a
     100-iteration gate of every RHS against the plain version, the device
     memory one batched launch takes, and the batched (chunks of 8) and
     sequential (one launch a RHS) solves timed in turns: us/it and us per
     RHS-iteration, the own-bytes rate (the kernel's bytes a node and RHS
     from ``stream_layout``: 68.69 B at its 16 x 128 tiles), GFLOPS by
     Table II, the bound and the 48 B-a-node-a-RHS state floor;
 21. a JSON line of the kernels (each with its launches on the main paths,
     its largest error against its plain version, its time, its plain
     version's time, its bound and what sets it, and ``library_ms``: null
     for the CG kernels, as no single PyTorch call computes a
     fixed-iteration CG solve, and the cuSPARSE product for
     ``route_spmv``, whose row holds one SpMV at random-routed B=1), the
     card line, and the result line.

Bounds (``bound_ms``): the larger of the bytes the solve must move, each
input read once and each output written once, over 3.35 TB/s, and its
floating-point operations by report Table II over the 67 TFLOP/s float32
rate of an H100 SXM (no tensor cores).  Phases 9 and 11 also print the
state streaming floor: an iterate that does not fit on chip must at least
read and write x, r and d every iteration (48 B a node), and on
``stream-coef`` read the half coefficient planes once (32 B more); phase 13
prints the real one (24 B a node, and 4 B a tap in coef mode).  Real
stencils count ``2 nnz + 10 n`` operations an iteration
(benchmarks/exp_realstream4.py:41).  The SpMV's bound counts the CSR
arrays (8 B a nonzero, 12 B complex), the row pointers, x and y once, and
2 (8 complex) operations a nonzero and column.

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
import warnings

import numpy as np
import torch

K_WAVE = 12.0
# the variable-coefficient benchmark configuration's omega
# (benchmarks/exp_stream4sym.py:28-38, exp_stream5sym.py:45-54)
OMEGA_VAR = 40.0


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


HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32, outside the tensor cores


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from tpcg_torch.ops.fused_cg import fused_cg_stencil_plain, prepare_coef3
    from tpcg_torch.problems import helm_fe, plane_wave_rhs

    A = helm_fe(N, K_WAVE, eps=K_WAVE, device=dev)
    bg = plane_wave_rhs(N, K_WAVE)
    n = N * N
    nnz = int(torch.count_nonzero(A.coef))

    reset_counts()
    plan = tpcg_torch.plan_stencil_cg(A, iters)
    x, hist = plan.solve(bg)
    torch.cuda.synchronize()
    launches = moved_counts().get("fused_cg_stencil", 0)
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
    bound_ms, bound_by = bound(
        4 * (coef3.numel() + 3 * bp.numel() + iters + 1),
        iters * (8 * nnz + 16 * n + 24 * n))
    print(f"time N={N} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, {gflops:.2f} GFLOPS Table II); "
          f"plain fused_cg_stencil_plain {plain_ms:.3f} ms (one run); bound "
          f"{bound_ms:.3f} ms ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, launches=launches,
                bound_ms=bound_ms, bound_by=bound_by)


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
    """name -> (wrapper, plain version, route info)."""
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


# kernel name here -> its launch counter in tpcg_torch.trace
LAUNCH_COUNTERS = {"fused_cg_stencil": "launch.fused_cg",
                   "fused_cg_const": "launch.fused_const",
                   "stream_cg": "launch.stream_const",
                   "stream_cg_sym": "launch.stream_sym",
                   "stream_cg_real": "launch.stream_real",
                   "stream_cg_coef": "launch.stream_coef",
                   "stream_cg_dia": "launch.stream_dia",
                   "stream_cg_dia_cplx": "launch.stream_dia_cplx",
                   "fused_cg_dia_cplx": "launch.fused_dia",
                   "route_spmv": "launch.route_spmv"}


def reset_counts():
    from tpcg_torch import trace
    trace.clear()


def moved_counts():
    from tpcg_torch import trace
    c = trace.counters()
    return {k: c[v] for k, v in LAUNCH_COUNTERS.items() if c.get(v)}


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
    # values and offsets read once, b and x0 read and x written once
    bound_ms, bound_by = bound(
        4 * (vals.numel() + len(offsets) + 3 * bp.numel()
             + (iters + 1) * nrhs), nrhs * iters * flop)
    print(f"time {label} B={nrhs} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, {gflops:.2f} GFLOPS Table II, all "
          f"RHS); plain {plain_ms:.3f} ms (one run, {iters} it); bound "
          f"{bound_ms:.3f} ms ({bound_by})")
    if also:
        other = dia_kernels()[also][0]
        ms2, _ = median_ms(lambda: other(offsets, vals, bp, x0, iters),
                           reps=5)
        print(f"time {label} B={nrhs} {iters} it: {also} (off the main "
              f"path) {ms2:.3f} ms ({ms2 * 1e3 / iters:.3f} us/it)")
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=worst,
                bound_ms=bound_ms, bound_by=bound_by)


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


# phases 8 and 19: square, non-square, an odd height, a width that is not a
# multiple of 128, an odd width (513 x 1027: csrc/stream_cg.cu pads its rows
# to 1056 floats) and a grid whose blocks take uneven numbers of tiles
# (700 x 901; 513 x 1027 too), with their x0 seeds
STREAM_GEOMETRIES = ((256, 256, 1), (300, 700, 2), (1031, 1024, 3),
                     (600, 1000, 4), (513, 1027, 5), (700, 901, 6))


def stream_case(dev, nv, nh, seed, direction=None):
    """local_rect(max(nv, nh), 12) cut to nv x nh (helm_fe when square), with
    its operands for the streaming kernel, the square grid's plane wave cut
    to size, and a seeded 0.1 N(0, 1) initial guess."""
    from tpcg_torch.ops.stream_cg import prepare_stream
    from tpcg_torch.problems import local_rect, plane_wave_rhs
    N = max(nv, nh)
    S = local_rect(N, K_WAVE, K_WAVE, eta=K_WAVE, Nvert=nv, Nhoriz=nh,
                   device=dev)
    taps, strips = prepare_stream(S)
    b = plane_wave_rhs(N, K_WAVE, direction)[:nv, :nh]
    x0 = 0.1 * random_guess(b.shape, seed)
    return S, taps, strips, planes(b[None], dev)[:, 0], planes(x0[None],
                                                              dev)[:, 0]


def freeze_check(name, xk, hk, xp, hp):
    """2 I converges in one iteration: the kernel's history must reach 0 at
    the iteration its plain version's does and stay there, all finite."""
    hk, hp = hk.cpu().numpy(), hp.cpu().numpy()
    zk, zp = np.where(hk == 0)[0], np.where(hp == 0)[0]
    frozen = (len(zk) > 0 and len(zp) > 0 and zk[0] == zp[0]
              and bool(np.all(hk[zk[0]:] == 0)))
    finite = bool(torch.isfinite(xk).all() and np.isfinite(hk).all())
    print(f"freeze {name} 400 it: finite {finite}, frozen {frozen} (first "
          f"zero at {zk[0] if len(zk) else None}, plain "
          f"{zp[0] if len(zp) else None}), x == plain {torch.equal(xk, xp)}")
    if not (finite and frozen):
        fail(f"{name} did not freeze as its plain version does")


def phase_stream_compare(dev):
    """The streaming kernel against its plain version on the card; returns
    the max |x err|."""
    import tpcg_torch
    from tpcg_torch.ops import stream_cg as tsc
    from tpcg_torch.problems import helm_fe
    from tpcg_torch.sparse import Stencil2D
    worst = 0.0
    for nv, nh, seed in STREAM_GEOMETRIES:
        S, taps, strips, bp, x0p = stream_case(dev, nv, nh, seed)
        args = (S.offsets, S.grid, taps, strips, bp, x0p, 40)
        xk, hk = tsc.stream_cg_const_planes(*args)
        xk2, hk2 = tsc.stream_cg_const_planes(*args)
        xp, hp = tsc.stream_cg_const_planes_plain(*args)
        torch.cuda.synchronize()
        ok, err, lim, rel = dia_close(xk, hk, xp, hp)
        same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
        print(f"compare stream_cg {nv}x{nh} 40 it: max|x err| {err:.3e} "
              f"(limit {lim:.3e}), hist max rel {rel:.3e} (limit 1e-2), "
              f"repeat bit-equal {same}")
        if not (ok and same):
            fail(f"stream_cg disagrees with its plain version ({nv}x{nh})")
        worst = max(worst, err)

    # a 2-RHS plan: two launches, each column its single-RHS launch's bits
    S, taps, strips, b1, x1 = stream_case(dev, 520, 520, 5)
    _, _, _, b2, x2 = stream_case(dev, 520, 520, 6, direction=(0.6, 0.8))
    plan = tpcg_torch.plan_stencil_cg(S, 40, nb=2)
    xb, hb = plan.solve_planes(torch.stack([b1, b2], dim=1),
                               torch.stack([x1, x2], dim=1))
    same = plan.path == "stream"
    for c, (b, x0) in enumerate(((b1, x1), (b2, x2))):
        xs, hs = tsc.stream_cg_const_planes(S.offsets, S.grid, taps, strips,
                                            b, x0, 40)
        same = same and torch.equal(xb[:, c], xs) and torch.equal(hb[:, c],
                                                                  hs)
    print(f"stream plan 520x520 B=2 40 it: path {plan.path}, each column "
          f"bit-equal to its single-RHS launch {same}")
    if not same:
        fail("a 2-RHS stream plan differs from its single-RHS launches")

    # 2 I on the helm_fe offsets: converges in one iteration, then frozen
    A = helm_fe(64, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    S = Stencil2D(A.offsets, coef, A.grid)
    taps, strips = tsc.prepare_stream(S)
    b = torch.zeros((2, 64, 64), device=dev)
    b[0] = 1.0
    args = (S.offsets, S.grid, taps, strips, b, torch.zeros_like(b), 400)
    freeze_check("stream_cg 2 I 64x64", *tsc.stream_cg_const_planes(*args),
                 *tsc.stream_cg_const_planes_plain(*args))
    return worst


def wave_speeds(nv, nh):
    """The benchmark configuration's wave speeds, C = 1 + 0.5 U(0, 1) from
    seed 0 (benchmarks/exp_stream4sym.py:28-38), one per grid square."""
    return 1.0 + 0.5 * np.random.default_rng(0).random((nv - 1, nh - 1))


def sym_case(dev, nv, nh, seed, direction=None):
    """helm_fe_var(max(nv, nh), 40, C, rho=0.1) on an nv x nh grid, its half
    planes, the square grid's plane wave cut to size, and a seeded
    0.1 N(0, 1) initial guess."""
    from tpcg_torch.ops.stream_cg_sym import prepare_stream_sym
    from tpcg_torch.problems import helm_fe_var, plane_wave_rhs
    N = max(nv, nh)
    S = helm_fe_var(N, OMEGA_VAR, wave_speeds(nv, nh), rho=0.1, Nhoriz=nh,
                    Nvert=nv, device=dev)
    half, cplanes = prepare_stream_sym(S)
    b = plane_wave_rhs(N, OMEGA_VAR, direction)[:nv, :nh]
    x0 = 0.1 * random_guess(b.shape, seed)
    return S, half, cplanes, planes(b[None], dev)[:, 0], planes(x0[None],
                                                               dev)[:, 0]


def phase_sym_compare(dev):
    """The streaming symmetric-coefficient kernel against its plain version
    on the card; returns the max |x err|."""
    import tpcg_torch
    from tpcg_torch.ops import stream_cg_sym as tss
    from tpcg_torch.problems import helm_fe
    from tpcg_torch.sparse import Stencil2D
    from tpcg_torch.trace import counters
    worst = 0.0
    # odd heights and widths (513 x 1027: rows padded to 1056 floats) and
    # grids whose blocks take uneven numbers of tiles (700 x 901)
    for nv, nh, seed in ((256, 256, 1), (300, 700, 2), (1031, 1024, 3),
                         (600, 1000, 4), (513, 1027, 5), (700, 901, 6)):
        S, half, cplanes, bp, x0p = sym_case(dev, nv, nh, seed)
        args = (half, cplanes, bp, x0p, 40)
        xk, hk = tss.stream_cg_sym_planes(*args)
        xk2, hk2 = tss.stream_cg_sym_planes(*args)
        xp, hp = tss.stream_cg_sym_planes_plain(*args)
        torch.cuda.synchronize()
        ok, err, lim, rel = dia_close(xk, hk, xp, hp)
        same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
        print(f"compare stream_cg_sym {nv}x{nh} 40 it: max|x err| {err:.3e} "
              f"(limit {lim:.3e}), hist max rel {rel:.3e} (limit 1e-2), "
              f"repeat bit-equal {same}, x and history bit-equal to plain "
              f"{torch.equal(xk, xp) and torch.equal(hk, hp)}")
        if not (ok and same):
            fail(f"stream_cg_sym disagrees with its plain version "
                 f"({nv}x{nh})")
        worst = max(worst, err)

    # the kernel's limits: pad 8 and 16 half planes, odd grid
    nv, nh = 157, 203
    S = sym_limit_stencil(dev, nv, nh, 3)
    half, cplanes = tss.prepare_stream_sym(S)
    bp = planes(random_guess((1, nv, nh), 41), dev)[:, 0]
    x0p = 0.1 * torch.flip(bp, dims=(2,))
    args = (half, cplanes, bp, x0p, 16)
    xk, hk = tss.stream_cg_sym_planes(*args)
    xk2, hk2 = tss.stream_cg_sym_planes(*args)
    xp, hp = tss.stream_cg_sym_planes_plain(*args)
    torch.cuda.synchronize()
    ok, err, lim, rel = dia_close(xk, hk, xp, hp)
    same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
    print(f"compare stream_cg_sym pad 8, {len(half)} half planes ("
          f"{len(S.offsets)} offsets) {nv}x{nh} 16 it: max|x err| {err:.3e} "
          f"(limit {lim:.3e}), hist max rel {rel:.3e}, repeat bit-equal "
          f"{same}, bit-equal to plain "
          f"{torch.equal(xk, xp) and torch.equal(hk, hp)}; layout "
          f"{tss.sym_layout(nv, nh, 8, len(half))}")
    if not (ok and same and len(half) == 16):
        fail("stream_cg_sym disagrees with its plain version (pad 8, 16 half "
             "planes)")
    worst = max(worst, err)

    # a 2-RHS plan: one copy of the half planes at the kernel's pitch, two
    # launches, each column its single-RHS launch's bits
    S, half, cplanes, b1, x1 = sym_case(dev, 520, 520, 5)
    _, _, _, b2, x2 = sym_case(dev, 520, 520, 6, direction=(0.6, 0.8))
    copies = counters().get("copy.pad_sym_planes", 0)
    plan = tpcg_torch.plan_stencil_cg(S, 40, nb=2)
    xb, hb = plan.solve_planes(torch.stack([b1, b2], dim=1),
                               torch.stack([x1, x2], dim=1))
    copies = counters().get("copy.pad_sym_planes", 0) - copies
    same = plan.path == "stream-coef" and copies == 1
    for c, (b, x0) in enumerate(((b1, x1), (b2, x2))):
        xs, hs = tss.stream_cg_sym_planes(half, cplanes, b, x0, 40)
        same = same and torch.equal(xb[:, c], xs) and torch.equal(hb[:, c],
                                                                  hs)
    print(f"stream-coef plan 520x520 B=2 40 it: path {plan.path}, half "
          f"planes copied to the pitch {copies} time(s), each column "
          f"bit-equal to its single-RHS launch {same}")
    if not same:
        fail("a 2-RHS stream-coef plan differs from its single-RHS launches")

    # 2 I on the helm_fe offsets: converges in one iteration, then frozen
    A = helm_fe(64, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    half, cplanes = tss.prepare_stream_sym(Stencil2D(A.offsets, coef, A.grid))
    b = torch.zeros((2, 64, 64), device=dev)
    b[0] = 1.0
    args = (half, cplanes, b, torch.zeros_like(b), 400)
    freeze_check("stream_cg_sym 2 I 64x64", *tss.stream_cg_sym_planes(*args),
                 *tss.stream_cg_sym_planes_plain(*args))

    # the kernel's registers (no spill) and its layout
    from tpcg_torch.ops import _build
    name = spill = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and \
                "stream_cg_sym_kernel" in name:
            print(f"  ptxas {name}: {spill}; "
                  f"{line.split(':', 1)[1].strip()}")
            if "0 bytes spill stores" not in spill or \
                    "0 bytes spill loads" not in spill:
                fail(f"stream_cg_sym spills: {spill}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for pad, nh1 in ((1, 4), (2, 7), (8, 16)):
        blocks = tss.grid_blocks(2048, 2048, pad, nh1)
        print(f"stream_cg_sym layout at 2048 x 2048, pad {pad}, {nh1} half "
              f"planes: {tss.sym_layout(2048, 2048, pad, nh1)}; {blocks} "
              f"blocks of 256 threads ({blocks / sms:g} an SM)")
    return worst


def sym_limit_stencil(dev, nv, nh, seed):
    """A symmetric stencil at csrc/stream_cg_sym.cu's limits: 31 offsets
    within 8 nodes, (8, -8) among them, so 16 half planes; diagonally
    dominant (centre 4 + 0.5j + 0.1 U, the half planes -0.1 (1 + 0.3 U) +
    0.02j), each mirrored plane plane_{-s}(n) = plane_s(n - s)."""
    from tpcg_torch.ops import stream_cg_sym as tss
    from tpcg_torch.sparse import Stencil2D
    rng = np.random.default_rng(seed)
    pos = [(dm, dj) for dm in range(0, 9) for dj in range(-8, 9)
           if (dm, dj) > (0, 0) and (dm, dj) != (8, -8)]
    pick = rng.choice(len(pos), size=14, replace=False)
    half = [(0, 0), (8, -8)] + [pos[i] for i in pick]
    c = -0.1 * (1.0 + 0.3 * rng.random((16, nv, nh))) + 0.02j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((nv, nh))
    c = torch.from_numpy(c)
    mirrors = [tss._shift(c[t], dm, dj) for t, (dm, dj) in
               enumerate(half) if t > 0]
    offsets = tuple(half) + tuple((-dm, -dj) for dm, dj in half[1:])
    return Stencil2D(offsets, torch.cat([c, torch.stack(mirrors)]).to(dev),
                     (nv, nh))


def stream_spec(sym):
    """What the two streaming paths' full-size phases (9 and 11) vary: the
    problem, the preparation, the path, the kernel and its plain version,
    and the state streaming floor per node and iteration (x, r and d read
    and written once, 48 B; plus the half coefficient planes read once,
    32 B, on stream-coef)."""
    from tpcg_torch.ops import stream_cg as tsc
    from tpcg_torch.ops import stream_cg_sym as tss
    from tpcg_torch.problems import helm_fe, helm_fe_var
    if sym:
        return dict(
            label="stream-coef", path="stream-coef", kernel="stream_cg_sym",
            k=OMEGA_VAR, prep_name="prepare_stream_sym",
            build=lambda N, dev: helm_fe_var(N, OMEGA_VAR, wave_speeds(N, N),
                                             rho=0.1, device=dev),
            prepare=tss.prepare_stream_sym,
            lead=lambda A, prep: tuple(prep),
            wrap=tss.stream_cg_sym_planes,
            plain=tss.stream_cg_sym_planes_plain, floor_bytes=80,
            # a second plain version, its dot products summed in float32:
            # the witness of how far two float32 orders part on this class
            plain32=lambda half, cplanes, b, x0, n: tsc.cocg_planes_plain(
                lambda v: tss.apply_sym_planes(half, cplanes, v), b, x0, n))
    return dict(
        label="stream", path="stream", kernel="stream_cg", k=K_WAVE,
        prep_name="prepare_stream",
        build=lambda N, dev: helm_fe(N, K_WAVE, eps=K_WAVE, device=dev),
        prepare=tsc.prepare_stream,
        lead=lambda A, prep: (A.offsets, A.grid) + tuple(prep),
        wrap=tsc.stream_cg_const_planes,
        plain=tsc.stream_cg_const_planes_plain, floor_bytes=48)


def stream_launches(nv, nh, nb):
    """Launches of the ``stream`` path for nb RHS: one per chunk of the
    planner's rule (``auto._stream_chunk``; None is the kernel's limit)."""
    from tpcg_torch.ops import auto
    from tpcg_torch.ops import stream_cg as tsc
    chunk = auto._stream_chunk(nv, nh) or tsc.kernel_limits()[2]
    return -(-nb // chunk)


def phase_stream_main(dev, N, iters, nb=1, plain_full=False, spread=False,
                      sym=False):
    """A streaming path at full size; returns its numbers.  ``sym`` False:
    the ``stream`` path on helm_fe(N, 12, eps=12); True: the
    ``stream-coef`` path on helm_fe_var(N, 40, C, rho=0.1).

    plain_full: also time one run of the plain version over all the
    iterations (the JSON line's plain_ms).  spread: print beside the
    kernel's residual those of its plain version and of a complex128 solve
    over the same iterations (as phase 5 does at N=512: this indefinite
    system need not converge, and past a few hundred iterations float32
    orders drift apart)."""
    import tpcg_torch
    from tpcg_torch.problems import plane_wave_rhs
    spec = stream_spec(sym)
    label, kname = spec["label"], spec["kernel"]
    t0 = time.perf_counter()
    A = spec["build"](N, dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    n = N * N
    nnz = int(torch.count_nonzero(A.coef))
    t0 = time.perf_counter()
    prep = spec["prepare"](A)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    B = np.stack([plane_wave_rhs(N, spec["k"]),
                  plane_wave_rhs(N, spec["k"], (0.6, 0.8))][:nb])

    reset_counts()
    t0 = time.perf_counter()
    plan = tpcg_torch.plan_stencil_cg(A, iters, nb=nb)
    x, hist = plan.solve(B if nb > 1 else B[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = moved_counts()
    launches = counts.get(kname, 0)
    print(f"{label} N={N} B={nb}: n={n} nnz={nnz} path={plan.path} kernel "
          f"launches {counts}; host s: assembly {t_asm:.3f}, "
          f"{spec['prep_name']} {t_prep:.3f}, plan + solve {wall:.3f} (plan "
          f"runs {spec['prep_name']} again; solve uploads b and downloads x)")
    want = nb if sym else stream_launches(N, N, nb)
    if plan.path != spec["path"] or set(counts) != {kname} or launches != want:
        fail(f"N={N}: the {spec['path']} path did not launch its kernel "
             f"{want} times")

    X = np.asarray(x).reshape(nb, N, N)
    H = np.asarray(hist).reshape(iters + 1, nb)
    for c in range(nb):
        xt = torch.from_numpy(X[c].astype(np.complex128)).to(dev)
        bt = torch.from_numpy(B[c]).to(dev)
        res = float(torch.linalg.norm(bt - A.apply_grid(xt))
                    / torch.linalg.norm(bt))
        finite = bool(np.isfinite(X[c]).all() and np.isfinite(H[:, c]).all())
        print(f"{label} N={N} B={nb} rhs {c} {iters} it: finite {finite}, "
              f"hist[0] {H[0, c]:.4e}, hist[-1] {H[-1, c]:.4e}, relative "
              f"residual (f64) {res:.3e}")
        if not finite:
            fail(f"non-finite {label} solve at N={N}")

    # the 100-iteration gate on the plane wave, and the plain version's time
    bp = planes(B, dev)
    b0 = bp[:, 0].contiguous()
    x0 = torch.zeros_like(b0)
    args = spec["lead"](A, prep) + (b0, x0)
    xk, hk = spec["wrap"](*args, 100)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    xp, hp = spec["plain"](*args, 100)
    end.record()
    torch.cuda.synchronize()
    gate_plain_ms = start.elapsed_time(end)
    ok, err, lim, rel = dia_close(xk, hk, xp, hp)
    print(f"{label} N={N}: gate 100 it vs plain: max|x err| {err:.3e} (limit "
          f"{lim:.3e}), hist max rel {rel:.3e} (limit 1e-2), bit-equal "
          f"{torch.equal(xk, xp) and torch.equal(hk, hp)}; plain "
          f"{gate_plain_ms:.3f} ms")
    if "plain32" in spec:
        x32, _ = spec["plain32"](*args, 100)
        print(f"{label} N={N}: spread 100 it, max|x| distance / max|x| of the "
              f"plain version with float32 dot sums: "
              f"{float((x32 - xp).abs().max() / xp.abs().max()):.3e}")
    if not ok:
        fail(f"{kname} disagrees with its plain version at N={N}")

    ms, _ = median_ms(lambda: plan.solve_planes(bp if nb > 1 else b0),
                      reps=5)
    flop = 8 * nnz + 16 * n + 24 * n
    gflops = nb * iters * flop / (ms * 1e-3) / 1e9
    # the prepared operand (strips or half planes) read once; per RHS b and
    # x0 read and x and the history written
    bound_ms, bound_by = bound(
        4 * (prep[1].numel() + nb * (3 * 2 * n + iters + 1)),
        nb * iters * flop)
    ops_ms = nb * iters * flop / F32_FLOP_PER_S * 1e3
    floor_ms = nb * iters * spec["floor_bytes"] * n / HBM_BYTES_PER_S * 1e3
    plain_ms = None
    if plain_full:
        start.record()
        spec["plain"](*args, iters)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
    if spread:
        from tpcg_torch.cg import block_cg

        def rel_residual(xc):
            r = bt - A.apply_grid(xc.to(torch.complex128).reshape(N, N))
            return float(torch.linalg.norm(r) / torch.linalg.norm(bt))
        bt = torch.from_numpy(B[0]).to(dev)
        xs, _ = spec["plain"](*args, iters)
        x128 = block_cg(A, bt.reshape(-1), n_iterations=iters).x
        print(f"spread {label} N={N} {iters} it: rel residual (f64) of the "
              f"plain version (f32) {rel_residual(torch.complex(*xs)):.3e}, "
              f"of complex128 block_cg {rel_residual(x128):.3e}")
    rates = ""
    if sym:
        # the kernel's own bytes (sym_layout) and the floor's, over its time
        lay = tss_layout(N, prep)
        own_b = lay.bytes_a + lay.bytes_b
        rates = (f"; own {own_b:.2f} B a node ({lay.tile_rows} x "
                 f"{lay.tile_cols} tiles) at "
                 f"{nb * iters * own_b * n / (ms * 1e-3) / 1e12:.3f} TB/s, the "
                 f"floor's {spec['floor_bytes']} B at "
                 f"{nb * iters * spec['floor_bytes'] * n / (ms * 1e-3) / 1e12:.3f}"
                 " TB/s")
    print(f"time {label} N={N} B={nb} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / (nb * iters):.3f} us/it per RHS, {gflops:.2f} GFLOPS "
          f"Table II, all RHS{rates}); bound {bound_ms:.3f} ms ({bound_by}; "
          f"operations {ops_ms:.3f} ms); state streaming floor "
          f"({spec['floor_bytes']} B a node) {floor_ms:.3f} ms"
          + (f"; plain {plain_ms:.3f} ms (one run, {iters} it)"
             if plain_ms is not None else ""))
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=err,
                bound_ms=bound_ms, bound_by=bound_by, nb=nb)


def tss_layout(N, prep):
    """csrc/stream_cg_sym.cu's layout at N x N for prepare_stream_sym's
    (half_offsets, cplanes)."""
    from tpcg_torch.ops import stream_cg_sym as tss
    from tpcg_torch.ops.fused_cg import _pad_for
    half = prep[0]
    return tss.sym_layout(N, N, _pad_for(half), len(half))


# row 14 of PERF.md's kernel table: stream_cg_real at Poisson N=4096 x 1000,
# before its redesign (TMA-fed phase A, padded pitch): 348.203 ms (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md, row 14)
ROW14_MS = 348.203


def real_layout_of(S, prepared):
    """The layout a launch of csrc/stream_cg_real.cu runs for the stencil S
    in the mode ``prepared`` names on this card."""
    from tpcg_torch.ops import stream_cg_real as tsr
    from tpcg_torch.ops.fused_cg import _pad_for
    return tsr.card_layout(*S.grid, _pad_for(S.offsets), len(S.offsets),
                           prepared[0] == "coef")[0]


def real_stencil(dev, kind, nv, nh):
    """A real nv x nh stencil: ``poisson`` (5-point, diagonal 4), ``fe`` (the
    parabolic_fem-class 7-point stencil, diagonal 8), ``parabolic_fem``
    (square only: the same stencil with diagonal 6, the benchmark cell
    parabolic_fem.stencil_calls' operator) or ``vardiag`` (Poisson with
    c[0] += 0.3 U(0, 1) from seed 2); taps that leave the grid are zero.
    Square grids come from the entry points (``problems.poisson``,
    ``parabolic_stencil``)."""
    from tpcg_torch.problems import parabolic_stencil, poisson
    from tpcg_torch.sparse import Stencil2D
    if nv == nh and kind in ("poisson", "vardiag"):
        S = poisson(nv, device=dev)
    elif kind == "parabolic_fem":
        S = parabolic_stencil(nv, device=dev, diag=6.0)
    elif nv == nh:
        S = parabolic_stencil(nv, device=dev)
    else:
        offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))
        taps = [4.0, -1.0, -1.0, -1.0, -1.0]
        if kind == "fe":
            offs += ((1, 1), (-1, -1))
            taps = [8.0] + [-1.0] * 6
        c = np.zeros((len(offs), nv, nh))
        for s, (dm, dj) in enumerate(offs):
            c[s, max(0, -dm):nv - max(0, dm),
              max(0, -dj):nh - max(0, dj)] = taps[s]
        S = Stencil2D(offs, torch.from_numpy(c).to(dev), (nv, nh))
    if kind == "vardiag":
        S.coef[0] += torch.from_numpy(
            0.3 * np.random.default_rng(2).random((nv, nh))).to(dev)
    return S


def real_rhs(dev, nv, nh, seed):
    """A seeded standard normal RHS and a 0.1 N(0, 1) initial guess."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((nv, nh)).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((nv, nh))).astype(np.float32)
    return torch.from_numpy(b).to(dev), torch.from_numpy(x0).to(dev)


def real_run(S, prepared, b, x0, iters, plain=False):
    """One RHS through the real kernel (or its plain version) in the mode
    ``prepared`` names."""
    from tpcg_torch.ops import stream_cg_real as tsr
    mode, operand = prepared
    if mode == "const":
        fn = (tsr.stream_cg_real_planes_plain if plain
              else tsr.stream_cg_real_planes)
        return fn(S.offsets, S.grid, *operand, b, x0, iters)
    fn = (tsr.stream_cg_real_coef_planes_plain if plain
          else tsr.stream_cg_real_coef_planes)
    return fn(S.offsets, operand, b, x0, iters)


def phase_real_compare(dev):
    """The streaming real kernel against its plain version on the card;
    returns the max |x err|."""
    import tpcg_torch
    from tpcg_torch.ops import stream_cg_real as tsr
    from tpcg_torch.sparse import Stencil2D
    worst = 0.0
    for nv, nh, seed in ((256, 256, 1), (300, 700, 2), (1031, 1024, 3),
                         (600, 1000, 4), (513, 1027, 7), (700, 901, 8)):
        for kind in ("poisson", "fe", "vardiag"):
            S = real_stencil(dev, kind, nv, nh)
            prepared = tsr.prepare_real(S)
            b, x0 = real_rhs(dev, nv, nh, seed)
            xk, hk = real_run(S, prepared, b, x0, 40)
            xk2, hk2 = real_run(S, prepared, b, x0, 40)
            xp, hp = real_run(S, prepared, b, x0, 40, plain=True)
            torch.cuda.synchronize()
            ok, err, lim, rel = dia_close(xk, hk, xp, hp)
            same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
            print(f"compare stream_cg_real {kind} ({prepared[0]}) {nv}x{nh} "
                  f"40 it: max|x err| {err:.3e} (limit {lim:.3e}), hist max "
                  f"rel {rel:.3e} (limit 1e-2), repeat bit-equal {same}, x "
                  f"and history bit-equal to plain "
                  f"{torch.equal(xk, xp) and torch.equal(hk, hp)}")
            if not (ok and same):
                fail(f"stream_cg_real disagrees with its plain version "
                     f"({kind} {nv}x{nh})")
            worst = max(worst, err)

    # the one-wave resident layout (const mode, one tile a block, x, r and
    # q in registers) at the parabolic_fem cell's grid: bit for bit the
    # plain version over 100 iterations
    for kind, seed in (("parabolic_fem", 9), ("poisson", 10)):
        S = real_stencil(dev, kind, 725, 725)
        prepared = tsr.prepare_real(S)
        lay = real_layout_of(S, prepared)
        b, x0 = real_rhs(dev, 725, 725, seed)
        xk, hk = real_run(S, prepared, b, x0, 100)
        xk2, hk2 = real_run(S, prepared, b, x0, 100)
        xp, hp = real_run(S, prepared, b, x0, 100, plain=True)
        torch.cuda.synchronize()
        _, err, lim, _ = dia_close(xk, hk, xp, hp)
        same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
        plain = torch.equal(xk, xp) and torch.equal(hk, hp)
        print(f"compare stream_cg_real {kind} ({prepared[0]}) 725x725 100 "
              f"it: {lay}; max|x err| {err:.3e}, repeat bit-equal {same}, x "
              f"and history bit-equal to plain {plain}")
        if not (lay.resident and same and plain):
            fail(f"stream_cg_real's resident layout at 725x725 ({kind}) is "
                 f"not bit-equal to its plain version (resident "
                 f"{lay.resident})")
        worst = max(worst, err)

    # the kernel's limits, pad 8 and 16 taps, in both modes
    for mode in ("const", "coef"):
        S = real_limit_stencil(dev, 157, 203, 3, mode == "coef")
        prepared = tsr.prepare_real(S)
        b, _ = real_rhs(dev, 157, 203, 41)
        x0 = 0.1 * torch.flip(b, dims=(1,))
        xk, hk = real_run(S, prepared, b, x0, 16)
        xk2, hk2 = real_run(S, prepared, b, x0, 16)
        xp, hp = real_run(S, prepared, b, x0, 16, plain=True)
        torch.cuda.synchronize()
        ok, err, lim, rel = dia_close(xk, hk, xp, hp)
        same = torch.equal(xk, xk2) and torch.equal(hk, hk2)
        print(f"compare stream_cg_real 16 taps within pad 8 ({prepared[0]}) "
              f"157x203 16 it: {real_layout_of(S, prepared)}; max|x err| "
              f"{err:.3e} (limit {lim:.3e}), hist max rel {rel:.3e} (limit "
              f"1e-2), repeat bit-equal {same}")
        if not (ok and same and prepared[0] == mode):
            fail(f"stream_cg_real disagrees with its plain version at its "
                 f"limits ({mode} mode)")
        worst = max(worst, err)

    # a 2-RHS plan: two launches, each column its single-RHS launch's bits
    S = real_stencil(dev, "poisson", 1024, 1024)
    (b1, x1), (b2, x2) = (real_rhs(dev, 1024, 1024, seed) for seed in (5, 6))
    plan = tpcg_torch.plan_stencil_cg(S, 40, nb=2)
    xb, hb = plan.solve_planes(torch.stack([b1, b2]), torch.stack([x1, x2]))
    same = plan.path == "stream-real"
    prepared = tsr.prepare_real(S)
    for c, (b, x0) in enumerate(((b1, x1), (b2, x2))):
        xs, hs = real_run(S, prepared, b, x0, 40)
        same = same and torch.equal(xb[c], xs) and torch.equal(hb[:, c], hs)
    print(f"stream-real plan 1024x1024 B=2 40 it: path {plan.path}, each "
          f"column bit-equal to its single-RHS launch {same}")
    if not same:
        fail("a 2-RHS stream-real plan differs from its single-RHS launches")

    # 2 I: converges in one iteration, then frozen, in both modes
    A = real_stencil(dev, "poisson", 64, 64)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    S = Stencil2D(A.offsets, coef, A.grid)
    b = torch.ones((64, 64), device=dev)
    for prepared in (tsr.prepare_real(S),
                     ("coef", tsr.prepare_stream_coef_real(S))):
        xk, hk = real_run(S, prepared, b, torch.zeros_like(b), 400)
        xp, hp = real_run(S, prepared, b, torch.zeros_like(b), 400,
                          plain=True)
        freeze_check(f"stream_cg_real ({prepared[0]}) 2 I 64x64", xk, hk, xp,
                     hp)

    # the kernel's registers (no spill in any instance) and its layout
    from tpcg_torch.ops import _build
    name = spill = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and \
                "stream_cg_real_kernel" in name:
            print(f"  ptxas {name}: {spill}; "
                  f"{line.split(':', 1)[1].strip()}")
            if "0 bytes spill stores" not in spill or \
                    "0 bytes spill loads" not in spill:
                fail(f"stream_cg_real spills: {spill}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for coef in (False, True):
        for pad, noff in ((1, 5), (2, 9), (8, 16)):
            lay, blocks = tsr.card_layout(2048, 2048, pad, noff, coef)
            print(f"stream_cg_real layout at 2048 x 2048, "
                  f"{'coef' if coef else 'const'} mode, pad {pad}, {noff} "
                  f"taps: {lay}; {blocks} blocks of 256 threads "
                  f"({blocks / sms:g} an SM)")
    return worst


def real_limit_stencil(dev, nv, nh, seed, coef):
    """A real stencil at the kernel's limits: 16 taps within 8 nodes,
    (8, -8) among them; centre 4, the others from -0.2, -0.15, -0.1 (equal
    taps form groups in const mode).  Const mode: constant planes (a tap
    that leaves the grid reads 0 there); coef mode: each plane times
    1 + 0.3 U(0, 1).  As tests/test_torch_cuda.py's."""
    from tpcg_torch.sparse import Stencil2D
    rng = np.random.default_rng(seed)
    pos = [(dm, dj) for dm in range(-8, 9) for dj in range(-8, 9)
           if (dm, dj) not in ((0, 0), (8, -8))]
    pick = rng.choice(len(pos), size=14, replace=False)
    offsets = ((0, 0), (8, -8)) + tuple(pos[i] for i in pick)
    c = np.empty((16, nv, nh))
    c[0] = 4.0
    for s in range(1, 16):
        c[s] = (-0.2, -0.15, -0.1)[s % 3]
    if coef:
        c *= 1.0 + 0.3 * rng.random(c.shape)
    return Stencil2D(offsets, torch.from_numpy(c).to(dev), (nv, nh))


def phase_real_main(dev, kind, N, iters, nb=1, gate_residual=False,
                    plain_full=False, also_coef=False, resident=False):
    """The ``stream-real`` path at full size on ``real_stencil(kind, N)``
    with seeded normal RHS (with ``resident``, every launch in the resident
    layout); returns its numbers."""
    import tpcg_torch
    from tpcg_torch import trace
    from tpcg_torch.ops import stream_cg_real as tsr
    t0 = time.perf_counter()
    A = real_stencil(dev, kind, N, N)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    n = N * N
    nnz = int(torch.count_nonzero(A.coef))
    t0 = time.perf_counter()
    prep = tsr.prepare_real(A)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    B = torch.stack([real_rhs(dev, N, N, 11 + c)[0] for c in range(nb)])
    Bh = B.cpu().numpy()

    reset_counts()
    t0 = time.perf_counter()
    plan = tpcg_torch.plan_stencil_cg(A, iters, nb=nb)
    x, hist = plan.solve(Bh if nb > 1 else Bh[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = moved_counts()
    launches = counts.get("stream_cg_real", 0)
    held = trace.counters().get("resident.stream_real", 0)
    label = f"stream-real {kind} ({prep[0]}) N={N} B={nb}"
    print(f"{label}: n={n} nnz={nnz} path={plan.path} kernel launches "
          f"{counts}, resident {held}; host s: assembly {t_asm:.3f}, "
          f"prepare_real "
          f"{t_prep:.3f}, plan + solve {wall:.3f} (plan prepares again; "
          "solve uploads b and downloads x)")
    if (plan.path != "stream-real" or set(counts) != {"stream_cg_real"}
            or launches != nb):
        fail(f"N={N}: the stream-real path did not run its kernel once per "
             "RHS")
    if resident and held != launches:
        fail(f"N={N}: {held} of {launches} launches ran resident")
    X = np.asarray(x).reshape(nb, N, N)
    H = np.asarray(hist).reshape(iters + 1, nb)
    if X.dtype != np.float32:
        fail(f"stream-real returned {X.dtype}, not float32")
    for c in range(nb):
        xt = torch.from_numpy(X[c]).to(dev, torch.float64)
        bt = B[c].double()
        res = float(torch.linalg.norm(bt - A.apply_grid(xt))
                    / torch.linalg.norm(bt))
        finite = bool(np.isfinite(X[c]).all() and np.isfinite(H[:, c]).all())
        print(f"{label} rhs {c} {iters} it: finite {finite}, hist[0] "
              f"{H[0, c]:.4e}, least {H[:, c].min():.4e} at iteration "
              f"{int(H[:, c].argmin())}, hist[-1] {H[-1, c]:.4e}, relative "
              f"residual (f64) {res:.3e}"
              + (" (limit 1e-3)" if gate_residual else ""))
        if not finite or (gate_residual and res > 1e-3):
            fail(f"{label}: relative residual {res:.3e}")

    # the 100-iteration gate from a zero guess, and the plain version's time
    b0 = B[0].contiguous()
    x0 = torch.zeros_like(b0)
    xk, hk = real_run(A, prep, b0, x0, 100)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    xp, hp = real_run(A, prep, b0, x0, 100, plain=True)
    end.record()
    torch.cuda.synchronize()
    gate_plain_ms = start.elapsed_time(end)
    ok, err, lim, rel = dia_close(xk, hk, xp, hp)
    print(f"{label}: gate 100 it vs plain: max|x err| {err:.3e} (limit "
          f"{lim:.3e}), hist max rel {rel:.3e} (limit 1e-2), bit-equal "
          f"{torch.equal(xk, xp) and torch.equal(hk, hp)}; plain "
          f"{gate_plain_ms:.3f} ms")
    if not ok:
        fail(f"stream_cg_real disagrees with its plain version at N={N}")

    ms, (xk_full, _) = median_ms(
        lambda: plan.solve_planes(B if nb > 1 else b0), reps=5)
    xk_full = xk_full if nb == 1 else xk_full[0]
    flop = 2 * nnz + 10 * n
    gflops = nb * iters * flop / (ms * 1e-3) / 1e9
    operand = prep[1][1] if prep[0] == "const" else prep[1]
    # the strips or planes read once; per RHS b and x0 read, x and the
    # history written
    bound_ms, bound_by = bound(
        4 * (operand.numel() + nb * (3 * n + iters + 1)), nb * iters * flop)
    tap_bytes = 0 if prep[0] == "const" else 4 * len(A.offsets)
    floor_ms = nb * iters * (24 + tap_bytes) * n / HBM_BYTES_PER_S * 1e3
    lay = real_layout_of(A, prep)
    own_b = lay.bytes_a + lay.bytes_b
    own = nb * iters * own_b * n / (ms * 1e-3) / 1e12
    floor_rate = nb * iters * (24 + tap_bytes) * n / (ms * 1e-3) / 1e12
    plain_ms = None
    if plain_full:
        start.record()
        xs, hs = real_run(A, prep, b0, x0, iters, plain=True)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        res = float(torch.linalg.norm(B[0].double() - A.apply_grid(
            xs.double())) / torch.linalg.norm(B[0].double()))
        print(f"{label}: the plain version over {iters} it: hist[-1] "
              f"{float(hs[-1]):.4e}, relative residual (f64) {res:.3e}, x "
              f"bit-equal to the kernel's {torch.equal(xs, xk_full)}")
    print(f"time {label} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / (nb * iters):.3f} us/it per RHS, {gflops:.2f} GFLOPS "
          f"Table II, all RHS; own {own_b:.2f} B a node "
          f"(card_layout) at {own:.3f} TB/s, the {24 + tap_bytes} B floor at "
          f"{floor_rate:.3f} TB/s); bound {bound_ms:.3f} ms ({bound_by}); "
          f"state streaming floor ({24 + tap_bytes} B a node) "
          f"{floor_ms:.3f} ms"
          + (f"; plain {plain_ms:.3f} ms (one run, {iters} it)"
             if plain_ms is not None else ""))
    if also_coef:
        coefp = tsr.prepare_stream_coef_real(A)
        cpad = tsr.pad_real_planes(A.offsets, coefp)
        ms2, _ = median_ms(lambda: tsr.stream_cg_real_coef_planes(
            A.offsets, coefp, b0, x0, iters, cpad=cpad), reps=5)
        lay2 = real_layout_of(A, ("coef", coefp))
        own2_b = lay2.bytes_a + lay2.bytes_b
        own2 = iters * own2_b * n / (ms2 * 1e-3) / 1e12
        print(f"time {label} {iters} it: coef mode on the same planes (off "
              f"the main path) {ms2:.3f} ms ({ms2 * 1e3 / iters:.3f} us/it, "
              f"{iters * flop / (ms2 * 1e-3) / 1e9:.2f} GFLOPS Table II; own "
              f"{own2_b:.2f} B a node at {own2:.3f} TB/s)")
        del cpad, coefp
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=err,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_l2_const(dev, N, iters, nb, check_residual, plain_full=False):
    """The forced ``l2-const`` path on helm_fe(N, 12, eps=12) with nb plane
    waves; returns its numbers and prints l2-coef's time beside."""
    import tpcg_torch
    from tpcg_torch.ops import fused_cg_const as tcc
    from tpcg_torch.ops.cplx import block_cg_planes, make_pair_operator
    from tpcg_torch.problems import helm_fe, plane_wave_rhs
    A = helm_fe(N, K_WAVE, eps=K_WAVE, device=dev)
    n = N * N
    nnz = int(torch.count_nonzero(A.coef))
    B = np.stack([plane_wave_rhs(N, K_WAVE),
                  plane_wave_rhs(N, K_WAVE, (0.6, 0.8))][:nb])
    reset_counts()
    plan = tpcg_torch.plan_stencil_cg(A, iters, nb=nb, path="l2-const")
    x, hist = plan.solve(B if nb > 1 else B[0])
    torch.cuda.synchronize()
    counts = moved_counts()
    launches = counts.get("fused_cg_const", 0)
    label = f"l2-const N={N} B={nb}"
    print(f"{label}: n={n} nnz={nnz} path={plan.path} kernel launches "
          f"{counts}")
    if plan.path != "l2-const" or set(counts) != {"fused_cg_const"}:
        fail(f"{label}: the l2-const path did not run its kernel")
    X = np.asarray(x).reshape(nb, N, N)
    A64 = A.to_scipy()
    for c in range(nb):
        res = float(np.linalg.norm(B[c].reshape(-1) - A64 @ X[c].astype(
            np.complex128).reshape(-1)) / np.linalg.norm(B[c]))
        finite = bool(np.isfinite(X[c]).all() and np.isfinite(hist).all())
        gated = check_residual and c == 0
        print(f"{label} rhs {c} {iters} it: finite {finite}, relative "
              f"residual (f64) {res:.3e}" + (" (limit 1e-3)" if gated else ""))
        if not finite or (gated and res > 1e-3):
            fail(f"{label}: relative residual {res:.3e}")

    # phase 4's gates over 100 iterations: x and the history against the
    # plain version, the history against the plain planes oracle
    bp = planes(B, dev)
    x0p = torch.zeros_like(bp)
    cr, ci, strips = tcc.prepare_const(A)
    xk, hk = tpcg_torch.plan_stencil_cg(A, 100, path="l2-const").solve_planes(
        bp, x0p)
    xp, hp = tcc.fused_cg_const_planes_plain(A.offsets, A.grid, cr, ci,
                                             strips, bp, x0p, 100)
    ok, err, lim, excess = fused_close(xk, hk, xp, hp)
    hs = block_cg_planes(make_pair_operator(A),
                         bp.reshape(2, nb, n).transpose(1, 2),
                         n_iterations=100).residual_history
    # phase 4 holds its plane wave (rhs 0) to the oracle; the second
    # direction is printed
    rel = ((hk - hs).abs() / (hs.abs() + 1e-30)).amax(dim=0).tolist()
    print(f"{label}: gate 100 it vs fused_cg_const_planes_plain: max|x err| "
          f"{err:.3e} (limit {lim:.3e}), hist excess over tolerance "
          f"{excess:.3e}; vs plain block_cg_planes: max rel history diff "
          f"{', '.join(f'{v:.3e}' for v in rel)} (limit 1e-2 on rhs 0)")
    if not (ok and rel[0] <= 1e-2):
        fail(f"{label}: 100-iteration gate failed")

    ms, _ = median_ms(lambda: plan.solve_planes(bp), reps=5)
    coef_plan = tpcg_torch.plan_stencil_cg(A, iters, nb=nb)
    ms_coef, _ = median_ms(lambda: coef_plan.solve_planes(bp), reps=5)
    flop = 8 * nnz + 16 * n + 24 * n
    plain_ms = None
    if plain_full:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tcc.fused_cg_const_planes_plain(A.offsets, A.grid, cr, ci, strips, bp,
                                        x0p, iters)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
    # the strips read once; per RHS b and x0 read, x and the history written
    bound_ms, bound_by = bound(
        4 * (sum(t.numel() for t in strips) + 3 * bp.numel()
             + nb * (iters + 1)), nb * iters * flop)
    print(f"time {label} {iters} it: l2-const kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, "
          f"{nb * iters * flop / (ms * 1e-3) / 1e9:.2f} GFLOPS Table II, all "
          f"RHS); l2-coef kernel on the same RHS ({coef_plan.path}) "
          f"{ms_coef:.3f} ms ({ms_coef * 1e3 / iters:.3f} us/it); const / "
          f"coef {ms / ms_coef:.3f}; bound {bound_ms:.3f} ms ({bound_by})"
          + (f"; plain {plain_ms:.3f} ms (one run, {iters} it)"
             if plain_ms is not None else ""))
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=err,
                bound_ms=bound_ms, bound_by=bound_by)


# ---- phases 15-16: unstructured matrices and the CSR kernel ----

def route_matrix(name):
    """Phase 15's geometries: the 1138_bus class, random_spd(5000, 100),
    empty rows beside one row of 5,000 nonzeros, and the CSR matrix that
    routed_to_csr rebuilds from tables build_routing_spmv made."""
    import scipy.sparse as sp
    from tpcg_torch.ops.routing import build_routing_spmv, routed_to_csr
    from tpcg_torch.problems import irregular_spd, random_spd
    if name == "1138_bus":
        return irregular_spd(1138, 3.56, seed=0)
    if name == "random_spd(5000)":
        return random_spd(5000, 100, seed=1)
    if name == "skewed":
        rng = np.random.default_rng(3)
        n = 6000
        rows = np.concatenate([np.zeros(5000, np.int64),
                               rng.integers(1, n, 3000) // 2 * 2])
        return sp.csr_matrix((rng.standard_normal(len(rows)),
                              (rows, rng.integers(0, n, len(rows)))),
                             shape=(n, n))
    return routed_to_csr(build_routing_spmv(irregular_spd(700, 5, seed=4)))


def route_product(D, x, plain=False):
    """The function of route_spmv on (D, x): x (n, k) real, or (2, n, k)
    planes (complex values, or a real matrix with a complex RHS)."""
    from tpcg_torch.ops import route_spmv as rs
    if not plain:
        return (rs.routed_matvec_block(D.row_ptr, D.col, D.val, x)
                if x.dim() == 2 else rs.routed_pair(D).matvec(x))
    if x.dim() == 3 and D.val.dim() == 1:
        return torch.stack([rs.routed_matvec_plain(D.row_ptr, D.col, D.val,
                                                   x[p]) for p in range(2)])
    return rs.routed_matvec_plain(D.row_ptr, D.col, D.val, x)


def phase_route_compare(dev):
    """route_spmv against its plain version on the card: y within
    1e-5 max|y| (the kernel sums a row across 32 lanes and a shuffle tree,
    the plain version in row order), two launches bit-equal.  Returns the
    max |y err|."""
    from tpcg_torch.ops.route_spmv import DeviceRouted
    worst = 0.0
    rng = np.random.default_rng(5)
    for name in ("1138_bus", "random_spd(5000)", "skewed", "tables"):
        A = route_matrix(name)
        for kind in ("real", "complex", "real, complex RHS"):
            D = DeviceRouted.from_scipy(
                A.astype(np.complex64 if kind == "complex" else np.float32),
                device=dev)
            line = []
            for nrhs in (1, 2, 4, 5, 8, 13):
                shape = (D.n, nrhs) if kind == "real" else (2, D.n, nrhs)
                x = torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).to(dev)
                y1, y2 = route_product(D, x), route_product(D, x)
                yp = route_product(D, x, plain=True)
                torch.cuda.synchronize()
                err = float((y1 - yp).abs().max())
                lim = 1e-5 * float(yp.abs().max())
                same = torch.equal(y1, y2)
                line.append(f"{nrhs}: {err:.2e}/{lim:.2e}"
                            + ("" if same else " NOT bit-equal"))
                if not (torch.isfinite(y1).all() and err <= lim and same):
                    fail(f"route_spmv disagrees with its plain version "
                         f"({name}, {kind}, nrhs={nrhs})")
                worst = max(worst, err)
            print(f"compare route_spmv {name} n={D.n} nnz={D.nnz} {kind}: "
                  f"max|y err|/limit by nrhs {'; '.join(line)}; repeats "
                  "bit-equal")
    return worst


def route_spmv_times(D, X):
    """(kernel, plain, cuSPARSE) ms of one product on X, each the median
    of 5 CUDA-event timings of 20 products, and the bound (ms, by)."""
    nnz, n = D.nnz, D.n
    k = X.shape[-1]
    cplx = D.val.dim() == 2
    with warnings.catch_warnings():      # "beta" and invariant notices
        warnings.simplefilter("ignore")
        S = torch.sparse_csr_tensor(
            D.row_ptr, D.col,
            torch.complex(D.val[0], D.val[1]) if cplx else D.val, (n, n))
    Xl = torch.complex(X[0], X[1]) if cplx else X

    def reps(fn):
        return lambda: [fn() for _ in range(20)]
    ms = median_ms(reps(lambda: route_product(D, X)), 5)[0] / 20
    plain_ms = median_ms(reps(lambda: route_product(D, X, plain=True)),
                         5)[0] / 20
    lib_ms = median_ms(reps(lambda: S @ Xl), 5)[0] / 20
    # CSR read once (val, col, row_ptr), X read once, Y written once
    vb = 8 if cplx else 4
    nbytes = vb * nnz + 4 * nnz + 4 * (n + 1) + 2 * 4 * X.numel()
    flops = (8 if cplx else 2) * nnz * k
    return ms, plain_ms, lib_ms, bound(nbytes, flops)


def blow_up(hist):
    """(blew up, iteration of the lowest entry, per-iteration max over RHS)
    of a history: a blow-up is a non-finite entry, or a climb to 1e3 x the
    lowest entry."""
    h = np.asarray(hist, dtype=np.float64).reshape(len(hist), -1)
    worst = np.where(np.isfinite(h), h, np.nan).max(axis=1)   # over RHS
    k = int(np.nanargmin(worst))
    return (not np.isfinite(h).all() or worst[-1] > 1e3 * worst[k]), k, worst


def gate_routed(label, D, b, cplx):
    """100 iterations of the solve over the kernel against the same
    block_cg over the plain SpMV, on the card: x within 2e-3 max|x|, the
    live history within rel 1e-2 (dia_close).  Where either solve blows up
    past convergence (there two sum orders part: the plain version's
    index_add_ sums in no fixed order on the card), the gate runs both to
    the earlier of their histories' lowest entries instead, and says so."""
    from tpcg_torch.cg import block_cg
    from tpcg_torch.ops.cplx import block_cg_planes_chunked
    from tpcg_torch.ops.route_spmv import routed_pair

    def run(op, k):
        if cplx:
            return block_cg_planes_chunked(op, b, n_iterations=k)
        return block_cg(op, b, n_iterations=k)

    def plain(x):
        return route_product(D, x, plain=True)
    kernel = routed_pair(D) if cplx else D
    iters = 100
    rk, rp = run(kernel, iters), run(plain, iters)
    seen = [(name, *blow_up(r.residual_history.cpu().numpy()))
            for name, r in (("kernel", rk), ("plain", rp))]
    if any(bad for _, bad, _, _ in seen):
        iters = max(1, min(k for _, _, k, _ in seen))
        for name, bad, k, worst in seen:
            print(f"{label}: {name} solve over 100 it: blow-up {bad}, lowest "
                  f"history {worst[k]:.3e} at iteration {k}, largest finite "
                  f"{np.nanmax(worst):.3e}, last {worst[-1]:.3e}")
        print(f"{label}: BLOW-UP past convergence: the gate runs {iters} "
              "iterations")
        rk, rp = run(kernel, iters), run(plain, iters)
    torch.cuda.synchronize()
    worst, lim_w, rel_w, ok = 0.0, 0.0, 0.0, True
    for c in range(b.shape[-1]):
        ok_c, err, lim, rel = dia_close(
            rk.x[..., c], rk.residual_history[:, c], rp.x[..., c],
            rp.residual_history[:, c])
        ok = ok and ok_c
        worst, lim_w, rel_w = max(worst, err), max(lim_w, lim), max(rel_w, rel)
    return ok, worst, lim_w, rel_w, iters


def residual_at_best(label, A, B, x, hist, solve):
    """The float64 relative residual of x; where the history left the
    finite range (or x did), print the blow-up and read the residual of a
    solve stopped where the history is lowest (``solve(k)``)."""
    bad, k, worst = blow_up(hist)
    if not bad and np.isfinite(x).all():
        return rel_residual64(A, x, B)
    bad = np.where(~np.isfinite(worst))[0]
    print(f"{label}: BLOW-UP past convergence: first non-finite history "
          f"entry at iteration {bad[0] if len(bad) else None}, largest "
          f"finite {np.nanmax(worst):.3e}, last {worst[-1]:.3e}; the lowest, "
          f"{worst[k]:.3e}, is at iteration {k}: the residual below is that "
          "solve's")
    return rel_residual64(A, solve(k), B)


def phase_route_main(dev, label, make, nrhs, iters, cplx=False, via="api",
                     converges=True):
    """One unstructured class through an entry point (``via`` "api":
    tpcg_torch.cg with CSR arrays; "cli": the .mtx through ``python -m
    tpcg_torch.cli cg`` in this process); only route_spmv may launch."""
    import scipy.io
    import tpcg_torch
    from tpcg_torch import cli
    from tpcg_torch.ops.route_spmv import DeviceRouted
    t0 = time.perf_counter()
    A = make()
    t_gen = time.perf_counter() - t0
    A = A.astype(np.complex64 if cplx else np.float32).tocsr()
    n, nnz = A.shape[0], A.nnz
    rng = np.random.default_rng(7)
    if via == "cli":
        B = np.stack([np.full(n, (r + 1) * 5.0, A.dtype)
                      for r in range(nrhs)], axis=1)
    else:
        B = rng.standard_normal((n, nrhs)).astype(np.float32)
        if cplx:
            B = (B + 1j * rng.standard_normal((n, nrhs))).astype(A.dtype)
    b = B.T.reshape(-1)
    t0 = time.perf_counter()
    M, perm = tpcg_torch.to_device_matrix(A, reorder=True,
                                          route_fallback=not cplx,
                                          device=dev)
    if not isinstance(M, DeviceRouted):
        M = DeviceRouted.from_ell(M)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    if perm is not None:
        fail(f"{label}: RCM made the class banded; it is no unstructured "
             "cell")

    def solve(k):
        return tpcg_torch.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:],
                             n_rhs=nrhs, n_iterations=k, record_history=True,
                             device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        if via == "cli":
            path = os.path.join(tmp, f"{label}.mtx")
            scipy.io.mmwrite(path, A)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["cg", path, str(nrhs), str(int(cplx)),
                               str(iters), "--device", str(dev)])
            for line in out.getvalue().splitlines():
                print(f"  cli: {line}")
            if rc != 0:
                fail(f"{label}: the CLI failed (exit {rc})")
        else:
            x, hist = solve(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = moved_counts()
    launches = counts.get("route_spmv", 0)
    print(f"{label}: n={n} nnz={nnz} B={nrhs} {iters} it via {via}: kernel "
          f"launches {counts}; host s: generation {t_gen:.3f}, conversion "
          f"(RCM included) and upload {t_conv:.3f}, entry point {wall:.3f} "
          "(conversion and transfers included)")
    if set(counts) != {"route_spmv"} or launches < 1:
        fail(f"{label}: expected only route_spmv to launch, got {counts}")
    if via == "cli":
        # the CLI prints residual norms, not x: the API it calls gives x
        x, hist = solve(iters)
    X = x.reshape(nrhs, n).T
    res = residual_at_best(label, A, B, X, hist,
                           lambda k: solve(k)[0].reshape(nrhs, n).T)
    print(f"{label}: finite {bool(np.isfinite(X).all())}, relative residual "
          f"(f64) {res:.3e}" + (" (limit 1e-3)" if converges else
                                " (printed, not gated)"))
    if not np.isfinite(res) or (converges and res > 1e-3):
        fail(f"{label}: relative residual {res:.3e}")

    # device-resident operands: the gate and the timings
    from tpcg_torch.cg import block_cg
    from tpcg_torch.ops.cplx import block_cg_planes_chunked
    from tpcg_torch.ops.route_spmv import routed_pair
    if cplx:
        bd = torch.from_numpy(np.stack([B.real, B.imag]).astype(
            np.float32)).to(dev)
    else:
        bd = torch.from_numpy(np.ascontiguousarray(B)).to(dev)
    ok, err, lim, rel, gate_it = gate_routed(label, M, bd, cplx)
    print(f"{label}: gate {gate_it} it vs plain SpMV: max|x err| {err:.3e} "
          f"(limit {lim:.3e}), hist max rel {rel:.3e} (limit 1e-2)")
    if not ok:
        fail(f"{label}: 100-iteration gate failed")
    if cplx:
        P = routed_pair(M)
        ms, _ = median_ms(lambda: block_cg_planes_chunked(
            P, bd, n_iterations=iters), reps=5)
    else:
        ms, _ = median_ms(lambda: block_cg(M, bd, n_iterations=iters),
                          reps=5)
    flop = (8 * nnz + 40 * n) if cplx else (2 * nnz + 10 * n)
    gflops = nrhs * iters * flop / (ms * 1e-3) / 1e9
    spmv_ms, plain_ms, lib_ms, (bound_ms, bound_by) = route_spmv_times(
        M, bd)
    print(f"time {label} B={nrhs} {iters} it: solve {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, {gflops:.2f} GFLOPS Table II, all "
          f"RHS); one SpMV: kernel {spmv_ms * 1e3:.3f} us, plain "
          f"{plain_ms * 1e3:.3f} us, cuSPARSE (torch.sparse_csr_tensor @ X) "
          f"{lib_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}); SpMV share of an iteration "
          f"{spmv_ms * iters / ms:.2f}")
    return dict(ms=spmv_ms, plain_ms=plain_ms, library_ms=lib_ms,
                solve_ms=ms, launches=launches, err=err, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_route_tables(dev):
    """routing= with tables the port's ``cli route`` wrote for the
    1138_bus class: its x over 100 iterations within 1e-5 max|x| of the CSR
    call's; only route_spmv may launch."""
    import scipy.io
    import tpcg_torch
    from tpcg_torch import cli
    A = route_matrix("1138_bus").tocsr()
    n = A.shape[0]
    b = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path, tables = os.path.join(tmp, "1138.mtx"), os.path.join(
            tmp, "1138.npz")
        scipy.io.mmwrite(path, A)
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["route", path, tables])
        print(f"  cli route: {out.getvalue().strip()} "
              f"({time.perf_counter() - t0:.3f} s)")
        if rc != 0:
            fail(f"cli route failed (exit {rc})")
        reset_counts()
        xr = tpcg_torch.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:],
                           n_iterations=100, routing=tables, device=dev)
        counts = moved_counts()
    xc = tpcg_torch.cg(n, *csr_args(A)[:2], b, *csr_args(A)[2:],
                       n_iterations=100, device=dev)
    err = float(np.abs(xr - xc).max())
    lim = 1e-5 * float(np.abs(xc).max())
    print(f"1138_bus routing= tables vs CSR, 100 it: max|x err| {err:.3e} "
          f"(limit {lim:.3e}); launches {counts}")
    if set(counts) != {"route_spmv"} or err > lim:
        fail("routing= disagrees with the CSR call or ran another kernel")
    return counts["route_spmv"]


# row 18 of PERF.md's kernel table: stream_cg_sym at helm_fe_var(4096, 40,
# C, rho=0.1) x 1000, before its redesign (TMA-fed phase A with haloed
# half-plane boxes, padded pitch): 803.145 ms (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md, row 18)
ROW18_MS = 803.145


# ---- phases 17-18: general variable coefficients (csrc/stream_cg_coef.cu) --

# row 8 of PERF.md's kernel table: stream_cg_coef at the class below, N=4096
# x 1000, B=1, before its redesign (TMA-fed phase A, padded pitch): 999.598
# ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md, row 8)
ROW8_MS = 999.598

# the general-coefficient benchmark configuration's omega and damping
# (benchmarks/exp_batchfat.py:32-36)
OMEGA_GEN = 8.0
RHO_GEN = 0.5


def coef_class(dev, nv, nh, sym=False):
    """benchmarks/exp_batchfat.py's class, helm_fe_var(N, 8, C, rho=0.5)
    with C = 1 + 0.5 U(0, 1) from seed 0, on an nv x nh grid; unless
    ``sym``, made non-symmetric by scaling coefficient plane 1 by 1.5 (as
    tests/test_torch_auto.py does), which the general kernel then carries."""
    from tpcg_torch.problems import helm_fe_var
    A = helm_fe_var(max(nv, nh), OMEGA_GEN, wave_speeds(nv, nh), rho=RHO_GEN,
                    Nhoriz=nh, Nvert=nv, device=dev)
    if not sym:
        A.coef[1] *= 1.5
    return A


def coef_rhs(nv, nh, nb):
    """exp_batchfat.py's RHS (:57-58): the plane wave times (1 + 0.1j r),
    cut to nv x nh; (nb, nv, nh) complex."""
    from tpcg_torch.problems import plane_wave_rhs
    bg = plane_wave_rhs(max(nv, nh), OMEGA_GEN)[:nv, :nh]
    return np.stack([bg * (1 + 0.1j * r) for r in range(nb)])


def coef_gate(tgc, offsets, coefp, bp, x0p, iters):
    """The batched kernel against its plain version over ``iters``: every
    RHS within dia_close's tolerances, and two launches bit-equal.  Returns
    (ok, worst max|x err|, its limit, worst history rel, bit-equal to the
    plain version)."""
    xk, hk = tgc.stream_cg_coef_planes_batched_fat(offsets, coefp, bp, x0p,
                                                   iters)
    xk2, hk2 = tgc.stream_cg_coef_planes_batched_fat(offsets, coefp, bp, x0p,
                                                     iters)
    xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(offsets, coefp, bp,
                                                         x0p, iters)
    torch.cuda.synchronize()
    ok = torch.equal(xk, xk2) and torch.equal(hk, hk2)
    err = lim = rel = 0.0
    for c in range(bp.shape[1]):
        ok_c, e, li, r = dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])
        ok, err, lim, rel = ok and ok_c, max(err, e), max(lim, li), max(rel, r)
    same = torch.equal(xk, xp) and torch.equal(hk, hp)
    return ok, err, lim, rel, same


def phase_coef_compare(dev):
    """The general-coefficient kernel against its plain version on the
    card; returns the max |x err|."""
    from tpcg_torch.ops import stream_cg_coef as tgc
    from tpcg_torch.problems import helm_fe
    from tpcg_torch.sparse import Stencil2D
    worst = 0.0
    # odd heights and widths, a tile-less ragged edge, seeded x0; NB 1..8
    for nv, nh, nb, seed in ((256, 256, 1, 1), (301, 517, 2, 2),
                             (1031, 1024, 3, 3), (600, 1000, 4, 4),
                             (37, 45, 5, 5), (300, 700, 8, 6),
                             (1024, 1024, 8, 7)):
        A = coef_class(dev, nv, nh)
        coefp = tgc.prepare_stream_coef(A)
        bp = planes(coef_rhs(nv, nh, nb), dev)
        x0p = planes(0.1 * random_guess((nb, nv, nh), seed), dev)
        ok, err, lim, rel, same = coef_gate(tgc, A.offsets, coefp, bp, x0p, 40)
        print(f"compare stream_cg_coef {nv}x{nh} NB={nb} 40 it: max|x err| "
              f"{err:.3e} (limit {lim:.3e}), hist max rel {rel:.3e} (limit "
              f"1e-2), repeat bit-equal, x and history bit-equal to plain "
              f"{same}")
        if not ok:
            fail(f"stream_cg_coef disagrees with its plain version "
                 f"({nv}x{nh}, NB={nb})")
        worst = max(worst, err)

    # a non-symmetric 13-point stencil two nodes out (pad 2)
    nv, nh = 203, 311
    offsets = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2),
               (2, 0), (-2, 0), (1, 1), (-1, -1), (2, 1), (-1, 2))
    rng = np.random.default_rng(12)
    c = -0.2 * (1.0 + 0.3 * rng.random((len(offsets), nv, nh))) + 0.05j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((nv, nh))
    coefp = tgc.prepare_stream_coef(
        Stencil2D(offsets, torch.from_numpy(c).to(dev), (nv, nh)))
    for nb in (1, 4):
        bp = planes(random_guess((nb, nv, nh), 20 + nb), dev)
        x0p = planes(0.1 * random_guess((nb, nv, nh), 30 + nb), dev)
        ok, err, lim, rel, same = coef_gate(tgc, offsets, coefp, bp, x0p, 30)
        print(f"compare stream_cg_coef pad 2 {nv}x{nh} NB={nb} 30 it: max|x "
              f"err| {err:.3e} (limit {lim:.3e}), hist max rel {rel:.3e}, "
              f"bit-equal to plain {same}")
        if not ok:
            fail(f"stream_cg_coef disagrees with its plain version (pad 2, "
                 f"NB={nb})")
        worst = max(worst, err)

    # a stencil at the kernel's limits: pad 8 and 32 offsets, odd grid
    nv, nh = 157, 203
    rng = np.random.default_rng(3)
    ring = [(dm, dj) for dm in range(-8, 9) for dj in range(-8, 9)
            if (dm, dj) not in ((0, 0), (8, -8))]
    offsets = ((0, 0), (8, -8)) + tuple(
        ring[i] for i in rng.choice(len(ring), size=30, replace=False))
    c = -0.1 * (1.0 + 0.3 * rng.random((32, nv, nh))) + 0.02j
    c[0] = 4.0 + 0.5j + 0.1 * rng.random((nv, nh))
    coefp = tgc.prepare_stream_coef(
        Stencil2D(offsets, torch.from_numpy(c).to(dev), (nv, nh)))
    for nb in (1, 8):
        bp = planes(random_guess((nb, nv, nh), 50 + nb), dev)
        x0p = planes(0.1 * random_guess((nb, nv, nh), 60 + nb), dev)
        ok, err, lim, rel, same = coef_gate(tgc, offsets, coefp, bp, x0p, 20)
        print(f"compare stream_cg_coef pad 8, 32 offsets {nv}x{nh} NB={nb} 20 "
              f"it: max|x err| {err:.3e} (limit {lim:.3e}), hist max rel "
              f"{rel:.3e}, bit-equal to plain {same}; layout "
              f"{tgc.coef_layout(nv, nh, 8, nb, 32)}")
        if not ok:
            fail(f"stream_cg_coef disagrees with its plain version (pad 8, "
                 f"NB={nb})")
        worst = max(worst, err)

    # each RHS of an NB launch against its own NB = 1 launch, bit for bit
    # (the tile, the rings and the grid do not depend on NB), and against
    # the plain version: odd widths whose rows the kernel pads (513 x 1027)
    # and grids whose blocks take uneven numbers of tiles (700 x 901)
    for nv, nh, nb in ((300, 700, 2), (1024, 1024, 4), (1024, 1024, 8),
                       (513, 1027, 2), (513, 1027, 8), (700, 901, 2),
                       (700, 901, 8)):
        A = coef_class(dev, nv, nh)
        coefp = tgc.prepare_stream_coef(A)
        bp = planes(coef_rhs(nv, nh, nb), dev)
        x0p = planes(0.1 * random_guess((nb, nv, nh), nv + nb), dev)
        ok, err, lim, rel, _ = coef_gate(tgc, A.offsets, coefp, bp, x0p, 40)
        xb, hb = tgc.stream_cg_coef_planes_batched_fat(A.offsets, coefp, bp,
                                                       x0p, 40)
        equal = True
        for k in range(nb):
            x1, h1 = tgc.stream_cg_coef_planes(A.offsets, coefp, bp[:, k],
                                               x0p[:, k], 40)
            equal = equal and torch.equal(xb[:, k], x1) and torch.equal(
                hb[:, k], h1)
        print(f"stream_cg_coef {nv}x{nh} NB={nb} 40 it: max|x err| {err:.3e} "
              f"(limit {lim:.3e}), hist max rel {rel:.3e}; each RHS bit-equal "
              f"to its NB=1 launch {equal}")
        if not (ok and equal):
            fail(f"an NB={nb} launch parts from its plain version or its NB=1 "
                 f"launches ({nv}x{nh})")
        worst = max(worst, err)

    # the instances' registers and spills (none may spill), the layout and
    # the blocks an NB launch holds at N=2048, pad 1 (all co-resident)
    from tpcg_torch.ops import _build
    name = spill = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and \
                "stream_cg_coef_kernel" in name:
            print(f"  ptxas {name}: {spill}; "
                  f"{line.split(':', 1)[1].strip()}")
            if "0 bytes spill stores" not in spill or \
                    "0 bytes spill loads" not in spill:
                fail(f"an instance of stream_cg_coef spills: {spill}")
    for pad, noff in ((1, 7), (2, 13), (8, 32)):
        print(f"stream_cg_coef layout at 2048 x 2048, pad {pad}, {noff} "
              f"offsets, NB=1: {tgc.coef_layout(2048, 2048, pad, 1, noff)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("stream_cg_coef blocks of 256 threads at 2048 x 2048, pad 1, by NB "
          "1..8 (per SM): " + ", ".join(
              f"{g} ({g / sms:g})" for g in (
                  tgc.grid_blocks(2048, 2048, 1, nb, 7)
                  for nb in range(1, 9))))

    # 2 I as full planes on the helm_fe offsets: frozen from iteration 1
    A = helm_fe(64, 5.0, eps=5.0, device=dev)
    coef = torch.zeros_like(A.coef)
    coef[0] = 2.0
    coefp = tgc.prepare_stream_coef(Stencil2D(A.offsets, coef, A.grid))
    b = torch.zeros((2, 3, 64, 64), device=dev)
    b[0] = torch.arange(1, 4, device=dev, dtype=torch.float32)[:, None, None]
    args = (A.offsets, coefp, b, torch.zeros_like(b), 400)
    xk, hk = tgc.stream_cg_coef_planes_batched_fat(*args)
    xp, hp = tgc.stream_cg_coef_planes_batched_fat_plain(*args)
    for k in range(3):
        freeze_check(f"stream_cg_coef 2 I 64x64 NB=3 rhs {k}", xk[:, k],
                     hk[:, k], xp[:, k], hp[:, k])
    return worst


def phase_coef_main(dev, A, iters, nb, plain_full=False, converges=False):
    """The ``stream-coef`` path on a non-symmetric stencil at full size,
    through ``plan_stencil_cg(...).solve``: the path and the launches (one
    per chunk of at most 8 RHS), the float64 residual (gated only where
    COCG converges), the 100-iteration gate against the plain version, the
    timings and the bound.  Returns its numbers."""
    import tpcg_torch
    from tpcg_torch.ops import stream_cg_coef as tgc
    nv, nh = A.grid
    n = nv * nh
    noff = len(A.offsets)
    nnz = int(torch.count_nonzero(A.coef))
    label = f"stream-coef general {nv}x{nh} B={nb}"
    B = coef_rhs(nv, nh, nb)

    reset_counts()
    t0 = time.perf_counter()
    plan = tpcg_torch.plan_stencil_cg(A, iters, nb=nb)
    x, hist = plan.solve(B if nb > 1 else B[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = moved_counts()
    launches = counts.get("stream_cg_coef", 0)
    chunks = -(-nb // tgc.kernel_limits()[2])
    print(f"{label}: n={n} nnz={nnz} noff={noff} path={plan.path} kernel "
          f"launches {counts} (expected {chunks}); host s: plan + solve "
          f"{wall:.3f} (plan tries prepare_stream, prepare_stream_sym, then "
          "prepare_stream_coef; solve uploads b and downloads x)")
    if (plan.path != "stream-coef" or set(counts) != {"stream_cg_coef"}
            or launches != chunks):
        fail(f"{label}: the stream-coef path did not run the general kernel "
             "once per chunk of RHS")
    X = np.asarray(x).reshape(nb, nv, nh)
    H = np.asarray(hist).reshape(iters + 1, nb)
    worst_res = 0.0
    for c in range(nb):
        xt = torch.from_numpy(X[c].astype(np.complex128)).to(dev)
        bt = torch.from_numpy(B[c]).to(dev)
        res = float(torch.linalg.norm(bt - A.apply_grid(xt))
                    / torch.linalg.norm(bt))
        worst_res = max(worst_res, res)
        finite = bool(np.isfinite(X[c]).all() and np.isfinite(H[:, c]).all())
        print(f"{label} rhs {c} {iters} it: finite {finite}, hist[0] "
              f"{H[0, c]:.4e}, hist[-1] {H[-1, c]:.4e}, relative residual "
              f"(f64) {res:.3e}" + (" (limit 1e-3)" if converges
                                    else " (printed, not gated)"))
        if not finite or (converges and res > 1e-3):
            fail(f"{label}: relative residual {res:.3e}")

    # the 100-iteration gate against the plain version, every RHS
    coefp = tgc.prepare_stream_coef(A)
    bp = planes(B, dev)
    x0p = torch.zeros_like(bp)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ok, err, lim, rel, same = coef_gate(tgc, A.offsets, coefp, bp, x0p, 100)
    end.record()
    torch.cuda.synchronize()
    print(f"{label}: gate 100 it vs plain, every RHS: max|x err| {err:.3e} "
          f"(limit {lim:.3e}), hist max rel {rel:.3e} (limit 1e-2), bit-equal "
          f"{same} ({start.elapsed_time(end):.3f} ms for two kernel runs and "
          "the plain version)")
    if not ok:
        fail(f"stream_cg_coef disagrees with its plain version ({label})")

    ms, _ = median_ms(lambda: plan.solve_planes(bp if nb > 1 else bp[:, 0]),
                      reps=5)
    flop = 8 * nnz + 16 * n + 24 * n
    gflops = nb * iters * flop / (ms * 1e-3) / 1e9
    # the coefficient planes read once; per RHS b and x0 read, x and the
    # history written
    bound_ms, bound_by = bound(
        4 * (coefp.numel() + nb * (3 * 2 * n + iters + 1)),
        nb * iters * flop)
    ops_ms = nb * iters * flop / F32_FLOP_PER_S * 1e3
    floor_b = 48 * nb + 8 * noff
    floor_ms = iters * floor_b * n / HBM_BYTES_PER_S * 1e3
    lay = tgc.coef_layout(nv, nh, 1, nb, noff)
    own_b = nb * (lay.bytes_a + lay.bytes_b)
    own = iters * own_b * n / (ms * 1e-3) / 1e12
    plain_ms = None
    if plain_full:
        start.record()
        tgc.stream_cg_coef_planes_batched_fat_plain(A.offsets, coefp, bp, x0p,
                                                    iters)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
    print(f"time {label} {iters} it: kernel {ms:.3f} ms "
          f"({ms * 1e3 / iters:.3f} us/it, {ms * 1e3 / (nb * iters):.3f} us "
          f"per RHS-iteration, {gflops:.2f} GFLOPS Table II, all RHS; own "
          f"{own_b:.2f} B a node (coef_layout, {lay.tile_rows} x "
          f"{lay.box_cols - 2 * lay.col_halo} tiles) at {own:.3f} TB/s, "
          f"the floor's {floor_b} B at "
          f"{iters * floor_b * n / (ms * 1e-3) / 1e12:.3f} TB/s); bound "
          f"{bound_ms:.3f} ms ({bound_by}; operations {ops_ms:.3f} ms); bytes "
          f"floor ({floor_b} B a node: 48 B a RHS + 8 B a coefficient plane) "
          f"{floor_ms:.3f} ms"
          + (f"; plain {plain_ms:.3f} ms (one run, {iters} it)"
             if plain_ms is not None else ""))
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=err,
                bound_ms=bound_ms, bound_by=bound_by, res=worst_res)


def phase_coef_sym_cross(dev, N, iters):
    """The general kernel called directly on the symmetric class, where COCG
    converges: its x against the symmetric kernel's (2e-3 max|x|), both
    float64 relative residuals printed; returns the max |x err|."""
    from tpcg_torch.ops import stream_cg_coef as tgc
    from tpcg_torch.ops import stream_cg_sym as tss
    A = coef_class(dev, N, N, sym=True)
    bp = planes(coef_rhs(N, N, 1), dev)[:, 0]
    x0p = torch.zeros_like(bp)
    coefp = tgc.prepare_stream_coef(A)
    half, cplanes = tss.prepare_stream_sym(A)
    cpad = tss.pad_sym_planes(half, cplanes)
    # both kernels on their own operands, timed in turns (median of 5 each)
    ms_g, (xg, hg) = median_ms(lambda: tgc.stream_cg_coef_planes(
        A.offsets, coefp, bp, x0p, iters), reps=5)
    ms_s, (xs, hs) = median_ms(lambda: tss.stream_cg_sym_planes(
        half, cplanes, bp, x0p, iters, cpad=cpad), reps=5)
    ms_g2, _ = median_ms(lambda: tgc.stream_cg_coef_planes(
        A.offsets, coefp, bp, x0p, iters), reps=5)
    torch.cuda.synchronize()
    print(f"time on the symmetric class N={N} x {iters} it: general kernel "
          f"{ms_g:.3f} / {ms_g2:.3f} ms ({ms_g * 1e3 / iters:.3f} us/it), "
          f"symmetric kernel {ms_s:.3f} ms ({ms_s * 1e3 / iters:.3f} us/it): "
          f"symmetric / general {ms_s / statistics.median([ms_g, ms_g2]):.3f}")
    bt = torch.complex(bp[0], bp[1]).to(torch.complex128)

    def rel_res(xp):
        xc = torch.complex(xp[0], xp[1]).to(torch.complex128)
        return float(torch.linalg.norm(bt - A.apply_grid(xc))
                     / torch.linalg.norm(bt))
    err = float((xg - xs).abs().max())
    lim = 2e-3 * float(xs.abs().max())
    print(f"stream_cg_coef on the symmetric class N={N} x {iters} it: max|x - "
          f"stream_cg_sym x| {err:.3e} (limit {lim:.3e}); relative residual "
          f"(f64) general {rel_res(xg):.3e}, symmetric {rel_res(xs):.3e}; "
          f"hist[-1] {float(hg[-1]):.3e} / {float(hs[-1]):.3e}")
    if not (torch.isfinite(xg).all() and err <= lim):
        fail("the general kernel parts from the symmetric one on a "
             "symmetric stencil")
    return err


# ---- phases 19-20: several RHS in one launch of csrc/stream_cg.cu ----

# row 6 of PERF.md's kernel table: stream_cg at helm_fe N=4096 x 1000, B=1,
# before its redesign (no stored q, padded pitch, TMA ring): the NB=1
# instance, 556.841 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md, row 6)
ROW6_MS = 556.841


def wave_batch(N, nb):
    """helm_fe's plane wave times (1 + 0.1j r), r = 0..nb-1, as phase 18
    builds its batch (exp_batchfat.py:57-58); (nb, N, N) complex."""
    from tpcg_torch.problems import plane_wave_rhs
    b = plane_wave_rhs(N, K_WAVE)
    return np.stack([b * (1 + 0.1j * r) for r in range(nb)])


def phase_stream_batched_compare(dev, row6_ms):
    """The batched constant-tap kernel (``stream_cg_const_planes_batched``)
    against its plain version on the card: phase 8's geometries at NB =
    1..8, 40 iterations, seeded x0; each RHS of every launch against its own
    NB = 1 launch (bit-equal); the instances' registers, spills and blocks
    an SM; row 6's cell (phase 9's N=4096 time) against its PR 3 time.
    Returns the max |x err|."""
    from tpcg_torch.ops import _build
    from tpcg_torch.ops import stream_cg as tsc
    worst = 0.0
    for nv, nh, seed in STREAM_GEOMETRIES:
        # phase 8's (b, x0) pair times s_r = 1 + 0.1j r: every RHS as well
        # conditioned as phase 8's (independent 0.1 N(0, 1) draws of x0
        # land some RHS near a float32 breakdown, where at 40 iterations
        # two sum orders part past 2e-3 max|x|: PERF.md, PR 9)
        S, taps, strips, b, x0 = stream_case(dev, nv, nh, seed)
        s_r = torch.tensor([1 + 0.1j * r for r in range(8)], device=dev,
                           dtype=torch.complex64)[:, None, None]
        B = torch.complex(b[0], b[1])[None] * s_r
        X0 = torch.complex(x0[0], x0[1])[None] * s_r
        bp = torch.stack([B.real, B.imag]).contiguous()
        x0p = torch.stack([X0.real, X0.imag]).contiguous()
        lead = (S.offsets, S.grid, taps, strips)
        ones = [tsc.stream_cg_const_planes(*lead, bp[:, c].contiguous(),
                                           x0p[:, c].contiguous(), 40)
                for c in range(8)]
        plain = [tsc.stream_cg_const_planes_plain(
            *lead, bp[:, c].contiguous(), x0p[:, c].contiguous(), 40)
            for c in range(8)]
        for nb in range(1, 9):
            args = lead + (bp[:, :nb].contiguous(), x0p[:, :nb].contiguous(),
                           40)
            xk, hk = tsc.stream_cg_const_planes_batched(*args)
            xk2, hk2 = tsc.stream_cg_const_planes_batched(*args)
            torch.cuda.synchronize()
            ok = torch.equal(xk, xk2) and torch.equal(hk, hk2)
            same = True
            err = lim = rel = 0.0
            for c in range(nb):
                ok_c, e, li, r = dia_close(xk[:, c], hk[:, c], *plain[c])
                ok, err, lim, rel = (ok and ok_c, max(err, e), max(lim, li),
                                     max(rel, r))
                same = same and torch.equal(xk[:, c], ones[c][0]) and \
                    torch.equal(hk[:, c], ones[c][1])
            print(f"compare stream_cg batched {nv}x{nh} NB={nb} 40 it: max|x "
                  f"err| {err:.3e} (limit {lim:.3e}), hist max rel {rel:.3e} "
                  f"(limit 1e-2), repeat bit-equal, each RHS bit-equal to its "
                  f"NB=1 launch {same}")
            if not (ok and same):
                fail(f"stream_cg NB={nb} disagrees with its plain version or "
                     f"its NB=1 launches ({nv}x{nh})")
            worst = max(worst, err)

    # the instances' registers and spills, and the blocks of a launch
    name = spill = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and \
                "stream_cg_kernel" in name:
            print(f"  ptxas {name}: {spill}; "
                  f"{line.split(':', 1)[1].strip()}")
            if "stream_cg_kernelILi1EE" in name and \
                    "0 bytes spill stores" not in spill:
                fail(f"the NB=1 instance of stream_cg spills: {spill}")
    lay = tsc.stream_layout(2048, 2048, 1)
    print(f"stream_cg layout at 2048 x 2048, pad 1: {lay}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("stream_cg blocks of 256 threads at 2048 x 2048, pad 1, by NB 1..8 "
          "(per SM): " + ", ".join(
              f"{g} ({g / sms:g})" for g in (
                  tsc.grid_blocks(2048, 2048, 1, nb) for nb in range(1, 9))))
    print(f"row 6 (stream_cg, helm_fe N=4096 x 1000, B=1, NB=1 instance): "
          f"{row6_ms:.3f} ms (phase 9) against {ROW6_MS} ms of the kernel "
          f"before its redesign: {100 * (row6_ms / ROW6_MS - 1):+.2f}%")
    return worst


def alternating_ms(fns, reps):
    """Median device ms of each of fns (CUDA events), run in turns after one
    warm-up each, so that both see the same card state; and their last
    results."""
    outs = [fn() for fn in fns]
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for k, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs[k] = fn()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times], outs


def phase_stream_batch_main(dev, A, prep, iters, nb, plain_full=False):
    """The planner's ``stream`` path with nb RHS at full width: helm_fe(N,
    12, eps=12) and the plane wave times (1 + 0.1j r) through
    ``plan_stencil_cg(...).solve``, the launch counts set to 0 just before
    and read just after (only ``stream_cg`` may move, as often as the
    planner's rule says); the float64 relative residual of every RHS
    (printed, not gated); a 100-iteration gate of every RHS against the
    plain version; then the same RHS batched (chunks of 8) and sequential
    (one launch a RHS), timed in turns.  Returns its numbers."""
    import tpcg_torch
    from tpcg_torch.ops import auto
    from tpcg_torch.ops import stream_cg as tsc
    nv, nh = A.grid
    n = nv * nh
    taps, strips = prep
    nnz = int(torch.count_nonzero(A.coef))
    label = f"stream N={nv} B={nb}"
    B = wave_batch(nv, nb)
    want = stream_launches(nv, nh, nb)

    reset_counts()
    t0 = time.perf_counter()
    plan = tpcg_torch.plan_stencil_cg(A, iters, nb=nb)
    x, hist = plan.solve(B if nb > 1 else B[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = moved_counts()
    launches = counts.get("stream_cg", 0)
    rule = auto._stream_chunk(nv, nh)
    print(f"{label}: n={n} nnz={nnz} path={plan.path} kernel launches "
          f"{counts} (expected {want}: chunks of "
          f"{rule or tsc.kernel_limits()[2]} RHS); host s: plan + solve "
          f"{wall:.3f} (plan runs prepare_stream; solve uploads b and "
          "downloads x)")
    if plan.path != "stream" or set(counts) != {"stream_cg"} or \
            launches != want:
        fail(f"{label}: the stream path did not launch stream_cg {want} "
             "times")
    X = np.asarray(x).reshape(nb, nv, nh)
    H = np.asarray(hist).reshape(iters + 1, nb)
    for c in range(nb):
        xt = torch.from_numpy(X[c].astype(np.complex128)).to(dev)
        bt = torch.from_numpy(B[c]).to(dev)
        res = float(torch.linalg.norm(bt - A.apply_grid(xt))
                    / torch.linalg.norm(bt))
        finite = bool(np.isfinite(X[c]).all() and np.isfinite(H[:, c]).all())
        print(f"{label} rhs {c} {iters} it: finite {finite}, hist[0] "
              f"{H[0, c]:.4e}, hist[-1] {H[-1, c]:.4e}, relative residual "
              f"(f64) {res:.3e} (printed, not gated)")
        if not finite:
            fail(f"non-finite {label} solve")

    # the 100-iteration gate of every RHS against the plain version
    bp = planes(B, dev)
    x0p = torch.zeros_like(bp)
    args = (A.offsets, A.grid, taps, strips, bp, x0p)
    xk, hk = tsc.stream_cg_const_planes_batched(*args, 100, chunk=rule)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    xp, hp = tsc.stream_cg_const_planes_batched_plain(*args, 100)
    end.record()
    torch.cuda.synchronize()
    ok, err, lim, rel = True, 0.0, 0.0, 0.0
    for c in range(nb):
        ok_c, e, li, r = dia_close(xk[:, c], hk[:, c], xp[:, c], hp[:, c])
        ok, err, lim, rel = ok and ok_c, max(err, e), max(lim, li), max(rel, r)
    print(f"{label}: gate 100 it vs plain, every RHS: max|x err| {err:.3e} "
          f"(limit {lim:.3e}), hist max rel {rel:.3e} (limit 1e-2); plain "
          f"{start.elapsed_time(end):.3f} ms")
    if not ok:
        fail(f"stream_cg disagrees with its plain version ({label})")

    # the device memory of one batched launch (chunks of 8)
    lay = tsc.stream_layout(nv, nh, 1)
    own = lay.bytes_a + lay.bytes_b
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tsc.stream_cg_const_planes_batched(*args, 1)
    torch.cuda.synchronize()
    print(f"{label}: one batched launch takes "
          f"{(torch.cuda.max_memory_allocated(dev) - base) / 2**20:.1f} MiB "
          f"past its operands (state {min(nb, 8)} x {lay.pitch}-float rows: "
          f"r, two d, x; x out, history, partials)")
    # batched (chunks of 8) and sequential (one launch a RHS), in turns
    (ms_b, ms_s), _ = alternating_ms(
        [lambda: tsc.stream_cg_const_planes_batched(*args, iters),
         lambda: tsc.stream_cg_const_planes_batched(*args, iters, chunk=1)],
        reps=5)
    ms = ms_s if rule == 1 else ms_b
    flop = 8 * nnz + 16 * n + 24 * n
    bound_ms, bound_by = bound(
        4 * (strips.numel() + nb * (3 * 2 * n + iters + 1)),
        nb * iters * flop)
    floor_ms = nb * iters * 48 * n / HBM_BYTES_PER_S * 1e3
    plain_ms = None
    if plain_full:
        start.record()
        tsc.stream_cg_const_planes_batched_plain(*args, iters)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)

    def rates(t):
        return (f"{t * 1e3 / iters:.3f} us/it, {t * 1e3 / (nb * iters):.3f} "
                f"us per RHS-iteration, own {own:.2f} B a node and RHS at "
                f"{nb * iters * own * n / (t * 1e-3) / 1e12:.2f} TB/s, "
                f"{nb * iters * flop / (t * 1e-3) / 1e9:.2f} GFLOPS Table II")
    print(f"time {label} {iters} it: batched {ms_b:.3f} ms ({rates(ms_b)}); "
          f"sequential {ms_s:.3f} ms ({rates(ms_s)}); batched / sequential "
          f"{ms_b / ms_s:.4f}; the plan takes "
          f"{'sequential' if rule == 1 else 'batched'}; bound "
          f"{bound_ms:.3f} ms ({bound_by}); state floor (48 B a node and "
          f"RHS) {floor_ms:.3f} ms"
          + (f"; plain {plain_ms:.3f} ms (one run, {iters} it)"
             if plain_ms is not None else ""))
    return dict(ms=ms, ms_batched=ms_b, ms_seq=ms_s, plain_ms=plain_ms,
                launches=launches, err=err, bound_ms=bound_ms,
                bound_by=bound_by, nb=nb)


def phase_stream_batch(dev):
    """Phase 20: the cells of the ``stream`` path with several RHS."""
    from tpcg_torch.ops.stream_cg import prepare_stream
    from tpcg_torch.problems import helm_fe
    runs = []
    for N, iters, nbs in ((1024, 1000, (1, 2, 4, 8)), (1448, 500, (4,)),
                          (2048, 500, (1, 2, 4, 8)), (2100, 500, (1, 4)),
                          (2500, 500, (4,)), (4096, 500, (2,))):
        t0 = time.perf_counter()
        A = helm_fe(N, K_WAVE, eps=K_WAVE, device=dev)
        prep = prepare_stream(A)
        torch.cuda.synchronize()
        print(f"stream N={N}: helm_fe assembled and prepare_stream in "
              f"{time.perf_counter() - t0:.3f} s (host)")
        runs += [phase_stream_batch_main(dev, A, prep, iters, nb,
                                         plain_full=(N, nb) == (2048, 8))
                 for nb in nbs]
        del A, prep
    return runs


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
    stream_err = phase_stream_compare(dev)
    stream = [phase_stream_main(dev, 1024, 5000, spread=True),
              phase_stream_main(dev, 2048, 1000),
              phase_stream_main(dev, 2896, 1000),
              phase_stream_main(dev, 4096, 1000, plain_full=True),
              phase_stream_main(dev, 1024, 1000, nb=2),
              phase_stream_main(dev, 2049, 1000)]
    sym_err = phase_sym_compare(dev)
    sym = [phase_stream_main(dev, 1024, 1000, spread=True, sym=True),
           phase_stream_main(dev, 2048, 1000, sym=True),
           phase_stream_main(dev, 2049, 1000, sym=True),
           phase_stream_main(dev, 2896, 1000, sym=True),
           phase_stream_main(dev, 4096, 1000, plain_full=True, sym=True),
           phase_stream_main(dev, 1024, 1000, nb=2, sym=True)]
    print(f"row 18 (stream_cg_sym, N=4096 x 1000): {sym[4]['ms']:.3f} ms "
          f"(phase 11) against {ROW18_MS} ms of the kernel before its "
          f"redesign: {100 * (sym[4]['ms'] / ROW18_MS - 1):+.2f}%")
    real_err = phase_real_compare(dev)
    real = [phase_real_main(dev, "poisson", 1024, 5000, gate_residual=True),
            phase_real_main(dev, "poisson", 2048, 1000, also_coef=True),
            phase_real_main(dev, "poisson", 2049, 1000),
            phase_real_main(dev, "poisson", 2896, 1000),
            phase_real_main(dev, "poisson", 4096, 1000, plain_full=True),
            phase_real_main(dev, "poisson", 1024, 1000, nb=2),
            phase_real_main(dev, "fe", 2048, 1000),
            phase_real_main(dev, "vardiag", 1024, 5000, gate_residual=True),
            phase_real_main(dev, "vardiag", 4096, 1000, plain_full=True),
            phase_real_main(dev, "parabolic_fem", 725, 5000, plain_full=True,
                            resident=True)]
    print(f"row 14 (stream_cg_real, Poisson N=4096 x 1000): "
          f"{real[4]['ms']:.3f} ms (phase 13) against {ROW14_MS} ms of the "
          f"kernel before its redesign: "
          f"{100 * (real[4]['ms'] / ROW14_MS - 1):+.2f}%")
    l2c = [phase_l2_const(dev, 128, 5000, 1, True, plain_full=True),
           phase_l2_const(dev, 128, 5000, 2, True),
           phase_l2_const(dev, 512, 1000, 1, False),
           phase_l2_const(dev, 512, 1000, 2, False)]
    from tpcg_torch.problems import irregular_spd, random_spd
    route_err = phase_route_compare(dev)
    route = [
        phase_route_main(dev, "1138_bus", lambda: irregular_spd(
            1138, 3.56, seed=0), 1, 5000, via="cli"),
        phase_route_main(dev, "random-routed", lambda: random_spd(
            97578, 100, seed=1), 1, 200),
        phase_route_main(dev, "random-routed", lambda: random_spd(
            97578, 100, seed=1), 4, 200),
        phase_route_main(dev, "random-routed complex", lambda: random_spd(
            97578, 100, seed=1, dtype=np.complex64), 1, 200, cplx=True)]
    route_tables = phase_route_tables(dev)
    coef_err = phase_coef_compare(dev)
    coef = []
    for N, runs in ((1024, ((1000, 1), (1000, 2))),
                    (2048, ((500, 1), (500, 2), (500, 4), (500, 8))),
                    (2049, ((500, 1),)), (4096, ((1000, 1),))):
        t0 = time.perf_counter()
        A = coef_class(dev, N, N)
        torch.cuda.synchronize()
        print(f"stream-coef general N={N}: helm_fe_var assembled and plane 1 "
              f"scaled in {time.perf_counter() - t0:.3f} s (host)")
        coef += [phase_coef_main(dev, A, iters, nb, plain_full=N == 4096)
                 for iters, nb in runs]
        del A
    coef_err = max([coef_err, phase_coef_sym_cross(dev, 2048, 500)]
                   + [r["err"] for r in coef])
    print(f"row 8 (stream_cg_coef, N=4096 x 1000, B=1): {coef[-1]['ms']:.3f} "
          f"ms (phase 18) against {ROW8_MS} ms of the kernel before its "
          f"redesign: {100 * (coef[-1]['ms'] / ROW8_MS - 1):+.2f}%")
    batch_err = phase_stream_batched_compare(dev, stream[3]["ms"])
    sb = phase_stream_batch(dev)
    # launches of the one-RHS instance (one RHS, or the plan's sequential
    # rule) and of the NB >= 2 instances on the main paths (phases 9, 20)
    one = [r for r in stream + sb if r["nb"] == r["launches"]]
    multi = [r for r in stream + sb if r["nb"] != r["launches"]]
    head_b = next(r for r in sb if r["plain_ms"] is not None)
    kernels = [{
        "name": "fused_cg_stencil", "route": "cuda",
        "source": "tpcg_torch/csrc/fused_cg.cu",
        "replaces": "tpcg/ops/fused_cg.py:215",
        "launches": head["launches"], "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None}]
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
            "ms": fig5[cell]["ms"], "plain_ms": fig5[cell]["plain_ms"],
            "bound_ms": fig5[cell]["bound_ms"],
            "bound_by": fig5[cell]["bound_by"], "library_ms": None})
    # the stream kernel's headline cell: N=4096, 1000 iterations
    kernels.append({
        "name": "stream_cg", "route": "cuda",
        "source": "tpcg_torch/csrc/stream_cg.cu",
        "replaces": "tpcg/ops/stream_cg.py:166; tpcg/ops/stream_cg.py:387; "
                    "tpcg/ops/stream_cg_v4.py:73; tpcg/ops/stream_cg_v5.py:77",
        "launches": sum(r["launches"] for r in one),
        "max_abs_err": max([stream_err] + [r["err"] for r in one]),
        "ms": stream[3]["ms"], "plain_ms": stream[3]["plain_ms"],
        "bound_ms": stream[3]["bound_ms"], "bound_by": stream[3]["bound_by"],
        "library_ms": None})
    # the NB >= 2 instances' cell: N=2048 x 500, B=8, one launch
    kernels.append({
        "name": "stream_cg_batched", "route": "cuda",
        "source": "tpcg_torch/csrc/stream_cg.cu",
        "replaces": "tpcg/ops/stream_cg.py:741; tpcg/ops/stream_cg.py:941",
        "launches": sum(r["launches"] for r in multi),
        "max_abs_err": max([batch_err] + [r["err"] for r in multi]),
        "ms": head_b["ms_batched"], "plain_ms": head_b["plain_ms"],
        "bound_ms": head_b["bound_ms"], "bound_by": head_b["bound_by"],
        "library_ms": None})
    # the sym kernel's headline cell: N=4096, 1000 iterations
    kernels.append({
        "name": "stream_cg_sym", "route": "cuda",
        "source": "tpcg_torch/csrc/stream_cg_sym.cu",
        "replaces": "tpcg/ops/stream_cg.py:387; tpcg/ops/stream_cg.py:461; "
                    "tpcg/ops/stream_cg_v3.py:56; "
                    "tpcg/ops/stream_cg_v4_sym.py:104; "
                    "tpcg/ops/stream_cg_v5_sym.py:67",
        "launches": sum(r["launches"] for r in sym),
        "max_abs_err": max([sym_err] + [r["err"] for r in sym]),
        "ms": sym[4]["ms"], "plain_ms": sym[4]["plain_ms"],
        "bound_ms": sym[4]["bound_ms"], "bound_by": sym[4]["bound_by"],
        "library_ms": None})
    # the real kernel's headline cell: Poisson N=4096, 1000 iterations
    kernels.append({
        "name": "stream_cg_real", "route": "cuda",
        "source": "tpcg_torch/csrc/stream_cg_real.cu",
        "replaces": "tpcg/ops/stream_cg_real.py:167; "
                    "tpcg/ops/stream_cg_real.py:265; "
                    "tpcg/ops/stream_cg_real.py:315; "
                    "tpcg/ops/stream_cg_v4_real.py:37; "
                    "tpcg/ops/stream_cg_v5_real.py:51",
        "launches": sum(r["launches"] for r in real),
        "max_abs_err": max([real_err] + [r["err"] for r in real]),
        "ms": real[4]["ms"], "plain_ms": real[4]["plain_ms"],
        "bound_ms": real[4]["bound_ms"], "bound_by": real[4]["bound_by"],
        "library_ms": None})
    # the const whole solve's headline cell: helm_fem N=128, 5000 it, B=1
    kernels.append({
        "name": "fused_cg_const", "route": "cuda",
        "source": "tpcg_torch/csrc/fused_cg.cu",
        "replaces": "tpcg/ops/fused_cg_const.py:136",
        "launches": sum(r["launches"] for r in l2c),
        "max_abs_err": max(r["err"] for r in l2c),
        "ms": l2c[0]["ms"], "plain_ms": l2c[0]["plain_ms"],
        "bound_ms": l2c[0]["bound_ms"], "bound_by": l2c[0]["bound_by"],
        "library_ms": None})
    # the CSR kernel's headline cell: random-routed B=1, one SpMV
    kernels.append({
        "name": "route_spmv", "route": "cuda",
        "source": "tpcg_torch/csrc/route_spmv.cu",
        "replaces": "tpcg/ops/route_spmv.py:104",
        "launches": sum(r["launches"] for r in route) + route_tables,
        "max_abs_err": max([route_err] + [r["err"] for r in route]),
        "ms": route[1]["ms"], "plain_ms": route[1]["plain_ms"],
        "bound_ms": route[1]["bound_ms"], "bound_by": route[1]["bound_by"],
        "library_ms": route[1]["library_ms"]})
    # the general-coefficient kernel's headline cell: N=4096, 1000 it, B=1
    kernels.append({
        "name": "stream_cg_coef", "route": "cuda",
        "source": "tpcg_torch/csrc/stream_cg_coef.cu",
        "replaces": "tpcg/ops/stream_cg.py:461; tpcg/ops/stream_cg.py:1012; "
                    "tpcg/ops/stream_cg.py:1152; tpcg/ops/stream_cg_v3.py:56; "
                    "tpcg/ops/stream_cg_v4.py:73",
        "launches": sum(r["launches"] for r in coef),
        "max_abs_err": coef_err,
        "ms": coef[-1]["ms"], "plain_ms": coef[-1]["plain_ms"],
        "bound_ms": coef[-1]["bound_ms"], "bound_by": coef[-1]["bound_by"],
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
