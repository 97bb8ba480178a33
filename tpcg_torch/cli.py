"""Command-line driver (counterpart of ``tpcg/cli.py``).

``python -m tpcg_torch.cli cg <matrix.mtx> <nRHS> <isComplex> <nIterations> [--device DEV]``
    ==  the C CLI (``main.c:13-61``): load a Matrix Market file (symmetric
    expansion included), build B with per-RHS constant ``(r+1)*5.0`` and
    X0 = 0, run the fixed-iteration block CG on DEV (default ``cuda:0``),
    report timing and the final residual per RHS.  It exits non-zero if DEV
    is absent; it never falls back to the CPU.

``python -m tpcg_torch.cli route <matrix.mtx> <out.npz>``
    ==  ``tpcg.cli route``: build the routing tables of an unstructured
    matrix once, offline, and save them in JAX's ``.npz`` layout, which
    ``tpcg_torch.cg(routing=)`` and ``tpcg.cg(routing=)`` both load.  Host
    only (numpy, or the repository's C++ table code).

``python -m tpcg_torch.cli helmholtz <M_s> <W_s> <UseCG> [CGMaxIT] [--device DEV]``
    ==  ``tpcg.cli helmholtz`` (the reference's ``__main__``,
    ``p_h-PY_C-CL-multi-GPU.py:3639-3718``): the ORAS-FGMRES solve of the
    plane-wave Helmholtz problem at k = 20 on M_s x M_s subdomains of width
    W_s (overlap (W_s-2)/2), CGMaxIT subdomain COCG iterations (default 256),
    on DEV (default ``cuda:0``; exits non-zero if it is absent).  It prints
    each FGMRES residual estimate, the iterations, the true residual and the
    time an iteration.  UseCG may list modes (``2,0``); only 2, the batched
    subdomain solve, is ported: another mode prints why and the sweep goes
    on, as the reference's does.  No output file is written.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

def _device_present(device) -> bool:
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return (dev.index or 0) < torch.cuda.device_count()


def _pop_device(argv):
    """(device, the other arguments), or (None, None) when ``--device`` has
    no value."""
    if "--device" not in argv:
        return "cuda:0", argv
    i = argv.index("--device")
    if i + 1 == len(argv):
        print("--device needs a value", file=sys.stderr)
        return None, None
    return argv[i + 1], argv[:i] + argv[i + 2:]


def run_cg_cli(argv):
    device, argv = _pop_device(argv)
    if device is None:
        return 1
    if len(argv) != 4:
        print("Usage: tpcg_torch cg <input matrix file> <number of RHS> "
              "<is complex> <number of iterations> [--device DEV]",
              file=sys.stderr)
        return 1
    path, n_rhs, is_complex, n_iter = (argv[0], int(argv[1]),
                                       int(argv[2]), int(argv[3]))
    if not _device_present(device):
        print(f"device {device} is not available", file=sys.stderr)
        return 1
    from .io.mtx import read_matrix_market
    from .api import cg

    try:
        A, reader = read_matrix_market(
            path, dtype=np.complex64 if is_complex else np.float32)
    except FileNotFoundError:
        print(f"Could not read matrix: {path}", file=sys.stderr)
        return 1
    n = A.shape[0]
    print(f"loaded {path}: n={n} nnz={A.nnz} dtype={A.dtype} "
          f"reader={reader}")
    b = np.zeros(n * n_rhs, dtype=A.dtype)
    for r in range(n_rhs):
        b[r * n:(r + 1) * n] = (r + 1) * 5.0
    t0 = time.time()
    x, hist = cg(n, A.nnz, A.data, b, A.indptr, A.indices, n_rhs=n_rhs,
                 n_iterations=n_iter, record_history=True, device=device)
    dt = time.time() - t0
    for r in range(n_rhs):
        print(f"rhs {r}: final residual {hist[-1, r]:.6e}")
    print(f"solve time (incl. build): {dt:.3f}s")
    return 0


def run_helmholtz_cli(argv):
    device, argv = _pop_device(argv)
    if device is None:
        return 1
    if len(argv) not in (3, 4):
        print("Usage: tpcg_torch helmholtz <M_s> <W_s> <UseCG> [CGMaxIT] "
              "[--device DEV]", file=sys.stderr)
        return 1
    m_s, w_s = int(argv[0]), int(argv[1])
    cgs = [int(v) for v in argv[2].split(",")]
    cg_max_it = int(argv[3]) if len(argv) == 4 else 256
    if not _device_present(device):
        print(f"device {device} is not available", file=sys.stderr)
        return 1
    from .parallel.hsolver import hsolver
    from .utils.config import HelmholtzConfig

    kkk = 20.0
    ol = (w_s - 2) // 2
    print(f"N= {(w_s - 1) * m_s + 1} k= {kkk} M_s= {m_s} W_s= {w_s} "
          f"OL= {ol}")
    print("One-level AS preconditioner")
    print("----> setting epsilon=k^beta: ", kkk)
    for cg_mode in cgs:
        print(f"=== UseCG={cg_mode}, CGMaxIT={cg_max_it}, on {device}")
        steps = []

        def count(res):
            steps.append(res)
            print(len(steps), "--", res, flush=True)
        try:
            cfg = HelmholtzConfig(k=kkk, M_subd=m_s, W_subd=w_s, OL=ol,
                                  use_cg=cg_mode, cg_max_it=cg_max_it,
                                  verbose=10)
            t1 = time.time()
            res = hsolver(cfg, device=device, callback=count)
            t2 = time.time()
        except NotImplementedError as ex:   # the sweep goes on (:3715-3718)
            print(ex)
            continue
        print("  residual norm:", res.true_residual,
              " ####it:", res.iterations)
        print("Total time:", t2 - t1, "(", (t2 - t1) / 60, "minutes )")
        print("Aver. time per iter:", res.time_per_it)
    return 0


def run_route_cli(argv):
    if len(argv) != 2:
        print("Usage: tpcg_torch route <input matrix file> <output .npz>",
              file=sys.stderr)
        return 1
    path, out = argv
    from .io.mtx import load_matrix_market
    from .ops.routing import build_routing_spmv

    try:
        A = load_matrix_market(path)
    except FileNotFoundError:
        print(f"Could not read matrix: {path}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as ex:     # malformed .mtx and friends
        print(f"Could not parse matrix {path}: {ex}", file=sys.stderr)
        return 1
    print(f"loaded {path}: n={A.shape[0]} nnz={A.nnz}")
    t0 = time.time()
    R = build_routing_spmv(A)
    dt = time.time() - t0
    try:
        R.save(out)
    except OSError as ex:
        print(f"Could not write routing tables to {out}: {ex}",
              file=sys.stderr)
        return 1
    print(f"routing built in {dt:.1f}s: {R.n_layers} layers, m={R.m}, "
          f"masks {R.masks.nbytes / 1e6:.0f} MB -> {out}")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "cg":
        return run_cg_cli(rest)
    if cmd == "route":
        return run_route_cli(rest)
    if cmd == "helmholtz":
        return run_helmholtz_cli(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
