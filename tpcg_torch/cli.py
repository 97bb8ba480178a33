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

The ``helmholtz`` subcommand of ``tpcg.cli`` is not ported yet (ROADMAP
queue 1 item 12); it says so and exits non-zero.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

_NOT_PORTED = {
    "helmholtz": "ROADMAP queue 1 item 12 (tpcg/parallel/)",
}


def _device_present(device) -> bool:
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return (dev.index or 0) < torch.cuda.device_count()


def run_cg_cli(argv):
    device = "cuda:0"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 == len(argv):
            print("--device needs a value", file=sys.stderr)
            return 1
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
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
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not ported to tpcg_torch yet, see "
              f"{_NOT_PORTED[cmd]}; the JAX package runs it: "
              f"python -m tpcg.cli {cmd}", file=sys.stderr)
        return 2
    print(f"unknown command {cmd!r}", file=sys.stderr)
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
