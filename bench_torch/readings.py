"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 bench_torch/readings.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--hist-ks 10 20 50] [--x-gap-seeds 2]

In one process on the card: for every seed, the answers of as many
requests as a run checks (``check_requests`` of the traffic), made by the
program through the cell's entry, and for every control seed the same
requests answered by the control: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configuration's float32.  Each set of answers gets the numbers of
``check.py``, whether the cell compares it or not (``x_gap``, which needs
the reference over every iteration, on the first ``--x-gap-seeds`` seeds
of each kind).  One JSON line a reading on stdout.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import check, spec  # noqa: E402
from bench_torch.run import _load  # noqa: E402


def program_answers(cell, problem, pool, device):
    """(b, x, hist) of the first ``check_requests`` requests of a run."""
    traffic = cell.traffic
    entry = _load("entries", traffic["entry"]).Entry(
        problem, cell.config, traffic, device)
    k = traffic["check_requests"]
    outs = [entry.result(entry.request(pool[1 + i])) for i in range(k)]
    entry.close()
    b = np.concatenate([pool[1 + i] for i in range(k)])
    return (b, np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs], axis=1))


def control_answers(cell, pool, device, dtype=torch.bfloat16, block=16):
    """The same requests answered by the reference in ``dtype``."""
    k = cell.traffic["check_requests"]
    b = np.concatenate([pool[1 + i] for i in range(k)])
    op = check.reference_op(cell, dtype, device)
    xs, hs = [], []
    for s in range(0, len(b), block):
        xp, h = check.solve(op, check.planes(b[s:s + block], device, dtype),
                            cell.config["n_iterations"])
        xp = [p.double().cpu().numpy() for p in xp]
        xs.append(xp[0] + 1j * xp[1] if len(xp) == 2 else xp[0])
        hs.append(h.cpu().numpy())
    return b, np.concatenate(xs), np.concatenate(hs, axis=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--hist-ks", type=int, nargs="*", default=[])
    ap.add_argument("--x-gap-seeds", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    device = torch.device("cuda:0")
    problem = _load("problems", cell.problem).build(cell.config, device)
    make_pool = _load("rhs", cell.traffic["rhs"]).pool

    def emit(kind, seed, b, x, h, with_x):
        want = [n for n in check.NUMBERS if with_x or n != "x_gap"]
        t = time.perf_counter()
        got, _ = check.readings(cell, b, x, h, device, want=want,
                                hist_ks=args.hist_ks)
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          **got,
                          "reference_s": time.perf_counter() - t}),
              flush=True)

    for n, seed in enumerate(args.seeds):
        pool = make_pool(cell.config, cell.traffic, seed)
        answers = program_answers(cell, problem, pool, device)
        gc.collect()
        torch.cuda.empty_cache()
        emit("program", seed, *answers, n < args.x_gap_seeds)
    del problem
    for n, seed in enumerate(args.control_seeds):
        pool = make_pool(cell.config, cell.traffic, seed)
        emit("control", seed, *control_answers(cell, pool, device),
             n < args.x_gap_seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
