"""Run one cell of the port's benchmark once.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names its
configuration and traffic mix; every piece is found by those names (see
``spec.py``).  A run:

1. builds the cell's operator through the program's public entry points
   (``problems/<problem>.py``), and the request's entry
   (``entries/<entry>.py``: the plan, or the CSR arrays);
2. makes the RHS pool from ``--seed`` (``rhs/<rhs>.py``): request ``i``'s
   RHS are ``pool[i]``, and no two requests share one;
3. warms up with one request, ``pool[0]`` (the first run in a checkout
   builds the program's kernels into ``tpcg_torch/_build/`` here); set-up
   ends;
4. calls the entry back to back on ``pool[1]``, ``pool[2]``, ..., one
   caller and no think time, until ``--seconds`` have passed, and lets the
   last request finish: the window ends when it does;
5. frees the program's state and compares a sample of the window's answers,
   drawn from the seed and moved to the host as each is kept, with the
   plain reference (``check.py``);
6. prints each number compared beside its limit, then the result's line.

With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the per-layer metrics, else the end-to-end ones.  Without a CUDA
card, or with fewer than the cell asks for, it exits with code 3 and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import check, spec  # noqa: E402
from bench_torch.accounting import h100  # noqa: E402
from bench_torch.trace import WARM, Tracer  # noqa: E402

T_IMPORTED = time.perf_counter()


class Context:
    """What the metric readers (``metrics/<name>.py``) read."""

    def __init__(self, cell, acc):
        n_rhs = cell.traffic["n_rhs"]
        self.request_ops = h100.request_ops(acc, cell.config, n_rhs)
        self.request_bytes = h100.request_bytes(acc, cell.config, n_rhs)
        self.setup_s = 0.0
        self.window_s = 0.0
        self.completed = 0
        self.latencies_s = []
        self.memory_peak_bytes = 0
        self.trace = None

    def roofline(self, kernel):
        """The traced requests' least time over the device time of the
        kernels that ``kernel`` matches, in %; None where none ran."""
        if self.trace is None:
            return None
        busy = self.trace.kernel_s(kernel)
        if busy <= 0:
            return None
        least = h100.least_seconds(self.request_ops, self.request_bytes)
        return 100.0 * least * len(self.trace.spans) / busy


class Sample:
    """A uniform sample of ``k`` requests' answers drawn from the seed
    (reservoir sampling), so that at most ``k`` are held at any time, in
    host memory."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 1])
        self.kept = []

    def offer(self, i: int, out, to_host):
        """Offer request ``i``'s output; ``to_host(out)`` is what is kept."""
        if len(self.kept) < self.k:
            self.kept.append((i, to_host(out)))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.kept[j] = (i, to_host(out))


def _load(kind: str, name: str):
    return importlib.import_module(f"bench_torch.{kind}.{name}")


def measure(cell, seed: int, seconds: float, trace: bool, device):
    """One run of ``cell`` on ``device``; returns ``(result, lines)``: the
    result's dict and the lines to print before it."""
    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    on_card = device.type == "cuda"
    acc = _load("accounting", cell.problem)
    ctx = Context(cell, acc)
    lines = []

    marks = [("start", T_START), ("imports", T_IMPORTED),
             ("card", time.perf_counter())]
    problem = _load("problems", cell.problem).build(cfg, device)
    marks.append(("problem", time.perf_counter()))
    pool = _load("rhs", traffic["rhs"]).pool(cfg, traffic, seed)
    marks.append(("pool", time.perf_counter()))
    entry = _load("entries", traffic["entry"]).Entry(problem, cfg, traffic,
                                                     device)
    del problem
    marks.append(("entry", time.perf_counter()))
    lines.append(f"entry: {entry.describe()}")
    entry.request(pool[0])                 # warm-up: builds or loads
    if on_card:
        torch.cuda.synchronize(device)
    marks.append(("warm-up", time.perf_counter()))
    lines.append("set-up s: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))

    sample = Sample(traffic["check_requests"], seed)
    attempted = failed = 0
    out = None
    with Tracer(trace) as tracer:
        if trace:
            with tracer.span(WARM):        # CUPTI's first activity
                entry.request(pool[0])
        ctx.setup_s = time.perf_counter() - T_START
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            i = attempted
            attempted += 1
            b = pool[1 + i]
            t = time.perf_counter()
            try:
                with tracer.span():
                    out = entry.request(b)
            except Exception:               # counted; the loop goes on
                failed += 1
                if failed == 1:
                    lines.append(traceback.format_exc())
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            ctx.latencies_s.append(t_end - t)
            sample.offer(i, out, entry.result)
        ctx.window_s = t_end - t0
    ctx.completed = attempted - failed
    if ctx.latencies_s:
        q = np.percentile(ctx.latencies_s, [0, 25, 50, 75, 100]) * 1e3
        lines.append(f"{ctx.completed} requests in {ctx.window_s:.3f} s; "
                     "latency ms min/q1/median/q3/max "
                     + "/".join(f"{v:.3f}" for v in q))
    ctx.trace = tracer.reduce()
    if on_card:
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    # the program's state freed; the kept answers are on the host
    kept = sorted(sample.kept, key=lambda k: k[0])
    entry.close()
    del entry, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    numbers, ok = {}, False
    if kept:
        b = np.concatenate([pool[1 + i] for i, _ in kept])
        x = np.concatenate([r[0] for _, r in kept])
        hist = np.concatenate([r[1] for _, r in kept], axis=1)
        values, rel = check.readings(cell, b, x, hist, device)
        ok, numbers = check.judge(cell, values)
        lines.append(f"checked {len(b)} RHS of requests "
                     f"{[i for i, _ in kept]}")
        lines.append("float64 relative residual |b - S x| / |b|: "
                     + " ".join(f"{r:.6e}" for r in rel))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        # ``<base>.<kind>`` is read by metrics/<base>.py: one quantity split
        # by the kind of cell, each kind with its own bound or ``moves``
        value = _load("metrics", m["name"].split(".")[0]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(ok and failed == 0 and ctx.completed > 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "count": 1,
                   "memory_peak_bytes": ctx.memory_peak_bytes},
    }
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = numbers
    for name, c in numbers.items():
        lines.append(f"{name} {c['value']:.6e} limit {c['limit']:.6e}")
    return result, lines


def card() -> tuple[str, str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = out.stdout.strip().splitlines()[0].split(", ")
    return name, limit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    name, limit = card()
    print(f"card: {name}, power limit {limit}", file=sys.stderr, flush=True)
    result, lines = measure(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda:0")
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["device"]["power_limit"] = limit
    result["checks"] = result.pop("checks")         # the last key
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
