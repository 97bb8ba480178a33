"""One traced run of a benchmark cell, split into the program's spans.

    python3 probes/span_split.py --workload helm_fem.csr_calls --seed 7 \\
        --seconds 30 [--out split.json]

runs ``bench_torch/run.py --trace 1`` in this process (its lines and its
JSON result print as they do there), then splits the timed calls into the
spans of ``tpcg_torch.trace``: for each span name the self time (its
duration less its child spans) in ms a call and the spans a call, averaged
over the timed calls (the first call, the harness's untimed warm-up under
the profiler, is left out), and the program's counters a call (``counts``:
``launch.*``, ``resident.*``, bytes).  The split prints on stderr as one
JSON object, and goes to ``--out`` where given.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bench_torch import run  # noqa: E402
from bench_torch.program_spans import self_s  # noqa: E402


def split(records) -> dict:
    """{span name: {"self_ms", "spans"} a call, the counters a call,
    "calls": n} over the calls after the first."""
    by_call = {}
    for rec in records:
        by_call.setdefault(rec.call, []).append(rec)
    calls = [recs for call, recs in by_call.items()
             if recs[0].id == call][1:]
    out, counts = {}, {}
    for recs in calls:
        for name, v in recs[0].counts.items():
            counts[name] = counts.get(name, 0) + v / len(calls)
        for rec in recs:
            row = out.setdefault(rec.name, {"self_ms": 0.0, "spans": 0})
            row["self_ms"] += self_s(rec, recs) * 1e3
            row["spans"] += 1
    for row in out.values():
        row["self_ms"] /= len(calls)
        row["spans"] /= len(calls)
    return {"calls": len(calls), "spans": out, "counts": counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    from tpcg_torch import trace
    result = {"workload": args.workload, "seed": args.seed,
              **split(trace.records()),
              "dropped": trace.counters().get(trace.DROPPED, 0)}
    line = json.dumps(result)
    print("split: " + line, file=sys.stderr)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
