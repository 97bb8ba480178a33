"""Stand-ins of the ORAS cell's program that do less work or run in a lower
precision, read by the numbers that ``limits/helm_oras_m4.source_calls.json``
judges: can a weaker program pass the limits?

    python3 probes/hsolve_standins.py [--seeds 2100000501 ...]
        [--kinds sound bf16_storage bf16_plain cg128 cg64]

For every kind and seed, the requests that a run of the cell checks
(``check_requests`` of its traffic, through the cell's entry), read by
``check.readings`` (``missing_iterations``, ``rel_residual``,
``rel_residual_median``) and judged against the cell's limits.  Kinds:

* ``sound``: the program as it is;
* ``bf16_storage``: the subdomain block, the subdomain RHS and the
  subdomain solution rounded to bfloat16 around kernel A (a kernel that
  keeps its planes in bfloat16 and computes in float32);
* ``bf16_plain``: the subdomain COCG computed in bfloat16 (kernel A's
  plain twin on bfloat16 planes);
* ``cg<N>`` (``cg128``, ``cg64``, ...): the subdomain COCG cut from 256 to
  N iterations.

One JSON line a reading on stdout and in
``chiprun_out/hsolve_standins.jsonl``; the card's name and power limit
first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch import check, spec  # noqa: E402
from bench_torch.readings import program_answers  # noqa: E402
from bench_torch.run import _load  # noqa: E402
from tpcg_torch.ops.stream_cg_dia import (  # noqa: E402
    _stream_plain, stream_cg_dia_rows_cplx)
from tpcg_torch.parallel.schwarz import SchwarzPrec  # noqa: E402

CELL = "helm_oras_m4.source_calls"
WANT = ("missing_iterations", "rel_residual", "rel_residual_median")


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _storage(self, zb):
    x0 = torch.zeros_like(zb)
    x, _ = stream_cg_dia_rows_cplx(self.offsets, _bf16(self.values),
                                   _bf16(zb), x0, self.cg_iterations)
    return _bf16(x)


def _plain(self, zb):
    lo = torch.bfloat16
    zl = zb.to(lo)
    x, _ = _stream_plain(self.offsets, self.values.to(lo), zl,
                         torch.zeros_like(zl), self.cg_iterations)
    return x.to(zb.dtype)


SUBSOLVE = {"bf16_storage": _storage, "bf16_plain": _plain}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[2100000501, 2100000502, 2100000503])
    ap.add_argument("--kinds", nargs="+",
                    default=["sound", "bf16_storage", "bf16_plain", "cg128",
                             "cg64"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    log = open(out / "hsolve_standins.jsonl", "w")
    device = torch.device("cuda:0")
    base = spec.cell(CELL)
    make_pool = _load("rhs", base.traffic["rhs"]).pool
    sound_subsolve = SchwarzPrec.subsolve
    for kind in args.kinds:
        cfg = {**base.config}
        if kind.startswith("cg"):
            cfg["cg_max_it"] = int(kind[2:])
        problem = _load("problems", base.problem).build(cfg, device)
        if kind in SUBSOLVE:
            SchwarzPrec.subsolve = SUBSOLVE[kind]
        try:
            for seed in args.seeds:
                pool = make_pool(base.config, base.traffic, seed)
                t = time.perf_counter()
                b, x, h = program_answers(base, problem, pool, device)
                solve_s = time.perf_counter() - t
                got, _ = check.readings(base, b, x, h, device, want=WANT)
                ok, _ = check.judge(base, got)
                line = json.dumps({"kind": kind, "seed": seed, **got,
                                   "passes_limits": ok,
                                   "solve_s": solve_s, "card": smi})
                print(line, flush=True)
                log.write(line + "\n")
                log.flush()
        finally:
            SchwarzPrec.subsolve = sound_subsolve
        del problem
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
