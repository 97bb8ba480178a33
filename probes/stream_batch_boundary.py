"""Probe: several RHS in one launch of ``csrc/stream_cg.cu`` (the NB >= 2
instances) against one launch a RHS, per RHS-iteration, on grids around
the ``stream`` planner's batching boundaries (``auto._STREAM_BATCH_MIN_NODES``
and ``_STREAM_BATCH_MAX_NODES``).

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 probes/stream_batch_boundary.py

For helm_fe(N, 12, eps=12) and B RHS (the plane wave times 1 + 0.1j r,
x0 = 0) at N = 1024 (B = 2, 8), 1200 (2, 4), 1448 (2, 8), 2048 (2, 8),
2896 (2), 3072 (2) and 4096 (1, 2, 4), it times ``stream_cg_const_planes_batched`` with chunks of 8 and
with chunks of 1 in turns, 7 times each after a warm-up (CUDA events), and
prints the median and range of each in us per RHS-iteration and their
ratio.  At B = 1 both sides run the same launch: that ratio is the spread
of the method.  The first line is the card's name and power limit.
"""
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from tpcg_torch.ops import stream_cg as tsc  # noqa: E402
from tpcg_torch.problems import helm_fe, plane_wave_rhs  # noqa: E402

CELLS = ((1024, 1000, (2, 8)), (1200, 500, (2, 4)), (1448, 500, (2, 8)),
         (2048, 500, (2, 8)), (2896, 300, (2,)), (3072, 300, (2,)),
         (4096, 300, (1, 2, 4)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    for N, iters, nbs in CELLS:
        A = helm_fe(N, 12.0, eps=12.0, device=dev)
        taps, strips = tsc.prepare_stream(A)
        b = plane_wave_rhs(N, 12.0)
        for nb in nbs:
            B = np.stack([b * (1 + 0.1j * r) for r in range(nb)])
            bp = torch.from_numpy(
                np.stack([B.real, B.imag]).astype(np.float32)).to(dev)
            x0p = torch.zeros_like(bp)
            runs = [lambda c=c: tsc.stream_cg_const_planes_batched(
                A.offsets, A.grid, taps, strips, bp, x0p, iters, chunk=c)
                for c in (None, 1)]
            for run in runs:
                run()
            torch.cuda.synchronize()
            times = [[], []]
            for rep in range(7):
                for k in ((0, 1) if rep % 2 == 0 else (1, 0)):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    runs[k]()
                    end.record()
                    torch.cuda.synchronize()
                    times[k].append(start.elapsed_time(end) * 1e3
                                    / (nb * iters))
            mb, ms = (statistics.median(t) for t in times)
            print(f"N={N} B={nb} {iters} it, us per RHS-it: batched median "
                  f"{mb:.3f} [{min(times[0]):.3f}, {max(times[0]):.3f}], "
                  f"sequential median {ms:.3f} [{min(times[1]):.3f}, "
                  f"{max(times[1]):.3f}], ratio {mb / ms:.4f}", flush=True)
        del A


if __name__ == "__main__":
    main()
