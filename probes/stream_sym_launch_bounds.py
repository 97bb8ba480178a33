"""Probe: ``csrc/stream_cg_sym.cu`` at four blocks an SM (its launch bounds
cap it at 64 registers a thread) against the same source without the cap
(80 registers, three blocks an SM), on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 probes/stream_sym_launch_bounds.py

It copies ``tpcg_torch`` into ``probes/_variants/{bounded,unbounded}``
(ignored by git), drops the minimum-blocks argument of the launch bounds in
the second copy, and runs the two in turns (bounded, unbounded, unbounded,
bounded), each in its own process with its own kernel build: the register
report of ``stream_cg_sym_kernel``, then the median of 5 CUDA-event timings
of a 300-iteration solve of helm_fe_var(N, 40, C, rho=0.1) (C = 1 + 0.5
U(0, 1) from seed 0, plane wave) at N = 2048 and 4096, and a digest of x.
The last line is the card's name and power limit.
"""
import hashlib
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ROOT / "probes" / "_variants"
BOUND = "__launch_bounds__(kThreads, kBlocksPerSm)"


def make_variants():
    for name in ("bounded", "unbounded"):
        dst = VARIANTS / name / "tpcg_torch"
        shutil.rmtree(dst.parent, ignore_errors=True)
        shutil.copytree(ROOT / "tpcg_torch", dst,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        if name == "unbounded":
            src = dst / "csrc" / "stream_cg_sym.cu"
            text = src.read_text()
            if BOUND not in text:
                sys.exit(f"{BOUND} not found in {src}")
            src.write_text(text.replace(BOUND, "__launch_bounds__(kThreads)"))


def run_one(tree):
    """Time the kernel from the package copy in ``tree`` (a subprocess)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from tpcg_torch.ops import _build
    from tpcg_torch.ops import stream_cg_sym as tss
    from tpcg_torch.problems import helm_fe_var, plane_wave_rhs
    _build.load()
    name = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "stream_cg_sym_kernel" in name and ("Used" in line
                                                 or "spill" in line):
            print(f"{tree.name}: ptxas {line.strip()}")
    dev = torch.device("cuda:0")
    iters = 300
    for N in (2048, 4096):
        C = 1.0 + 0.5 * np.random.default_rng(0).random((N - 1, N - 1))
        half, cplanes = tss.prepare_stream_sym(
            helm_fe_var(N, 40.0, C, rho=0.1, device=dev))
        b = plane_wave_rhs(N, 40.0)
        bp = torch.from_numpy(np.stack([b.real, b.imag]).astype(
            np.float32)).to(dev)
        x0 = torch.zeros_like(bp)
        x, _ = tss.stream_cg_sym_planes(half, cplanes, bp, x0, iters)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tss.stream_cg_sym_planes(half, cplanes, bp, x0, iters)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / iters)
        digest = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:12]
        print(f"{tree.name}: N={N} {iters} it: median "
              f"{statistics.median(times):.3f} us/it (min {min(times):.3f}, "
              f"max {max(times):.3f}); x digest {digest}", flush=True)


def main():
    if len(sys.argv) == 2:
        run_one(pathlib.Path(sys.argv[1]))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    make_variants()
    for name in ("bounded", "unbounded", "unbounded", "bounded"):
        subprocess.run([sys.executable, __file__, str(VARIANTS / name)],
                       check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
