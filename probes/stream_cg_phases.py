"""Probe: phase A and phase B of a streaming CG kernel timed apart, the
kernel's tile and ring swept, and two versions of the kernel timed in
turns, on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 probes/stream_cg_phases.py split [--kernel K] [--tree DIR]
    python3 probes/stream_cg_phases.py sweep [--kernel K]
    python3 probes/stream_cg_phases.py variants [--kernel K]
    python3 probes/stream_cg_phases.py compare [--kernel K] --tree DIR

with K one of const, coef, sym, real, real-coef.

``--kernel const`` (the default) probes ``csrc/stream_cg.cu`` on
helm_fe(N, 12, eps=12) and its plane wave; ``--kernel coef`` probes
``csrc/stream_cg_coef.cu`` on the general-coefficient class of the smoke's
phase 18, helm_fe_var(N, 8, C, rho=0.5) with C = 1 + 0.5 U(0, 1) from seed
0 and coefficient plane 1 times 1.5 (benchmarks/exp_batchfat.py:32-36), and
its plane wave; RHS r of a batch is the plane wave times 1 + 0.1j r.
``--kernel sym`` probes ``csrc/stream_cg_sym.cu`` (one RHS a launch) on the
symmetric class of the smoke's phase 11, helm_fe_var(N, 40, C, rho=0.1)
with C = 1 + 0.5 U(0, 1) from seed 0 (benchmarks/exp_stream4sym.py:28-38),
and plane_wave_rhs(N, 40).  ``--kernel real`` probes ``csrc/stream_cg_real.cu``
in const mode on Poisson (``problems.poisson(N)``) and on the
parabolic_fem.stencil_calls cell's operator (``parabolic_stencil(725,
diag=6.0)``, "FE 725" in the output), ``--kernel real-coef``
the same kernel in coef mode on Poisson with c[0] += 0.3 U(0, 1) from seed
2 (the classes of the smoke's phase 13), each with a standard normal RHS
from seed 11, one RHS a launch.

``--tree DIR`` names a directory that holds another ``tpcg_torch`` package
(for example an earlier commit's, unpacked with ``git archive`` under
``probes/_variants/``, which git ignores); the default is this checkout's.

Phase timing: the probe copies the package into
``probes/_variants/<name>-stamped/`` and edits the copy's kernel source so
that thread 0 of block 0 reads ``%globaltimer`` and ``clock64()`` after
every ``grid.sync()`` of the kernel and adds the time since the previous
stamp to a slot of that barrier (the last stamp is kept in shared memory,
so the stamps cost the kernel no registers).  The last two barriers of the
kernel's source close phase A (the direction, q = A d' and <d', q>) and
phase B (the update and <r, r>) of an iteration: their slots, over an
n-iteration solve, are the two phases' times, each with its scalar step
and its barrier wait.  The clock64 shares of the two phases, times the
solve's CUDA-event time, give the split; the globaltimer sums are printed
beside them.  Each phase's rate is its own bytes (the kernel's count a
node and RHS, from the package's layout function where it has one, else
the earlier kernel's tiles) over its time.

``split``: const: N = 1024 (1000 iterations), 2048 (500) and 4096 (300),
one RHS and one launch of NB = 4.  coef: the same sizes at one RHS, and one
launch of NB = 2 and of NB = 8 at 2048.  sym and real: the same sizes and
2049 (500), and real also FE 725 (1000).  real-coef: N = 1024 (1000) and
4096 (300).  ``--configs`` runs each of those layouts at every cell of the
split, ``--edit NAME`` in a build with that edit of ``variants``, and
``--bounds B`` with launch bounds of B blocks an SM.

``sweep``: this checkout's kernel at every layout of ``SWEEP_*`` that fits
the shared memory, at every count of blocks an SM that it allows, first
with the source's launch bounds, then built with bounds of more blocks an
SM (fewer registers a thread) for the layouts of that many blocks (const
also with 512 threads a block): us per RHS-iteration and the split at
N = 2048 (500 iterations) and 4096 (300), one RHS (coef also NB = 8 at
2048; sym and real also 2049 x 500), then N = 1024 (1000) for the best few
of each build.  Each build prints its instances' registers and spills.
``--configs "R,S,C,m;..."`` (const, real: "R,S,m;..."; real: the
streaming layout at every size, the resident one left out) sweeps those
layouts
alone, each also at N = 1024, in the source's own build; ``--edit NAME``
builds every copy with that edit of ``variants``.

``variants``: this checkout's kernel at its default layout, built as it is
and with one edit each (``EDITS``), then as it is again, at N = 2048, 4096
and 1024, one RHS (coef also NB = 8 at 2048).  const: the tensor maps' L2
promotion, the unrolling of the node loop, the shared-memory proxy fence
left out (which the memory model needs: a measurement only).  coef:
phase B's sweep in forward order (the kernel sweeps from the planes' ends
back, so that the d' and q that phase A wrote last are read first, from
the L2).  sym: phase B's sweep in forward order.  real, real-coef: the
edits of ``KERNELS``.  An earlier design is timed against this one with
``compare --tree`` on its commit's archive.

``compare``: DIR's package and this checkout's in turns (DIR, this, this,
DIR), each in its own process with its own build, median of 3 CUDA-event
timings: const at N = 1024 x 1000 (B = 1), 2048 x 500 (B = 1 and one
launch of NB = 8) and 4096 x 1000 (B = 1); coef at N = 4096 x 1000 (B =
1), 2048 x 500 (B = 1, one launch of NB = 2 and one of NB = 8), 1024 x
1000 (B = 1) and 2049 x 500 (B = 1); sym at N = 4096 x 1000, 2048 x 500,
1024 x 1000 and 2049 x 500; real at those, 2896 x 500, FE 725 x 1000 and
Poisson 725 x 1000; real-coef at N =
4096 x 1000, 2048 x 500 and 1024 x 1000; us per RHS-iteration and the rate
of the kernel's own bytes.

``--sizes N,...`` keeps a mode's cells of those N (FE 725 is 725).

Every mode prints the card's name and power limit first.
"""
import argparse
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ROOT / "probes" / "_variants"

STAMP_HEADER = r"""
// ---- phase stamps (probes/stream_cg_phases.py) ----
__device__ unsigned long long tpcg_probe_slots[32];
#define TPCG_PROBE_STAMP(k)                                               \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
    unsigned long long ns_;                                               \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));               \
    const unsigned long long cy_ = clock64();                             \
    if (tpcg_probe_last[0]) {                                             \
      tpcg_probe_slots[2 * (k)] += ns_ - tpcg_probe_last[0];              \
      tpcg_probe_slots[2 * (k) + 1] += cy_ - tpcg_probe_last[1];          \
    }                                                                     \
    tpcg_probe_last[0] = ns_;                                             \
    tpcg_probe_last[1] = cy_;                                             \
  }
extern "C" int tpcg_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, tpcg_probe_slots,
                                       sizeof(tpcg_probe_slots));
  if (e != cudaSuccess) return e;
  static const unsigned long long zero[32] = {};
  return cudaMemcpyToSymbol(tpcg_probe_slots, zero, sizeof(zero));
}
"""
GRID_DECL = "cg::grid_group grid = cg::this_grid();"
THREADS = "constexpr int kThreads = 256;"

# per kernel: source, module, the kernel's name in the compiler report,
# the launch-bounds text a build edits (with its blocks an SM), the builds
# of the sweep (name, blocks an SM in the launch bounds, threads a block:
# at most 65536 / (blocks x threads) registers a thread), and the edits of
# ``variants`` (name, [(text, replacement), ...]), run at the module's
# default layout
KERNELS = {
    "const": dict(
        source="stream_cg.cu", module="stream_cg", entry="stream_cg_kernel",
        bounds=("__launch_bounds__(kThreads, 2)",
                "__launch_bounds__(kThreads, {})"), default_blocks=2,
        builds=(("b2", 2, 256), ("b3", 3, 256), ("b4", 4, 256),
                ("t512", 2, 512)),
        edits=(
            ("base", None),
            ("l2-none", [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                          "CU_TENSOR_MAP_L2_PROMOTION_NONE")]),
            ("l2-128", [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                         "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")]),
            ("unroll-2", [("#pragma unroll 1\n        for (int tm",
                           "#pragma unroll 2\n        for (int tm")]),
            ("no-smem-fence", [("        fence_async_smem();  // the slot is "
                                "refilled",
                                "        // the slot is refilled")]))),
    "coef": dict(
        source="stream_cg_coef.cu", module="stream_cg_coef",
        entry="stream_cg_coef_kernel",
        bounds=("constexpr int kMinBlocks = 2;",
                "constexpr int kMinBlocks = {};"), default_blocks=2,
        builds=(("b2", 2, 256), ("b1", 1, 256)),
        edits=(
            ("base", None),
            ("forward-b", [("const size_t u = n4 - 1 - v;",
                            "const size_t u = v;")]))),
    "sym": dict(
        source="stream_cg_sym.cu", module="stream_cg_sym",
        entry="stream_cg_sym_kernel",
        bounds=("constexpr int kMinBlocks = 2;",
                "constexpr int kMinBlocks = {};"), default_blocks=2,
        builds=(("b2", 2, 256), ("b1", 1, 256), ("b3", 3, 256)),
        edits=(
            ("base", None),
            ("forward-b", [("const size_t u = n4 - 1 - v;",
                            "const size_t u = v;")]))),
    "real": dict(
        source="stream_cg_real.cu", module="stream_cg_real",
        entry="stream_cg_real_kernel",
        bounds=("constexpr int kMinBlocks = 4;",
                "constexpr int kMinBlocks = {};"), default_blocks=4,
        builds=(("b4", 4, 256), ("b2", 2, 256)),
        edits=(
            ("base", None),
            ("forward-b", [("const size_t u = n4 - 1 - v;",
                            "const size_t u = v;")]))),
    "real-coef": dict(
        source="stream_cg_real.cu", module="stream_cg_real",
        entry="stream_cg_real_kernel",
        bounds=("constexpr int kMinBlocks = 4;",
                "constexpr int kMinBlocks = {};"), default_blocks=4,
        builds=(("b4", 4, 256), ("b2", 2, 256)),
        edits=(
            ("base", None),
            ("forward-b", [("const size_t u = n4 - 1 - v;",
                            "const size_t u = v;")]))),
}


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def stamped_copy(tree, name, kernel, min_blocks=None, threads=None,
                 edit=None):
    """Copy ``tree/tpcg_torch`` to ``probes/_variants/<name>-stamped`` with
    the phase stamps in the kernel's source (and, given ``min_blocks``, its
    launch bounds asking for that many blocks an SM, which caps the
    registers a thread; given ``threads``, that many threads a block; given
    ``edit``, a list of (text, replacement) pairs); returns (copy root,
    number of barriers)."""
    k = KERNELS[kernel]
    dst = VARIANTS / f"{name}-{kernel}-stamped"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "tpcg_torch", dst / "tpcg_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "tpcg_torch" / "csrc" / k["source"]
    text = src.read_text()
    if GRID_DECL not in text:
        sys.exit(f"{GRID_DECL} not found in {src}")
    text = text.replace(
        GRID_DECL, GRID_DECL + " __shared__ unsigned long long"
        " tpcg_probe_last[2]; if (threadIdx.x == 0) tpcg_probe_last[0] = 0;",
        1)
    count = 0

    def stamp(_m):
        nonlocal count
        count += 1
        return f"grid.sync(); TPCG_PROBE_STAMP({count - 1});"
    text = re.sub(r"grid\.sync\(\);", stamp, text)
    if count < 2 or count > 16:
        sys.exit(f"{src}: {count} grid barriers")
    for old, new in edit or ():
        if old not in text:
            sys.exit(f"{old!r} not found in {src}")
        text = text.replace(old, new)
    if threads is not None and threads != 256:
        if THREADS not in text:
            sys.exit(f"{THREADS} not found in {src}")
        text = text.replace(THREADS, f"constexpr int kThreads = {threads};")
    if min_blocks is not None and min_blocks != k["default_blocks"]:
        if k["bounds"][0] not in text:
            sys.exit(f"{k['bounds'][0]} not found in {src}")
        text = text.replace(k["bounds"][0], k["bounds"][1].format(min_blocks))
    first = text.index("namespace {")
    text = text[:first] + STAMP_HEADER + text[first:]
    src.write_text(text)
    return dst, count


# ---- one tree in one process ----

# const: tile rows, ring stages, blocks an SM
SWEEP_CONST = [(r, s, m) for r in (8, 16, 32, 64) for s in (2, 3)
               for m in (1, 2, 3, 4)]
# coef: tile rows, state ring slots, coefficient slots, blocks an SM
SWEEP_COEF = [(r, s, c, m) for r in (4, 8, 16) for s in (2, 3)
              for c in (1, 2) for m in (1, 2)]
# sym: tile rows, state ring slots, coefficient slots, blocks an SM
SWEEP_SYM = [(r, s, c, m) for r in (2, 4, 8, 16) for s in (2, 3)
             for c in (1, 2) for m in (1, 2, 3)]
# real (const mode): tile rows, state ring slots, blocks an SM
SWEEP_REAL = [(r, s, m) for r in (8, 16, 32, 64) for s in (2, 3)
              for m in (1, 2, 3, 4)]
# real-coef: tile rows, state ring slots, coefficient slots, blocks an SM
SWEEP_REAL_COEF = [(r, s, c, m) for r in (4, 8, 16, 32) for s in (2, 3)
                   for c in (1, 2) for m in (1, 2, 3)]


def fits(mod, kernel, config):
    """Whether a sweep configuration's ring fits m blocks on an SM (the
    card's shared memory from the package of ``mod``)."""
    from tpcg_torch.ops._tiles import (BLOCK_RESERVED, BLOCK_SHARED,
                                       SM_SHARED, STATIC_SHARED)
    if kernel == "const":
        rows, stages, m = config
        smem = mod.stream_layout(2048, 2048, 1, rows, stages).smem_bytes
    elif kernel == "real":
        rows, stages, m = config
        lay = mod.real_layout(2048, 2048, 1, 5, False, tile_rows=rows,
                              stages=stages)
        if lay.tile_rows != rows:
            return False
        smem = lay.smem_bytes
    elif kernel == "real-coef":
        rows, stages, cst, m = config
        lay = mod.real_layout(2048, 2048, 1, 5, True, tile_rows=rows,
                              stages=stages, coef_stages=cst)
        if (lay.tile_rows, lay.coef_stages) != (rows, cst):
            return False
        smem = lay.smem_bytes
    elif kernel == "sym":
        rows, stages, cst, m = config
        lay = mod.sym_layout(2048, 2048, 1, 4, tile_rows=rows, stages=stages,
                             coef_stages=cst)
        if (lay.tile_rows, lay.coef_stages) != (rows, cst):
            return False
        smem = lay.smem_bytes
    else:
        rows, stages, cst, m = config
        lay = mod.coef_layout(2048, 2048, 1, 1, 7, tile_rows=rows,
                              stages=stages, coef_stages=cst)
        if (lay.tile_rows, lay.coef_stages) != (rows, cst):
            return False
        smem = lay.smem_bytes
    per = smem + BLOCK_RESERVED + STATIC_SHARED
    return smem + STATIC_SHARED <= BLOCK_SHARED and m * per <= SM_SHARED


def coef_problem(N, dev):
    """The smoke's phase-18 class at N x N, and its plane wave."""
    import numpy as np
    from tpcg_torch.problems import helm_fe_var, plane_wave_rhs
    C = 1.0 + 0.5 * np.random.default_rng(0).random((N - 1, N - 1))
    A = helm_fe_var(N, 8.0, C, rho=0.5, device=dev)
    A.coef[1] *= 1.5
    return A, plane_wave_rhs(N, 8.0)


def sym_problem(N, dev):
    """The smoke's phase-11 class at N x N, and its plane wave."""
    import numpy as np
    from tpcg_torch.problems import helm_fe_var, plane_wave_rhs
    C = 1.0 + 0.5 * np.random.default_rng(0).random((N - 1, N - 1))
    return (helm_fe_var(N, 40.0, C, rho=0.1, device=dev),
            plane_wave_rhs(N, 40.0))


def real_problem(N, dev, coef, fe=False):
    """The smoke's phase-13 classes at N x N: Poisson (const mode) or
    Poisson with c[0] += 0.3 U(0, 1) from seed 2 (coef mode); with ``fe``
    the parabolic_fem cell's 7-point FE operator, diagonal 6 (const mode);
    and a seeded standard normal RHS."""
    import numpy as np
    import torch
    from tpcg_torch.problems import parabolic_stencil, poisson
    if fe:
        return (parabolic_stencil(N, device=dev, diag=6.0),
                np.random.default_rng(11).standard_normal((N, N)))
    A = poisson(N, device=dev)
    if coef:
        A.coef[0] += torch.from_numpy(
            0.3 * np.random.default_rng(2).random((N, N))).to(dev)
    return A, np.random.default_rng(11).standard_normal((N, N))


def run_tree(tree, mode, nbar, kernel, min_blocks=2, threads=256,
             configs=None, sizes=None):
    sys.path.insert(0, str(tree))
    import ctypes
    import hashlib
    import importlib
    import numpy as np
    import torch
    from tpcg_torch.ops import _build
    from tpcg_torch.problems import helm_fe, plane_wave_rhs
    kd = KERNELS[kernel]
    mod = importlib.import_module(f"tpcg_torch.ops.{kd['module']}")
    lib = _build.load()
    lib.tpcg_probe_read.argtypes = [ctypes.c_void_p]
    lib.tpcg_probe_read.restype = ctypes.c_int
    slots = np.zeros(32, dtype=np.uint64)
    name = ""
    for line in _build.compiler_report().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif kd["entry"] in name and ("Used" in line or "spill" in line):
            print(f"{tree.name}: ptxas {name}: {line.strip()}")

    def read_slots():
        torch.cuda.synchronize()
        _build.check(lib.tpcg_probe_read(slots.ctypes.data), "probe read")
        return slots.copy()

    real = kernel in ("real", "real-coef")

    def own_bytes(N, nb, noff):
        """(phase A, phase B) bytes a node and RHS of the tree's kernel
        (the coefficients' share included, divided over the RHS)."""
        if real:
            if hasattr(mod, "card_layout"):
                lay = mod.card_layout(N, N, 1, noff, kernel == "real-coef",
                                      dev)[0]
                return lay.bytes_a, lay.bytes_b
            if hasattr(mod, "real_layout"):
                lay = mod.real_layout(N, N, 1, noff, kernel == "real-coef")
                return lay.bytes_a, lay.bytes_b
            # the earlier kernel: 16 x 128 tiles, a halo of one node, q
            # stored, the coefficient planes read once
            h = (16 + 2) * (128 + 2) / (16 * 128) - 1
            return 8 * (1 + h) + 8 + (4 * noff if kernel == "real-coef"
                                      else 0), 24.0
        if kernel == "const":
            if hasattr(mod, "stream_layout"):
                lay = mod.stream_layout(N, N, 1)
                return lay.bytes_a, lay.bytes_b
            h = (16 + 2) * (128 + 2) / (16 * 128)  # earlier: 16 x 128, q stored
            return 16 * h + 16, 48.0
        if kernel == "sym":
            if hasattr(mod, "sym_layout"):
                lay = mod.sym_layout(N, N, 1, noff)
                return lay.bytes_a, lay.bytes_b
            # the earlier kernel: 16 x 128 tiles, a halo of one node, the half
            # planes read once
            h = (16 + 2) * (128 + 2) / (16 * 128)
            return 16 * h + 16 + 8 * noff, 48.0
        if hasattr(mod, "coef_layout"):
            lay = mod.coef_layout(N, N, 1, nb, noff)
            return lay.bytes_a, lay.bytes_b
        # the earlier kernel: 16, 8 or 4 rows by NB, a halo of one node
        rows = 16 if nb <= 2 else (8 if nb <= 4 else 4)
        h = (rows + 2) * (128 + 2) / (rows * 128)
        return 16 * h + 16 + 8 * noff / nb, 48.0

    # the tree's grid_blocks take (nv, nh, pad, ...) where it has
    # ops/_tiles.py; an earlier tree's const and coef ones take nb first
    nb_first = not (tree / "tpcg_torch" / "ops" / "_tiles.py").exists()

    def blocks_of(nb, N, noff):
        if real:
            if hasattr(mod, "grid_blocks"):
                return mod.grid_blocks(N, N, 1, noff, kernel == "real-coef")
            g = ctypes.c_int()
            _build.check(lib.tpcg_stream_real_grid(
                N, N, 1, int(kernel == "real-coef"), ctypes.byref(g)),
                "tpcg_stream_real_grid")
            return g.value
        if kernel == "sym":
            if hasattr(mod, "grid_blocks"):
                return mod.grid_blocks(N, N, 1, noff)
            g = ctypes.c_int()
            _build.check(lib.tpcg_stream_sym_grid(N, N, 1, ctypes.byref(g)),
                         "tpcg_stream_sym_grid")
            return g.value
        own = (nb, noff) if kernel == "coef" else (nb,)
        if nb_first:
            return mod.grid_blocks(nb, N, N, 1, *own[1:])
        return mod.grid_blocks(N, N, 1, *own)

    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if kernel == "const":
        compare = [(1024, 1000, 1), (2048, 500, 1), (2048, 500, 8),
                   (4096, 1000, 1)]
        split = [(N, it, nb) for N, it in ((1024, 1000), (2048, 500),
                                           (4096, 300)) for nb in (1, 4)]
        sweep_nb = [(2048, 500, 1), (4096, 300, 1)]
        variants = [(2048, 500, 1), (4096, 300, 1), (1024, 1000, 1)]
        sweep, knobs = SWEEP_CONST, ("TILE_ROWS", "STAGES", "BLOCKS_PER_SM")
    elif kernel == "real":
        # N < 0: the parabolic_fem cell's FE operator at |N|
        compare = [(-725, 1000, 1), (725, 1000, 1), (4096, 1000, 1),
                   (2048, 500, 1), (1024, 1000, 1), (2049, 500, 1),
                   (2896, 500, 1)]
        split = [(-725, 1000, 1), (1024, 1000, 1), (2048, 500, 1),
                 (2049, 500, 1), (4096, 300, 1)]
        sweep_nb = [(2048, 500, 1), (2049, 500, 1), (4096, 300, 1)]
        variants = [(2048, 500, 1), (4096, 300, 1), (1024, 1000, 1)]
        sweep, knobs = SWEEP_REAL, ("TILE_ROWS", "STAGES", "BLOCKS_PER_SM")
    elif kernel == "real-coef":
        compare = [(4096, 1000, 1), (2048, 500, 1), (1024, 1000, 1)]
        split = [(1024, 1000, 1), (4096, 300, 1)]
        sweep_nb = [(2048, 500, 1), (4096, 300, 1)]
        variants = [(2048, 500, 1), (4096, 300, 1), (1024, 1000, 1)]
        sweep = SWEEP_REAL_COEF
        knobs = ("COEF_TILE_ROWS", "STAGES", "COEF_STAGES",
                 "COEF_BLOCKS_PER_SM")
    elif kernel == "sym":
        compare = [(4096, 1000, 1), (2048, 500, 1), (1024, 1000, 1),
                   (2049, 500, 1)]
        split = [(1024, 1000, 1), (2048, 500, 1), (2049, 500, 1),
                 (4096, 300, 1)]
        sweep_nb = [(2048, 500, 1), (2049, 500, 1), (4096, 300, 1)]
        variants = [(2048, 500, 1), (4096, 300, 1), (1024, 1000, 1)]
        sweep = SWEEP_SYM
        knobs = ("TILE_ROWS", "STAGES", "COEF_STAGES", "BLOCKS_PER_SM")
    else:
        compare = [(1024, 1000, 1), (2048, 500, 1), (2048, 500, 2),
                   (2048, 500, 8), (2049, 500, 1), (4096, 1000, 1)]
        split = [(1024, 1000, 1), (2048, 500, 1), (2048, 500, 2),
                 (2048, 500, 8), (4096, 300, 1)]
        sweep_nb = [(2048, 500, 1), (2048, 500, 8), (4096, 300, 1)]
        variants = [(2048, 500, 1), (2048, 500, 8), (4096, 300, 1),
                    (1024, 1000, 1)]
        sweep = SWEEP_COEF
        knobs = ("TILE_ROWS", "STAGES", "COEF_STAGES", "BLOCKS_PER_SM")
    given = configs is not None
    if mode == "compare":
        cells = [c + (None,) for c in compare]
    elif mode == "variants":
        cells = [c + (None,) for c in variants]
    elif mode == "split":
        cells = [c + (cf,) for cf in (configs or [None]) for c in split]
    elif configs:
        # the given layouts, at N = 1024 too
        configs = [c for c in configs if fits(mod, kernel, c)]
        cells = [(N, it, nb, c) for N, it, nb in sweep_nb + [(1024, 1000, 1)]
                 for c in configs]
    else:
        # the source's own bounds: every configuration that fits; a tighter
        # or looser register cap: the configurations it is for
        own = (min_blocks, threads) == (kd["default_blocks"], 256)
        configs = [c for c in sweep if fits(mod, kernel, c) and (
            own or (c[-1] == min_blocks if threads == 256
                    else c[-1] <= min_blocks))]
        cells = [(N, it, nb, c) for N, it, nb in sweep_nb for c in configs]
    if sizes:
        cells = [c for c in cells if abs(c[0]) in sizes]
    defaults = tuple(getattr(mod, k, None) for k in knobs)
    last_N = None
    out = []

    def cell(N, iters, nb, config):
        nonlocal last_N, A, prep, b
        fe, N, cell_N = N < 0, abs(N), N
        if cell_N != last_N:
            A = prep = b = None
            torch.cuda.empty_cache()
            if kernel == "const":
                A = helm_fe(N, 12.0, eps=12.0, device=dev)
                prep = mod.prepare_stream(A)
                b = plane_wave_rhs(N, 12.0)
            elif kernel == "real":
                A, b = real_problem(N, dev, False, fe)
                prep = mod.prepare_stream_real(A)
            elif kernel == "real-coef":
                A, b = real_problem(N, dev, True)
                coefp = mod.prepare_stream_coef_real(A)
                # the planes at the kernel's pitch, once (as a plan holds
                # them), where the tree's wrapper takes such a copy
                prep = (coefp,) + ((mod.pad_real_planes(A.offsets, coefp),)
                                   if hasattr(mod, "pad_real_planes")
                                   else ())
            elif kernel == "sym":
                A, b = sym_problem(N, dev)
                half, cplanes = mod.prepare_stream_sym(A)
                # the half planes at the kernel's pitch, once (as a plan
                # holds them), where the tree's wrapper takes such a copy
                prep = (half, cplanes) + ((mod.pad_sym_planes(half, cplanes),)
                                          if hasattr(mod, "pad_sym_planes")
                                          else ())
            else:
                A, b = coef_problem(N, dev)
                prep = mod.prepare_stream_coef(A)
            last_N = cell_N
        noff = len(prep[0]) if kernel == "sym" else len(A.offsets)
        if config is not None:
            for k, v in zip(knobs, config):
                setattr(mod, k, v)
            if kernel == "real" and hasattr(mod, "SMALL_GRID_NODES"):
                mod.SMALL_GRID_NODES = 0  # the configuration at every size
            if kernel == "real" and hasattr(mod, "resident_layout"):
                mod.resident_layout = lambda *args: None  # streaming
        tag = tree.name if config is None else " ".join(
            f"{k[0]}{v}" for k, v in zip(knobs, config)) + (
                f" ({threads} threads, launch bounds {min_blocks})"
                if (min_blocks, threads) != (kd["default_blocks"], 256)
                else "")
        if real:
            bp = torch.from_numpy(b.astype(np.float32)).to(dev)
        else:
            B = np.stack([b * (1 + 0.1j * r) for r in range(nb)])
            bp = torch.from_numpy(np.stack([B.real, B.imag]).astype(
                np.float32)).to(dev)
        x0 = torch.zeros_like(bp)

        def solve():
            if kernel == "real":
                taps, strips = prep
                return mod.stream_cg_real_planes(A.offsets, A.grid, taps,
                                                 strips, bp, x0, iters)
            if kernel == "real-coef":
                kw = {"cpad": prep[1]} if len(prep) > 1 else {}
                return mod.stream_cg_real_coef_planes(A.offsets, prep[0], bp,
                                                      x0, iters, **kw)
            if kernel == "const":
                taps, strips = prep
                return mod.stream_cg_const_planes_batched(
                    A.offsets, A.grid, taps, strips, bp, x0, iters)
            if kernel == "sym":
                kw = {"cpad": prep[2]} if len(prep) > 2 else {}
                return mod.stream_cg_sym_planes(prep[0], prep[1], bp[:, 0],
                                                x0[:, 0], iters, **kw)
            return mod.stream_cg_coef_planes_batched_fat(
                A.offsets, prep, bp, x0, iters)
        try:
            x, _ = solve()
            blocks = blocks_of(nb, N, noff)
        except (RuntimeError, ValueError) as e:
            print(f"{tag}: N={N} NB={nb}: refused ({e})", flush=True)
            return
        read_slots()
        times, split_ = [], []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solve()
            end.record()
            s = read_slots()
            t_ms = start.elapsed_time(end)
            times.append(t_ms)
            ns = [int(s[2 * k]) for k in range(nbar)]
            cy = [int(s[2 * k + 1]) for k in range(nbar)]
            share_a = cy[-2] / max(1, sum(cy))
            share_b = cy[-1] / max(1, sum(cy))
            split_.append((t_ms * share_a, t_ms * share_b, ns[-2] * 1e-6,
                           ns[-1] * 1e-6))
        t = statistics.median(times)
        ta, tb, na, nbns = split_[times.index(t)]
        ba, bb = own_bytes(N, nb, noff)
        n = N * N
        per = 1e3 / (iters * nb)
        digest = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:12]
        row = dict(tree=tree.name, kernel=kernel, config=config,
                   bounds=min_blocks, threads=threads, N=N, fe=fe, nb=nb,
                   iters=iters, ms=t, us_rhs_it=t * per, a_us=ta * per,
                   b_us=tb * per,
                   a_tbs=ba * n * nb * iters / (ta * 1e-3) / 1e12,
                   b_tbs=bb * n * nb * iters / (tb * 1e-3) / 1e12,
                   own_b=ba + bb, blocks=blocks,
                   own_tbs=(ba + bb) * n * nb * iters / (t * 1e-3) / 1e12)
        out.append(row)
        print(f"{tag}: {'FE ' if fe else ''}N={N} NB={nb} {iters} it, "
              f"{blocks} blocks "
              f"({blocks / sms:g} an SM): median {t:.3f} ms "
              f"[{min(times):.3f}, {max(times):.3f}] = {t * per:.3f} us per "
              f"RHS-iteration, own {ba + bb:.2f} B a node and RHS at "
              f"{row['own_tbs']:.3f} TB/s; phase A {ta * per:.3f} us "
              f"({ba:.2f} B, {row['a_tbs']:.3f} TB/s; globaltimer "
              f"{na * per:.3f}), phase B {tb * per:.3f} us ({bb:.2f} B, "
              f"{row['b_tbs']:.3f} TB/s; globaltimer {nbns * per:.3f}); "
              f"x digest {digest}", flush=True)

    A = prep = b = None
    for c in cells:
        cell(*c)
    if mode == "sweep" and not given:
        # the three fastest over the NB = 1 cells together, at N = 1024 too
        tot = {}
        for r in out:
            if r["nb"] == 1:
                tot.setdefault(tuple(r["config"]), []).append(r["us_rhs_it"])
        full = max((len(v) for v in tot.values()), default=0)
        best = sorted((c for c, v in tot.items() if len(v) == full),
                      key=lambda c: sum(tot[c]))[:3]
        for c in best + ([defaults] if defaults[0] is not None
                         and defaults not in best else []):
            cell(1024, 1000, 1, c)
    return out


def sub(tree, mode, nbar, kernel, min_blocks=2, threads=256, configs=None,
        sizes=None):
    cmd = [sys.executable, __file__, "_run", "--tree", str(tree), "--mode",
           mode, "--nbar", str(nbar), "--kernel", kernel, "--bounds",
           str(min_blocks), "--threads", str(threads)] + (
               ["--configs", configs] if configs else []) + (
               ["--sizes", sizes] if sizes else [])
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=2400)
    sys.stdout.write(res.stdout)
    sys.stdout.flush()
    if res.returncode != 0:
        sys.stdout.write(res.stderr[-3000:])
        raise SystemExit(f"{tree}: exit {res.returncode}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("split", "sweep", "variants", "compare",
                                     "_run"))
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="const")
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    ap.add_argument("--mode", dest="inner")
    ap.add_argument("--nbar", type=int)
    ap.add_argument("--bounds", type=int)
    ap.add_argument("--threads", type=int, default=256)
    ap.add_argument("--configs")
    ap.add_argument("--edit")
    ap.add_argument("--sizes")
    a = ap.parse_args()
    configs = [tuple(int(v) for v in c.split(","))
               for c in a.configs.split(";")] if a.configs else None
    sizes = {int(v) for v in a.sizes.split(",")} if a.sizes else None
    if a.mode == "_run":
        rows = run_tree(a.tree.resolve(), a.inner, a.nbar, a.kernel,
                        2 if a.bounds is None else a.bounds, a.threads,
                        configs, sizes)
        print("ROWS " + json.dumps(rows))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(card_line(), flush=True)
    kd = KERNELS[a.kernel]
    tree = a.tree.resolve()
    name = "this" if tree == ROOT else tree.name
    bounds = kd["default_blocks"] if a.bounds is None else a.bounds
    if a.mode == "split":
        edit = dict(kd["edits"])[a.edit] if a.edit else None
        copy, nbar = stamped_copy(
            tree, name + (f"-{a.edit}" if a.edit else "") + (
                f"-b{bounds}" if bounds != kd["default_blocks"] else ""),
            a.kernel, bounds, edit=edit)
        sub(copy, a.mode, nbar, a.kernel, bounds, configs=a.configs,
            sizes=a.sizes)
    elif a.mode == "variants":
        for name_e, edit in kd["edits"] + kd["edits"][:1]:
            copy, nbar = stamped_copy(tree, f"{name}-{name_e}", a.kernel,
                                      edit=edit)
            sub(copy, a.mode, nbar, a.kernel, kd["default_blocks"],
                sizes=a.sizes)
    elif a.mode == "sweep":
        edit = dict(kd["edits"])[a.edit] if a.edit else None
        builds = kd["builds"][:1] if configs else kd["builds"]
        for build, b, threads in builds:
            copy, nbar = stamped_copy(
                tree, f"{name}-{build}" + (f"-{a.edit}" if a.edit else ""),
                a.kernel, b, threads, edit)
            sub(copy, a.mode, nbar, a.kernel, b, threads, a.configs)
    else:
        other, nbar_o = stamped_copy(tree, name, a.kernel)
        this, nbar_t = stamped_copy(ROOT, "this", a.kernel)
        for t, nb in ((other, nbar_o), (this, nbar_t), (this, nbar_t),
                      (other, nbar_o)):
            sub(t, "compare", nb, a.kernel, kd["default_blocks"],
                sizes=a.sizes)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
