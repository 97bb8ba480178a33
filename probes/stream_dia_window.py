"""Probe: kernel A (``csrc/stream_cg_dia.cu``) timed an iteration on the
m_t1 band, with and without its window of the direction in shared memory.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 probes/stream_dia_window.py freeze
    python3 probes/stream_dia_window.py rule
    python3 probes/stream_dia_window.py compare --tree DIR
    python3 probes/stream_dia_window.py split
    python3 probes/stream_dia_window.py table
    python3 probes/stream_dia_window.py variants
    python3 probes/stream_dia_window.py floor
    python3 probes/stream_dia_window.py cluster
    python3 probes/stream_dia_window.py clusters

``freeze``: kernel A at m_t1's n and offsets, B = 1, 2, 4 and 8 RHS a
launch, on the benchmark's stand-in ``banded_spd(97578, 50)`` (every RHS
freezes by iteration ~10: ``<r, r>`` underflows) and on a band of the same
n, offsets and layout that converges slowly: the stand-in's off-diagonals
made negative and damped by (min|off| / |off|)^4, each row's diagonal their
magnitudes' sum times 1 + 1e-5 (SPD by Gershgorin; ||r|| falls ~10x in
1,100 iterations).  It checks that no RHS of the second band
freezes within the timed iterations (no history entry 0 or equal to the one
before: a frozen RHS holds its delta) and prints the per-iteration times
of the two bands side by side: the kernel does the same work on a frozen
RHS, so they agree.

``rule``: the staged window against the direct L2 read (``dia_layout``
forced to ``staged=False``) at helm_fem (complex, 1 RHS, 7 diagonals),
m_t1 (B = 1, 8) and parabolic_fem (B = 1, 8), in turns.

``compare --tree DIR``: this checkout's kernel A and the one of the
``tpcg_torch`` package under DIR (for example the parent commit's, from
``git archive`` under ``probes/_variants/``, which git ignores) at m_t1
B = 1 and 8, helm_fem and parabolic_fem, each in its own process, in turns
(DIR, this, this, DIR).

``split``: a copy of the kernel's source that stamps ``%globaltimer`` in
block 0 after each grid barrier of an iteration and around its window's
fill, built into a library of its own: per iteration, phase 1 (the fill,
q = A d and the <d, q> partials, with its barrier wait), the fill alone
(its copies in flight beside the first diagonals' values), phase 2 (x,
r and the <r, r> partials) and phase 3 (d), at m_t1 B = 1 and 8, helm_fem
and parabolic_fem.

``table``: PERF.md's kernel table rows 3-5 at their cells, one solve on
device operands timed by CUDA events, median of ``REPS``: mhd1280b through
kernel B (``csrc/fused_cg_dia.cu``, 5000 iterations), m_t1 B = 1 (200) and
helm_fem as a DIA matrix (5000) through kernel A.

``floor``: a kernel of its own that does an iteration's three phases
with no work: a barrier across the launch, and the exchange of one float2
partial a block, summed in block order; cooperative grids of 16, 32 and
132 blocks against one cluster of 2, 4, 8 and 16 blocks, whose exchange
is a cluster barrier (with and without its release), a read over
distributed shared memory after it, or a push by st.async into every
block's slot completing on its mbarrier.  us a phase.

``cluster``: helm_fem at 1 and 8 RHS as the cooperative grid and as one
cluster of 4, 8 and 16 blocks (``dia_layout(cluster=C)``), us an
iteration in turns, then each one's phases from the ``split`` build.

``clusters``: the ORAS block (the subdomain operator of the helm_oras_m4
cell, ``SchwarzPrec.values``: n 4,356, 7 diagonals, complex) at 16 RHS as
one launch of G = 16 / k clusters side by side, k = 1, 2, 4 and 8 RHS a
cluster (``cluster_split`` forced), in turns: us an iteration (slope) and
the time of a 256-iteration solve (the cell's, one preconditioner
application), beside G and the clusters of the k-RHS instance the card
holds at once (``tpcg_stream_dia_grid``); then that count for k = 1..8
and the rule's own (k, G).

``variants``: edited copies of the kernel's source (threads a block, rows
a thread takes through one pass of the taps, diagonals of values in
flight) built into
libraries of their own under ``probes/_variants/`` and timed at m_t1 B = 8
and B = 1; each build prints its instances' registers and spills.

Times are CUDA-event slopes: a solve of ``IT0 + IT`` iterations less one of
``IT0``, over ``IT``, the median of ``REPS`` rounds.  Every line names the
card and its power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ROOT / "probes" / "_variants"
IT0, IT, REPS = 100, 1000, 3
RHS_COUNTS = (1, 2, 4, 8)
# (threads a block, rows a thread takes at once, diagonals of values in
# flight); each ring at most 80 KB, so m_t1's 143 KB window fits beside it
VARIANT_GRID = [(256, 3, 8), (256, 3, 16), (256, 3, 4), (192, 4, 8),
                (128, 6, 8), (384, 2, 8), (512, 2, 8), (768, 1, 8)]


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else "unknown card"


def _import(tree):
    if tree is not None:
        sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    else:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("tpcg_torch.ops.stream_cg_dia")


def _dia(A, dtype, dev):
    import scipy.sparse as sp
    from tpcg_torch.sparse import DiaMatrix
    return DiaMatrix.from_scipy(sp.csr_matrix(A.astype(dtype)), device=dev)


def _band(name):
    """Host scipy matrix and whether it is complex."""
    import scipy.sparse as sp
    from tpcg_torch.problems import banded_spd, helm_fe, parabolic_stencil
    if name == "m_t1":
        return banded_spd(97578, 50), False
    if name == "m_t1_live":
        # the stand-in's off-diagonals made negative and damped by
        # (min|off| / |off|)^4, each row's diagonal their magnitudes' sum
        # times 1 + 1e-5: SPD by Gershgorin, condition ~1e5.  (The stand-in
        # with its diagonal lowered to that sum + 0.01 underflows by
        # iteration ~50, and with the signs made negative by ~500.)
        A = banded_spd(97578, 50).tocoo()
        far = np.abs(A.col - A.row)
        keep = far > 0
        w = -np.abs(A.data[keep]) * (far[keep].min() / far[keep]) ** 4.0
        off = sp.csr_matrix((w, (A.row[keep], A.col[keep])), shape=A.shape)
        d = np.asarray(-off.sum(axis=1)).ravel() * (1 + 1e-5)
        return (off + sp.diags(d)).tocsr(), False
    if name == "parabolic":
        return parabolic_stencil(725, device="cpu").to_dia().to_scipy(), False
    return helm_fe(128, 12.0, eps=12.0, device="cpu").to_scipy(), True


_MADE = {}


def _operands(tsd, name, nb, dev):
    key = (id(tsd), name, nb)
    if key not in _MADE:
        _MADE[key] = _make(tsd, name, nb, dev)
    return _MADE[key]


def _make(tsd, name, nb, dev):
    import torch
    A, cplx = _band(name)
    D = _dia(A, np.complex64 if cplx else np.float32, dev)
    offs, vals = (tsd.prepare_dia_rows_cplx(D) if cplx
                  else tsd.prepare_dia_rows(D))
    rng = np.random.default_rng(11)
    shape = (2, nb, D.n) if cplx else (nb, D.n)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    solve = tsd.stream_cg_dia_rows_cplx if cplx else tsd.stream_cg_dia_rows
    return solve, offs, vals, b, torch.zeros_like(b)


def _time(run, iters):
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = run(iters)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _slope(run):
    """Median over REPS of (t(IT0 + IT) - t(IT0)) / IT, in us, and the last
    history of IT0 + IT iterations."""
    run(IT0)
    times, hist = [], None
    for _ in range(REPS):
        t1, _ = _time(run, IT0)
        t2, (_, hist) = _time(run, IT0 + IT)
        times.append((t2 - t1) / IT * 1e3)
    return float(np.median(times)), hist


def _forced(tsd, cluster=None, staged=None):
    """tsd.dia_layout, taking ``cluster`` (0: the cooperative layout, C: a
    cluster of C blocks) and, where ``staged`` is False, reading d from L2;
    an explicit ``cluster=`` of the caller (the wrapper's fallback) wins."""
    layout = tsd.dia_layout
    if cluster is None and staged is None:
        return layout       # (an older tree's dia_layout has no cluster=)

    def forced(*a, cluster=cluster):
        lay = layout(*a, cluster=cluster)
        return lay._replace(staged=False) if staged is False else lay
    return forced


def _solver(tsd, name, nb, dev, cluster=None, staged=None):
    solve, offs, vals, b, x0 = _operands(tsd, name, nb, dev)
    layout = tsd.dia_layout
    tsd.dia_layout = _forced(tsd, cluster, staged)

    def run(iters):
        return solve(offs, vals, b, x0, iters)
    try:
        return _slope(run)
    finally:
        tsd.dia_layout = layout


def _frozen(hist):
    """Per RHS: the first iteration whose history entry is 0 or equals the
    one before (a frozen RHS holds its delta), or None."""
    h = hist.cpu().numpy()
    out = []
    for c in range(h.shape[1]):
        bad = np.where((h[1:, c] == 0) | (h[1:, c] == h[:-1, c]))[0]
        out.append(int(bad[0]) + 1 if len(bad) else None)
    return out


def freeze(args):
    import torch
    tsd = _import(None)
    dev = torch.device("cuda:0")
    card = _card()
    for nb in RHS_COUNTS:
        rows = {}
        for name in ("m_t1", "m_t1_live", "m_t1_live", "m_t1"):
            us, hist = _solver(tsd, name, nb, dev)
            rows.setdefault(name, []).append(us)
            rows[name + ".frozen"] = _frozen(hist)
        a, b = np.median(rows["m_t1"]), np.median(rows["m_t1_live"])
        print(json.dumps({
            "probe": "freeze", "card": card, "nb": nb,
            "us_per_it_stand_in": rows["m_t1"],
            "us_per_it_live": rows["m_t1_live"],
            "live_over_stand_in": b / a,
            "frozen_at_stand_in": rows["m_t1.frozen"],
            "frozen_at_live": rows["m_t1_live.frozen"]}), flush=True)
        live = rows["m_t1_live.frozen"]
        if any(f is not None for f in live):
            print(f"FAIL: a RHS of the live band froze: {live}", flush=True)
        if abs(b / a - 1) > 0.03:
            print(f"FAIL: live / stand-in {b / a:.4f}", flush=True)


def rule(args):
    import torch
    tsd = _import(None)
    dev = torch.device("cuda:0")
    card = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, nb in (("helm_fem", 1), ("m_t1", 1), ("m_t1", 8),
                     ("parabolic", 1), ("parabolic", 8)):
        out = {}
        for staged in (True, False, False, True):
            us, _ = _solver(tsd, name, nb, dev, cluster=0, staged=staged)
            out.setdefault("staged" if staged else "direct", []).append(us)
        A, cplx = _band(name)
        offs = tuple(int(o) for o in _dia(A, np.complex64 if cplx else
                                          np.float32, "cpu").offsets)
        print(json.dumps({"probe": "rule", "card": card, "case": name,
                          "nb": nb, "ndiag_x_nb": len(offs) * nb,
                          "layout": tsd.dia_layout(A.shape[0], offs, nb,
                                                   2 if cplx else 1, sms,
                                                   cluster=0)._asdict(),
                          "us_per_it": out}), flush=True)


CASES = (("m_t1", 1), ("m_t1", 8), ("helm_fem", 1), ("parabolic", 1))


def time_tree(args):
    import torch
    tsd = _import(args.tree)
    dev = torch.device("cuda:0")
    for name, nb in CASES:
        us, _ = _solver(tsd, name, nb, dev)
        print(json.dumps({"tree": args.tree or "this", "case": name,
                          "nb": nb, "us_per_it": us}), flush=True)


def compare(args):
    card = _card()
    rows = {}
    for tree in (args.tree, None, None, args.tree):
        cmd = [sys.executable, __file__, "time"]
        if tree is not None:
            cmd += ["--tree", tree]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, flush=True)
            raise SystemExit(out.returncode)
        for line in out.stdout.splitlines():
            rec = json.loads(line)
            rows.setdefault((rec["case"], rec["nb"]), {}).setdefault(
                rec["tree"], []).append(rec["us_per_it"])
    for (name, nb), by in rows.items():
        base, this = np.median(by[args.tree]), np.median(by["this"])
        print(json.dumps({"probe": "compare", "card": card, "case": name,
                          "nb": nb, "us_per_it": by,
                          "this_over_tree": this / base}), flush=True)


class _Lib:
    """Stands in for ``ops._build`` with a variant's library."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        sig = importlib.import_module("tpcg_torch.ops._build")._SIGNATURES
        for name in ("tpcg_stream_dia_limits", "tpcg_stream_dia_grid",
                     "tpcg_stream_dia"):
            getattr(lib, name).argtypes = list(sig[name])
            getattr(lib, name).restype = ctypes.c_int
        self.lib = lib

    def load(self):
        return self.lib

    @staticmethod
    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")


def _variant_source(threads, rows, depth):
    src = (ROOT / "tpcg_torch" / "csrc" / "stream_cg_dia.cu").read_text()
    edits = [(r"constexpr int kThreads = \d+;",
              f"constexpr int kThreads = {threads};"),
             (r"constexpr int kRows = \d+;", f"constexpr int kRows = {rows};"),
             (r"constexpr int kDepth = \d+;",
              f"constexpr int kDepth = {depth};")]
    for pat, rep in edits:
        src, hits = re.subn(pat, rep, src)
        if hits != 1:
            raise RuntimeError(f"variant edit {pat!r} matched {hits} times")
    return src


SPLIT_SLOTS = ("phase1", "phase2", "phase3", "fill")


def _stamped(src):
    """The kernel's source with block 0's barrier stamps (``split``)."""
    head = "namespace {\n"
    stamp = (
        "__device__ unsigned long long g_split[4];\n"
        "__device__ __forceinline__ unsigned long long split_now() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n")
    edits = [(head, head + stamp, 1),
             ("    if (STAGED) issue_window<P * NB>(p.dpad, t, win);\n",
              "    const unsigned long long f0 = split_now();\n"
              "    if (STAGED) issue_window<P * NB>(p.dpad, t, win);\n", 1),
             ("    copy_wait<D - 1>();  // the window's group, the oldest\n"
              "    __syncthreads();\n",
              "    copy_wait<D - 1>();  // the window's group, the oldest\n"
              "    __syncthreads();\n"
              "    if (STORE_Q && blockIdx.x == 0 && threadIdx.x == 0)\n"
              "      g_split[3] += split_now() - f0;\n", 1)]
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"split edit {old!r} matched "
                               f"{src.count(old)} times")
        src = src.replace(old, new)
    loop = "  for (int it = 0; it < p.n_iterations; ++it) {\n"
    pre, body = src.split(loop)
    end = body.index("\n}\n")      # the kernel's closing brace
    # the iteration's three exchanges (grid barriers, or in cluster mode
    # the waits for the pushes of the other blocks)
    syncs = re.split(r"(    exchange<CLUSTER>\([^;]*\);\n)", body[:end])
    if len(syncs) != 7:
        raise RuntimeError("split: the iteration has not 3 exchanges")
    stamped = "".join(
        syncs[2 * k] + syncs[2 * k + 1] + "    if (blockIdx.x == 0 && "
        "threadIdx.x == 0) {\n      const unsigned long long u = "
        f"split_now();\n      g_split[{k}] += u - split_t;\n"
        "      split_t = u;\n    }\n" for k in range(3)) + syncs[6]
    src = (pre + "  unsigned long long split_t = split_now();\n" + loop +
           stamped + body[end:])
    return src + (
        '\nextern "C" int tpcg_dia_split(unsigned long long* out) {\n'
        "  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, "
        "sizeof(g_split));\n"
        "  static const unsigned long long zero[4] = {};\n"
        "  if (err == cudaSuccess)\n"
        "    err = cudaMemcpyToSymbol(g_split, zero, sizeof(zero));\n"
        "  return err;\n}\n")


def _build_variants(named_sources):
    """Build each (name, source) into probes/_variants/<name>/k.so in
    parallel; print each build's registers and spills; return the
    libraries that built."""
    build = importlib.import_module("tpcg_torch.ops._build")
    jobs = []
    for name, src in named_sources:
        d = VARIANTS / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "k.cu").write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
               str(d / "k.so"), str(d / "k.cu")]
        jobs.append((name, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for name, d, proc in jobs:
        log, _ = proc.communicate()
        regs = re.findall(r"Function properties for (\S*stream_dia_kernel\S*)"
                          r"[\s\S]*?(\d+) bytes spill stores[\s\S]*?Used "
                          r"(\d+) registers", log)
        print(json.dumps({"probe": "build", "variant": name,
                          "ok": proc.returncode == 0,
                          "max_registers": max((int(r[2]) for r in regs),
                                               default=None),
                          "spill_stores": sum(int(r[1]) for r in regs)}),
              flush=True)
        if proc.returncode == 0:
            libs.append((name, d / "k.so"))
        else:
            print(log[-3000:], flush=True)
    return libs


def _splitter(tsd):
    """Point tsd at the stamped build of the kernel; return a function of
    (case, nb, cluster) giving block 0's phase times an iteration, in us."""
    import torch
    dev = torch.device("cuda:0")
    src = (ROOT / "tpcg_torch" / "csrc" / "stream_cg_dia.cu").read_text()
    libs = _build_variants([("dia_split", _stamped(src))])
    if not libs:
        raise SystemExit(1)
    shim = _Lib(libs[0][1])
    read = shim.lib.tpcg_dia_split
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    tsd._build = shim
    out = (ctypes.c_ulonglong * 4)()

    def phases(name, nb, cluster=None):
        solve, offs, vals, b, x0 = _operands(tsd, name, nb, dev)
        layout = tsd.dia_layout
        tsd.dia_layout = _forced(tsd, cluster)
        try:
            solve(offs, vals, b, x0, IT0)
            torch.cuda.synchronize()
            shim.check(read(out), "tpcg_dia_split")
            solve(offs, vals, b, x0, IT)
            torch.cuda.synchronize()
            shim.check(read(out), "tpcg_dia_split")
        finally:
            tsd.dia_layout = layout
        return {k: out[i] / IT / 1e3 for i, k in enumerate(SPLIT_SLOTS)}
    return phases


def split(args):
    tsd = _import(None)
    card = _card()
    phases = _splitter(tsd)
    for name, nb in (("m_t1", 8), ("m_t1", 1), ("helm_fem", 1),
                     ("parabolic", 1)):
        print(json.dumps({"probe": "split", "card": card, "case": name,
                          "nb": nb, "us_per_it": phases(name, nb)}),
              flush=True)


# cluster sizes of the ``cluster`` sweep; 0 is the cooperative grid
CLUSTER_SIZES = (0, 4, 8, 16)


def cluster(args):
    """helm_fem (complex, 1 and 8 RHS) as a cooperative grid and as one
    cluster of 4, 8 and 16 blocks: us an iteration in turns, then the
    phases of each from the stamped build.  A size whose tiles do not fit
    a block's shared memory reports the kernel's refusal."""
    import torch
    tsd = _import(None)
    card = _card()
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    A, _ = _band("helm_fem")
    offs = tuple(int(o) for o in _dia(A, np.complex64, "cpu").offsets)
    for nb in (1, 8):
        times = {}
        for c in CLUSTER_SIZES + CLUSTER_SIZES[::-1]:
            try:
                us, _ = _solver(tsd, "helm_fem", nb, dev, cluster=c)
            except RuntimeError as exc:
                us = str(exc)
            times.setdefault(c, []).append(us)
        for c, us in times.items():
            lay = tsd.dia_layout(A.shape[0], offs, nb, 2, sms, cluster=c)
            print(json.dumps({"probe": "cluster", "card": card,
                              "case": "helm_fem", "nb": nb, "cluster": c,
                              "layout": lay._asdict(), "us_per_it": us}),
                  flush=True)
    phases = _splitter(tsd)
    for nb in (1, 8):
        for c in CLUSTER_SIZES:
            try:
                row = phases("helm_fem", nb, c)
            except RuntimeError as exc:
                row = str(exc)
            print(json.dumps({"probe": "cluster_split", "card": card,
                              "case": "helm_fem", "nb": nb, "cluster": c,
                              "us_per_it": row}), flush=True)


FLOOR_SRC = r"""
// One phase of kernel A with no work: a barrier across the launch and the
// exchange of one float2 partial a block, each block summing the partials
// in block order.  mode 0: the barrier alone (grid.sync or
// barrier.cluster); 1: a block's partial (warp butterflies, shared memory),
// the barrier, then one warp reads every block's partial (through L2 from
// global memory, or over distributed shared memory); cluster launches only:
// 2: each warp's partial in shared memory, the barrier, one warp reads the
// C x 12 warp partials over distributed shared memory; 3: the block's
// partial pushed into a slot of every block by st.async, which completes
// bytes on that block's mbarrier, each block waiting on its own (one
// one-way trip in place of a barrier and a read); 4: the barrier alone,
// arrive.relaxed; 5: the barrier alone as remote mbarrier arrivals.
// Slots and mbarriers alternate by phase parity.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;
namespace {
constexpr int kThreads = 384, kWarps = kThreads / 32;
__device__ __forceinline__ float2 warp_sum(float2 v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void push(uint32_t dst, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
      "[%0], {%1, %2}, [%3];" :: "r"(dst), "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void remote_arrive(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(bar) : "memory");
}
__device__ __forceinline__ bool try_parity(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// trap after ~2 s: a push that never lands is a fault, not a hang
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  if (try_parity(bar, parity)) return;
  const long long t0 = clock64();
  while (!try_parity(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}
template <bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
floor_kernel(float2* part, float* out, int iters, int mode) {
  __shared__ float2 red[kWarps];
  __shared__ float2 own[2];
  __shared__ float2 slot[2][16];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float2 tot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  if (CLUSTER && threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(saddr(&bar[k])), "r"(mode == 5 ? nb : 1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (CLUSTER) cg::this_cluster().sync();
  const uint32_t rank = CLUSTER ? cg::this_cluster().block_rank() : 0;
  float2 acc = make_float2(threadIdx.x * 1e-3f, 1.f);
  for (int it = 0; it < iters; ++it) {
    for (int ph = 0; ph < 3; ++ph) {
      const int buf = (it * 3 + ph) & 1;
      if (mode == 0) {
        if (CLUSTER) cg::this_cluster().sync();
        else cg::this_grid().sync();
      } else if (mode == 4) {
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                     "barrier.cluster.wait.aligned;" ::: "memory");
      } else if (mode == 5) {
        if (threadIdx.x < nb) remote_arrive(mapa(saddr(&bar[buf]), threadIdx.x));
        wait_parity(saddr(&bar[buf]), ((it * 3 + ph) >> 1) & 1);
      } else if (mode == 1) {
        float2 v = warp_sum(acc);
        if (lane == 0) red[warp] = v;
        __syncthreads();
        if (warp == 0) {
          float2 w = lane < kWarps ? red[lane] : make_float2(0.f, 0.f);
          w = warp_sum(w);
          if (lane == 0) {
            if (CLUSTER) own[buf] = w;
            else part[buf * nb + blockIdx.x] = w;
          }
        }
        __syncthreads();
        if (CLUSTER) cg::this_cluster().sync();
        else cg::this_grid().sync();
        if (warp == 0) {
          float2 u = make_float2(0.f, 0.f);
          if (lane < nb) {
            if (CLUSTER) u = *cg::this_cluster().map_shared_rank(&own[buf], lane);
            else u = __ldcg(part + buf * nb + lane);
          }
          u = warp_sum(u);
          if (lane == 0) tot = u;
        }
        __syncthreads();
        acc.x += tot.x * 1e-9f;
      } else if (mode == 2) {
        float2 v = warp_sum(acc);
        if (lane == 0) red[warp] = v;
        cg::this_cluster().sync();
        if (warp == 0) {
          float2 u = make_float2(0.f, 0.f);
          for (int e = lane; e < nb * kWarps; e += 32) {
            const float2 t = *cg::this_cluster().map_shared_rank(
                &red[e % kWarps], e / kWarps);
            u.x += t.x;
            u.y += t.y;
          }
          u = warp_sum(u);
          if (lane == 0) tot = u;
        }
        __syncthreads();
        acc.x += tot.x * 1e-9f;
      } else {  // mode 3
        float2 v = warp_sum(acc);
        if (lane == 0) red[warp] = v;
        __syncthreads();
        if (warp == 0) {
          float2 w = lane < kWarps ? red[lane] : make_float2(0.f, 0.f);
          w = warp_sum(w);
          if (lane == 0)
            asm volatile(
                "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, "
                "[%0], %1;" :: "r"(saddr(&bar[buf])), "r"(8 * nb)
                : "memory");
          if (lane < nb)
            push(mapa(saddr(&slot[buf][rank]), lane), w,
                 mapa(saddr(&bar[buf]), lane));
        }
        wait_parity(saddr(&bar[buf]), ((it * 3 + ph) >> 1) & 1);
        float2 u = lane < nb ? slot[buf][lane] : make_float2(0.f, 0.f);
        u = warp_sum(u);
        acc.x += u.x * 1e-9f;
      }
    }
  }
  if (CLUSTER) cg::this_cluster().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = acc.x;
}
}  // namespace
extern "C" int tpcg_floor(int cluster, int nblocks, int mode, int iters,
                          void* part, void* out, void* stream) {
  void* args[] = {&part, &out, &iters, &mode};
  cudaError_t err;
  if (!cluster) {
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(floor_kernel<false>), dim3(nblocks),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  } else {
    const void* fn = reinterpret_cast<const void*>(floor_kernel<true>);
    if (nblocks > 8) {
      err = cudaFuncSetAttribute(fn,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nblocks);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nblocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelExC(&cfg, fn, args);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
"""
# (cluster size or 0 for a cooperative grid, blocks)
FLOOR_CASES = ((0, 132), (0, 32), (0, 16), (2, 2), (4, 4), (8, 8),
               (16, 16))


def floor(args):
    """The floor of one phase of kernel A: a barrier across the launch with
    and without the reduction of one float2 a block (``FLOOR_SRC``)."""
    import torch
    sys.path.insert(0, str(ROOT))
    card = _card()
    libs = _build_variants([("dia_floor", FLOOR_SRC)])
    if not libs:
        raise SystemExit(1)
    lib = ctypes.CDLL(str(libs[0][1]))
    lib.tpcg_floor.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.tpcg_floor.restype = ctypes.c_int
    part = torch.zeros(2 * 132 * 2, device="cuda:0")
    out = torch.zeros(1, device="cuda:0")

    def run(cluster, blocks, mode, iters):
        err = lib.tpcg_floor(cluster, blocks, mode, iters, part.data_ptr(),
                             out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tpcg_floor: CUDA error {err}")
        return None, None
    for cluster, blocks in FLOOR_CASES + FLOOR_CASES[::-1]:
        row = {}
        modes = ((0, "barrier"), (1, "barrier_and_partials"))
        if cluster:
            modes += ((2, "warp_partials_read"), (3, "push_partials"),
                      (4, "barrier_relaxed"), (5, "barrier_by_arrivals"))
        for mode, what in modes:
            try:
                us, _ = _slope(lambda k: run(cluster, blocks, mode, k))
            except RuntimeError as exc:
                row[what] = str(exc)
                continue
            row[what] = us / 3
        print(json.dumps({"probe": "floor", "card": card,
                          "launch": "cluster" if cluster else "cooperative",
                          "blocks": blocks, "us_per_phase": row}),
              flush=True)


def table(args):
    import torch
    tsd = _import(None)
    from tpcg_torch.problems import banded_complex
    tfd = importlib.import_module("tpcg_torch.ops.fused_cg_dia")
    card = _card()
    dev = torch.device("cuda:0")
    mhd = _dia(banded_complex(1280, tuple(range(0, 9)), seed=2),
               np.complex64, dev)
    offs, vals = tsd.prepare_dia_rows_cplx(mhd)
    b = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 1, mhd.n)).astype(np.float32)).to(dev)
    rows = [(3, "mhd1280b", 5000, tfd.fused_cg_dia_rows_cplx,
             (offs, vals, b, torch.zeros_like(b)))]
    for row, name, iters in ((4, "m_t1", 200), (5, "helm_fem", 5000)):
        solve, offs, vals, b, x0 = _operands(tsd, name, 1, dev)
        rows.append((row, name, iters, solve, (offs, vals, b, x0)))
    for row, name, iters, solve, ops in rows:
        solve(*ops, iters)
        ms = [_time(lambda k: solve(*ops, k), iters)[0] for _ in range(REPS)]
        print(json.dumps({"probe": "table", "card": card, "row": row,
                          "case": name, "iterations": iters, "ms": ms}),
              flush=True)


def variants(args):
    import torch
    tsd = _import(None)
    card = _card()
    dev = torch.device("cuda:0")
    libs = _build_variants([("dia_t%d_r%d_d%d" % v, _variant_source(*v))
                            for v in VARIANT_GRID])
    for name, nb in (("m_t1", 8), ("m_t1", 1)):
        for v, path in libs + libs[::-1]:
            tsd._build = _Lib(path)
            us, _ = _solver(tsd, name, nb, dev)
            print(json.dumps({"probe": "variant", "card": card,
                              "variant": v, "case": name, "nb": nb,
                              "us_per_it": us}), flush=True)


# RHS a cluster of the ``clusters`` sweep, and the batch
CLUSTER_RHS, ORAS_RHS = (1, 2, 4, 8), 16


def clusters(args):
    """The ORAS block at 16 RHS as G clusters of k RHS side by side in
    one launch, k of ``CLUSTER_RHS``, in turns."""
    import torch
    sys.path.insert(0, str(ROOT))
    import tpcg_torch
    tsd = importlib.import_module("tpcg_torch.ops.stream_cg_dia")
    card = _card()
    dev = torch.device("cuda:0")
    cfg = tpcg_torch.HelmholtzConfig(k=20.0, M_subd=4, W_subd=34,
                                     cg_max_it=256, verbose=0)
    prec = tpcg_torch.plan_hsolver(cfg, dev).prec
    offs, vals = prec.offsets, prec.values
    n = vals.shape[2]
    rng = np.random.default_rng(11)
    b = torch.from_numpy(rng.standard_normal((2, ORAS_RHS, n)).astype(
        np.float32)).to(dev)
    x0 = torch.zeros_like(b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = tsd.dia_layout(n, offs, 1, 2, sms)

    def active(k):
        return tsd._grid_of(dev, offs, n, 2, k, lay)[1]
    rule = tsd.cluster_split

    def run(iters):
        return tsd.stream_cg_dia_rows_cplx(offs, vals, b, x0, iters)
    times = {}
    try:
        for k in CLUSTER_RHS + CLUSTER_RHS[::-1]:
            tsd.cluster_split = lambda nrhs, act, k=k: (k, -(-nrhs // k))
            us, _ = _slope(run)
            run(256)
            ms = [_time(run, 256)[0] for _ in range(REPS)]
            times.setdefault(k, []).append((us, float(np.median(ms))))
    finally:
        tsd.cluster_split = rule
    for k, rows in times.items():
        print(json.dumps({"probe": "clusters", "card": card, "case": "oras",
                          "n": n, "ndiag": len(offs), "nrhs": ORAS_RHS,
                          "k": k, "G": -(-ORAS_RHS // k),
                          "co_resident": active(k),
                          "layout": tsd.dia_layout(n, offs, k, 2,
                                                   sms)._asdict(),
                          "us_per_it": [u for u, _ in rows],
                          "ms_256_it": [m for _, m in rows]}), flush=True)
    print(json.dumps({"probe": "clusters_rule", "card": card,
                      "co_resident": {k: active(k) for k in range(1, 9)},
                      "rule_k_G": rule(ORAS_RHS, active)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["freeze", "rule", "compare", "time",
                                     "split", "table", "variants",
                                     "floor", "cluster", "clusters"])
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    if args.mode == "compare" and args.tree is None:
        ap.error("compare needs --tree")
    {"freeze": freeze, "rule": rule, "compare": compare, "time": time_tree,
     "split": split, "table": table, "variants": variants,
     "floor": floor, "cluster": cluster,
     "clusters": clusters}[args.mode](args)


if __name__ == "__main__":
    main()
