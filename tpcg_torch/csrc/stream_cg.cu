// Fixed-iteration COCG on a constant-tap complex 2-D stencil whose state
// does not fit on chip, for 1..8 right-hand sides (RHS) in one persistent
// cooperative launch.
//
// Replaces, on the planner's `stream` path, the Pallas kernels of the JAX
// package that compute this one function with the TPU's memory tiers:
//   * tpcg/ops/stream_cg.py::_build_kernels (v2 K1: d = r + beta d, q = A d,
//     <d,q>, alpha over row blocks with halo strips; also the r0 init of v4
//     and v5) and ::_make_k2 (v2 K2: x += alpha d, r -= alpha q, <r,r>,
//     beta);
//   * tpcg/ops/stream_cg.py::_build_k1_const_batched and ::_make_k2_batched
//     (the same two sweeps over a (row block, RHS) grid: nb RHS a program);
//   * tpcg/ops/stream_cg_v3.py::_build_merged, const taps (v2's two sweeps
//     merged into one call; bit-equal to v2 in JAX's own tests);
//   * tpcg/ops/stream_cg_v4.py::_build_resident (const taps): K iterations
//     per call with the state resident in VMEM;
//   * tpcg/ops/stream_cg_v5.py::_build_v5: the v4 loop with state row panels
//     round-tripping HBM by DMA, including the column-padded `cpos` route.
// Their VMEM budgets, row-block sizes and 128-lane padding have no purpose
// here: the state lives in device memory.
//
// What it computes, for each of the NB RHS of a launch independently
// (tpcg_torch/ops/stream_cg.py::stream_cg_const_planes_plain is the same
// function for one RHS in plain PyTorch, step for step):
//   r0 = b - A x0, delta0 = <r0, r0>, d = 0, beta = 0; then per iteration
//   d' = r + beta d, q = A d', alpha = delta / <d',q>, x += alpha d',
//   r -= alpha q, delta' = <r,r>, beta = delta' / delta (Smith division);
//   done = (delta == 0) | (<d',q> == 0), both parts, evaluated afresh each
//   iteration, zeroes alpha and beta; hist[it] = sqrt(sqrt(|delta|^2)).
// A x = the interior taps c_s on every node, the left/right edge taps on
// columns 0 / nh-1, the bottom/top strips on rows 0 / nv-1 (the strips are
// corner-adjusted on the host, tpcg_torch.ops.stream_cg.prepare_stream); a
// neighbour outside the grid reads 0.  Unconjugated dots <u,v> = sum u v.
// The RHS of a launch share the taps (kernel parameters), the strips, the
// launch and the two grid barriers of an iteration, and nothing else: each
// has its own alpha, beta, delta, freeze guard and history column.
//
// What bounds it on the H100: device-memory bytes, and past them the work
// of a tile on the SM (below).  At N = 4096 one RHS's state takes 537 MB,
// far past the 50 MB L2, so every iteration streams it from HBM.  Per node, RHS and iteration this design moves, with tiles of
// R rows and 128 columns whose halo boxes span R + 2 pad rows and
// 128 + 2 hc columns (hc = pad rounded up to 4; h = box / tile - 1):
//   phase A reads r and the old d with their halo and writes d',
//     16 (1 + h) + 8 B;
//   phase B reads d' with its halo, r and x, and writes r and x,
//     8 (1 + h) + 32 B;
// 64 + 24 h in all: 68.69 B at R = 16, pad 1 (h = 0.195), against the
// 48 B floor of reading and writing x, r and d once and the ~82 B of the
// kernel before this design, which stored q = A d' in phase A and read it
// back in phase B (tpcg_torch.ops.stream_cg.stream_layout counts it).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings;
// probes/stream_cg_phases.py; us per iteration at N = 1024 / 2048 / 4096,
// one RHS): the kernel before this design spent 22.9 / 82.7 / 287.6 in
// phase A, its halo tile loaded element by element into one buffer with
// no load in flight while a tile was applied (1.6-2.0 TB/s of its own
// bytes), and 13.5 / 71.2 / 277.3 in its flat phase B (2.8-3.7 TB/s).
// This design spends 22.6 / 69.4 / 199.1 in phase A (1.3-2.3 TB/s) and
// 22.1 / 77.1 / 271.9 in phase B (2.0-2.6 TB/s): 0.83x the earlier
// kernel's iteration at N = 4096, 0.95x at 2048 and 1.22x at 1024.  Phase
// B, which now applies the stencil a second time, sets the pace: a tile
// takes about as long on an SM when the state sits in the L2 (N = 1024)
// as when it streams from HBM, and neither the ring's depth, the blocks an
// SM, 512 threads a block, the L2 promotion nor cp.async in place of TMA
// moved it, so the bound is on the SM, not the bytes.
//
// What the design does about it:
//   * no stored q: phase B recomputes q = A d' from a halo tile of d',
//     which phase A wrote, with the same non-contracting operations
//     (__fmul_rn, __fadd_rn) in the same tap order, so it is bit-identical
//     to the q phase A formed for <d', q>;
//   * the Tensor Memory Accelerator feeds every tile: phase A's r and d_old
//     halo boxes, phase B's d' halo box and its own tiles of r and x, and
//     the init's x0 halo box are 3-D tile copies (columns, rows, re/im
//     planes of every RHS) into a ring of `stages` slots of dynamic shared
//     memory, one mbarrier a slot; thread 0 keeps the next tiles' copies in
//     flight while the block works on the current one.  TMA's
//     out-of-bounds fill gives the zero neighbours at rows -1 / nv and
//     columns -1 / nh with no branch.  The box's first column is j0 - hc,
//     so its rows are 16-byte multiples as TMA needs;
//   * the state (r, both d buffers and a working copy of x) lives in planes
//     whose row pitch is nh + pad rounded up to 32 floats: every row starts
//     128-byte aligned at every width, so an odd width takes the same path
//     as any other; the columns past nh are zero and never written.  The
//     init copies x0 in and the end copies x out, once a launch;
//   * two grid barriers per iteration for all NB RHS: phase A recomputes
//     d' = r + beta d on its tile's halo from r and the old d (a ping-pong
//     pair of d buffers) with the same operations as the owner, so every
//     block applies A to bit-identical values;
//   * cross-proxy order: every thread that stores state that a TMA copy
//     will read (d' in phase A, r and x in phase B, x0's copy and r0 in the
//     init) runs fence.proxy.async before the grid barrier, and thread 0
//     runs it again after the barrier before it issues copies; threads that
//     wrote d' into a ring slot run fence.proxy.async.shared::cta before
//     the slot is refilled;
//   * within each phase a block runs the RHS one after another, each over
//     the same tiles in the same order as a one-RHS launch; the grid is the
//     one-RHS grid whatever NB, and the ring's slot and mbarrier parity
//     follow one running count of copies over RHS, phases and iterations
//     (nothing is reset mid-solve).  So each RHS's dot products are cut
//     into the same partial sums and every RHS of an NB launch gives the
//     bits of its own NB = 1 launch: a batch may be chunked freely;
//   * taps and edge taps are kernel parameters; strips, b and x0 go through
//     the read-only path;
//   * dot products reduce in a fixed order (per thread, warp shuffle, block,
//     then over blocks in block order, the same in every block), so every
//     block derives bit-identical alpha and beta and reruns agree bit for
//     bit;
//   * offsets into the planes are 64-bit (N = 4096 has 16.8 M nodes a
//     plane; b, x0 and x of a batch are (2, B, nv, nh) planes, so a RHS's
//     imaginary plane lies B planes past its real one).
// Tile height, ring depth and blocks an SM are arguments, chosen by
// tpcg_torch.ops.stream_cg.stream_layout from the sweep of
// probes/stream_cg_phases.py.  Not used yet: thread-block clusters (a
// cluster could share a halo between neighbouring tiles' SMs, which the
// L2 already serves) and keeping the state resident on chip at N <= 1448
// (one RHS's state nearly fits the 50 MB L2 at N = 1024; a resident
// variant is an open question in PERF.md).  wgmma has no place: there is
// no matrix product.
//
// Numerics: build without --use_fast_math (flush-to-zero and approximate
// division would move the freeze guard and the Smith division).  Plain C
// interface, loaded with ctypes (tpcg_torch/ops/_build.py); every entry
// point returns a cudaError_t as int.  The tensor maps are encoded on the
// host per launch with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so that the library need not link libcuda.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstdlib>

#include "tma.cuh"

namespace cg = cooperative_groups;
using namespace tpcg_tma;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 128;
constexpr int kMaxStages = 4;
constexpr int kMaxBox = 256;        // TMA's largest box extent
constexpr int kMaxTaps = 16;
constexpr int kMaxPad = 8;
constexpr int kMaxRhs = 8;  // one warp a RHS for the scalar steps
static_assert(kMaxRhs <= kWarps, "one warp a RHS");
static_assert(kThreads % kTileCols == 0, "whole tile rows a sweep");

enum Phase { kInit, kApply, kUpdate };

struct Params {
  const float* b;       // (2, B, nv, nh); RHS c at c * n, im cs further  read-only
  const float* x0;      // as b                                          read-only
  const float* strips;  // (2 bottom/top, 2 re/im, noff, nh)             read-only
  float* x;             // as b                                          out
  float* hist;          // (n_iterations + 1, NB)                        out
  float* r;             // (NB, 2, nv, pitch)                            scratch
  float* d;             // (2 ping/pong, NB, 2, nv, pitch)               scratch
  float* xw;            // (NB, 2, nv, pitch): the working copy of x     scratch
  float* part;          // (2 dq/rr, NB, gridDim.x, 2)                   scratch
  size_t cs;            // elements from a RHS's real plane of b, x0, x to its
                        // imaginary one (B * nv * nh)
  int nv, nh, pitch, noff, pad, n_iterations;
  int rows;             // tile rows
  int hc;               // box columns each side of the tile (pad rounded up to 4)
  int stages;           // ring slots
  int disp[kMaxTaps];   // tap displacement in a halo box
  float cr[kMaxTaps], ci[kMaxTaps];    // interior taps
  float lr[kMaxTaps], li[kMaxTaps];    // left edge taps (column 0)
  float rr[kMaxTaps], ri[kMaxTaps];    // right edge taps (column nh - 1)
};

// TMA descriptors of the state, each over (nh, nv, planes) floats with row
// pitch `pitch`; a box is (columns, rows, 2 re/im planes).
struct Maps {
  CUtensorMap r;      // halo boxes of r: planes 2 NB
  CUtensorMap d;      // halo boxes of both d buffers: planes 4 NB
  CUtensorMap x;      // halo boxes of xw (the init): planes 2 NB
  CUtensorMap r_own;  // (128, rows) tiles of r
  CUtensorMap x_own;  // (128, rows) tiles of xw
};

// Shared-memory geometry of one launch, the same in every block.
struct Ring {
  int br, bc;         // halo box rows, columns
  int halo;           // floats of one halo box (both planes), 128-B multiple
  int own;            // floats of one own tile (both planes)
  int stage;          // floats of a ring slot
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline Ring ring_of(int rows, int pad, int hc) {
  Ring g;
  g.br = rows + 2 * pad;
  g.bc = kTileCols + 2 * hc;
  g.halo = round_up(2 * g.br * g.bc, 32);
  g.own = 2 * rows * kTileCols;
  const int a = 2 * g.halo, b = g.halo + 2 * g.own;
  g.stage = a > b ? a : b;
  return g;
}

__host__ __device__ inline size_t smem_bytes(int rows, int pad, int hc,
                                             int stages) {
  return static_cast<size_t>(stages) * ring_of(rows, pad, hc).stage *
         sizeof(float);
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// ---- reductions and scalars ----

__device__ __forceinline__ float2 warp_sum(float2 v) {
  // xor butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Block-wide sum of v; thread 0 stores it to out[0..1].
__device__ void block_partial(float2 v, float2* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float2 w = lane < kWarps ? red[lane] : make_float2(0.f, 0.f);
    w = warp_sum(w);
    if (lane == 0) {
      out[0] = w.x;
      out[1] = w.y;
    }
  }
  __syncthreads();
}

// Sum over blocks of the partials, by one warp, in a fixed order.
__device__ float2 grid_total(const float* part, int nblocks) {
  const int lane = threadIdx.x & 31;
  float2 v = make_float2(0.f, 0.f);
  for (int g = lane; g < nblocks; g += 32) {
    v.x += __ldcg(part + 2 * g);
    v.y += __ldcg(part + 2 * g + 1);
  }
  return warp_sum(v);
}

// Smith-scaled complex division a / b (tpcg/ops/fused_cg.py::_cdiv_scalar).
__device__ __forceinline__ float2 cdiv_smith(float ar, float ai, float br,
                                             float bi) {
  const float m = fmaxf(fabsf(br), fabsf(bi));
  const float ms = m == 0.f ? 1.f : m;
  const float b0 = br / ms, b1 = bi / ms;
  const float d = (b0 * b0 + b1 * b1) * ms;
  return make_float2((ar * b0 + ai * b1) / d, (ai * b0 - ar * b1) / d);
}

// ---- the stencil ----

// sum_s (er_s + i ei_s) x_s over the taps, from 0 in tap order, for one
// boundary term: kEdge 0 / 1 the left / right edge taps (parameters), 2 / 3
// the bottom / top strip at column j.
template <int kEdge>
__device__ __forceinline__ float2 edge_sum(const Params& p, const float* sr,
                                           const float* si, int j) {
  const size_t sp = static_cast<size_t>(p.noff) * p.nh;  // one strip plane
  float ar = 0.f, ai = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s >= p.noff) break;
    float er, ei;
    if (kEdge == 0) {
      er = p.lr[s];
      ei = p.li[s];
    } else if (kEdge == 1) {
      er = p.rr[s];
      ei = p.ri[s];
    } else {
      const float* st = p.strips + (kEdge == 3 ? 2 * sp : 0) +
                        static_cast<size_t>(s) * p.nh + j;
      er = __ldg(st);
      ei = __ldg(st + sp);
    }
    const float xr = sr[p.disp[s]], xi = si[p.disp[s]];
    ar = fsub(fadd(ar, fmul(er, xr)), fmul(ei, xi));
    ai = fadd(fadd(ai, fmul(er, xi)), fmul(ei, xr));
  }
  return make_float2(ar, ai);
}

// (A v) at node (m, j); sr / si point at the node in a halo box.
__device__ __forceinline__ float2 apply_at(const Params& p, const float* sr,
                                           const float* si, int m, int j) {
  float qr = 0.f, qi = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s >= p.noff) break;
    const float xr = sr[p.disp[s]], xi = si[p.disp[s]];
    qr = fsub(fadd(qr, fmul(p.cr[s], xr)), fmul(p.ci[s], xi));
    qi = fadd(fadd(qi, fmul(p.cr[s], xi)), fmul(p.ci[s], xr));
  }
  float2 a;
  if (j == 0) {
    a = edge_sum<0>(p, sr, si, j);
    qr = fadd(qr, a.x);
    qi = fadd(qi, a.y);
  }
  if (j == p.nh - 1) {
    a = edge_sum<1>(p, sr, si, j);
    qr = fadd(qr, a.x);
    qi = fadd(qi, a.y);
  }
  if (m == 0) {
    a = edge_sum<2>(p, sr, si, j);
    qr = fadd(qr, a.x);
    qi = fadd(qi, a.y);
  }
  if (m == p.nv - 1) {
    a = edge_sum<3>(p, sr, si, j);
    qr = fadd(qr, a.x);
    qi = fadd(qi, a.y);
  }
  return make_float2(qr, qi);
}

// x += alpha d, r -= alpha q at one node; returns its <r, r> terms
// (rr^2 - ri^2, rr ri).
__device__ __forceinline__ float2 update_node(float2 a, float dr, float di,
                                              float qr, float qi, float& xr,
                                              float& xi, float& rr,
                                              float& ri) {
  xr = fsub(fadd(xr, fmul(a.x, dr)), fmul(a.y, di));
  xi = fadd(fadd(xi, fmul(a.x, di)), fmul(a.y, dr));
  rr = fsub(rr, fsub(fmul(a.x, qr), fmul(a.y, qi)));
  ri = fsub(ri, fadd(fmul(a.x, qi), fmul(a.y, qr)));
  return make_float2(rr * rr - ri * ri, rr * ri);
}

// ---- one phase over the block's tiles, fed by the ring ----

// The block's share of the tiles and the running count of the ring.
struct Walk {
  float* slots;       // ring slot 0
  uint64_t* full;     // one mbarrier a slot
  Ring g;
  int tiles_h;        // tiles across a row of tiles
  int mine;           // tiles of this block: blockIdx.x + t gridDim.x
  unsigned pos;       // copies consumed so far in this launch (every thread)
  unsigned issued;    // copies issued so far (thread 0)
};

// Thread 0: issue the copies of item k of a phase (RHS k / mine, the
// block's tile k % mine) into the next ring slot.  dbuf: the d buffer the
// phase reads (A: the old one, B: the new one).
template <Phase kPhase>
__device__ __forceinline__ void issue(const Params& p, const Maps& m, Walk& w, int k, int nb,
                      int dbuf) {
  const int c = k / w.mine;
  const int tile = blockIdx.x + (k - c * w.mine) * gridDim.x;
  const int m0 = (tile / w.tiles_h) * p.rows;
  const int j0 = (tile % w.tiles_h) * kTileCols;
  const int slot = w.issued % p.stages;
  float* st = w.slots + static_cast<size_t>(slot) * w.g.stage;
  uint64_t* bar = w.full + slot;
  const uint32_t box = 2u * w.g.br * w.g.bc * sizeof(float);
  const uint32_t own = 2u * p.rows * kTileCols * sizeof(float);
  const int hj = j0 - p.hc, hm = m0 - p.pad;
  if (kPhase == kInit) {
    mbar_expect(bar, box);
    tma_load(st, &m.x, bar, hj, hm, 2 * c);
  } else if (kPhase == kApply) {
    mbar_expect(bar, 2 * box);
    tma_load(st, &m.r, bar, hj, hm, 2 * c);
    tma_load(st + w.g.halo, &m.d, bar, hj, hm, 2 * (dbuf * nb + c));
  } else {
    mbar_expect(bar, box + 2 * own);
    tma_load(st, &m.d, bar, hj, hm, 2 * (dbuf * nb + c));
    tma_load(st + w.g.halo, &m.r_own, bar, j0, m0, 2 * c);
    tma_load(st + w.g.halo + w.g.own, &m.x_own, bar, j0, m0, 2 * c);
  }
  ++w.issued;
}

// One phase for all NB RHS: for each RHS c, over the block's tiles, the
// phase's work on each tile; this block's partial sum of RHS c to
// part + c * pstride.  kInit: r0 = b - A x0 and <r0, r0>; kApply: d' =
// r + beta d_old on the halo, d' stored, <d', A d'>; kUpdate: q = A d',
// x += alpha d', r -= alpha q, <r, r>.
template <Phase kPhase, int NB>
__device__ void run_phase(const Params& p, const Maps& m, Walk& w,
                          float2* red, float* part, size_t pstride, int dbuf,
                          const float2* coef) {
  const int nv = p.nv, nh = p.nh, P = p.pad;
  const int total = NB * w.mine;
  const size_t plane = static_cast<size_t>(nv) * p.pitch;
  const size_t n = static_cast<size_t>(nv) * nh;
  const int bc = w.g.bc, hb = w.g.br * w.g.bc;
  if (threadIdx.x == 0) {
    fence_async();  // state stored before the grid barrier, read by TMA
    for (int k = 0; k < total && k < p.stages; ++k)
      issue<kPhase>(p, m, w, k, NB, dbuf);
  }
  const size_t mine = 2 * static_cast<size_t>(blockIdx.x);
#pragma unroll 1
  for (int c = 0; c < NB; ++c) {
    float2 acc = make_float2(0.f, 0.f);
    const float2 s = coef[c];
    float* const r = p.r + static_cast<size_t>(c) * 2 * plane;
    float* const xw = p.xw + static_cast<size_t>(c) * 2 * plane;
    float* const dn =
        p.d + (static_cast<size_t>(dbuf ^ 1) * NB + c) * 2 * plane;
#pragma unroll 1
    for (int t = 0; t < w.mine; ++t) {
      const int k = c * w.mine + t;
      const int tile = blockIdx.x + t * gridDim.x;
      const int m0 = (tile / w.tiles_h) * p.rows;
      const int j0 = (tile % w.tiles_h) * kTileCols;
      const int slot = w.pos % p.stages;
      float* const st = w.slots + static_cast<size_t>(slot) * w.g.stage;
      mbar_wait(w.full + slot, (w.pos / p.stages) & 1u);
      float* const s_re = st;
      float* const s_im = st + hb;
      if (kPhase == kApply) {
        // d' = r + beta d_old over the whole box, in place of r
        float4* const r4 = reinterpret_cast<float4*>(st);
        const float4* const d4 = reinterpret_cast<const float4*>(st + w.g.halo);
        const int hb4 = hb / 4;
        for (int e = threadIdx.x; e < hb4; e += kThreads) {
          const float4 rr = r4[e], ri = r4[hb4 + e];
          const float4 dr = d4[e], di = d4[hb4 + e];
          float4 vr, vi;
#define TPCG_DIR(L)                                                    \
  vr.L = fsub(fadd(rr.L, fmul(s.x, dr.L)), fmul(s.y, di.L));           \
  vi.L = fadd(fadd(ri.L, fmul(s.x, di.L)), fmul(s.y, dr.L));
          TPCG_DIR(x) TPCG_DIR(y) TPCG_DIR(z) TPCG_DIR(w)
#undef TPCG_DIR
          r4[e] = vr;
          r4[hb4 + e] = vi;
        }
        fence_async_smem();  // the slot is refilled by TMA later
        __syncthreads();
      }
      const float* const o_r = st + w.g.halo;            // phase B: r tile
      const float* const o_x = st + w.g.halo + w.g.own;  // phase B: x tile
      // node (tm, tj) of the tile, tm = threadIdx.x / 128 + 2 i: each thread
      // keeps one column, and its rows in order
      const int tj = threadIdx.x % kTileCols, gj = j0 + tj;
      const int rows = nv - m0 < p.rows ? nv - m0 : p.rows;
      if (gj < nh) {
#pragma unroll 1
        for (int tm = threadIdx.x / kTileCols; tm < rows;
             tm += kThreads / kTileCols) {
          const int gm = m0 + tm;
          const int ci = (tm + P) * bc + tj + p.hc;
          const int e = tm * kTileCols + tj;  // in an own tile
          const float2 aq = apply_at(p, s_re + ci, s_im + ci, gm, gj);
          const size_t g = static_cast<size_t>(gm) * p.pitch + gj;
          if (kPhase == kInit) {
            const size_t eb = static_cast<size_t>(c) * n +
                              static_cast<size_t>(gm) * nh + gj;
            const float rr = fsub(__ldg(p.b + eb), aq.x);
            const float ri = fsub(__ldg(p.b + p.cs + eb), aq.y);
            r[g] = rr;
            r[plane + g] = ri;
            acc.x += rr * rr - ri * ri;
            acc.y += rr * ri;
          } else if (kPhase == kApply) {
            const float dr = s_re[ci], di = s_im[ci];
            dn[g] = dr;
            dn[plane + g] = di;
            acc.x += dr * aq.x - di * aq.y;
            acc.y += dr * aq.y + di * aq.x;
          } else {
            float xr, xi, rr, ri;
            rr = o_r[e];
            ri = o_r[p.rows * kTileCols + e];
            xr = o_x[e];
            xi = o_x[p.rows * kTileCols + e];
            const float2 tr = update_node(s, s_re[ci], s_im[ci], aq.x, aq.y,
                                          xr, xi, rr, ri);
            acc.x += tr.x;
            acc.y += tr.y;
            xw[g] = xr;
            xw[plane + g] = xi;
            r[g] = rr;
            r[plane + g] = ri;
          }
        }
      }
      __syncthreads();  // the slot is free
      ++w.pos;
      if (threadIdx.x == 0 && k + p.stages < total)
        issue<kPhase>(p, m, w, k + p.stages, NB, dbuf);
    }
    block_partial(acc, red, part + c * pstride + mine);
  }
  fence_async();  // stores above are read by TMA after the grid barrier
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 2)
    stream_cg_kernel(Params p, const __grid_constant__ Maps maps) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ float2 red[kWarps];
  __shared__ float2 s_delta[NB], s_alpha[NB], s_beta[NB];
  __shared__ int s_done[NB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const int nv = p.nv, nh = p.nh;
  const size_t n = static_cast<size_t>(nv) * nh;
  const size_t plane = static_cast<size_t>(nv) * p.pitch;
  const int tiles_h = (nh + kTileCols - 1) / kTileCols;
  const int ntiles = ((nv + p.rows - 1) / p.rows) * tiles_h;
  Walk w;
  w.slots = ring;
  w.full = full;
  w.g = ring_of(p.rows, p.pad, p.hc);
  w.tiles_h = tiles_h;
  w.mine = (ntiles - static_cast<int>(blockIdx.x) + nblocks - 1) / nblocks;
  w.pos = w.issued = 0;
  // partials of RHS c: <d', q> at part_dq(c), <r, r> at part_rr(c); this
  // block's pair at + 2 blockIdx.x
  const size_t pstride = 2 * static_cast<size_t>(nblocks);
  float* const part_dq = p.part;
  float* const part_rr = p.part + NB * pstride;
  const float2 zero = make_float2(0.f, 0.f);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // init: xw = x0 and d = 0 (the ping buffer, read by iteration 0) on the
  // grid's nodes; then r0 = b - A x0 and the partials of <r0, r0>
#pragma unroll 1
  for (int c = 0; c < NB; ++c) {
    const float* x0 = p.x0 + static_cast<size_t>(c) * n;
    float* xw = p.xw + static_cast<size_t>(c) * 2 * plane;
    float* dc = p.d + static_cast<size_t>(c) * 2 * plane;
    for (int row = blockIdx.x; row < nv; row += nblocks)
      for (int j = threadIdx.x; j < nh; j += kThreads) {
        const size_t e = static_cast<size_t>(row) * nh + j;
        const size_t g = static_cast<size_t>(row) * p.pitch + j;
        xw[g] = __ldg(x0 + e);
        xw[plane + g] = __ldg(x0 + p.cs + e);
        dc[g] = 0.f;
        dc[plane + g] = 0.f;
      }
  }
  fence_async();
  __syncthreads();  // the mbarriers are initialised
  grid.sync();
  {
    float2 none[NB];
    for (int c = 0; c < NB; ++c) none[c] = zero;
    run_phase<kInit, NB>(p, maps, w, red, part_rr, pstride, 0, none);
  }
  grid.sync();
  if (warp < NB) {
    const float2 t = grid_total(part_rr + warp * pstride, nblocks);
    if (lane == 0) {
      s_delta[warp] = make_float2(t.x, 2.f * t.y);
      s_beta[warp] = zero;
      if (blockIdx.x == 0) {
        const float2 dl = s_delta[warp];
        p.hist[warp] = sqrtf(sqrtf(dl.x * dl.x + dl.y * dl.y));
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < p.n_iterations; ++it) {
    const int d_old = it & 1;  // d_new is the other buffer
    // phase A: d' = r + beta d, partials of <d', A d'>
    run_phase<kApply, NB>(p, maps, w, red, part_dq, pstride, d_old, s_beta);
    grid.sync();

    // alpha, bit-identical in every block; warp c for RHS c
    if (warp < NB) {
      const float2 dq = grid_total(part_dq + warp * pstride, nblocks);
      if (lane == 0) {
        const float2 dl = s_delta[warp];
        const int done =
            (dl.x == 0.f && dl.y == 0.f) || (dq.x == 0.f && dq.y == 0.f);
        s_done[warp] = done;
        s_alpha[warp] = done ? zero : cdiv_smith(dl.x, dl.y, dq.x, dq.y);
      }
    }
    __syncthreads();

    // phase B: q = A d', x += alpha d', r -= alpha q, partials of <r, r>
    run_phase<kUpdate, NB>(p, maps, w, red, part_rr, pstride, d_old ^ 1,
                           s_alpha);
    grid.sync();

    // beta and the history
    if (warp < NB) {
      const float2 t = grid_total(part_rr + warp * pstride, nblocks);
      if (lane == 0) {
        const float2 dn = make_float2(t.x, 2.f * t.y);
        const float2 dl = s_delta[warp];
        s_beta[warp] = s_done[warp] ? zero : cdiv_smith(dn.x, dn.y, dl.x, dl.y);
        s_delta[warp] = dn;
        if (blockIdx.x == 0)
          p.hist[static_cast<size_t>(it + 1) * NB + warp] =
              sqrtf(sqrtf(dn.x * dn.x + dn.y * dn.y));
      }
    }
    __syncthreads();
  }

  // x = xw on the grid's nodes
#pragma unroll 1
  for (int c = 0; c < NB; ++c) {
    float* x = p.x + static_cast<size_t>(c) * n;
    const float* xw = p.xw + static_cast<size_t>(c) * 2 * plane;
    for (int row = blockIdx.x; row < nv; row += nblocks)
      for (int j = threadIdx.x; j < nh; j += kThreads) {
        const size_t e = static_cast<size_t>(row) * nh + j;
        const size_t g = static_cast<size_t>(row) * p.pitch + j;
        x[e] = __ldcg(xw + g);
        x[p.cs + e] = __ldcg(xw + plane + g);
      }
  }
}

using Kernel = void (*)(Params, Maps);

Kernel kernel_for(int nb) {
  switch (nb) {
    case 1: return stream_cg_kernel<1>;
    case 2: return stream_cg_kernel<2>;
    case 3: return stream_cg_kernel<3>;
    case 4: return stream_cg_kernel<4>;
    case 5: return stream_cg_kernel<5>;
    case 6: return stream_cg_kernel<6>;
    case 7: return stream_cg_kernel<7>;
    case 8: return stream_cg_kernel<8>;
    default: return nullptr;
  }
}
static_assert(kMaxRhs == 8, "kernel_for lists the instances");

// The tile geometry the caller passes: refuse what the kernel cannot run.
bool geometry_ok(int nv, int nh, int pitch, int pad, int rows, int hc,
                 int stages) {
  return nv >= 1 && nh >= 1 && pad >= 0 && pad <= kMaxPad && rows >= 1 &&
         rows + 2 * pad <= kMaxBox && hc >= pad && hc % 4 == 0 &&
         kTileCols + 2 * hc <= kMaxBox && pitch % 32 == 0 &&
         pitch >= nh + pad && stages >= 2 && stages <= kMaxStages;
}

// Every instance may take the ring's dynamic shared memory (past 48 KB a
// kernel must opt in, before the occupancy query and the launch).  The
// runtime refuses more than the card gives a block beside the kernel's
// static shared memory, so no copy of the card's limit is kept here.
cudaError_t allow_smem(size_t bytes) {
  for (int nb = 1; nb <= kMaxRhs; ++nb) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel_for(nb)),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Kernel limits: taps per stencil, largest |offset| component, RHS a launch.
int tpcg_stream_cg_limits(int* max_taps, int* max_pad, int* max_rhs) {
  *max_taps = kMaxTaps;
  *max_pad = kMaxPad;
  *max_rhs = kMaxRhs;
  return 0;
}

// Grid size of an nb-RHS launch on an (nv, nh) grid with tiles of `rows`
// rows, box halo `hc` columns and a ring of `stages` slots on the current
// device: the one-RHS instance's grid, one block per tile where the card
// has room, at most `per_sm_cap` blocks per SM, never more than can be
// co-resident (a larger cooperative launch is refused).  Every nb gets the
// same grid, so a RHS's partial sums, and bits, do not depend on nb; an
// instance that cannot hold that grid on the card is refused.
int tpcg_stream_cg_grid(int nb, int nv, int nh, int pitch, int pad, int rows,
                        int hc, int stages, int per_sm_cap, int* grid_out) {
  const Kernel k = kernel_for(nb);
  if (k == nullptr || per_sm_cap < 1 ||
      !geometry_ok(nv, nh, pitch, pad, rows, hc, stages))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows, pad, hc, stages);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, coop = 0, per_sm = 0, per_sm_nb = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_cg_kernel<1>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > per_sm_cap) per_sm = per_sm_cap;
  const long long tiles = static_cast<long long>((nv + rows - 1) / rows) *
                          ((nh + kTileCols - 1) / kTileCols);
  long long g = tiles;
  if (g > static_cast<long long>(per_sm) * sms) g = per_sm * sms;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_nb, k, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(per_sm_nb) * sms < g)
    return cudaErrorCooperativeLaunchTooLarge;
  *grid_out = g < 1 ? 1 : static_cast<int>(g);
  return 0;
}

// b, x0, x: nb RHS of (2, B, nv, nh) float planes, RHS c's real plane at
// c * nv * nh and its imaginary one cs further (cs = B * nv * nh, B >= nb);
// strips: (2, 2, noff, nh); r, xw: (nb, 2, nv, pitch); d: (2, nb, 2, nv,
// pitch), all three zero past column nh; hist: (n_iterations + 1, nb);
// part: 4 * nb * grid.  offsets: host array of 2 * noff ints (dm, dj),
// |dm|, |dj| <= pad; taps: host array of 6 * noff floats (cr, ci, lcr,
// lci, rcr, rci).  pitch, rows, hc, stages: the layout of
// tpcg_torch.ops.stream_cg.stream_layout; grid: from tpcg_stream_cg_grid
// with the same layout.
int tpcg_stream_cg(const float* b, const float* x0, const float* strips,
                   float* x, float* hist, float* r, float* d, float* xw,
                   float* part, int nb, long long cs, int nv, int nh,
                   int pitch, int noff, const int* offsets, const float* taps,
                   int pad, int rows, int hc, int stages,
                   int n_iterations, int grid, void* stream) {
  const Kernel k = kernel_for(nb);
  if (k == nullptr || noff < 1 || noff > kMaxTaps || n_iterations < 0 ||
      grid < 1 || !geometry_ok(nv, nh, pitch, pad, rows, hc, stages) ||
      cs < static_cast<long long>(nb) * nv * nh)
    return cudaErrorInvalidValue;
  Params p;
  p.b = b;
  p.x0 = x0;
  p.strips = strips;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.d = d;
  p.xw = xw;
  p.part = part;
  p.cs = static_cast<size_t>(cs);
  p.nv = nv;
  p.nh = nh;
  p.pitch = pitch;
  p.noff = noff;
  p.pad = pad;
  p.n_iterations = n_iterations;
  p.rows = rows;
  p.hc = hc;
  p.stages = stages;
  const int bc = kTileCols + 2 * hc;
  for (int s = 0; s < kMaxTaps; ++s) {
    p.disp[s] = 0;
    p.cr[s] = p.ci[s] = p.lr[s] = p.li[s] = p.rr[s] = p.ri[s] = 0.f;
  }
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * bc + dj;
    p.cr[s] = taps[s];
    p.ci[s] = taps[noff + s];
    p.lr[s] = taps[2 * noff + s];
    p.li[s] = taps[3 * noff + s];
    p.rr[s] = taps[4 * noff + s];
    p.ri[s] = taps[5 * noff + s];
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps;
  const int br = rows + 2 * pad;
  if (!encode(fn, &maps.r, r, nh, nv, 2 * nb, pitch, bc, br, 2) ||
      !encode(fn, &maps.d, d, nh, nv, 4 * nb, pitch, bc, br, 2) ||
      !encode(fn, &maps.x, xw, nh, nv, 2 * nb, pitch, bc, br, 2) ||
      !encode(fn, &maps.r_own, r, nh, nv, 2 * nb, pitch, kTileCols, rows, 2) ||
      !encode(fn, &maps.x_own, xw, nh, nv, 2 * nb, pitch, kTileCols, rows, 2))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows, pad, hc, stages);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p, &maps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
