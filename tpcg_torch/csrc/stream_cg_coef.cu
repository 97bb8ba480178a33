// Fixed-iteration COCG on a general variable-coefficient complex 2-D
// stencil, for 1..8 right-hand sides (RHS) that share one read of the
// coefficient planes, in one persistent cooperative launch with the state in
// device memory.
//
// Replaces, on the planner's `stream-coef` path for stencils that
// prepare_stream_sym refuses (non-symmetric ones), the Pallas kernels of
// the JAX package that compute this one function with the TPU's memory
// tiers:
//   * tpcg/ops/stream_cg.py::_build_k1_coef (K1 with all noff coefficient
//     planes streamed) with _make_k2: the v2 tier, and the r0 pass of v4;
//   * tpcg/ops/stream_cg_v3.py::_build_merged (coefficient variant): K1 and
//     K2 merged in one call, keep_r or not;
//   * tpcg/ops/stream_cg_v4.py::_build_resident (coefficient variant): K
//     iterations a call, x, r, d and q resident in VMEM;
//   * tpcg/ops/stream_cg.py::_build_k1_coef_batched (a (row block, RHS)
//     grid), ::_build_k1_coef_batched_fat and ::_make_k2_batched_fat: K1
//     and K2 for nb RHS, one coefficient fetch a row block for all of them.
// Their row blocks, VMEM budgets, keep_r, the 128-row padding of heights
// JAX cannot stream and the nb * Bv * Nh compile cap exist for the TPU:
// this kernel reads any height and width, and the state lives in device
// memory.
//
// What it computes (tpcg_torch/ops/stream_cg_coef.py::
// stream_cg_coef_planes_plain is the same function in plain PyTorch, step
// for step), for each RHS on its own:
//   r0 = b - A x0, delta0 = <r0, r0>, d = 0, beta = 0; then per iteration
//   d' = r + beta d, q = A d', alpha = delta / <d',q>, x += alpha d',
//   r -= alpha q, delta' = <r,r>, beta = delta' / delta (Smith division);
//   done = (delta == 0) | (<d',q> == 0), both parts, evaluated afresh each
//   iteration, zeroes alpha and beta; hist[it] = sqrt(sqrt(|delta|^2)).
// A x from the full coefficient planes c_s, one per offset s = (dm, dj):
//   q(n) = sum_s c_s(n) x(n + s),
// terms added in the offsets' order as q_re + c_re x_re - c_im x_im,
// q_im + c_re x_im + c_im x_re; a neighbour outside the grid reads 0, whatever
// its coefficient.  Unconjugated dots <u,v> = sum u v.
//
// What bounds it on the H100: device-memory bytes.  Per node and iteration
// each RHS moves, with tiles of R rows and 128 columns whose halo boxes span
// R + 2 pad rows and 128 + 2 hc columns (hc = pad rounded up to 4; h = box /
// tile - 1):
//   phase A reads r and the old d with their halo and writes d' and q,
//     16 (1 + h) + 16 B, and the tile's noff complex coefficients, 8 noff B,
//     once for all NB RHS;
//   phase B reads x, d', r and q and writes x and r, 48 B;
// 80 + 16 h + 8 noff / NB in all: 145.5 B at R = 4, pad 1, noff = 7 and
// NB = 1 (h = 0.594; the halo rows are read again by the neighbouring
// tile's block at about the same time, mostly from the L2), against the
// floor of 48 + 8 noff / NB (x, r and d read and written once, the
// coefficients read once).  tpcg_torch.ops.stream_cg_coef.coef_layout
// counts it.  q stays stored: recomputing it in phase B would read the
// coefficients a second time, and csrc/stream_cg.cu showed that a second
// apply costs the SM more than the bytes of q (PERF.md, Findings).
// Phase A sets the pace: it took 73% of an iteration at N = 4096 and ran at
// 2.1 TB/s when its halo tile was staged element by element, with no load
// in flight while a tile was applied and the coefficients read one tap
// after another (PERF.md, Findings).
//
// What the design does about it:
//   * the Tensor Memory Accelerator feeds phase A and the init: a state
//     ring of `stages` slots, each one RHS's r and d_old halo boxes (the
//     init: its x0 box), 3-D tile copies (columns, rows, re/im planes), and
//     a coefficient ring of `coef_stages` slots, each a tile's 2 noff
//     coefficient planes with no halo; one mbarrier a slot.  The block walks
//     its tiles and, within a tile, the NB RHS one after another, all of
//     them reading the tile's one coefficient box; thread 0 keeps the next
//     items' copies in flight while the block applies the current one.
//     TMA's out-of-bounds fill gives the zero neighbours at rows -1 / nv
//     and columns -1 / nh with no branch.  Shared memory does not grow with
//     NB, so every pad up to kMaxPad runs 8 RHS a launch;
//   * the coefficient box is laid out [row][plane][column] (the tensor
//     map orders its dimensions columns, planes, rows), so a node's taps sit
//     128 floats apart, a compile-time stride; every shared-memory access is
//     a 32-bit offset from the one dynamic shared array.  Reading the
//     coefficients from device memory instead (__ldg, the next tile's lines
//     prefetched into the L2 before the current tile's apply) took phase A
//     1.8-2.3x as long at N = 4096 (PERF.md, Findings);
//   * the state (r, both d buffers, q and a working copy of x) and a copy of
//     the coefficient planes live in planes whose row pitch is nh + pad
//     rounded up to 32 floats: every row starts 128-byte aligned at every
//     width, the columns past nh are zero and never written, and phase B is
//     one float4 sweep at every width.  The init copies x0 in and the end
//     copies x out, once a launch; the wrapper copies the coefficients once
//     a solve;
//   * two grid barriers per iteration for all NB RHS: phase A recomputes
//     d' = r + beta d on its tile's halo from r and the old d (a ping-pong
//     pair of d buffers) with the same non-contracting float operations as
//     the owner, so every block applies A to bit-identical values, and
//     stores d' and q = A d' for the tile's own nodes; phase B updates x
//     and r and sums <r, r>;
//   * cross-proxy order: every thread that stores state that a TMA copy
//     will read (d' in phase A, r in phase B, x0's copy and r0 in the init)
//     runs fence.proxy.async before the grid barrier, and thread 0 runs it
//     again after the barrier before it issues copies; threads that wrote
//     d' into a ring slot run fence.proxy.async.shared::cta before the slot
//     is refilled;
//   * dot products accumulate in float64 (the float32 products are exact
//     there) and are rounded to float32 once, as the plain version's are:
//     two float32 sum orders of COCG on helm_fe_var part by up to a third of
//     max|x| within 100 iterations, which would leave the kernel no plain
//     version to be held to at full size;
//   * the reduction order is fixed (per thread over its nodes in tile order,
//     warp shuffle, block, then over blocks in block order, the same in
//     every block), so every block derives bit-identical alpha and beta per
//     RHS and reruns agree bit for bit.  The tile, the ring and the grid
//     are the one-RHS launch's whatever NB, and a RHS's terms go to the same
//     thread in the same order, so every RHS of an NB launch gives the bits
//     of its own NB = 1 launch: a batch may be chunked freely;
//   * offsets into the planes are 64-bit (7 planes at N = 4096 hold 118 M
//     values).
// Tile height, ring depths and blocks an SM are arguments, chosen by
// tpcg_torch.ops.stream_cg_coef.coef_layout from the sweep of
// probes/stream_cg_phases.py (--kernel coef).  The stencil apply, the
// updates, the Smith division and the history use __fmul_rn / __fadd_rn /
// __fdiv_rn in the plain version's order, so with equal float32 dot
// products the kernel follows it bit for bit.
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
constexpr int kMaxOff = 32;
constexpr int kMaxPad = 8;
constexpr int kMaxRhs = 8;
constexpr int kMaxStages = 4;
constexpr int kMaxCoefStages = 2;
constexpr int kMaxBox = 256;        // TMA's largest box extent
// Launch bounds: blocks an SM that every instance must reach (the grid is
// the one-RHS instance's whatever NB), which caps the registers a thread.
constexpr int kMinBlocks = 2;
static_assert(kMaxRhs <= kWarps, "one warp per RHS derives its scalars");
static_assert(kThreads % kTileCols == 0, "whole tile rows a sweep");

struct Params {
  const float* b;       // (2, B, nv, nh); RHS c at c * n, im cs further  read-only
  const float* x0;      // as b                                          read-only
  const float* c;       // (2 re/im, noff, nv, pitch) coefficients        read-only
  float* x;             // as b                                          out
  float* hist;          // (n_iterations + 1, NB)                        out
  float* r;             // (NB, 2, nv, pitch)                            scratch
  float* q;             // (NB, 2, nv, pitch)                            scratch
  float* d;             // (2 ping/pong, NB, 2, nv, pitch)               scratch
  float* xw;            // (NB, 2, nv, pitch): the working copy of x     scratch
  double* part;         // (2 dq/rr, gridDim.x, NB, 2)                   scratch
  size_t cs;            // elements from a RHS's real plane of b, x0, x to its
                        // imaginary one (B * nv * nh)
  int nv, nh, pitch, noff, pad, n_iterations;
  int rows;             // tile rows
  int hc;               // box columns each side of the tile (pad rounded up to 4)
  int stages;           // state ring slots
  int coef_stages;      // coefficient ring slots
  int disp[kMaxOff];    // dm * box columns + dj: displacement in a halo box
  // derived on the host (ring_of), read from the parameter bank: no
  // registers for the launch's geometry
  size_t n;             // nv * nh
  size_t plane;         // nv * pitch: one padded plane
  int br, bc;           // halo box rows, columns
  int hb;               // floats of one plane of a halo box (br * bc)
  int box;              // floats of one halo box (both planes), 128-B multiple
  int slot;             // floats of a state slot: r (or x0) box, d_old box
  int crow;             // floats of a coefficient box's row: 2 noff planes
  int cbox;             // floats of a coefficient slot: `rows` such rows
  int sring;            // offset of state slot 0 in the dynamic shared memory
  int tiles_h;          // tiles across a row of tiles
};

// TMA descriptors, each over (nh, nv, planes) floats with row pitch `pitch`.
struct Maps {
  CUtensorMap r;   // (box columns, box rows, 2) halo boxes of r: planes 2 NB
  CUtensorMap d;   // halo boxes of both d buffers: planes 4 NB
  CUtensorMap x;   // halo boxes of xw (the init): planes 2 NB
  CUtensorMap c;   // the coefficient planes as (nh, 2 noff, nv): (128,
                   // 2 noff, rows) boxes land as [row][plane][column]
};

// Shared-memory geometry of one launch, the same in every block (the
// host's; the kernel reads it from Params).
struct Ring {
  int br, bc;         // halo box rows, columns
  int box;            // floats of one halo box (both planes), 128-B multiple
  int slot;           // floats of a state slot: r (or x0) box, d_old box
  int crow;           // floats of a coefficient box's row: 2 noff planes
  int cbox;           // floats of a coefficient slot: `rows` such rows
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Ring ring_of(int rows, int pad, int hc, int noff) {
  Ring g;
  g.br = rows + 2 * pad;
  g.bc = kTileCols + 2 * hc;
  g.box = round_up(2 * g.br * g.bc, 32);
  g.slot = 2 * g.box;
  g.crow = 2 * noff * kTileCols;
  g.cbox = rows * g.crow;
  return g;
}

inline size_t smem_bytes(int rows, int pad, int hc, int noff, int stages,
                         int coef_stages) {
  const Ring g = ring_of(rows, pad, hc, noff);
  return (static_cast<size_t>(coef_stages) * g.cbox +
          static_cast<size_t>(stages) * g.slot) *
         sizeof(float);
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// The dynamic shared memory: the coefficient slots, then the state slots.
// Every access is a 32-bit offset from this symbol, so the compiler keeps
// shared-memory addresses; the rings' mbarriers, one a slot.
extern __shared__ __align__(128) float ring[];
__shared__ __align__(8) uint64_t full[kMaxStages];
__shared__ __align__(8) uint64_t cfull[kMaxCoefStages];

// ---- reductions and scalars ----

__device__ __forceinline__ double2 warp_sum(double2 v) {
  // xor butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// The warp's sum of v, RHS k's, to red[warp * NB + k].
template <int NB>
__device__ __forceinline__ void warp_partial(double2 v, double2* red, int k) {
  const double2 w = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * NB + k] = w;
}

// After warp_partial of every RHS: the block's sums, warp k storing RHS k's
// to out[2k..2k+1].
template <int NB>
__device__ void block_finish(double2* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (warp < NB) {
    double2 w = lane < kWarps ? red[lane * NB + warp] : make_double2(0.0, 0.0);
    w = warp_sum(w);
    if (lane == 0) {
      out[2 * warp] = w.x;
      out[2 * warp + 1] = w.y;
    }
  }
  __syncthreads();
}

// Block-wide sums of v[0..NB); warp k stores RHS k's to out[2k..2k+1].
template <int NB>
__device__ void block_partials(double2 (&v)[NB], double2* red, double* out) {
#pragma unroll
  for (int k = 0; k < NB; ++k) warp_partial<NB>(v[k], red, k);
  block_finish<NB>(red, out);
}

// RHS k's sum over blocks of the partials, by one warp, in a fixed order.
template <int NB>
__device__ double2 grid_total(const double* part, int nblocks, int k) {
  const int lane = threadIdx.x & 31;
  double2 v = make_double2(0.0, 0.0);
  for (int g = lane; g < nblocks; g += 32) {
    const double* src = part + 2 * (static_cast<size_t>(g) * NB + k);
    v.x += __ldcg(src);
    v.y += __ldcg(src + 1);
  }
  return warp_sum(v);
}

// Smith-scaled complex division a / b (tpcg/ops/fused_cg.py::_cdiv_scalar),
// in the plain version's order of rounded operations.
__device__ __forceinline__ float2 cdiv_smith(float ar, float ai, float br,
                                             float bi) {
  const float m = fmaxf(fabsf(br), fabsf(bi));
  const float ms = m == 0.f ? 1.f : m;
  const float b0 = fdiv(br, ms), b1 = fdiv(bi, ms);
  const float d = fmul(fadd(fmul(b0, b0), fmul(b1, b1)), ms);
  return make_float2(fdiv(fadd(fmul(ar, b0), fmul(ai, b1)), d),
                     fdiv(fsub(fmul(ai, b0), fmul(ar, b1)), d));
}

// The float32 delta = <r, r> from the float64 sums (sum rr^2 - ri^2,
// sum rr ri), and its history entry sqrt(sqrt(|delta|^2)).
__device__ __forceinline__ float2 delta_of(double2 t) {
  return make_float2(static_cast<float>(t.x), static_cast<float>(2.0 * t.y));
}
__device__ __forceinline__ float hist_of(float2 dl) {
  return sqrtf(sqrtf(fadd(fmul(dl.x, dl.x), fmul(dl.y, dl.y))));
}

// ---- phase A and the init, fed by the rings ----

// The block's share of the tiles and the running counts of the rings.
struct Walk {
  int mine;           // tiles of this block: blockIdx.x + t gridDim.x
  unsigned pos;       // state copies consumed so far in this launch
  unsigned issued;    // state copies issued so far (thread 0)
  unsigned cpos;      // coefficient boxes consumed so far
  unsigned cissued;   // coefficient boxes issued so far
};

__device__ __forceinline__ int tile_row0(const Params& p, int t) {
  return ((blockIdx.x + t * gridDim.x) / p.tiles_h) * p.rows;
}
__device__ __forceinline__ int tile_col0(const Params& p, int t) {
  return ((blockIdx.x + t * gridDim.x) % p.tiles_h) * kTileCols;
}

// Thread 0: copy item k of the phase (the block's tile k / NB, RHS k % NB)
// into the next state slot: its x0 box (the init), or its r and d_old
// boxes (dbuf: the d buffer the phase reads).
template <bool kInit>
__device__ __forceinline__ void issue_state(const Params& p, const Maps& m,
                                            Walk& w, int k, int nb,
                                            int dbuf) {
  const int t = k / nb, c = k - t * nb;
  const int slot = w.issued % p.stages;
  float* const st = ring + p.sring + slot * p.slot;
  uint64_t* const bar = full + slot;
  const uint32_t box = 2u * p.hb * sizeof(float);
  const int hj = tile_col0(p, t) - p.hc, hm = tile_row0(p, t) - p.pad;
  if (kInit) {
    mbar_expect(bar, box);
    tma_load(st, &m.x, bar, hj, hm, 2 * c);
  } else {
    mbar_expect(bar, 2 * box);
    tma_load(st, &m.r, bar, hj, hm, 2 * c);
    tma_load(st + p.box, &m.d, bar, hj, hm, 2 * (dbuf * nb + c));
  }
  ++w.issued;
}

// Thread 0: copy the coefficient box of the block's tile t into the next
// coefficient slot.
__device__ __forceinline__ void issue_coef(const Params& p, const Maps& m,
                                           Walk& w, int t) {
  const int slot = w.cissued % p.coef_stages;
  mbar_expect(cfull + slot, static_cast<uint32_t>(p.cbox * sizeof(float)));
  tma_load(ring + slot * p.cbox, &m.c, cfull + slot, tile_col0(p, t), 0,
           tile_row0(p, t));
  ++w.cissued;
}

// One phase over the block's tiles, for all NB RHS.  kInit: r0 = b - A x0,
// accumulating <r0, r0>.  Otherwise: d' = r + beta d_old on the halo, d'
// and q = A d' stored for the tile's own nodes, accumulating <d', q>.
// acc[c] receives this thread's partial sum for RHS c.
template <bool kInit, int NB>
__device__ void phase_apply(const Params& p, const Maps& m, Walk& w,
                            int dbuf, const float2* beta,
                            double2 (&acc)[NB]) {
  const int total = NB * w.mine;
#pragma unroll
  for (int c = 0; c < NB; ++c) acc[c] = make_double2(0.0, 0.0);
  if (threadIdx.x == 0) {
    fence_async();  // state stored before the grid barrier, read by TMA
    for (int t = 0; t < w.mine && t < p.coef_stages; ++t)
      issue_coef(p, m, w, t);
    for (int k = 0; k < total && k < p.stages; ++k)
      issue_state<kInit>(p, m, w, k, NB, dbuf);
  }
  // node (tm, tj) of the tile, tm = threadIdx.x / 128 + 2 i: each thread
  // keeps one column, and its rows in order
  const int tj = threadIdx.x % kTileCols;
#pragma unroll 1
  for (int t = 0; t < w.mine; ++t) {
    const int m0 = tile_row0(p, t), gj = tile_col0(p, t) + tj;
    const int rows = p.nv - m0 < p.rows ? p.nv - m0 : p.rows;
    // the tile's coefficient slot in `ring`
    const int cslot = w.cpos % p.coef_stages;
    mbar_wait(cfull + cslot, (w.cpos / p.coef_stages) & 1u);
    const int cso = cslot * p.cbox;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int k = t * NB + c;
      const int slot = w.pos % p.stages;
      float* const st = ring + p.sring + slot * p.slot;
      mbar_wait(full + slot, (w.pos / p.stages) & 1u);
      if (!kInit) {
        // d' = r + beta d_old over the whole box, in place of r
        const float2 s = beta[c];
        float4* const r4 = reinterpret_cast<float4*>(st);
        const float4* const d4 = reinterpret_cast<const float4*>(st + p.box);
        const int hb4 = p.hb / 4;
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
      const float* const s_re = st;
      const float* const s_im = st + p.hb;
      const size_t plane = p.plane;
      float* const rc = p.r + static_cast<size_t>(2 * c) * plane;
      float* const qc = p.q + static_cast<size_t>(2 * c) * plane;
      float* const dn = p.d + static_cast<size_t>(2 * ((dbuf ^ 1) * NB + c)) *
                                  plane;
      if (gj < p.nh) {
#pragma unroll 1
        for (int tm = threadIdx.x / kTileCols; tm < rows;
             tm += kThreads / kTileCols) {
          const int gm = m0 + tm;
          const int ci = (tm + p.pad) * p.bc + tj + p.hc;
          const size_t g = static_cast<size_t>(gm) * p.pitch + gj;
          // the node's coefficient planes: c_re(s) at cre[128 s], c_im(s)
          // at cim[128 s]
          const float* const cre = ring + cso + tm * p.crow + tj;
          const float* const cim = cre + p.noff * kTileCols;
          float qr = 0.f, qi = 0.f;
#pragma unroll
          for (int s = 0; s < kMaxOff; ++s) {
            if (s >= p.noff) break;
            const float car = cre[s * kTileCols], cai = cim[s * kTileCols];
            const float xr = s_re[ci + p.disp[s]], xi = s_im[ci + p.disp[s]];
            qr = fsub(fadd(qr, fmul(car, xr)), fmul(cai, xi));
            qi = fadd(fadd(qi, fmul(car, xi)), fmul(cai, xr));
          }
          if (kInit) {
            const size_t eb = static_cast<size_t>(c) * p.n +
                              static_cast<size_t>(gm) * p.nh + gj;
            const float rr = fsub(__ldg(p.b + eb), qr);
            const float ri = fsub(__ldg(p.b + p.cs + eb), qi);
            rc[g] = rr;
            rc[plane + g] = ri;
            acc[c].x += static_cast<double>(rr) * rr -
                        static_cast<double>(ri) * ri;
            acc[c].y += static_cast<double>(rr) * ri;
          } else {
            const float dr = s_re[ci], di = s_im[ci];
            dn[g] = dr;
            dn[plane + g] = di;
            qc[g] = qr;
            qc[plane + g] = qi;
            acc[c].x += static_cast<double>(dr) * qr -
                        static_cast<double>(di) * qi;
            acc[c].y += static_cast<double>(dr) * qi +
                        static_cast<double>(di) * qr;
          }
        }
      }
      __syncthreads();  // the slot is free (and, after the tile's last RHS,
                        // its coefficient slot)
      ++w.pos;
      if (threadIdx.x == 0 && k + p.stages < total)
        issue_state<kInit>(p, m, w, k + p.stages, NB, dbuf);
    }
    ++w.cpos;
    if (threadIdx.x == 0 && t + p.coef_stages < w.mine)
      issue_coef(p, m, w, t + p.coef_stages);
  }
  fence_async();  // stores above are read by TMA after the grid barrier
}

// x += alpha d, r -= alpha q at one node; returns its <r, r> terms
// (rr^2 - ri^2, rr ri) in float64 (exact products).
__device__ __forceinline__ double2 update_node(float2 a, float dr, float di,
                                              float qr, float qi, float& xr,
                                              float& xi, float& rr,
                                              float& ri) {
  xr = fsub(fadd(xr, fmul(a.x, dr)), fmul(a.y, di));
  xi = fadd(fadd(xi, fmul(a.x, di)), fmul(a.y, dr));
  rr = fsub(rr, fsub(fmul(a.x, qr), fmul(a.y, qi)));
  ri = fsub(ri, fadd(fmul(a.x, qi), fmul(a.y, qr)));
  const double r0 = rr, r1 = ri;
  return make_double2(r0 * r0 - r1 * r1, r0 * r1);
}

// Phase B for one RHS: x += alpha d', r -= alpha q over its padded planes
// (re at the pointer, im `plane` floats on: every plane starts 128-byte
// aligned, and the zero columns past nh stay zero); returns this thread's
// partial of (sum rr^2 - ri^2, sum rr ri).  The sweep runs from the planes'
// ends back, so the d' and q that phase A stored last (the blocks' last
// tiles, the bottom rows) are read first, while the L2 still holds them:
// phase B 11% shorter at N = 1024, 3% at 2048, the same at 4096 (PERF.md,
// Findings).
__device__ double2 sweep_update(const float* dn, const float* q, float* x,
                                float* r, size_t plane, float2 a) {
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t n4 = plane / 4;
  const float4* d4 = reinterpret_cast<const float4*>(dn);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* r4 = reinterpret_cast<float4*>(r);
  double2 acc = make_double2(0.0, 0.0);
  for (size_t v = t0; v < n4; v += stride) {
    const size_t u = n4 - 1 - v;
    const float4 dr = __ldcg(d4 + u), di = __ldcg(d4 + n4 + u);
    const float4 qr = __ldcg(q4 + u), qi = __ldcg(q4 + n4 + u);
    float4 xr = __ldcg(x4 + u), xi = __ldcg(x4 + n4 + u);
    float4 rr = __ldcg(r4 + u), ri = __ldcg(r4 + n4 + u);
    double2 t;
    t = update_node(a, dr.x, di.x, qr.x, qi.x, xr.x, xi.x, rr.x, ri.x);
    acc.x += t.x; acc.y += t.y;
    t = update_node(a, dr.y, di.y, qr.y, qi.y, xr.y, xi.y, rr.y, ri.y);
    acc.x += t.x; acc.y += t.y;
    t = update_node(a, dr.z, di.z, qr.z, qi.z, xr.z, xi.z, rr.z, ri.z);
    acc.x += t.x; acc.y += t.y;
    t = update_node(a, dr.w, di.w, qr.w, qi.w, xr.w, xi.w, rr.w, ri.w);
    acc.x += t.x; acc.y += t.y;
    x4[u] = xr;
    x4[n4 + u] = xi;
    r4[u] = rr;
    r4[n4 + u] = ri;
  }
  return acc;
}

template <int NB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stream_cg_coef_kernel(Params p, const __grid_constant__ Maps maps) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double2 red[kWarps * NB];
  __shared__ float2 s_delta[NB], s_alpha[NB], s_beta[NB];
  __shared__ int s_done[NB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const int nv = p.nv, nh = p.nh;
  const size_t n = p.n, plane = p.plane;
  const int ntiles = ((nv + p.rows - 1) / p.rows) * p.tiles_h;
  Walk w;
  w.mine = (ntiles - static_cast<int>(blockIdx.x) + nblocks - 1) / nblocks;
  w.pos = w.issued = w.cpos = w.cissued = 0;
  double* const part_dq = p.part;
  double* const part_rr = p.part + 2 * static_cast<size_t>(nblocks) * NB;
  double* const mine_dq = part_dq + 2 * static_cast<size_t>(blockIdx.x) * NB;
  double* const mine_rr = part_rr + 2 * static_cast<size_t>(blockIdx.x) * NB;
  const float2 zero = make_float2(0.f, 0.f);
  double2 acc[NB];

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full + s);
    for (int s = 0; s < p.coef_stages; ++s) mbar_init(cfull + s);
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
  phase_apply<true, NB>(p, maps, w, 0, s_beta, acc);
  block_partials<NB>(acc, red, mine_rr);
  grid.sync();
  if (warp < NB) {
    const double2 t = grid_total<NB>(part_rr, nblocks, warp);
    if (lane == 0) {
      s_delta[warp] = delta_of(t);
      s_beta[warp] = zero;
      if (blockIdx.x == 0) p.hist[warp] = hist_of(s_delta[warp]);
    }
  }
  __syncthreads();

  for (int it = 0; it < p.n_iterations; ++it) {
    const int d_old = it & 1;  // d_new is the other buffer
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
    phase_apply<false, NB>(p, maps, w, d_old, s_beta, acc);
    block_partials<NB>(acc, red, mine_dq);
    grid.sync();

    // alpha per RHS, bit-identical in every block
    if (warp < NB) {
      const double2 dq64 = grid_total<NB>(part_dq, nblocks, warp);
      if (lane == 0) {
        const float2 dq = make_float2(static_cast<float>(dq64.x),
                                      static_cast<float>(dq64.y));
        const float2 dl = s_delta[warp];
        const int done =
            (dl.x == 0.f && dl.y == 0.f) || (dq.x == 0.f && dq.y == 0.f);
        s_done[warp] = done;
        s_alpha[warp] = done ? zero : cdiv_smith(dl.x, dl.y, dq.x, dq.y);
      }
    }
    __syncthreads();

    // phase B: x += alpha d', r -= alpha q, partials of <r, r> (each RHS's
    // warp sums taken at once, so that no RHS's sum stays in registers)
    const float* dnew = p.d + static_cast<size_t>(d_old ^ 1) * NB * 2 * plane;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const size_t o = static_cast<size_t>(c) * 2 * plane;
      warp_partial<NB>(sweep_update(dnew + o, p.q + o, p.xw + o, p.r + o,
                                    plane, s_alpha[c]),
                       red, c);
    }
    fence_async();  // r is read by TMA after the grid barrier
    block_finish<NB>(red, mine_rr);
    grid.sync();

    // beta and the history per RHS
    if (warp < NB) {
      const double2 t = grid_total<NB>(part_rr, nblocks, warp);
      if (lane == 0) {
        const float2 dn = delta_of(t);
        const float2 dl = s_delta[warp];
        s_beta[warp] = s_done[warp] ? zero : cdiv_smith(dn.x, dn.y, dl.x, dl.y);
        s_delta[warp] = dn;
        if (blockIdx.x == 0)
          p.hist[static_cast<size_t>(it + 1) * NB + warp] = hist_of(dn);
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
    case 1: return stream_cg_coef_kernel<1>;
    case 2: return stream_cg_coef_kernel<2>;
    case 3: return stream_cg_coef_kernel<3>;
    case 4: return stream_cg_coef_kernel<4>;
    case 5: return stream_cg_coef_kernel<5>;
    case 6: return stream_cg_coef_kernel<6>;
    case 7: return stream_cg_coef_kernel<7>;
    case 8: return stream_cg_coef_kernel<8>;
    default: return nullptr;
  }
}
static_assert(kMaxRhs == 8, "kernel_for lists the instances");

// The tile geometry the caller passes: refuse what the kernel cannot run.
bool geometry_ok(int nv, int nh, int pitch, int pad, int noff, int rows,
                 int hc, int stages, int coef_stages) {
  return nv >= 1 && nh >= 1 && pad >= 0 && pad <= kMaxPad && noff >= 1 &&
         noff <= kMaxOff && rows >= 1 && rows + 2 * pad <= kMaxBox &&
         hc >= pad && hc % 4 == 0 && kTileCols + 2 * hc <= kMaxBox &&
         pitch % 32 == 0 && pitch >= nh + pad && stages >= 2 &&
         stages <= kMaxStages && coef_stages >= 1 &&
         coef_stages <= kMaxCoefStages;
}

// Every instance may take the rings' dynamic shared memory (past 48 KB a
// kernel must opt in, before the occupancy query and the launch).  The
// runtime refuses more than the card gives a block beside an instance's
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

// Kernel limits: offsets, largest |offset| component, RHS in one launch.
int tpcg_stream_coef_limits(int* max_off, int* max_pad, int* max_rhs) {
  *max_off = kMaxOff;
  *max_pad = kMaxPad;
  *max_rhs = kMaxRhs;
  return 0;
}

// Grid size of an nb-RHS launch on an (nv, nh) grid with the layout of
// tpcg_torch.ops.stream_cg_coef.coef_layout (pitch, tile rows, box halo
// columns, ring slots) on the current device: the one-RHS instance's grid,
// one block per tile where the card has room, at most `per_sm_cap` blocks
// per SM, never more than can be co-resident (a larger cooperative launch
// is refused).  Every nb gets the same grid, so a RHS's partial sums, and
// bits, do not depend on nb; an instance that cannot hold that grid on the
// card is refused.
int tpcg_stream_coef_grid(int nb, int nv, int nh, int pitch, int pad,
                          int noff, int rows, int hc, int stages,
                          int coef_stages, int per_sm_cap, int* grid_out) {
  const Kernel k = kernel_for(nb);
  if (k == nullptr || per_sm_cap < 1 ||
      !geometry_ok(nv, nh, pitch, pad, noff, rows, hc, stages, coef_stages))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows, pad, hc, noff, stages, coef_stages);
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
      &per_sm, stream_cg_coef_kernel<1>, kThreads, smem);
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
// c: (2, noff, nv, pitch), the coefficient planes copied to the pitch;
// r, q, xw: (nb, 2, nv, pitch); d: (2, nb, 2, nv, pitch), all four zero
// past column nh; hist: (n_iterations + 1, nb); part: 4 * grid * nb
// doubles.  offsets: host array of 2 * noff ints (dm, dj), |dm|, |dj| <=
// pad.  pitch, rows, hc, stages, coef_stages: the layout of coef_layout;
// grid: from tpcg_stream_coef_grid with the same layout.
int tpcg_stream_coef(const float* b, const float* x0, const float* c,
                     float* x, float* hist, float* r, float* q, float* d,
                     float* xw, double* part, int nb, long long cs, int nv,
                     int nh, int pitch, int noff, const int* offsets, int pad,
                     int rows, int hc, int stages, int coef_stages,
                     int n_iterations, int grid, void* stream) {
  const Kernel k = kernel_for(nb);
  if (k == nullptr || n_iterations < 0 || grid < 1 ||
      !geometry_ok(nv, nh, pitch, pad, noff, rows, hc, stages, coef_stages) ||
      cs < static_cast<long long>(nb) * nv * nh)
    return cudaErrorInvalidValue;
  Params p;
  p.b = b;
  p.x0 = x0;
  p.c = c;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.q = q;
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
  p.coef_stages = coef_stages;
  const Ring g = ring_of(rows, pad, hc, noff);
  p.n = static_cast<size_t>(nv) * nh;
  p.plane = static_cast<size_t>(nv) * pitch;
  p.br = g.br;
  p.bc = g.bc;
  p.hb = g.br * g.bc;
  p.box = g.box;
  p.slot = g.slot;
  p.crow = g.crow;
  p.cbox = g.cbox;
  p.sring = coef_stages * g.cbox;
  p.tiles_h = (nh + kTileCols - 1) / kTileCols;
  const int bc = g.bc;
  for (int s = 0; s < kMaxOff; ++s) p.disp[s] = 0;
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * bc + dj;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps;
  const int br = rows + 2 * pad;
  if (!encode(fn, &maps.r, r, nh, nv, 2 * nb, pitch, bc, br, 2) ||
      !encode(fn, &maps.d, d, nh, nv, 4 * nb, pitch, bc, br, 2) ||
      !encode(fn, &maps.x, xw, nh, nv, 2 * nb, pitch, bc, br, 2) ||
      !encode(fn, &maps.c, c, nh, nv, 2 * noff, pitch, kTileCols, rows,
              2 * noff, false))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows, pad, hc, noff, stages, coef_stages);
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
