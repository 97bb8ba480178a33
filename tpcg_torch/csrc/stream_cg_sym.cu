// Fixed-iteration single-RHS COCG on a symmetric variable-coefficient complex
// 2-D stencil, streaming half of the coefficient planes, in one persistent
// cooperative launch with the state in device memory.
//
// Replaces, on the planner's `stream-coef` path for symmetric stencils, the
// Pallas kernels of the JAX package that compute this one function with the
// TPU's memory tiers:
//   * tpcg/ops/stream_cg_v4_sym.py::_build_resident_sym: K iterations per
//     call, x, r, d (and q) resident in VMEM, half planes streamed;
//   * tpcg/ops/stream_cg_v5_sym.py::_build_v5_sym: the same with state row
//     panels round-tripping HBM by DMA (d-resident tiers, qx mode);
//   * tpcg/ops/stream_cg.py::_build_k1_coef: K1 with streamed full
//     coefficient planes -- the r0 init pass of v4-sym and v5-sym, and with
//     _make_k2 the v2-coef tier;
//   * tpcg/ops/stream_cg_v3.py::_build_merged (coefficient variant): v2's
//     two sweeps merged, JAX's tier for the row-padded `pad->` heights.
// Their VMEM budgets, row-block sizes, q modes, 128-lane alignment and the
// row padding have no purpose here: Hopper reads any height and width, and
// the state lives in device memory.  The design of csrc/stream_cg_coef.cu
// (TMA-fed phase A, padded pitch, q kept) carries over; what is new is the
// operator's mirrored term.
//
// What it computes (tpcg_torch/ops/stream_cg_sym.py::
// stream_cg_sym_planes_plain is the same function in plain PyTorch, step for
// step):
//   r0 = b - A x0, delta0 = <r0, r0>, d = 0, beta = 0; then per iteration
//   d' = r + beta d, q = A d', alpha = delta / <d',q>, x += alpha d',
//   r -= alpha q, delta' = <r,r>, beta = delta' / delta (Smith division);
//   done = (delta == 0) | (<d',q> == 0), both parts, evaluated afresh each
//   iteration, zeroes alpha and beta; hist[it] = sqrt(sqrt(|delta|^2)).
// A x from the half planes c_t (t = 0 the centre, then one per offset pair
// s = (dm, dj) > (0, 0)):
//   q(n) = c_0(n) x(n) + sum_s [ c_s(n) x(n+s) + c_s(n-s) x(n-s) ],
// terms added in that order; a coefficient or a neighbour outside the grid
// reads 0.  Unconjugated dots <u,v> = sum u v.
//
// What bounds it on the H100: device-memory bytes.  Per node and iteration,
// with tiles of R rows and C columns (C = 128, or 64 where the rings would
// not fit a block), state halo boxes of R + 2 pad rows and C + 2 hc columns
// (hc = pad rounded up to 4) and coefficient boxes of R + pad rows by the
// same columns (h_s, h_c = box / tile - 1):
//   phase A reads r and the old d with their halo, writes d' and q, and
//     reads and writes x (the previous iteration's x += alpha d', below),
//     16 (1 + h_s) + 32 B, and the tile's nh1 complex half planes with
//     their halo, 8 nh1 (1 + h_c) B;
//   phase B reads r and q and writes r, 24 B;
// 104 + 16 h_s + 32 h_c B at nh1 = 4 (115.5 B at R = 8, pad 1: h_s =
// 0.328, h_c = 0.195; the halo rows are read again by the neighbouring
// tile's block at about the same time, mostly from the L2), against the
// floor of 80 B (x, r and d read and written once, the half planes read
// once): 1.34 GB an iteration at N = 4096, 0.40 ms at 3.35 TB/s.
// tpcg_torch.ops.stream_cg_sym.sym_layout counts it.  q stays stored:
// recomputing it in phase B would read the half planes a second time, and
// csrc/stream_cg.cu showed that a second apply costs the SM more than the
// bytes of q (PERF.md, Findings).
//
// What the design does about it:
//   * the Tensor Memory Accelerator feeds phase A and the init: a state
//     ring of `stages` slots, each the tile's r and d_old halo boxes (the
//     init: its x0 box), 3-D tile copies (columns, rows, re/im planes), and
//     a coefficient ring of `coef_stages` slots, each the tile's 2 nh1 half
//     planes with their own halo: rows m0 - pad .. m0 + R - 1 and columns
//     j0 - hc .. j0 + C + hc - 1, so that both the down term c_s(n) and the
//     mirrored term c_s(n - s) (dm >= 0) read shared memory.  One mbarrier
//     a slot; thread 0 keeps the next tiles' copies in flight while the
//     block applies the current one.  TMA's out-of-bounds fill gives the
//     zero neighbours and the zero coefficients outside the grid with no
//     branch;
//   * the coefficient box is laid out [row][plane][column] (the tensor map
//     orders its dimensions columns, planes, rows), so a node's taps sit a
//     box row apart and its mirrored coefficient at a fixed displacement
//     from its own; every shared-memory access is a 32-bit offset from the
//     one dynamic shared array;
//   * the state (r, both d buffers, q and a working copy of x) and a copy of
//     the half planes live in planes whose row pitch is nh + pad rounded up
//     to 32 floats: every row starts 128-byte aligned at every width, the
//     columns past nh are zero and never written, and phase B is one float4
//     sweep at every width, from the planes' ends back (the q that phase A
//     stored last is read first, while the L2 holds it).  The
//     init copies x0 in and the end copies x out, once a launch; the
//     planner copies the half planes to the pitch once a plan
//     (stream_cg_sym.pad_sym_planes), not once a RHS;
//   * two grid barriers per iteration: phase A recomputes d' = r + beta d on
//     its tile's halo from r and the old d (a ping-pong pair of d buffers)
//     with the same non-contracting float operations as the owner, so every
//     block applies A to bit-identical values, and stores d' and q = A d'
//     for the tile's own nodes; phase B updates r and sums <r, r>;
//   * x += alpha d' is deferred into the next iteration's phase A (JAX's
//     qx), which holds d' of its nodes in the ring already, and one closing
//     pass adds the last one: phase B shrinks from 48 to 24 B and phase A
//     grows by x's 16 B.  The same float operations run on the same values
//     one sweep later, so x keeps its bits.  Phase A loads x before the
//     stencil apply, so that the load is in flight while the taps are
//     summed.  On an H100 it measured 3.7-10.7% faster at N = 2048-4096
//     and 2.7% slower at 1024 than the update in phase B (PERF.md,
//     Findings);
//   * cross-proxy order: every thread that stores state that a TMA copy
//     will read (d' in phase A, r in phase B, x0's copy and r0 in the init)
//     runs fence.proxy.async before the grid barrier, and thread 0 runs it
//     again after the barrier before it issues copies; threads that wrote
//     d' into a ring slot run fence.proxy.async.shared::cta before the slot
//     is refilled;
//   * dot products accumulate in float64 (the float32 products are exact
//     there) and are rounded to float32 once, as the plain version's are:
//     on this class COCG with float32 sums parts from COCG with float64
//     sums by a quarter of max|x| within 100 iterations (helm_fe_var,
//     omega 40, N = 1024), so a kernel with float32 sums could not be held
//     to its plain version at full size.  With float64 sums both nearly
//     always round to the same float32 alpha and beta; where the two
//     float64 sums straddle a float32 rounding boundary the scalars differ
//     by one ulp, not by a float32-order spread;
//   * the reduction order is fixed (per thread over its nodes in tile
//     order, warp shuffle, block, then over blocks in block order, the same
//     in every block), so every block derives bit-identical alpha and beta
//     and reruns agree bit for bit; one RHS per launch, so a RHS's bits
//     never depend on its batch;
//   * offsets into the planes are 64-bit (N = 4096 has 16.8 M nodes a plane).
// Tile rows, ring depths and blocks an SM are arguments, chosen by
// tpcg_torch.ops.stream_cg_sym.sym_layout from the sweep of
// probes/stream_cg_phases.py (--kernel sym).  The stencil apply, the
// updates, the Smith division and the history use __fmul_rn / __fadd_rn /
// __fdiv_rn in the plain version's order, so with equal float32 dot
// products the kernel follows it bit for bit.
//
// Numerics: build without --use_fast_math (flush-to-zero and approximate
// division would move the freeze guard and the Smith division).  Plain C
// interface, loaded with ctypes (tpcg_torch/ops/_build.py); every entry
// point returns a cudaError_t as int.  The tensor maps are encoded on the
// host per launch (csrc/tma.cuh).

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
constexpr int kMaxHalf = 16;
constexpr int kMaxPad = 8;
constexpr int kMaxStages = 4;
constexpr int kMaxCoefStages = 2;
constexpr int kMaxBox = 256;        // TMA's largest box extent
// Launch bounds: blocks an SM the kernel must reach, which caps the
// registers a thread.
constexpr int kMinBlocks = 2;

struct Params {
  const float* b;       // (2, nv, nh)                                read-only
  const float* x0;      // (2, nv, nh)                                read-only
  float* x;             // (2, nv, nh)                                out
  float* hist;          // (n_iterations + 1)                         out
  float* r;             // (2, nv, pitch)                             scratch
  float* q;             // (2, nv, pitch)                             scratch
  float* d;             // (2 ping/pong, 2, nv, pitch)                scratch
  float* xw;            // (2, nv, pitch): the working copy of x      scratch
  double* part;         // (2 dq/rr, gridDim.x, 2)                    scratch
  int nv, nh, pitch, nh1, pad, n_iterations;
  int rows, cols;       // tile rows, columns (128 or 64)
  int hc;               // box columns each side of the tile (pad rounded up to 4)
  int stages;           // state ring slots
  int coef_stages;      // coefficient ring slots
  int disp[kMaxHalf];   // dm * box columns + dj: displacement in a state box
  int cdisp[kMaxHalf];  // -(dm * crow + dj): from c_t(n) to c_t(n - s) in a
                        // coefficient box
  // derived on the host (ring_of), read from the parameter bank
  size_t n;             // nv * nh
  size_t plane;         // nv * pitch: one padded plane
  int bc;               // box columns
  int hb;               // floats of one plane of a state box
  int box;              // floats of one state box (both planes), 128-B multiple
  int slot;             // floats of a state slot: r (or x0) box, d_old box
  int crow;             // floats of a coefficient box's row: 2 nh1 planes
  int cbox;             // floats of a coefficient slot, 128-B multiple
  int sring;            // offset of state slot 0 in the dynamic shared memory
  int tiles_h;          // tiles across a row of tiles
};

// TMA descriptors, each over (nh, nv, planes) floats with row pitch `pitch`.
struct Maps {
  CUtensorMap r;   // (box columns, box rows, 2) halo boxes of r
  CUtensorMap d;   // halo boxes of both d buffers: planes 4
  CUtensorMap x;   // halo boxes of xw (the init)
  CUtensorMap c;   // the half planes as (nh, 2 nh1, nv): (box columns,
                   // 2 nh1, rows + pad) boxes land as [row][plane][column]
};

// Shared-memory geometry of one launch, the same in every block (the
// host's; the kernel reads it from Params).
struct Ring {
  int br, bc;         // state box rows, columns
  int box;            // floats of one state box (both planes), 128-B multiple
  int slot;           // floats of a state slot: r (or x0) box, d_old box
  int crow;           // floats of a coefficient box's row: 2 nh1 planes
  int cbox;           // floats of a coefficient slot: rows + pad such rows
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Ring ring_of(int rows, int cols, int pad, int hc, int nh1) {
  Ring g;
  g.br = rows + 2 * pad;
  g.bc = cols + 2 * hc;
  g.box = round_up(2 * g.br * g.bc, 32);
  g.slot = 2 * g.box;
  g.crow = 2 * nh1 * g.bc;
  g.cbox = round_up((rows + pad) * g.crow, 32);
  return g;
}

inline size_t smem_bytes(int rows, int cols, int pad, int hc, int nh1,
                         int stages, int coef_stages) {
  const Ring g = ring_of(rows, cols, pad, hc, nh1);
  return (static_cast<size_t>(coef_stages) * g.cbox +
          static_cast<size_t>(stages) * g.slot) *
         sizeof(float);
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// The dynamic shared memory: the coefficient slots, then the state slots;
// the rings' mbarriers, one a slot.
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

// Block-wide sum of v; thread 0 stores it to out[0..1].
__device__ void block_partial(double2 v, double2* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double2 w = lane < kWarps ? red[lane] : make_double2(0.0, 0.0);
    w = warp_sum(w);
    if (lane == 0) {
      out[0] = w.x;
      out[1] = w.y;
    }
  }
  __syncthreads();
}

// Sum over blocks of the partials, by one warp, in a fixed order.
__device__ double2 grid_total(const double* part, int nblocks) {
  const int lane = threadIdx.x & 31;
  double2 v = make_double2(0.0, 0.0);
  for (int g = lane; g < nblocks; g += 32) {
    v.x += __ldcg(part + 2 * g);
    v.y += __ldcg(part + 2 * g + 1);
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

// x + a d in the plain version's order.
__device__ __forceinline__ void axpy(float2 a, float dr, float di, float& xr,
                                     float& xi) {
  xr = fsub(fadd(xr, fmul(a.x, dr)), fmul(a.y, di));
  xi = fadd(fadd(xi, fmul(a.x, di)), fmul(a.y, dr));
}

// ---- phase A and the init, fed by the rings ----

// The block's share of the tiles and the running counts of the rings.
struct Walk {
  int mine;           // tiles of this block: blockIdx.x + t gridDim.x
  unsigned pos;       // state boxes consumed so far in this launch
  unsigned issued;    // state boxes issued so far (thread 0)
  unsigned cpos;      // coefficient boxes consumed so far
  unsigned cissued;   // coefficient boxes issued so far
};

__device__ __forceinline__ int tile_row0(const Params& p, int t) {
  return ((blockIdx.x + t * gridDim.x) / p.tiles_h) * p.rows;
}
__device__ __forceinline__ int tile_col0(const Params& p, int t) {
  return ((blockIdx.x + t * gridDim.x) % p.tiles_h) * p.cols;
}

// Thread 0: copy the state boxes of the block's tile t into the next state
// slot: its x0 box (the init), or its r and d_old boxes (dbuf: the d buffer
// the phase reads).
template <bool kInit>
__device__ __forceinline__ void issue_state(const Params& p, const Maps& m,
                                            Walk& w, int t, int dbuf) {
  const int slot = w.issued % p.stages;
  float* const st = ring + p.sring + slot * p.slot;
  uint64_t* const bar = full + slot;
  const uint32_t box = 2u * p.hb * sizeof(float);
  const int hj = tile_col0(p, t) - p.hc, hm = tile_row0(p, t) - p.pad;
  if (kInit) {
    mbar_expect(bar, box);
    tma_load(st, &m.x, bar, hj, hm, 0);
  } else {
    mbar_expect(bar, 2 * box);
    tma_load(st, &m.r, bar, hj, hm, 0);
    tma_load(st + p.box, &m.d, bar, hj, hm, 2 * dbuf);
  }
  ++w.issued;
}

// Thread 0: copy the coefficient box of the block's tile t (rows m0 - pad
// .. m0 + R - 1, the state box's columns) into the next coefficient slot.
__device__ __forceinline__ void issue_coef(const Params& p, const Maps& m,
                                           Walk& w, int t) {
  const int slot = w.cissued % p.coef_stages;
  const uint32_t bytes = static_cast<uint32_t>(
      (p.rows + p.pad) * p.crow * sizeof(float));
  mbar_expect(cfull + slot, bytes);
  tma_load(ring + slot * p.cbox, &m.c, cfull + slot, tile_col0(p, t) - p.hc,
           0, tile_row0(p, t) - p.pad);
  ++w.cissued;
}

// One phase over the block's tiles.  kInit: r0 = b - A x0, accumulating
// <r0, r0>.  Otherwise: d' = r + beta d_old on the halo, d' and q = A d'
// stored for the tile's own nodes, accumulating <d', q>, and where defer is
// set the previous iteration's x += a_prev d_old on them.  Returns this
// thread's partial sum.
template <bool kInit>
__device__ double2 phase_apply(const Params& p, const Maps& m, Walk& w,
                               int dbuf, float2 beta, float2 a_prev,
                               bool defer) {
  double2 acc = make_double2(0.0, 0.0);
  if (threadIdx.x == 0) {
    fence_async();  // state stored before the grid barrier, read by TMA
    for (int t = 0; t < w.mine && t < p.coef_stages; ++t) issue_coef(p, m, w, t);
    for (int t = 0; t < w.mine && t < p.stages; ++t)
      issue_state<kInit>(p, m, w, t, dbuf);
  }
  const size_t plane = p.plane;
  float* const dn = p.d + static_cast<size_t>(2 * (dbuf ^ 1)) * plane;
  // node (tm, tj) of the tile: each thread keeps one column, and its rows in
  // order
  const int tj = threadIdx.x % p.cols, tm0 = threadIdx.x / p.cols;
  const int rstep = kThreads / p.cols;
#pragma unroll 1
  for (int t = 0; t < w.mine; ++t) {
    const int m0 = tile_row0(p, t), gj = tile_col0(p, t) + tj;
    const int rows = p.nv - m0 < p.rows ? p.nv - m0 : p.rows;
    const int cslot = w.cpos % p.coef_stages;
    const int slot = w.pos % p.stages;
    const int st = p.sring + slot * p.slot;  // the state slot in `ring`
    mbar_wait(cfull + cslot, (w.cpos / p.coef_stages) & 1u);
    mbar_wait(full + slot, (w.pos / p.stages) & 1u);
    if (!kInit) {
      // d' = r + beta d_old over the whole box, in place of r
      float4* const r4 = reinterpret_cast<float4*>(ring + st);
      const float4* const d4 = reinterpret_cast<const float4*>(ring + st + p.box);
      const int hb4 = p.hb / 4;
      for (int e = threadIdx.x; e < hb4; e += kThreads) {
        const float4 rr = r4[e], ri = r4[hb4 + e];
        const float4 dr = d4[e], di = d4[hb4 + e];
        float4 vr, vi;
#define TPCG_DIR(L)                                                    \
  vr.L = fsub(fadd(rr.L, fmul(beta.x, dr.L)), fmul(beta.y, di.L));     \
  vi.L = fadd(fadd(ri.L, fmul(beta.x, di.L)), fmul(beta.y, dr.L));
        TPCG_DIR(x) TPCG_DIR(y) TPCG_DIR(z) TPCG_DIR(w)
#undef TPCG_DIR
        r4[e] = vr;
        r4[hb4 + e] = vi;
      }
      fence_async_smem();  // the slot is refilled by TMA later
      __syncthreads();
    }
    if (gj < p.nh) {
#pragma unroll 1
      for (int tm = tm0; tm < rows; tm += rstep) {
        const int gm = m0 + tm;
        // the node in the state box (re plane; im hb further) and its
        // c_t(n) in the coefficient box (re; im nh1 box columns further)
        const int si = st + (tm + p.pad) * p.bc + tj + p.hc;
        const int ci = cslot * p.cbox + (tm + p.pad) * p.crow + tj + p.hc;
        const int cim = p.nh1 * p.bc;
        const size_t g = static_cast<size_t>(gm) * p.pitch + gj;
        // the node's x, loaded before the apply so that the load is in
        // flight while the taps are summed
        float xr = 0.f, xi = 0.f;
        if (defer) {
          xr = __ldcg(p.xw + g);
          xi = __ldcg(p.xw + plane + g);
        }
        float qr = 0.f, qi = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxHalf; ++k) {
          if (k >= p.nh1) break;
          const int cd = ci + k * p.bc;
          // the down term c_k(n) v(n + s)
          const float car = ring[cd], cai = ring[cd + cim];
          const int sd = si + p.disp[k];
          const float vr = ring[sd], vi = ring[sd + p.hb];
          qr = fsub(fadd(qr, fmul(car, vr)), fmul(cai, vi));
          qi = fadd(fadd(qi, fmul(car, vi)), fmul(cai, vr));
          if (k == 0) continue;  // the centre has no mirror
          // the mirrored up term c_k(n - s) v(n - s)
          const int cu = cd + p.cdisp[k];
          const float cbr = ring[cu], cbi = ring[cu + cim];
          const int su = si - p.disp[k];
          const float yr = ring[su], yi = ring[su + p.hb];
          qr = fsub(fadd(qr, fmul(cbr, yr)), fmul(cbi, yi));
          qi = fadd(fadd(qi, fmul(cbr, yi)), fmul(cbi, yr));
        }
        if (kInit) {
          const size_t eb = static_cast<size_t>(gm) * p.nh + gj;
          const float rr = fsub(__ldg(p.b + eb), qr);
          const float ri = fsub(__ldg(p.b + p.n + eb), qi);
          p.r[g] = rr;
          p.r[plane + g] = ri;
          acc.x += static_cast<double>(rr) * rr - static_cast<double>(ri) * ri;
          acc.y += static_cast<double>(rr) * ri;
        } else {
          const float dr = ring[si], di = ring[si + p.hb];
          dn[g] = dr;
          dn[plane + g] = di;
          p.q[g] = qr;
          p.q[plane + g] = qi;
          acc.x += static_cast<double>(dr) * qr - static_cast<double>(di) * qi;
          acc.y += static_cast<double>(dr) * qi + static_cast<double>(di) * qr;
          if (defer) {
            // the previous iteration's x += alpha d', d' its d_old
            const int so = si + p.box;
            axpy(a_prev, ring[so], ring[so + p.hb], xr, xi);
            p.xw[g] = xr;
            p.xw[plane + g] = xi;
          }
        }
      }
    }
    __syncthreads();  // both slots are free
    ++w.pos;
    ++w.cpos;
    if (threadIdx.x == 0) {
      if (t + p.stages < w.mine) issue_state<kInit>(p, m, w, t + p.stages, dbuf);
      if (t + p.coef_stages < w.mine) issue_coef(p, m, w, t + p.coef_stages);
    }
  }
  fence_async();  // stores above are read by TMA after the grid barrier
  return acc;
}

// Phase B over the padded planes (re at the pointer, im `plane` floats on:
// every plane starts 128-byte aligned, and the zero columns past nh stay
// zero): r -= alpha q; returns this thread's partial of (sum rr^2 - ri^2,
// sum rr ri) in float64 (exact products).  The sweep runs from the planes'
// ends back, so the q that phase A stored last is read first, while the L2
// still holds it.
__device__ double2 sweep_update(const Params& p, float2 a) {
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t n4 = p.plane / 4;
  const float4* q4 = reinterpret_cast<const float4*>(p.q);
  float4* r4 = reinterpret_cast<float4*>(p.r);
  double2 acc = make_double2(0.0, 0.0);
  for (size_t v = t0; v < n4; v += stride) {
    const size_t u = n4 - 1 - v;
    const float4 qr = __ldcg(q4 + u), qi = __ldcg(q4 + n4 + u);
    float4 rr = __ldcg(r4 + u), ri = __ldcg(r4 + n4 + u);
#define TPCG_RES(L)                                                       \
  rr.L = fsub(rr.L, fsub(fmul(a.x, qr.L), fmul(a.y, qi.L)));              \
  ri.L = fsub(ri.L, fadd(fmul(a.x, qi.L), fmul(a.y, qr.L)));              \
  acc.x += static_cast<double>(rr.L) * rr.L -                             \
           static_cast<double>(ri.L) * ri.L;                              \
  acc.y += static_cast<double>(rr.L) * ri.L;
    TPCG_RES(x) TPCG_RES(y) TPCG_RES(z) TPCG_RES(w)
#undef TPCG_RES
    r4[u] = rr;
    r4[n4 + u] = ri;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stream_cg_sym_kernel(Params p, const __grid_constant__ Maps maps) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double2 red[kWarps];
  __shared__ float2 s_delta, s_alpha, s_beta;
  __shared__ int s_done;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const int nv = p.nv, nh = p.nh;
  const size_t plane = p.plane;
  const int ntiles = ((nv + p.rows - 1) / p.rows) * p.tiles_h;
  Walk w;
  w.mine = (ntiles - static_cast<int>(blockIdx.x) + nblocks - 1) / nblocks;
  w.pos = w.issued = w.cpos = w.cissued = 0;
  double* const part_dq = p.part;
  double* const part_rr = p.part + 2 * static_cast<size_t>(nblocks);
  double* const mine_dq = part_dq + 2 * static_cast<size_t>(blockIdx.x);
  double* const mine_rr = part_rr + 2 * static_cast<size_t>(blockIdx.x);
  const float2 zero = make_float2(0.f, 0.f);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full + s);
    for (int s = 0; s < p.coef_stages; ++s) mbar_init(cfull + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // init: xw = x0 and d = 0 (the ping buffer, read by iteration 0) on the
  // grid's nodes; then r0 = b - A x0 and the partials of <r0, r0>
  for (int row = blockIdx.x; row < nv; row += nblocks)
    for (int j = threadIdx.x; j < nh; j += kThreads) {
      const size_t e = static_cast<size_t>(row) * nh + j;
      const size_t g = static_cast<size_t>(row) * p.pitch + j;
      p.xw[g] = __ldg(p.x0 + e);
      p.xw[plane + g] = __ldg(p.x0 + p.n + e);
      p.d[g] = 0.f;
      p.d[plane + g] = 0.f;
    }
  fence_async();
  __syncthreads();  // the mbarriers are initialised
  grid.sync();
  block_partial(phase_apply<true>(p, maps, w, 0, zero, zero, false), red,
                mine_rr);
  grid.sync();
  if (warp == 0) {
    const double2 t = grid_total(part_rr, nblocks);
    if (lane == 0) {
      s_delta = delta_of(t);
      s_beta = zero;
      s_alpha = zero;
      if (blockIdx.x == 0) p.hist[0] = hist_of(s_delta);
    }
  }
  __syncthreads();

  for (int it = 0; it < p.n_iterations; ++it) {
    const int d_old = it & 1;  // d_new is the other buffer
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
    block_partial(phase_apply<false>(p, maps, w, d_old, s_beta, s_alpha,
                                     it > 0),
                  red, mine_dq);
    grid.sync();

    // alpha, bit-identical in every block
    if (warp == 0) {
      const double2 dq64 = grid_total(part_dq, nblocks);
      if (lane == 0) {
        const float2 dq = make_float2(static_cast<float>(dq64.x),
                                      static_cast<float>(dq64.y));
        const float2 dl = s_delta;
        const int done =
            (dl.x == 0.f && dl.y == 0.f) || (dq.x == 0.f && dq.y == 0.f);
        s_done = done;
        s_alpha = done ? zero : cdiv_smith(dl.x, dl.y, dq.x, dq.y);
      }
    }
    __syncthreads();

    // phase B: r -= alpha q, partials of <r, r> (x += alpha d' waits for
    // the next phase A)
    const double2 pr = sweep_update(p, s_alpha);
    fence_async();  // r is read by TMA after the grid barrier
    block_partial(pr, red, mine_rr);
    grid.sync();

    // beta and the history
    if (warp == 0) {
      const double2 t = grid_total(part_rr, nblocks);
      if (lane == 0) {
        const float2 dn = delta_of(t);
        const float2 dl = s_delta;
        s_beta = s_done ? zero : cdiv_smith(dn.x, dn.y, dl.x, dl.y);
        s_delta = dn;
        if (blockIdx.x == 0) p.hist[it + 1] = hist_of(dn);
      }
    }
    __syncthreads();
  }

  // x = xw on the grid's nodes, plus the last iteration's alpha d'
  const bool closing = p.n_iterations > 0;
  const float* dlast = p.d + static_cast<size_t>(p.n_iterations & 1) * 2 * plane;
  const float2 a = s_alpha;
  for (int row = blockIdx.x; row < nv; row += nblocks)
    for (int j = threadIdx.x; j < nh; j += kThreads) {
      const size_t e = static_cast<size_t>(row) * nh + j;
      const size_t g = static_cast<size_t>(row) * p.pitch + j;
      float xr = __ldcg(p.xw + g), xi = __ldcg(p.xw + plane + g);
      if (closing) axpy(a, __ldcg(dlast + g), __ldcg(dlast + plane + g), xr, xi);
      p.x[e] = xr;
      p.x[p.n + e] = xi;
    }
}

// The tile geometry the caller passes: refuse what the kernel cannot run.
bool geometry_ok(int nv, int nh, int pitch, int pad, int nh1, int rows,
                 int cols, int hc, int stages, int coef_stages) {
  return nv >= 1 && nh >= 1 && pad >= 0 && pad <= kMaxPad && nh1 >= 1 &&
         nh1 <= kMaxHalf && rows >= 1 && rows + 2 * pad <= kMaxBox &&
         (cols == 128 || cols == 64) && kThreads % cols == 0 && hc >= pad &&
         hc % 4 == 0 && cols + 2 * hc <= kMaxBox && pitch % 32 == 0 &&
         pitch >= nh + pad && stages >= 2 && stages <= kMaxStages &&
         coef_stages >= 1 && coef_stages <= kMaxCoefStages;
}

// The kernel may take the rings' dynamic shared memory (past 48 KB a kernel
// must opt in, before the occupancy query and the launch).  The runtime
// refuses more than the card gives a block beside the kernel's static
// shared memory, so no copy of the card's limit is kept here.
cudaError_t allow_smem(size_t bytes) {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(stream_cg_sym_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Kernel limits: half offsets (the centre included), largest |offset|
// component.
int tpcg_stream_sym_limits(int* max_half, int* max_pad) {
  *max_half = kMaxHalf;
  *max_pad = kMaxPad;
  return 0;
}

// Grid size for an (nv, nh) grid with the layout of
// tpcg_torch.ops.stream_cg_sym.sym_layout (pitch, tile rows and columns,
// box halo columns, ring slots) on the current device: one block per tile
// where the card has room, at most `per_sm_cap` blocks per SM, never more
// than can be co-resident (a larger cooperative launch is refused).
int tpcg_stream_sym_grid(int nv, int nh, int pitch, int pad, int nh1,
                         int rows, int cols, int hc, int stages,
                         int coef_stages, int per_sm_cap, int* grid_out) {
  if (per_sm_cap < 1 || !geometry_ok(nv, nh, pitch, pad, nh1, rows, cols, hc,
                                     stages, coef_stages))
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(rows, cols, pad, hc, nh1, stages, coef_stages);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_cg_sym_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > per_sm_cap) per_sm = per_sm_cap;
  const long long tiles = static_cast<long long>((nv + rows - 1) / rows) *
                          ((nh + cols - 1) / cols);
  long long g = tiles;
  if (g > static_cast<long long>(per_sm) * sms) g = per_sm * sms;
  *grid_out = g < 1 ? 1 : static_cast<int>(g);
  return 0;
}

// b, x0, x: (2, nv, nh) float planes; c: (2, nh1, nv, pitch), the half
// planes copied to the pitch; r, q, xw: (2, nv, pitch); d: (2, 2, nv,
// pitch), all four zero past column nh; hist: n_iterations + 1; part:
// 4 * grid doubles.  offsets: host array of 2 * nh1 ints (dm, dj), the
// centre (0, 0) first and every other one greater than (0, 0), |dm|, |dj|
// <= pad.  pitch, rows, cols, hc, stages, coef_stages: the layout of
// sym_layout; grid: from tpcg_stream_sym_grid with the same layout.
int tpcg_stream_sym(const float* b, const float* x0, const float* c, float* x,
                    float* hist, float* r, float* q, float* d, float* xw,
                    double* part, int nv, int nh, int pitch, int nh1,
                    const int* offsets, int pad, int rows, int cols, int hc,
                    int stages, int coef_stages, int n_iterations, int grid,
                    void* stream) {
  if (n_iterations < 0 || grid < 1 ||
      !geometry_ok(nv, nh, pitch, pad, nh1, rows, cols, hc, stages,
                   coef_stages))
    return cudaErrorInvalidValue;
  if (offsets[0] != 0 || offsets[1] != 0) return cudaErrorInvalidValue;
  Params p;
  p.b = b;
  p.x0 = x0;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.q = q;
  p.d = d;
  p.xw = xw;
  p.part = part;
  p.nv = nv;
  p.nh = nh;
  p.pitch = pitch;
  p.nh1 = nh1;
  p.pad = pad;
  p.n_iterations = n_iterations;
  p.rows = rows;
  p.cols = cols;
  p.hc = hc;
  p.stages = stages;
  p.coef_stages = coef_stages;
  const Ring g = ring_of(rows, cols, pad, hc, nh1);
  p.n = static_cast<size_t>(nv) * nh;
  p.plane = static_cast<size_t>(nv) * pitch;
  p.bc = g.bc;
  p.hb = g.br * g.bc;
  p.box = g.box;
  p.slot = g.slot;
  p.crow = g.crow;
  p.cbox = g.cbox;
  p.sring = coef_stages * g.cbox;
  p.tiles_h = (nh + cols - 1) / cols;
  for (int t = 0; t < kMaxHalf; ++t) p.disp[t] = p.cdisp[t] = 0;
  for (int t = 0; t < nh1; ++t) {
    const int dm = offsets[2 * t], dj = offsets[2 * t + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    // every offset but the centre is lexicographically positive, so the
    // mirrored term reads the coefficient box's rows above the tile only
    if (t > 0 && !(dm > 0 || (dm == 0 && dj > 0))) return cudaErrorInvalidValue;
    p.disp[t] = dm * g.bc + dj;
    p.cdisp[t] = -(dm * g.crow + dj);
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps;
  if (!encode(fn, &maps.r, r, nh, nv, 2, pitch, g.bc, g.br, 2) ||
      !encode(fn, &maps.d, d, nh, nv, 4, pitch, g.bc, g.br, 2) ||
      !encode(fn, &maps.x, xw, nh, nv, 2, pitch, g.bc, g.br, 2) ||
      !encode(fn, &maps.c, c, nh, nv, 2 * nh1, pitch, g.bc, rows + pad,
              2 * nh1, false))
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(rows, cols, pad, hc, nh1, stages, coef_stages);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p, &maps};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stream_cg_sym_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
