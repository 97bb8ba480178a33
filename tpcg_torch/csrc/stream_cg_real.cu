// Fixed-iteration single-RHS CG on a real 2-D stencil whose state does not
// fit on chip, in one persistent cooperative launch with the state in device
// memory.  Two operators, one template parameter (kCoef):
//   * const (kCoef false): constant interior taps, taps with equal values
//     summed first and multiplied once; constant left/right edge taps on
//     columns 0 / nh-1; bottom/top row strips on rows 0 / nv-1 (corner-
//     adjusted on the host, tpcg_torch.ops.stream_cg_real.prepare_stream_real);
//   * coef (kCoef true): per-node coefficient planes, q = sum_s c_s(n) x(n+s).
// A neighbour outside the grid reads 0.
//
// Replaces, on the planner's `stream-real` path, the Pallas kernels of the
// JAX package that compute this one function with the TPU's memory tiers:
//   * tpcg/ops/stream_cg_real.py::_build_k1_real_const and
//     ::_build_k1_real_coef (v2 K1: d = r + beta d, q = A d, <d,q>, alpha;
//     also the r0 init of v4 and v5) and ::_make_k2_real (v2 K2: x, r,
//     <r,r>, beta);
//   * tpcg/ops/stream_cg_v4_real.py::_build_resident_real: K iterations per
//     call, const (keep_q, recompute, q_hbm) and coef (keep_q);
//   * tpcg/ops/stream_cg_v5_real.py::_build_v5_real: the v4 loop with state
//     row panels round-tripping HBM (tiers A and B, qx, the column-padded
//     `cpos` route).
// Their VMEM budgets, row blocks, 128-lane padding and the planner's row
// padding of awkward heights have no purpose here: Hopper reads any height
// and width, and the state lives in device memory.  The design is that of
// csrc/stream_cg.cu (const mode) and csrc/stream_cg_coef.cu (coef mode) on
// one plane, with their float64 dot sums.
//
// What it computes (tpcg_torch/ops/stream_cg_real.py::cg_real_plain with
// apply_const_real / apply_coef_real is the same function in plain PyTorch,
// step for step):
//   r0 = b - A x0, delta0 = <r0, r0>, d = 0, beta = 0; then per iteration
//   d' = r + beta d, q = A d', alpha = delta / <d', q>, x += alpha d',
//   r -= alpha q, delta' = <r, r>, beta = delta' / delta;
//   done = (delta == 0) | (<d', q> == 0), evaluated afresh each iteration,
//   zeroes alpha and beta; hist[it] = sqrt(delta).
//
// What bounds it on the H100: device-memory bytes, and in const mode the
// work of a tile on the SM.  At N = 4096 the state (x, r, q and two d
// buffers) takes 336 MB, far past the 50 MB L2.  Per node and iteration,
// with tiles of R rows and 128 columns whose halo boxes span R + 2 pad rows
// and 128 + 2 hc columns (hc = pad rounded up to 4; h = box / tile - 1):
//   phase A reads r and the old d with their halo and writes d' and q,
//     16 + 8 h B, and in coef mode the tile's noff coefficient planes (no
//     halo: c_s(n) belongs to the node), 4 noff B;
//   phase B reads x, d', r and q and writes x and r, 24 B;
// 40 + 8 h B in all (41.6 B at R = 16, pad 1: h = 0.195), plus 4 B a tap
// in coef mode, against the 24 B (plus 4 B a tap) of reading and writing x,
// r and d once.  tpcg_torch.ops.stream_cg_real.real_layout counts them.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings;
// probes/stream_cg_phases.py): q recomputed in phase B from a halo box of
// d' (32 + 12 h B) ran as fast as q kept at N = 4096 and 11-27% slower at
// 2048 and 1024, its second apply bound on the SM; deferring x += alpha d'
// into the next phase A (JAX's qx) moved nothing in const mode and cost
// 11-22% in coef mode.  So both modes keep q and update x in phase B.
//
// What the design does about it:
//   * the Tensor Memory Accelerator feeds phase A and the init: the tile's
//     r and d_old halo boxes (the init: its x0 box) are tile copies into a
//     state ring of `stages` slots of dynamic shared memory, and in coef
//     mode the tile's noff coefficient planes into a coefficient ring of
//     `coef_stages` slots, one mbarrier a slot; thread 0 keeps the next
//     tiles' copies in flight while the block applies the current one.
//     TMA's out-of-bounds fill gives the zero neighbours at rows -1 / nv and
//     columns -1 / nh with no branch.  A box's first column is j0 - hc, so
//     its rows are 16-byte multiples as TMA needs;
//   * the state (r, both d buffers, q and a working copy of x) lives in
//     planes whose row pitch is nh + pad rounded up to 32 floats, and so
//     does the coefficient planes' copy (the planner makes it once a plan):
//     every row starts 128-byte aligned at every width, the columns past nh
//     are zero and never written, and phase B is one float4 sweep at every
//     width, from the planes' ends back (the d' and q that phase A stored
//     last are read first, while the L2 holds them).  The init copies x0 in
//     and the end copies x out, once a launch;
//   * two grid barriers per iteration: phase A recomputes d' = r + beta d on
//     its tile's halo from r and the old d (a ping-pong pair of d buffers)
//     with the same non-contracting float operations (__fmul_rn,
//     __fadd_rn) as the owner, so every block applies A to bit-identical
//     values;
//   * cross-proxy order: every thread that stores state that a TMA copy will
//     read (d' in phase A, r in phase B, x0's copy and r0 in the init) runs
//     fence.proxy.async before the grid barrier, and thread 0 runs it again
//     after the barrier before it issues copies; threads that wrote d' into
//     a ring slot run fence.proxy.async.shared::cta before the slot is
//     refilled;
//   * const mode takes the interior taps in group order, the group bounds as
//     bit masks, the edge taps and the strips' pointer as kernel parameters,
//     so the unrolled tap loop reads every tap's displacement and value from
//     the parameter bank at a fixed offset, and reads the strips through
//     __ldg only on rows 0 and nv-1;
//   * dot products accumulate in float64 (the float32 products are exact
//     there) and are rounded to float32 once, as the plain version's are, so
//     both nearly always round to the same alpha and beta; the reduction
//     order is fixed (per thread over its nodes in tile order, warp shuffle,
//     block, then over blocks in block order, the same in every block), so
//     every block derives bit-identical scalars and reruns agree bit for
//     bit;
//   * launch bounds of 4 blocks an SM: at most 64 registers a thread, so
//     that the 4 blocks real_layout asks for below 2048^2 nodes fit an SM;
//   * offsets into the planes are 64-bit (N = 4096 has 16.8 M nodes).
//
// Resident mode (const mode, template argument kResident): where the card
// holds one block for every tile of the grid at once, each block owns one
// tile for the whole solve, and each thread keeps x, r and q of its nodes of
// that tile in registers from r0 to the end.  Phase A is the streaming
// phase A on that tile, q kept in registers and not stored; phase B is
// x += alpha d' (d' read from the state slot that phase A left it in) and
// r -= alpha q on the thread's own nodes, storing only r, which the
// neighbours' halo boxes read in the next phase A (d' is stored in phase A
// as before).  No q plane, no working x and no plane-wide sweep: 16 + 8 h B
// a node and iteration against 40 + 8 h.  x is written once, at the end;
// the init stages x0's copy at the pitch in the pong d buffer, which
// iteration 0 overwrites.  The <r, r> partial is summed per thread over its
// nodes in tile order, then warp, block and blocks in block order, as
// <d', q> is (the sweep sums each thread's float4s from the planes' ends
// back): the float64 sums round otherwise, and the float32 scalars nearly
// always agree with the plain version's, as the sweep's do.
// What bounds it: a tile of at most kResidentRows (12) rows, kOwn (6) nodes
// a thread, whose x, r and q take 18 of the 85 registers that
// kResidentMinBlocks (3) blocks an SM leave a thread (the build must not
// spill: a card test reads ptxas's report); and one block a tile, so at
// most as many tiles as the card holds blocks at once.  What is left at
// 725^2 is latency: two grid barriers, two grid-wide sums and a TMA round
// trip an iteration, which a grid of a few blocks pays too.
// tpcg_torch.ops.stream_cg_real.card_layout picks it (resident_layout):
// the fewest tile rows whose tiles number at most the SMs times
// kResidentMinBlocks, where those rows are at most kResidentRows and an
// SM's shared memory holds kResidentMinBlocks rings of them (both bounds
// reach the wrapper through tpcg_stream_real_limits); the occupancy query
// of tpcg_stream_real_grid confirms that the card holds one block a tile
// (else it returns 0 and the wrapper takes the streaming layout).  Grids
// with more tiles (past 768^2 nodes at 132 SMs) and coef mode stream as
// above.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, Findings;
// probes/stream_cg_phases.py, the parabolic_fem cell's 725^2 FE operator):
// 19.5 us an iteration streaming (8-row tiles, 18 of 528 blocks with two),
// 18.2 with one 9-row tile a block and no other change, 15.7 resident at
// 3 blocks an SM; at 4 blocks an SM x, r and q of 8 nodes spilled (19.6),
// of 5 did not (18.0); at 2 with 18-row tiles 19.0; the grid-wide sum's
// loads issued 8 at a time, or phase A's copies issued before the <r, r>
// sum, did not help.
// Tile rows, ring depths and blocks an SM are arguments, chosen by
// tpcg_torch.ops.stream_cg_real.card_layout from the sweeps of
// probes/stream_cg_phases.py (--kernel real, real-coef).  The stencil apply,
// the updates and the divisions use non-contracting operations (__fmul_rn,
// __fadd_rn, __fdiv_rn) in the order of the plain version, so with equal
// float32 dot products the kernel follows it bit for bit.
//
// Numerics: build without --use_fast_math.  Plain C interface, loaded with
// ctypes (tpcg_torch/ops/_build.py); every entry point returns a cudaError_t
// as int.  The tensor maps are encoded on the host per launch (csrc/tma.cuh).

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
constexpr int kMaxTaps = 16;
constexpr int kMaxPad = 8;
constexpr int kMaxStages = 4;
constexpr int kMaxCoefStages = 2;
constexpr int kMaxBox = 256;        // TMA's largest box extent
// Launch bounds: blocks an SM the kernel must reach, which caps the
// registers a thread (resident mode: kResidentMinBlocks).
constexpr int kMinBlocks = 4;
static_assert(kThreads % kTileCols == 0, "whole tile rows a sweep");
constexpr int kRowStep = kThreads / kTileCols;  // tile rows a sweep
// Resident mode: the tallest tile, the nodes a thread keeps in registers
// there, and the blocks an SM (the wrapper reads the first and the last
// through tpcg_stream_real_limits).
constexpr int kResidentRows = 12;
constexpr int kOwn = kResidentRows / kRowStep;
constexpr int kResidentMinBlocks = 3;
static_assert(kResidentRows % kRowStep == 0, "whole sweeps a tile");

struct Params {
  const float* b;       // (nv, nh)                                 read-only
  const float* x0;      // (nv, nh)                                 read-only
  const float* strips;  // const: (2 bottom/top, noff, nh)          read-only
  float* x;             // (nv, nh)                                 out
  float* hist;          // (n_iterations + 1)                       out
  float* r;             // (nv, pitch)                              scratch
  float* q;             // (nv, pitch); null in resident mode       scratch
  float* d;             // (2 ping/pong, nv, pitch)                 scratch
  float* xw;            // (nv, pitch): the working copy of x;      scratch
                        // null in resident mode
  double* part;         // (2 dq/rr, gridDim.x)                     scratch
  int nv, nh, pitch, noff, pad, n_iterations;
  int rows;             // tile rows
  int hc;               // box columns each side of the tile (pad rounded up to 4)
  int stages;           // state ring slots
  int coef_stages;      // coefficient ring slots (coef mode)
  // derived on the host (ring_of), read from the parameter bank
  size_t plane;         // nv * pitch: one padded plane
  int bc;               // box columns
  int hb;               // floats of a halo box: (rows + 2 pad) * bc
  int box;              // hb rounded up to 32 floats
  int own;              // floats of a tile: rows * 128
  int cbox;             // floats of a coefficient slot: noff * rows * 128
  int sring;            // offset of state slot 0 in the dynamic shared memory
  int tiles_h;          // tiles across a row of tiles
  int disp[kMaxTaps];   // tap displacement in a halo box: dm * bc + dj
  // const mode: the nonzero interior taps in group order (groups in order of
  // first appearance, taps in tap order within a group): gdisp[t] the
  // displacement of the t-th of ntaps; bit t of gfirst set where it opens a
  // group, of glast where it closes one, gval[t] the group's value there;
  // lc / rc the edge taps
  int ntaps;
  unsigned gfirst, glast;
  int gdisp[kMaxTaps];
  float gval[kMaxTaps];
  float lc[kMaxTaps], rc[kMaxTaps];
};

// TMA descriptors, each over (nh, nv, planes) floats with row pitch `pitch`.
struct Maps {
  CUtensorMap r;      // halo boxes of r
  CUtensorMap d;      // halo boxes of both d buffers: planes 2
  CUtensorMap x;      // halo boxes of x0's copy at the pitch (the init): xw,
                      // in resident mode the pong d buffer
  CUtensorMap c;      // (128, rows, noff) boxes of the coefficient planes
};

// Shared-memory geometry of one launch, the same in every block (the
// host's; the kernel reads it from Params).
struct Ring {
  int br, bc;         // halo box rows, columns
  int box;            // floats of a halo box, 128-B multiple; a state slot
                      // holds two
  int own;            // floats of a tile
  int cbox;           // floats of a coefficient slot, 128-B multiple
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Ring ring_of(int rows, int pad, int hc, int noff, bool coef) {
  Ring g;
  g.br = rows + 2 * pad;
  g.bc = kTileCols + 2 * hc;
  g.box = round_up(g.br * g.bc, 32);
  g.own = rows * kTileCols;
  g.cbox = coef ? round_up(noff * g.own, 32) : 0;
  return g;
}

inline size_t smem_bytes(int rows, int pad, int hc, int noff, bool coef,
                         int stages, int coef_stages) {
  const Ring g = ring_of(rows, pad, hc, noff, coef);
  return (static_cast<size_t>(coef ? coef_stages : 0) * g.cbox +
          static_cast<size_t>(stages) * 2 * g.box) *
         sizeof(float);
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// The dynamic shared memory: the coefficient slots (coef mode), then the
// state slots; the rings' mbarriers, one a slot.
extern __shared__ __align__(128) float ring[];
__shared__ __align__(8) uint64_t full[kMaxStages];
__shared__ __align__(8) uint64_t cfull[kMaxCoefStages];

// ---- reductions ----

__device__ __forceinline__ double warp_sum(double v) {
  // xor butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of v; thread 0 stores it to *out.
__device__ void block_partial(double v, double* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kWarps ? red[lane] : 0.0;
    w = warp_sum(w);
    if (lane == 0) *out = w;
  }
  __syncthreads();
}

// Sum over blocks of the partials, by one warp, in a fixed order.
__device__ double grid_total(const double* part, int nblocks) {
  const int lane = threadIdx.x & 31;
  double v = 0.0;
  for (int g = lane; g < nblocks; g += 32) v += __ldcg(part + g);
  return warp_sum(v);
}

// ---- the stencil ----

// sum over the taps of e_s v(n + s), from 0 in tap order, skipping zero
// taps: an edge of the const operator, e the left (kRight false) or right
// edge taps; v at ring[si + disp].
template <bool kRight>
__device__ __forceinline__ float edge_sum(const Params& p, int si) {
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s >= p.noff) break;
    const float e = kRight ? p.rc[s] : p.lc[s];
    if (e != 0.f) a = fadd(a, fmul(e, ring[si + p.disp[s]]));
  }
  return a;
}

// sum over all taps of strip_s(j) v(n + s), from 0 in tap order (a row
// strip of the const operator).
__device__ __forceinline__ float strip_sum(const Params& p,
                                           const float* strip, int j,
                                           int si) {
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s >= p.noff) break;
    a = fadd(a, fmul(__ldg(strip + static_cast<size_t>(s) * p.nh + j),
                     ring[si + p.disp[s]]));
  }
  return a;
}

// (A v) at node (m, j); v's node at ring[si] in a halo box.  Coef mode: the
// node's coefficients at ring[ci + s * own], s = 0 .. noff - 1.
template <bool kCoef>
__device__ __forceinline__ float apply_at(const Params& p, int si, int ci,
                                          int m, int j) {
  float q = 0.f;
  if constexpr (kCoef) {
#pragma unroll
    for (int s = 0; s < kMaxTaps; ++s) {
      if (s >= p.noff) break;
      q = fadd(q, fmul(ring[ci + s * p.own], ring[si + p.disp[s]]));
    }
    return q;
  }
  // per group of equal taps: the values summed in tap order, times the tap
  float sx = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t >= p.ntaps) break;
    const float v = ring[si + p.gdisp[t]];
    sx = (p.gfirst >> t) & 1u ? v : fadd(sx, v);
    if ((p.glast >> t) & 1u) q = fadd(q, fmul(p.gval[t], sx));
  }
  if (j == 0) q = fadd(q, edge_sum<false>(p, si));
  if (j == p.nh - 1) q = fadd(q, edge_sum<true>(p, si));
  if (m == 0) q = fadd(q, strip_sum(p, p.strips, j, si));
  if (m == p.nv - 1)
    q = fadd(q, strip_sum(p, p.strips + static_cast<size_t>(p.noff) * p.nh,
                          j, si));
  return q;
}

// ---- the phases over the block's tiles, fed by the rings ----

// The block's share of the tiles and the running counts of the rings.
struct Walk {
  int mine;           // tiles of this block: blockIdx.x + t gridDim.x
  unsigned pos;       // state slots consumed so far in this launch
  unsigned issued;    // state slots issued so far (thread 0)
  unsigned cpos;      // coefficient slots consumed so far
  unsigned cissued;   // coefficient slots issued so far
};

// Resident mode: the thread's nodes of the block's one tile, node k at tile
// row tm0 + k kRowStep of the thread's column; x, r and q from the init to
// the end.
struct Own {
  float x[kOwn], r[kOwn], q[kOwn];
};

__device__ __forceinline__ int tile_row0(const Params& p, int t) {
  return ((blockIdx.x + t * gridDim.x) / p.tiles_h) * p.rows;
}
__device__ __forceinline__ int tile_col0(const Params& p, int t) {
  return ((blockIdx.x + t * gridDim.x) % p.tiles_h) * kTileCols;
}

// Thread 0: copy the state boxes of the block's tile t into the next state
// slot: its x0 box (the init), or its r and d_old boxes (dbuf: the d buffer
// the phase reads).
template <bool kInit>
__device__ __forceinline__ void issue_state(const Params& p, const Maps& m,
                                            Walk& w, int t, int dbuf) {
  const int slot = w.issued % p.stages;
  float* const st = ring + p.sring + slot * 2 * p.box;
  uint64_t* const bar = full + slot;
  const uint32_t box = p.hb * sizeof(float);
  const int hj = tile_col0(p, t) - p.hc, hm = tile_row0(p, t) - p.pad;
  if (kInit) {
    mbar_expect(bar, box);
    tma_load(st, &m.x, bar, hj, hm, 0);
  } else {
    mbar_expect(bar, 2 * box);
    tma_load(st, &m.r, bar, hj, hm, 0);
    tma_load(st + p.box, &m.d, bar, hj, hm, dbuf);
  }
  ++w.issued;
}

// Thread 0: copy the noff coefficient planes of the block's tile t into
// the next coefficient slot (coef mode).
__device__ __forceinline__ void issue_coef(const Params& p, const Maps& m,
                                           Walk& w, int t) {
  const int slot = w.cissued % p.coef_stages;
  mbar_expect(cfull + slot,
              static_cast<uint32_t>(p.noff * p.own * sizeof(float)));
  tma_load(ring + slot * p.cbox, &m.c, cfull + slot, tile_col0(p, t),
           tile_row0(p, t), 0);
  ++w.cissued;
}

// One phase over the block's tiles.  kInit: r0 = b - A x0, accumulating
// <r0, r0>.  Otherwise: d' = r + beta d_old on the halo, d' and q = A d'
// stored for the tile's own nodes, accumulating <d', q>.  kResident: the
// block's one tile; r0 and x0 (the init) or q (otherwise) of the thread's
// nodes go to `o` (q is not stored).  Returns this thread's partial sum.
template <bool kCoef, bool kInit, bool kResident>
__device__ __forceinline__ double phase_apply(const Params& p, const Maps& m,
                                              Walk& w, int dbuf, float beta,
                                              Own& o) {
  double acc = 0.0;
  if (threadIdx.x == 0) {
    fence_async();  // state stored before the grid barrier, read by TMA
    if (kCoef)
      for (int t = 0; t < w.mine && t < p.coef_stages; ++t)
        issue_coef(p, m, w, t);
    for (int t = 0; t < w.mine && t < p.stages; ++t)
      issue_state<kInit>(p, m, w, t, dbuf);
  }
  float* const dn = p.d + static_cast<size_t>(dbuf ^ 1) * p.plane;
  // node (tm, tj) of the tile: each thread keeps one column, and its rows in
  // order
  const int tj = threadIdx.x % kTileCols, tm0 = threadIdx.x / kTileCols;
#pragma unroll 1
  for (int t = 0; t < w.mine; ++t) {
    const int m0 = tile_row0(p, t), gj = tile_col0(p, t) + tj;
    const int rows = p.nv - m0 < p.rows ? p.nv - m0 : p.rows;
    const int slot = w.pos % p.stages;
    const int st = p.sring + slot * 2 * p.box;  // the state slot in `ring`
    const int cslot = kCoef ? w.cpos % p.coef_stages : 0;
    if (kCoef) mbar_wait(cfull + cslot, (w.cpos / p.coef_stages) & 1u);
    mbar_wait(full + slot, (w.pos / p.stages) & 1u);
    if (!kInit) {
      // d' = r + beta d_old over the whole box, in place of r
      float4* const r4 = reinterpret_cast<float4*>(ring + st);
      const float4* const d4 = reinterpret_cast<const float4*>(ring + st + p.box);
      const int hb4 = p.hb / 4;
      for (int e = threadIdx.x; e < hb4; e += kThreads) {
        const float4 rv = r4[e], dv = d4[e];
        float4 v;
        v.x = fadd(rv.x, fmul(beta, dv.x));
        v.y = fadd(rv.y, fmul(beta, dv.y));
        v.z = fadd(rv.z, fmul(beta, dv.z));
        v.w = fadd(rv.w, fmul(beta, dv.w));
        r4[e] = v;
      }
      fence_async_smem();  // the slot is refilled by TMA later
      __syncthreads();
    }
    // node tm of the thread's column; k its index in `o` (resident mode)
    const auto node = [&](int tm, int k) {
      const int gm = m0 + tm;
      const int si = st + (tm + p.pad) * p.bc + tj + p.hc;
      const size_t g = static_cast<size_t>(gm) * p.pitch + gj;
      const float aq = apply_at<kCoef>(
          p, si, cslot * p.cbox + tm * kTileCols + tj, gm, gj);
      if (kInit) {
        const size_t gb = static_cast<size_t>(gm) * p.nh + gj;
        const float r = fsub(__ldg(p.b + gb), aq);
        p.r[g] = r;
        acc += static_cast<double>(r) * r;
        if (kResident) {
          o.r[k] = r;
          o.x[k] = __ldg(p.x0 + gb);
        }
      } else {
        const float dv = ring[si];
        dn[g] = dv;
        if (kResident)
          o.q[k] = aq;
        else
          p.q[g] = aq;
        acc += static_cast<double>(dv) * aq;
      }
    };
    if (gj < p.nh) {
      if constexpr (kResident) {
#pragma unroll
        for (int k = 0; k < kOwn; ++k)
          if (tm0 + k * kRowStep < rows) node(tm0 + k * kRowStep, k);
      } else {
#pragma unroll 1
        for (int tm = tm0; tm < rows; tm += kRowStep) node(tm, 0);
      }
    }
    __syncthreads();  // the slots are free
    ++w.pos;
    if (kCoef) ++w.cpos;
    if (threadIdx.x == 0) {
      if (t + p.stages < w.mine)
        issue_state<kInit>(p, m, w, t + p.stages, dbuf);
      if (kCoef && t + p.coef_stages < w.mine)
        issue_coef(p, m, w, t + p.coef_stages);
    }
  }
  fence_async();  // stores above are read by TMA after the grid barrier
  return acc;
}

// Phase B: x += alpha d', r -= alpha q, one float4 sweep over the padded
// planes (every row starts 128-byte aligned and the zero columns past nh
// stay zero); returns this thread's partial of <r, r> in float64 (exact
// products).  The sweep runs from the planes' ends back, so the d' and q
// that phase A stored last are read first, while the L2 still holds them.
__device__ double sweep_update(const Params& p, const float* dn, float a) {
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t n4 = p.plane / 4;
  const float4* d4 = reinterpret_cast<const float4*>(dn);
  const float4* q4 = reinterpret_cast<const float4*>(p.q);
  float4* x4 = reinterpret_cast<float4*>(p.xw);
  float4* r4 = reinterpret_cast<float4*>(p.r);
  double acc = 0.0;
  for (size_t v = t0; v < n4; v += stride) {
    const size_t u = n4 - 1 - v;
    const float4 d = __ldcg(d4 + u), q = __ldcg(q4 + u);
    float4 x = __ldcg(x4 + u), r = __ldcg(r4 + u);
#define TPCG_UPD(L)                          \
  x.L = fadd(x.L, fmul(a, d.L));             \
  r.L = fsub(r.L, fmul(a, q.L));             \
  acc += static_cast<double>(r.L) * r.L;
    TPCG_UPD(x) TPCG_UPD(y) TPCG_UPD(z) TPCG_UPD(w)
#undef TPCG_UPD
    x4[u] = x;
    r4[u] = r;
  }
  return acc;
}

// Phase B in resident mode: x += alpha d', r -= alpha q on the thread's
// nodes of the block's one tile, in registers; r stored, for the halo boxes
// of the next phase A; returns this thread's partial of <r, r> in float64,
// over its nodes in tile order.  d' is read from the state slot that phase
// A left it in (`pos` slots consumed so far): no copy refills that slot
// before the next phase A but one.
__device__ __forceinline__ double own_update(const Params& p, Own& o,
                                             unsigned pos, float a) {
  const int st = p.sring + ((pos - 1) % p.stages) * 2 * p.box;
  const int tj = threadIdx.x % kTileCols, tm0 = threadIdx.x / kTileCols;
  const int m0 = tile_row0(p, 0), gj = tile_col0(p, 0) + tj;
  const int rows = p.nv - m0 < p.rows ? p.nv - m0 : p.rows;
  double acc = 0.0;
  if (gj < p.nh) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int tm = tm0 + k * kRowStep;
      if (tm < rows) {
        const float dv = ring[st + (tm + p.pad) * p.bc + tj + p.hc];
        o.x[k] = fadd(o.x[k], fmul(a, dv));
        o.r[k] = fsub(o.r[k], fmul(a, o.q[k]));
        acc += static_cast<double>(o.r[k]) * o.r[k];
        p.r[static_cast<size_t>(m0 + tm) * p.pitch + gj] = o.r[k];
      }
    }
  }
  return acc;
}

template <bool kCoef, bool kResident>
__global__ void __launch_bounds__(kThreads,
                                  kResident ? kResidentMinBlocks : kMinBlocks)
    stream_cg_real_kernel(Params p, const __grid_constant__ Maps maps) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[kWarps];
  __shared__ float s_delta, s_alpha, s_beta;
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
  double* const part_rr = p.part + nblocks;
  Own own;  // resident mode only

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full + s);
    if (kCoef)
      for (int s = 0; s < p.coef_stages; ++s) mbar_init(cfull + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // init: x0 copied to the pitch (into xw; in resident mode into the pong
  // d buffer, which iteration 0 overwrites) and d = 0 (the ping buffer,
  // read by iteration 0) on the grid's nodes; then r0 = b - A x0 and the
  // partials of <r0, r0>
  float* const x0w = kResident ? p.d + plane : p.xw;
  for (int row = blockIdx.x; row < nv; row += nblocks)
    for (int j = threadIdx.x; j < nh; j += kThreads) {
      const size_t g = static_cast<size_t>(row) * p.pitch + j;
      x0w[g] = __ldg(p.x0 + static_cast<size_t>(row) * nh + j);
      p.d[g] = 0.f;
    }
  fence_async();
  __syncthreads();  // the mbarriers are initialised
  grid.sync();
  block_partial(phase_apply<kCoef, true, kResident>(p, maps, w, 0, 0.f, own),
                red, part_rr + blockIdx.x);
  grid.sync();
  if (warp == 0) {
    const double t = grid_total(part_rr, nblocks);
    if (lane == 0) {
      s_delta = static_cast<float>(t);
      s_beta = 0.f;
      if (blockIdx.x == 0) p.hist[0] = sqrtf(s_delta);
    }
  }
  __syncthreads();

  for (int it = 0; it < p.n_iterations; ++it) {
    const int d_old = it & 1;  // d_new is the other buffer
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
    block_partial(
        phase_apply<kCoef, false, kResident>(p, maps, w, d_old, s_beta, own),
        red, part_dq + blockIdx.x);
    grid.sync();

    // alpha, bit-identical in every block
    if (warp == 0) {
      const double t = grid_total(part_dq, nblocks);
      if (lane == 0) {
        const float dq = static_cast<float>(t), dl = s_delta;
        const int done = dl == 0.f || dq == 0.f;
        s_done = done;
        s_alpha = done ? 0.f : fdiv(dl, dq);
      }
    }
    __syncthreads();

    // phase B: x += alpha d', r -= alpha q, partials of <r, r>
    const double pr =
        kResident ? own_update(p, own, w.pos, s_alpha)
                  : sweep_update(
                        p, p.d + static_cast<size_t>(d_old ^ 1) * plane,
                        s_alpha);
    fence_async();  // r is read by TMA after the grid barrier
    block_partial(pr, red, part_rr + blockIdx.x);
    grid.sync();

    // beta and the history
    if (warp == 0) {
      const double t = grid_total(part_rr, nblocks);
      if (lane == 0) {
        const float dn = static_cast<float>(t);
        s_beta = s_done ? 0.f : fdiv(dn, s_delta);
        s_delta = dn;
        if (blockIdx.x == 0) p.hist[it + 1] = sqrtf(dn);
      }
    }
    __syncthreads();
  }

  // x = xw on the grid's nodes; in resident mode each thread's own nodes
  if constexpr (kResident) {
    const int tj = threadIdx.x % kTileCols, tm0 = threadIdx.x / kTileCols;
    const int m0 = tile_row0(p, 0), gj = tile_col0(p, 0) + tj;
    const int rows = nv - m0 < p.rows ? nv - m0 : p.rows;
    if (gj < nh) {
#pragma unroll
      for (int k = 0; k < kOwn; ++k)
        if (tm0 + k * kRowStep < rows)
          p.x[static_cast<size_t>(m0 + tm0 + k * kRowStep) * nh + gj] =
              own.x[k];
    }
  } else {
    for (int row = blockIdx.x; row < nv; row += nblocks)
      for (int j = threadIdx.x; j < nh; j += kThreads)
        p.x[static_cast<size_t>(row) * nh + j] =
            __ldcg(p.xw + static_cast<size_t>(row) * p.pitch + j);
  }
}

const void* kernel_of(int coef, int resident) {
  if (coef)
    return reinterpret_cast<const void*>(stream_cg_real_kernel<true, false>);
  if (resident)
    return reinterpret_cast<const void*>(stream_cg_real_kernel<false, true>);
  return reinterpret_cast<const void*>(stream_cg_real_kernel<false, false>);
}

// The tile geometry the caller passes: refuse what the kernel cannot run.
bool geometry_ok(int nv, int nh, int pitch, int pad, int noff, int coef,
                 int resident, int rows, int hc, int stages,
                 int coef_stages) {
  return (!resident || (!coef && rows <= kResidentRows)) && nv >= 1 &&
         nh >= 1 && pad >= 0 && pad <= kMaxPad && noff >= 1 &&
         noff <= kMaxTaps && rows >= 1 && rows + 2 * pad <= kMaxBox &&
         hc >= pad && hc % 4 == 0 && kTileCols + 2 * hc <= kMaxBox &&
         pitch % 32 == 0 && pitch >= nh + pad && stages >= 2 &&
         stages <= kMaxStages &&
         (!coef || (coef_stages >= 1 && coef_stages <= kMaxCoefStages));
}

// The kernel may take the rings' dynamic shared memory (past 48 KB a kernel
// must opt in, before the occupancy query and the launch).  The runtime
// refuses more than the card gives a block beside the kernel's static
// shared memory, so no copy of the card's limit is kept here.
cudaError_t allow_smem(int coef, int resident, size_t bytes) {
  return cudaFuncSetAttribute(kernel_of(coef, resident),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Kernel limits: taps per stencil, largest |offset| component; resident
// mode's tallest tile and blocks an SM.
int tpcg_stream_real_limits(int* max_taps, int* max_pad, int* resident_rows,
                            int* resident_blocks) {
  *max_taps = kMaxTaps;
  *max_pad = kMaxPad;
  *resident_rows = kResidentRows;
  *resident_blocks = kResidentMinBlocks;
  return 0;
}

// Grid size for an (nv, nh) grid in the given mode with the layout of
// tpcg_torch.ops.stream_cg_real.card_layout (pitch, tile rows, box halo
// columns, ring slots) on the current device: one block per tile where the
// card has room, at most `per_sm_cap` blocks per SM, never more than can be
// co-resident (a larger cooperative launch is refused).  Resident mode
// needs one block for every tile: 0 where the card cannot hold them.
int tpcg_stream_real_grid(int nv, int nh, int pitch, int pad, int noff,
                          int coef, int resident, int rows, int hc,
                          int stages, int coef_stages, int per_sm_cap,
                          int* grid_out) {
  if (per_sm_cap < 1 || !geometry_ok(nv, nh, pitch, pad, noff, coef, resident,
                                     rows, hc, stages, coef_stages))
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(rows, pad, hc, noff, coef != 0, stages, coef_stages);
  cudaError_t err = allow_smem(coef, resident, smem);
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
      &per_sm, kernel_of(coef, resident), kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > per_sm_cap) per_sm = per_sm_cap;
  const long long tiles = static_cast<long long>((nv + rows - 1) / rows) *
                          ((nh + kTileCols - 1) / kTileCols);
  const long long held = static_cast<long long>(per_sm) * sms;
  *grid_out = static_cast<int>(tiles <= held ? tiles : resident ? 0 : held);
  return 0;
}

// b, x0, x: (nv, nh) floats; c: coef mode (noff, nv, pitch), the planes
// copied to the pitch; const mode (2, noff, nh) bottom/top strips; r, q, xw:
// (nv, pitch), q and xw null in resident mode; d: (2, nv, pitch); r, q, d
// and xw zero past column nh; hist: n_iterations + 1; part:
// 2 * grid doubles.  offsets: host array of 2 * noff ints (dm, dj), |dm|,
// |dj| <= pad; taps: host array of 3 * noff floats (c, lc, rc; read in const
// mode only); group_of: host array of noff ints, the group of each interior
// tap (-1 for a zero tap), groups numbered in order of first appearance
// (const mode only).  resident, pitch, rows, hc, stages, coef_stages: the
// layout of card_layout; grid: from tpcg_stream_real_grid with the same
// layout (resident mode: one block a tile).
int tpcg_stream_real(const float* b, const float* x0, const float* c,
                     float* x, float* hist, float* r, float* q, float* d,
                     float* xw, double* part, int nv, int nh, int pitch,
                     int noff, const int* offsets, const float* taps,
                     const int* group_of, int coef, int resident, int pad,
                     int rows, int hc, int stages, int coef_stages,
                     int n_iterations, int grid, void* stream) {
  if (n_iterations < 0 || grid < 1 ||
      !geometry_ok(nv, nh, pitch, pad, noff, coef, resident, rows, hc, stages,
                   coef_stages))
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>((nv + rows - 1) / rows) *
                          ((nh + kTileCols - 1) / kTileCols);
  if (resident ? grid != tiles : q == nullptr || xw == nullptr)
    return cudaErrorInvalidValue;
  Params p{};
  p.b = b;
  p.x0 = x0;
  p.strips = coef ? nullptr : c;
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
  p.noff = noff;
  p.pad = pad;
  p.n_iterations = n_iterations;
  p.rows = rows;
  p.hc = hc;
  p.stages = stages;
  p.coef_stages = coef ? coef_stages : 0;
  const Ring g = ring_of(rows, pad, hc, noff, coef != 0);
  p.plane = static_cast<size_t>(nv) * pitch;
  p.bc = g.bc;
  p.hb = g.br * g.bc;
  p.box = g.box;
  p.own = g.own;
  p.cbox = g.cbox;
  p.sring = coef ? coef_stages * g.cbox : 0;
  p.tiles_h = (nh + kTileCols - 1) / kTileCols;
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * g.bc + dj;
  }
  if (!coef) {
    for (int s = 0; s < noff; ++s) {
      if (group_of[s] < -1 || group_of[s] >= noff) return cudaErrorInvalidValue;
      p.lc[s] = taps[noff + s];
      p.rc[s] = taps[2 * noff + s];
    }
    int t = 0;
    for (int gi = 0; gi < noff; ++gi) {
      const int first = t;
      for (int s = 0; s < noff; ++s) {
        if (group_of[s] != gi) continue;
        p.gdisp[t++] = p.disp[s];
      }
      if (t == first) break;
      p.gfirst |= 1u << first;
      p.glast |= 1u << (t - 1);
      for (int s = 0; s < noff; ++s)
        if (group_of[s] == gi) {
          p.gval[t - 1] = taps[s];
          break;
        }
    }
    p.ntaps = t;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps{};
  if (!encode(fn, &maps.r, r, nh, nv, 1, pitch, g.bc, g.br, 1) ||
      !encode(fn, &maps.d, d, nh, nv, 2, pitch, g.bc, g.br, 1) ||
      !encode(fn, &maps.x, resident ? d + p.plane : xw, nh, nv, 1, pitch,
              g.bc, g.br, 1) ||
      (coef && !encode(fn, &maps.c, c, nh, nv, noff, pitch, kTileCols, rows,
                       noff)))
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(rows, pad, hc, noff, coef != 0, stages, coef_stages);
  cudaError_t err = allow_smem(coef, resident, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p, &maps};
  err = cudaLaunchCooperativeKernel(kernel_of(coef, resident), dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
