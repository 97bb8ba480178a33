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
// here: Hopper reads any width, and the state lives in device memory.
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
// What bounds it on the H100: device-memory bytes.  At N = 4096 the five
// complex fields (b, x, r, d, q; float32 re/im planes) take 670 MB a RHS,
// far past the 50 MB L2, so every iteration streams the state from HBM.
// This design moves per node, RHS and iteration: phase A reads r and the
// old d (8 B each, plus a halo of 2 rows and 2 columns per 16 x 128 tile,
// ~14%) and writes the new d and q (8 B each), ~34 B; phase B reads x, d, r,
// q and writes x and r, 48 B: ~82 B, against the 48 B that reading and
// writing x, r and d once would need.  Up to N = 1024 one RHS's state
// (~42 MB) nearly fits the L2 and the two grid barriers per iteration weigh
// in; several RHS in a launch pay those barriers once an iteration, and
// their states together no longer fit the L2.  On an H100 80GB HBM3 at
// 700 W a shared launch was 2-9% faster per RHS-iteration than one launch
// a RHS from 1448^2 to 2500^2 nodes, and 5-16% slower at 1024^2 (the L2)
// and 1-2% slower at 4096^2 (PERF.md, PR 9); the planner batches only
// where it won (tpcg_torch/ops/auto.py::_stream_chunk).
//
// What the design does about it:
//   * two grid barriers per iteration for all NB RHS, not three per RHS:
//     phase A recomputes the new direction d' = r + beta d on its tile's
//     halo from r and the old d (a ping-pong pair of d buffers), as v2 and
//     v4 do, instead of waiting on a barrier after the d update.  The halo
//     copies are computed by the same non-contracting float operations
//     (__fmul_rn, __fadd_rn) as the owner's, so every block applies A to
//     bit-identical values;
//   * phase A stages d' for a tile and its halo in shared memory, so each
//     node's 7 taps read shared memory and each of r and d is read from
//     device memory about once; phase B is a flat, vectorised sweep;
//   * within each phase a block runs the RHS one after another, each over
//     the same tiles (phase A) or nodes (phase B) in the same order as a
//     one-RHS launch, on one halo tile of shared memory; the grid is the
//     one-RHS grid whatever NB.  So each RHS's dot products are cut into
//     the same partial sums and every RHS of an NB launch gives the bits of
//     its own NB = 1 launch: a batch may be chunked freely.  Staging all NB
//     tiles at once (fewer tile rows as NB grows) would change the tiles,
//     the grid and so the bits, and would spend registers and shared memory
//     that the one-RHS kernel uses to keep 4 blocks an SM in flight;
//   * taps and edge taps are kernel parameters; strips, b and x0 go through
//     the read-only path; state that other blocks write is read with __ldcg
//     (L2, coherent) after a grid barrier;
//   * dot products reduce in a fixed order (per thread, warp shuffle, block,
//     then over blocks in block order, the same in every block), so every
//     block derives bit-identical alpha and beta and reruns agree bit for
//     bit;
//   * offsets into the planes are 64-bit (N = 4096 has 16.8 M nodes a
//     plane; b, x0 and x of a batch are (2, B, nv, nh) planes, so a RHS's
//     imaginary plane lies B planes past its real one).
// The stencil apply uses the same non-contracting operations in the order
// of the plain version, so A d' agrees with it bit for bit on equal inputs;
// only the reductions' order differs.  wgmma and TMA have no place in this
// first version: there is no matrix product, and TMA panels, clusters and
// keeping q on chip are the ways to cut the 82 B per node toward 48 B.
//
// Numerics: build without --use_fast_math (flush-to-zero and approximate
// division would move the freeze guard and the Smith division).  Plain C
// interface, loaded with ctypes (tpcg_torch/ops/_build.py); every entry
// point returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdlib>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kTileRows = 16;
constexpr int kTileCols = 128;
constexpr int kMaxTaps = 16;
constexpr int kMaxPad = 8;
constexpr int kMaxRhs = 8;  // one warp a RHS for the scalar steps
static_assert(kMaxRhs <= kWarps, "one warp a RHS");

struct Params {
  const float* b;       // (2, B, nv, nh); RHS c at c * n, im cs further  read-only
  const float* x0;      // as b                                          read-only
  const float* strips;  // (2 bottom/top, 2 re/im, noff, nh)             read-only
  float* x;             // as b                                          out
  float* hist;          // (n_iterations + 1, NB)                        out
  float* r;             // (NB, 2, nv, nh)                               scratch
  float* q;             // (NB, 2, nv, nh)                               scratch
  float* d;             // (2 ping/pong, NB, 2, nv, nh)                  scratch
  float* part;          // (2 dq/rr, NB, gridDim.x, 2)                   scratch
  size_t cs;            // elements from a RHS's real plane of b, x0, x to its
                        // imaginary one (B * nv * nh)
  int nv, nh, noff, pad, n_iterations;
  int disp[kMaxTaps];   // tap displacement in the shared tile
  float cr[kMaxTaps], ci[kMaxTaps];    // interior taps
  float lr[kMaxTaps], li[kMaxTaps];    // left edge taps (column 0)
  float rr[kMaxTaps], ri[kMaxTaps];    // right edge taps (column nh - 1)
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

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

// (A v) at node (m, j); sr / si point at the node in the shared tile.
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

// One RHS's planes: b, x0 and x with their imaginary plane p.cs further,
// the state (r, q, the two d buffers) with it n further.
struct Rhs {
  const float* b;
  const float* x0;
  float* x;
  float* r;
  float* q;
};

__device__ __forceinline__ Rhs rhs_of(const Params& p, int c) {
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t io = static_cast<size_t>(c) * n, st = 2 * io;
  return Rhs{p.b + io, p.x0 + io, p.x + io, p.r + st, p.q + st};
}

// Phase A over the block's tiles for one RHS.  kInit: stage x0 and form
// r0 = b - A x0, accumulating <r0, r0>.  Otherwise: stage d' = r + beta
// d_old, write d' for the tile's own nodes to d_new and q = A d',
// accumulating <d', q>.  Returns this thread's partial sum.
template <bool kInit>
__device__ float2 phase_apply(const Params& p, const Rhs& v, float* s_re,
                              float* s_im, const float* d_old, float* d_new,
                              float2 beta) {
  const int nv = p.nv, nh = p.nh, P = p.pad;
  const size_t n = static_cast<size_t>(nv) * nh, cs = p.cs;
  const int ph = kTileCols + 2 * P, hr = kTileRows + 2 * P;
  const int tiles_h = (nh + kTileCols - 1) / kTileCols;
  const int ntiles = ((nv + kTileRows - 1) / kTileRows) * tiles_h;
  float2 acc = make_float2(0.f, 0.f);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_h) * kTileRows;
    const int j0 = (tile % tiles_h) * kTileCols;
    for (int k = threadIdx.x; k < hr * ph; k += kThreads) {
      const int lm = k / ph, lj = k - lm * ph;
      const int gm = m0 + lm - P, gj = j0 + lj - P;
      float vr = 0.f, vi = 0.f;
      if (gm >= 0 && gm < nv && gj >= 0 && gj < nh) {
        const size_t e = static_cast<size_t>(gm) * nh + gj;
        if (kInit) {
          vr = __ldg(v.x0 + e);
          vi = __ldg(v.x0 + cs + e);
        } else {
          const float rr = __ldcg(v.r + e), ri = __ldcg(v.r + n + e);
          const float dr = __ldcg(d_old + e), di = __ldcg(d_old + n + e);
          vr = fsub(fadd(rr, fmul(beta.x, dr)), fmul(beta.y, di));
          vi = fadd(fadd(ri, fmul(beta.x, di)), fmul(beta.y, dr));
          if (lm >= P && lm < P + kTileRows && lj >= P && lj < P + kTileCols) {
            d_new[e] = vr;
            d_new[n + e] = vi;
          }
        }
      }
      s_re[k] = vr;
      s_im[k] = vi;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kTileRows * kTileCols; k += kThreads) {
      const int tm = k / kTileCols, tj = k - tm * kTileCols;
      const int gm = m0 + tm, gj = j0 + tj;
      if (gm >= nv || gj >= nh) continue;
      const int c = (tm + P) * ph + tj + P;
      const float2 aq = apply_at(p, s_re + c, s_im + c, gm, gj);
      const size_t e = static_cast<size_t>(gm) * nh + gj;
      if (kInit) {
        const float rr = fsub(__ldg(v.b + e), aq.x);
        const float ri = fsub(__ldg(v.b + cs + e), aq.y);
        v.r[e] = rr;
        v.r[n + e] = ri;
        acc.x += rr * rr - ri * ri;
        acc.y += rr * ri;
      } else {
        v.q[e] = aq.x;
        v.q[n + e] = aq.y;
        const float dr = s_re[c], di = s_im[c];
        acc.x += dr * aq.x - di * aq.y;
        acc.y += dr * aq.y + di * aq.x;
      }
    }
    __syncthreads();
  }
  return acc;
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

// Phase B for one RHS: x += alpha d', r -= alpha q over all nodes; returns
// this thread's partial of (sum rr^2 - ri^2, sum rr ri).
__device__ float2 phase_update(const Params& p, const Rhs& v, const float* dn,
                               float2 a) {
  const size_t n = static_cast<size_t>(p.nv) * p.nh, cs = p.cs;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  float2 acc = make_float2(0.f, 0.f);
  if ((n & 3) == 0 && (cs & 3) == 0) {
    // float4 sweep: every plane starts 16-byte aligned when n (and so cs)
    // is a multiple of 4
    const size_t n4 = n / 4, cs4 = cs / 4;
    const float4* d4 = reinterpret_cast<const float4*>(dn);
    const float4* q4 = reinterpret_cast<const float4*>(v.q);
    float4* x4 = reinterpret_cast<float4*>(v.x);
    float4* r4 = reinterpret_cast<float4*>(v.r);
    for (size_t e = t0; e < n4; e += stride) {
      const float4 dr = __ldcg(d4 + e), di = __ldcg(d4 + n4 + e);
      const float4 qr = __ldcg(q4 + e), qi = __ldcg(q4 + n4 + e);
      float4 xr = __ldcg(x4 + e), xi = __ldcg(x4 + cs4 + e);
      float4 rr = __ldcg(r4 + e), ri = __ldcg(r4 + n4 + e);
      float2 t;
      t = update_node(a, dr.x, di.x, qr.x, qi.x, xr.x, xi.x, rr.x, ri.x);
      acc.x += t.x; acc.y += t.y;
      t = update_node(a, dr.y, di.y, qr.y, qi.y, xr.y, xi.y, rr.y, ri.y);
      acc.x += t.x; acc.y += t.y;
      t = update_node(a, dr.z, di.z, qr.z, qi.z, xr.z, xi.z, rr.z, ri.z);
      acc.x += t.x; acc.y += t.y;
      t = update_node(a, dr.w, di.w, qr.w, qi.w, xr.w, xi.w, rr.w, ri.w);
      acc.x += t.x; acc.y += t.y;
      x4[e] = xr;
      x4[cs4 + e] = xi;
      r4[e] = rr;
      r4[n4 + e] = ri;
    }
    return acc;
  }
  for (size_t e = t0; e < n; e += stride) {
    float xr = __ldcg(v.x + e), xi = __ldcg(v.x + cs + e);
    float rr = __ldcg(v.r + e), ri = __ldcg(v.r + n + e);
    const float2 t = update_node(a, __ldcg(dn + e), __ldcg(dn + n + e),
                                 __ldcg(v.q + e), __ldcg(v.q + n + e), xr, xi,
                                 rr, ri);
    acc.x += t.x;
    acc.y += t.y;
    v.x[e] = xr;
    v.x[cs + e] = xi;
    v.r[e] = rr;
    v.r[n + e] = ri;
  }
  return acc;
}

template <int NB>
__global__ void __launch_bounds__(kThreads) stream_cg_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float tile[];
  __shared__ float2 red[kWarps];
  __shared__ float2 s_delta[NB], s_alpha[NB], s_beta[NB];
  __shared__ int s_done[NB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(nblocks) * kThreads;
  const int tile_len = (kTileRows + 2 * p.pad) * (kTileCols + 2 * p.pad);
  float* const s_re = tile;
  float* const s_im = tile + tile_len;
  // partials of RHS c: <d', q> at part_dq(c), <r, r> at part_rr(c); this
  // block's pair at + 2 blockIdx.x
  const size_t pstride = 2 * static_cast<size_t>(nblocks);
  float* const part_dq = p.part;
  float* const part_rr = p.part + NB * pstride;
  const size_t mine = 2 * static_cast<size_t>(blockIdx.x);
  const size_t dstride = NB * 2 * n;  // one d buffer of all NB RHS
  const float2 zero = make_float2(0.f, 0.f);

  // init: x = x0, d = 0 (the ping buffer, read by iteration 0),
  // r0 = b - A x0 and the partials of <r0, r0>.
#pragma unroll 1
  for (int c = 0; c < NB; ++c) {
    const Rhs v = rhs_of(p, c);
    float* const dc = p.d + static_cast<size_t>(c) * 2 * n;
    for (size_t e = t0; e < n; e += stride) {
      v.x[e] = __ldg(v.x0 + e);
      v.x[p.cs + e] = __ldg(v.x0 + p.cs + e);
      dc[e] = 0.f;
      dc[n + e] = 0.f;
    }
    block_partial(phase_apply<true>(p, v, s_re, s_im, nullptr, nullptr, zero),
                  red, part_rr + c * pstride + mine);
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
    const float* d_old = p.d + static_cast<size_t>(it & 1) * dstride;
    float* d_new = p.d + static_cast<size_t>((it + 1) & 1) * dstride;
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
#pragma unroll 1
    for (int c = 0; c < NB; ++c) {
      const size_t dc = static_cast<size_t>(c) * 2 * n;
      block_partial(phase_apply<false>(p, rhs_of(p, c), s_re, s_im,
                                       d_old + dc, d_new + dc, s_beta[c]),
                    red, part_dq + c * pstride + mine);
    }
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

    // phase B: x += alpha d', r -= alpha q, partials of <r, r>
#pragma unroll 1
    for (int c = 0; c < NB; ++c) {
      const float2 pr = phase_update(p, rhs_of(p, c),
                                     d_new + static_cast<size_t>(c) * 2 * n,
                                     s_alpha[c]);
      block_partial(pr, red, part_rr + c * pstride + mine);
    }
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
}

// Dynamic shared memory: the re and im planes of one halo tile (at most
// 36,864 bytes, under the 48 KB a launch may take without opting in).
constexpr size_t smem_bytes(int pad) {
  return static_cast<size_t>(2) * (kTileRows + 2 * pad) *
         (kTileCols + 2 * pad) * sizeof(float);
}
static_assert(smem_bytes(kMaxPad) <= 48 * 1024, "halo tile past 48 KB");

using Kernel = void (*)(Params);

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

}  // namespace

extern "C" {

// Kernel limits: taps per stencil, largest |offset| component, RHS a launch.
int tpcg_stream_cg_limits(int* max_taps, int* max_pad, int* max_rhs) {
  *max_taps = kMaxTaps;
  *max_pad = kMaxPad;
  *max_rhs = kMaxRhs;
  return 0;
}

// Grid size of an nb-RHS launch on an (nv, nh) grid on the current device:
// the one-RHS instance's grid, one block per 16 x 128 tile where the card
// has room, at most kBlocksPerSm blocks per SM, never more than can be
// co-resident (a larger cooperative launch is refused).  Every nb gets the
// same grid, so a RHS's partial sums, and bits, do not depend on nb; an
// instance that cannot hold that grid on the card is refused.
int tpcg_stream_cg_grid(int nb, int nv, int nh, int pad, int* grid_out) {
  const Kernel k = kernel_for(nb);
  if (k == nullptr || nv < 1 || nh < 1 || pad < 0 || pad > kMaxPad)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, coop = 0, per_sm = 0, per_sm_nb = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_cg_kernel<1>, kThreads, smem_bytes(pad));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long tiles =
      static_cast<long long>((nv + kTileRows - 1) / kTileRows) *
      ((nh + kTileCols - 1) / kTileCols);
  long long g = tiles;
  if (g > static_cast<long long>(per_sm) * sms) g = per_sm * sms;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_nb, k, kThreads,
                                                      smem_bytes(pad));
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(per_sm_nb) * sms < g)
    return cudaErrorCooperativeLaunchTooLarge;
  *grid_out = g < 1 ? 1 : static_cast<int>(g);
  return 0;
}

// b, x0, x: nb RHS of (2, B, nv, nh) float planes, RHS c's real plane at
// c * nv * nh and its imaginary one cs further (cs = B * nv * nh, B >= nb);
// strips: (2, 2, noff, nh); r, q: (nb, 2, nv, nh); d: (2, nb, 2, nv, nh);
// hist: (n_iterations + 1, nb); part: 4 * nb * grid.  offsets: host array
// of 2 * noff ints (dm, dj), |dm|, |dj| <= pad; taps: host array of
// 6 * noff floats (cr, ci, lcr, lci, rcr, rci).  grid: from
// tpcg_stream_cg_grid.
int tpcg_stream_cg(const float* b, const float* x0, const float* strips,
                   float* x, float* hist, float* r, float* q, float* d,
                   float* part, int nb, long long cs, int nv, int nh,
                   int noff, const int* offsets, const float* taps, int pad,
                   int n_iterations, int grid, void* stream) {
  const Kernel k = kernel_for(nb);
  if (k == nullptr || nv < 1 || nh < 1 || noff < 1 || noff > kMaxTaps ||
      pad < 0 || pad > kMaxPad || n_iterations < 0 || grid < 1 ||
      cs < static_cast<long long>(nb) * nv * nh)
    return cudaErrorInvalidValue;
  Params p;
  p.b = b;
  p.x0 = x0;
  p.strips = strips;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.q = q;
  p.d = d;
  p.part = part;
  p.cs = static_cast<size_t>(cs);
  p.nv = nv;
  p.nh = nh;
  p.noff = noff;
  p.pad = pad;
  p.n_iterations = n_iterations;
  for (int s = 0; s < kMaxTaps; ++s) {
    p.disp[s] = 0;
    p.cr[s] = p.ci[s] = p.lr[s] = p.li[s] = p.rr[s] = p.ri[s] = 0.f;
  }
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * (kTileCols + 2 * pad) + dj;
    p.cr[s] = taps[s];
    p.ci[s] = taps[noff + s];
    p.lr[s] = taps[2 * noff + s];
    p.li[s] = taps[3 * noff + s];
    p.rr[s] = taps[4 * noff + s];
    p.ri[s] = taps[5 * noff + s];
  }
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k), dim3(grid), dim3(kThreads), args,
      smem_bytes(pad), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
