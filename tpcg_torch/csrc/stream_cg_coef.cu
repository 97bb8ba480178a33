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
//   * tpcg/ops/stream_cg.py::_build_k1_coef_batched_fat and
//     _make_k2_batched_fat: K1 and K2 for nb RHS, one coefficient fetch a
//     row block for all of them.
// Their row blocks, VMEM budgets, keep_r, the 128-row padding of heights
// JAX cannot stream and the nb * Bv * Nh compile cap exist for the TPU:
// this kernel reads any height and width, and the state lives in device
// memory.  The design is csrc/stream_cg_sym.cu's; what is new is the full
// operator and the RHS count NB, a template parameter.
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
// each RHS's state moves ~82 B as in csrc/stream_cg.cu (phase A reads r and
// the old d with a halo and writes d' and q; phase B reads x, d', r, q and
// writes x and r), and the coefficients add noff complex float32 values
// (72 B for a 9-point stencil), read once for all NB RHS: ~82 NB + 8 noff B
// against a floor of 48 NB + 8 noff B (x, r and d read and written once,
// the coefficients read once).  At N = 4096 and NB = 1 the floor is 2.01 GB
// an iteration, 0.60 ms at 3.35 TB/s.
//
// What the design does about it:
//   * two grid barriers per iteration: phase A recomputes d' = r + beta d on
//     its tile's halo from r and the old d (ping-pong d buffers), with the
//     owner's non-contracting float operations, so every block applies A to
//     bit-identical values, stages the NB tiles of d' in shared memory and
//     computes q = A d' and <d', q>; phase B updates x and r and sums
//     <r, r>;
//   * each coefficient c_s(n) is loaded once (__ldg) and applied to all NB
//     staged tiles: the coefficient bytes an RHS pays fall as 8 noff / NB;
//   * the tile is 128 columns wide and 16, 8 or 4 rows high for NB <= 2,
//     <= 4 or <= 8, so that the NB staged tiles (2 planes each, with their
//     halo) take 19-50 KB of shared memory at pad 1 and several blocks fit
//     an SM; past 48 KB (larger pads) the launch opts in;
//   * dot products accumulate in float64 (the float32 products are exact
//     there) and are rounded to float32 once, as the plain version's are:
//     two float32 sum orders of COCG on helm_fe_var part by up to a third of
//     max|x| within 100 iterations, which would leave the kernel no plain
//     version to be held to at full size;
//   * the reduction order is fixed (per thread, warp shuffle, block, then
//     over blocks in block order, the same in every block), so every block
//     derives bit-identical alpha and beta per RHS and reruns agree bit for
//     bit.  The partition depends on the tile and the block count, both set
//     by NB: an RHS of an NB instance need not give an NB = 1 launch's bits;
//   * offsets into the planes are 64-bit (9 planes at N = 4096 hold 151 M
//     values).
// The stencil apply, the updates, the Smith division and the history use
// __fmul_rn / __fadd_rn / __fdiv_rn in the plain version's order, so with
// equal float32 dot products the kernel follows it bit for bit.  TMA
// panels, clusters, keeping q on chip and deferring the x update are the
// ways to cut the ~82 B a node toward the floor; none is in this version.
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
constexpr int kTileCols = 128;
constexpr int kMaxOff = 32;
constexpr int kMaxPad = 8;
constexpr int kMaxRhs = 8;
static_assert(kMaxRhs <= kWarps, "one warp per RHS derives its scalars");

// Tile rows and the launch-bounds occupancy of the NB instance.
template <int NB>
struct Cfg {
  static constexpr int kTileRows = NB <= 2 ? 16 : (NB <= 4 ? 8 : 4);
  static constexpr int kMinBlocks = NB == 1 ? 4 : 2;
};

struct Params {
  const float* b;       // (2 re/im, NB, nv, nh)                    read-only
  const float* x0;      // (2, NB, nv, nh)                          read-only
  const float* c;       // (2 re/im, noff, nv, nh) coefficients     read-only
  float* x;             // (2, NB, nv, nh)                          out
  float* hist;          // (n_iterations + 1, NB)                   out
  float* r;             // (2, NB, nv, nh)                          scratch
  float* q;             // (2, NB, nv, nh)                          scratch
  float* d;             // (2 ping/pong, 2, NB, nv, nh)             scratch
  double* part;         // (2 dq/rr, gridDim.x, NB, 2)              scratch
  int nv, nh, noff, pad, n_iterations;
  int disp[kMaxOff];    // dm * tile pitch + dj: displacement in the tile
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ double2 warp_sum(double2 v) {
  // xor butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Block-wide sums of v[0..NB); warp k stores RHS k's to out[2k..2k+1].
template <int NB>
__device__ void block_partials(double2 (&v)[NB], double2* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const double2 w = warp_sum(v[k]);
    if (lane == 0) red[warp * NB + k] = w;
  }
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

template <int NB>
constexpr size_t smem_bytes(int pad) {
  return static_cast<size_t>(2) * NB * (Cfg<NB>::kTileRows + 2 * pad) *
         (kTileCols + 2 * pad) * sizeof(float);
}

// Phase A over the block's tiles, for all NB RHS.  kInit: stage x0 and form
// r0 = b - A x0, accumulating <r0, r0>.  Otherwise: stage d' = r + beta d_old,
// write d' for the tile's own nodes to d_new and q = A d', accumulating
// <d', q>.  acc[k] receives this thread's partial sum for RHS k.
template <int NB, bool kInit>
__device__ void phase_apply(const Params& p, float* tile, const float* d_old,
                            float* d_new, const float2* beta,
                            double2 (&acc)[NB]) {
  constexpr int TR = Cfg<NB>::kTileRows;
  const int nv = p.nv, nh = p.nh, P = p.pad;
  const size_t n = static_cast<size_t>(nv) * nh;
  const int ph = kTileCols + 2 * P, hr = TR + 2 * P;
  const int tlen = hr * ph;
  const int tiles_h = (nh + kTileCols - 1) / kTileCols;
  const int ntiles = ((nv + TR - 1) / TR) * tiles_h;
  const float* cre = p.c;
  const float* cim = p.c + static_cast<size_t>(p.noff) * n;
#pragma unroll
  for (int k = 0; k < NB; ++k) acc[k] = make_double2(0.0, 0.0);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int m0 = (t / tiles_h) * TR;
    const int j0 = (t % tiles_h) * kTileCols;
    for (int i = threadIdx.x; i < tlen; i += kThreads) {
      const int lm = i / ph, lj = i - lm * ph;
      const int gm = m0 + lm - P, gj = j0 + lj - P;
      const bool inside = gm >= 0 && gm < nv && gj >= 0 && gj < nh;
      const bool own = lm >= P && lm < P + TR && lj >= P && lj < P + kTileCols;
      const size_t e = inside ? static_cast<size_t>(gm) * nh + gj : 0;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const size_t ere = static_cast<size_t>(k) * n + e;
        const size_t eim = static_cast<size_t>(NB + k) * n + e;
        float vr = 0.f, vi = 0.f;
        if (inside) {
          if (kInit) {
            vr = __ldg(p.x0 + ere);
            vi = __ldg(p.x0 + eim);
          } else {
            const float rr = __ldcg(p.r + ere), ri = __ldcg(p.r + eim);
            const float dr = __ldcg(d_old + ere), di = __ldcg(d_old + eim);
            vr = fsub(fadd(rr, fmul(beta[k].x, dr)), fmul(beta[k].y, di));
            vi = fadd(fadd(ri, fmul(beta[k].x, di)), fmul(beta[k].y, dr));
            if (own) {
              d_new[ere] = vr;
              d_new[eim] = vi;
            }
          }
        }
        tile[(2 * k) * tlen + i] = vr;
        tile[(2 * k + 1) * tlen + i] = vi;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TR * kTileCols; i += kThreads) {
      const int tm = i / kTileCols, tj = i - tm * kTileCols;
      const int gm = m0 + tm, gj = j0 + tj;
      if (gm >= nv || gj >= nh) continue;
      const int c = (tm + P) * ph + tj + P;
      const size_t e = static_cast<size_t>(gm) * nh + gj;
      float qr[NB], qi[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) qr[k] = qi[k] = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxOff; ++s) {
        if (s >= p.noff) break;
        // one load of c_s(n), applied to every RHS's d'(n + s)
        const size_t ps = static_cast<size_t>(s) * n + e;
        const float car = __ldg(cre + ps), cai = __ldg(cim + ps);
        const int at = c + p.disp[s];
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const float xr = tile[(2 * k) * tlen + at];
          const float xi = tile[(2 * k + 1) * tlen + at];
          qr[k] = fsub(fadd(qr[k], fmul(car, xr)), fmul(cai, xi));
          qi[k] = fadd(fadd(qi[k], fmul(car, xi)), fmul(cai, xr));
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const size_t ere = static_cast<size_t>(k) * n + e;
        const size_t eim = static_cast<size_t>(NB + k) * n + e;
        if (kInit) {
          const float rr = fsub(__ldg(p.b + ere), qr[k]);
          const float ri = fsub(__ldg(p.b + eim), qi[k]);
          p.r[ere] = rr;
          p.r[eim] = ri;
          acc[k].x += static_cast<double>(rr) * rr -
                      static_cast<double>(ri) * ri;
          acc[k].y += static_cast<double>(rr) * ri;
        } else {
          p.q[ere] = qr[k];
          p.q[eim] = qi[k];
          const double dr = tile[(2 * k) * tlen + c];
          const double di = tile[(2 * k + 1) * tlen + c];
          acc[k].x += dr * qr[k] - di * qi[k];
          acc[k].y += dr * qi[k] + di * qr[k];
        }
      }
    }
    __syncthreads();
  }
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

// Phase B for one RHS: x += alpha d', r -= alpha q over its n nodes (re
// planes at *re, im planes n further on); returns this thread's partial of
// (sum rr^2 - ri^2, sum rr ri).
__device__ double2 sweep_update(const float* dn, const float* q, float* x,
                                float* r, size_t im, size_t n, float2 a) {
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  double2 acc = make_double2(0.0, 0.0);
  if ((n & 3) == 0) {
    // float4 sweep: every plane starts 16-byte aligned when n is a multiple
    // of 4 (the buffers are the wrapper's own allocations)
    const size_t n4 = n / 4, im4 = im / 4;
    const float4* d4 = reinterpret_cast<const float4*>(dn);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    float4* x4 = reinterpret_cast<float4*>(x);
    float4* r4 = reinterpret_cast<float4*>(r);
    for (size_t v = t0; v < n4; v += stride) {
      const float4 dr = __ldcg(d4 + v), di = __ldcg(d4 + im4 + v);
      const float4 qr = __ldcg(q4 + v), qi = __ldcg(q4 + im4 + v);
      float4 xr = __ldcg(x4 + v), xi = __ldcg(x4 + im4 + v);
      float4 rr = __ldcg(r4 + v), ri = __ldcg(r4 + im4 + v);
      double2 t;
      t = update_node(a, dr.x, di.x, qr.x, qi.x, xr.x, xi.x, rr.x, ri.x);
      acc.x += t.x; acc.y += t.y;
      t = update_node(a, dr.y, di.y, qr.y, qi.y, xr.y, xi.y, rr.y, ri.y);
      acc.x += t.x; acc.y += t.y;
      t = update_node(a, dr.z, di.z, qr.z, qi.z, xr.z, xi.z, rr.z, ri.z);
      acc.x += t.x; acc.y += t.y;
      t = update_node(a, dr.w, di.w, qr.w, qi.w, xr.w, xi.w, rr.w, ri.w);
      acc.x += t.x; acc.y += t.y;
      x4[v] = xr;
      x4[im4 + v] = xi;
      r4[v] = rr;
      r4[im4 + v] = ri;
    }
    return acc;
  }
  for (size_t e = t0; e < n; e += stride) {
    float xr = __ldcg(x + e), xi = __ldcg(x + im + e);
    float rr = __ldcg(r + e), ri = __ldcg(r + im + e);
    const double2 t = update_node(a, __ldcg(dn + e), __ldcg(dn + im + e),
                                 __ldcg(q + e), __ldcg(q + im + e), xr, xi, rr,
                                 ri);
    acc.x += t.x;
    acc.y += t.y;
    x[e] = xr;
    x[im + e] = xi;
    r[e] = rr;
    r[im + e] = ri;
  }
  return acc;
}

template <int NB>
__global__ void __launch_bounds__(kThreads, Cfg<NB>::kMinBlocks)
    stream_cg_coef_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float tile[];
  __shared__ double2 red[kWarps * NB];
  __shared__ float2 s_delta[NB], s_alpha[NB], s_beta[NB];
  __shared__ int s_done[NB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t state = 2 * static_cast<size_t>(NB) * n;  // one state array
  const size_t im = static_cast<size_t>(NB) * n;         // re -> im plane
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(nblocks) * kThreads;
  double* const part_dq = p.part;
  double* const part_rr = p.part + 2 * static_cast<size_t>(nblocks) * NB;
  double* const mine_dq = part_dq + 2 * static_cast<size_t>(blockIdx.x) * NB;
  double* const mine_rr = part_rr + 2 * static_cast<size_t>(blockIdx.x) * NB;
  const float2 zero = make_float2(0.f, 0.f);
  double2 acc[NB];

  // init: x = x0, d = 0 (the ping buffer, read by iteration 0),
  // r0 = b - A x0 and the partials of <r0, r0>.
  for (size_t e = t0; e < state; e += stride) {
    p.x[e] = __ldg(p.x0 + e);
    p.d[e] = 0.f;
  }
  phase_apply<NB, true>(p, tile, nullptr, nullptr, s_beta, acc);
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
    const float* d_old = p.d + static_cast<size_t>(it & 1) * state;
    float* d_new = p.d + static_cast<size_t>((it + 1) & 1) * state;
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
    phase_apply<NB, false>(p, tile, d_old, d_new, s_beta, acc);
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

    // phase B: x += alpha d', r -= alpha q, partials of <r, r>
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const size_t o = static_cast<size_t>(k) * n;
      acc[k] = sweep_update(d_new + o, p.q + o, p.x + o, p.r + o, im, n,
                            s_alpha[k]);
    }
    block_partials<NB>(acc, red, mine_rr);
    grid.sync();

    // beta and the history per RHS
    if (warp < NB) {
      const double2 t = grid_total<NB>(part_rr, nblocks, warp);
      if (lane == 0) {
        const float2 dn = delta_of(t);
        const float2 dl = s_delta[warp];
        s_beta[warp] = s_done[warp] ? zero : cdiv_smith(dn.x, dn.y, dl.x, dl.y);
        s_delta[warp] = dn;
        if (blockIdx.x == 0) p.hist[(it + 1) * NB + warp] = hist_of(dn);
      }
    }
    __syncthreads();
  }
}

// Largest dynamic shared memory a block may opt in to on sm_90, less the
// static shared memory of the largest instance.
constexpr size_t kSmemCap = 232448 - 2048;
static_assert(smem_bytes<1>(kMaxPad) <= kSmemCap, "NB=1 tile past the cap");
static_assert(smem_bytes<2>(kMaxPad) <= kSmemCap, "NB=2 tiles past the cap");
static_assert(smem_bytes<4>(kMaxPad) <= kSmemCap, "NB=4 tiles past the cap");
static_assert(smem_bytes<8>(kMaxPad) <= kSmemCap, "NB=8 tiles past the cap");

// Allow the instance its dynamic shared memory at this pad (needed past
// 48 KB), then return it.
template <int NB>
cudaError_t allow_smem(int pad, size_t* smem) {
  *smem = smem_bytes<NB>(pad);
  return cudaFuncSetAttribute(stream_cg_coef_kernel<NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// Grid size of the NB instance for an (nv, nh) grid on the current device:
// one block per tile where the card has room, at most kBlocksPerSm blocks
// per SM, never more than can be co-resident (a larger cooperative launch
// is refused).
template <int NB>
int grid_for(int nv, int nh, int pad, int* grid_out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  size_t smem = 0;
  err = allow_smem<NB>(pad, &smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_cg_coef_kernel<NB>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  constexpr int TR = Cfg<NB>::kTileRows;
  const long long tiles = static_cast<long long>((nv + TR - 1) / TR) *
                          ((nh + kTileCols - 1) / kTileCols);
  long long g = tiles;
  if (g > static_cast<long long>(per_sm) * sms) g = per_sm * sms;
  *grid_out = g < 1 ? 1 : static_cast<int>(g);
  return 0;
}

template <int NB>
int launch(Params& p, int grid, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = allow_smem<NB>(p.pad, &smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stream_cg_coef_kernel<NB>), dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// Grid size for nb RHS on an (nv, nh) grid (see grid_for).
int tpcg_stream_coef_grid(int nb, int nv, int nh, int pad, int* grid_out) {
  if (nv < 1 || nh < 1 || pad < 0 || pad > kMaxPad) return cudaErrorInvalidValue;
  switch (nb) {
    case 1: return grid_for<1>(nv, nh, pad, grid_out);
    case 2: return grid_for<2>(nv, nh, pad, grid_out);
    case 3: return grid_for<3>(nv, nh, pad, grid_out);
    case 4: return grid_for<4>(nv, nh, pad, grid_out);
    case 5: return grid_for<5>(nv, nh, pad, grid_out);
    case 6: return grid_for<6>(nv, nh, pad, grid_out);
    case 7: return grid_for<7>(nv, nh, pad, grid_out);
    case 8: return grid_for<8>(nv, nh, pad, grid_out);
    default: return cudaErrorInvalidValue;
  }
}

// b, x0, x, r, q: (2, nb, nv, nh) floats; c: (2, noff, nv, nh); d:
// (2, 2, nb, nv, nh); hist: (n_iterations + 1, nb); part: 4 * grid * nb
// doubles.  offsets: host array of 2 * noff ints (dm, dj), |dm|, |dj| <= pad.
// grid: from tpcg_stream_coef_grid with the same nb, nv, nh and pad.
int tpcg_stream_coef(const float* b, const float* x0, const float* c, float* x,
                     float* hist, float* r, float* q, float* d, double* part,
                     int nb, int nv, int nh, int noff, const int* offsets,
                     int pad, int n_iterations, int grid, void* stream) {
  if (nv < 1 || nh < 1 || noff < 1 || noff > kMaxOff || pad < 0 ||
      pad > kMaxPad || n_iterations < 0 || grid < 1 || nb < 1 ||
      nb > kMaxRhs)
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
  p.part = part;
  p.nv = nv;
  p.nh = nh;
  p.noff = noff;
  p.pad = pad;
  p.n_iterations = n_iterations;
  for (int s = 0; s < kMaxOff; ++s) p.disp[s] = 0;
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * (kTileCols + 2 * pad) + dj;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 1: return launch<1>(p, grid, st);
    case 2: return launch<2>(p, grid, st);
    case 3: return launch<3>(p, grid, st);
    case 4: return launch<4>(p, grid, st);
    case 5: return launch<5>(p, grid, st);
    case 6: return launch<6>(p, grid, st);
    case 7: return launch<7>(p, grid, st);
    default: return launch<8>(p, grid, st);
  }
}

}  // extern "C"
