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
// Their VMEM budgets, row blocks, q modes, 128-lane padding and the planner's
// row padding of awkward heights have no purpose here: Hopper reads any
// height and width, and the state lives in device memory.  The design is
// that of csrc/stream_cg.cu on one plane, with csrc/stream_cg_sym.cu's
// float64 dot sums.
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
// What bounds it on the H100: device-memory bytes.  At N = 4096 the five
// fields (b, x, r, d, q) take 336 MB, far past the 50 MB L2.  Per node and
// iteration phase A reads r and the old d (4 B each, plus a halo of 2 rows
// and 2 columns per 16 x 128 tile, ~14%) and writes d' and q (4 B each),
// ~17 B; phase B reads x, d', r, q and writes x and r, 24 B: ~41 B against
// the 24 B that reading and writing x, r and d once would need.  Coef mode
// adds 4 B per tap (20 B for the 5-point Poisson stencil, 28 B for the
// 7-point FE stencil).  Up to N = 1024 (~21 MB of state) the state fits the
// L2 and the two grid barriers per iteration set the pace.
//
// What the design does about it:
//   * two grid barriers per iteration, not three: phase A recomputes the new
//     direction d' = r + beta d on its tile's halo from r and the old d (a
//     ping-pong pair of d buffers), with the same non-contracting float
//     operations (__fmul_rn, __fadd_rn) as the owner, so every block applies
//     A to bit-identical values;
//   * phase A stages d' for a 16 x 128 tile and its halo in shared memory
//     (9.4 KB at pad 1), so each node's taps read shared memory; phase B is
//     a flat, vectorised sweep;
//   * const mode takes the interior taps, the edge taps and the equal-tap
//     groups as kernel parameters and reads the strips through __ldg only on
//     rows 0 and nv-1; coef mode streams the planes through __ldg;
//   * dot products accumulate in float64 (the float32 products are exact
//     there) and are rounded to float32 once, as the plain version's are, so
//     both nearly always round to the same alpha and beta; the reduction
//     order is fixed (per thread, warp shuffle, block, then over blocks in
//     block order, the same in every block), so every block derives
//     bit-identical scalars and reruns agree bit for bit;
//   * __launch_bounds__(256, 4): four blocks an SM (csrc/stream_cg_sym.cu
//     found the cap worth 8-24%);
//   * offsets into the planes are 64-bit (N = 4096 has 16.8 M nodes).
// The stencil apply, the updates and the divisions use non-contracting
// operations (__fmul_rn, __fadd_rn, __fdiv_rn) in the order of the plain
// version, so with equal float32 dot products the kernel follows it bit for
// bit.  TMA panels, clusters, q kept on chip and deferring the x update
// (JAX's qx) are the ways to cut the ~41 B toward 24 B; none is in this first
// version.
//
// Numerics: build without --use_fast_math.  Plain C interface, loaded with
// ctypes (tpcg_torch/ops/_build.py); every entry point returns a cudaError_t
// as int.

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

struct Params {
  const float* b;       // (nv, nh)                                 read-only
  const float* x0;      // (nv, nh)                                 read-only
  const float* c;       // coef: (noff, nv, nh) planes; const: (2 bottom/top,
                        // noff, nh) strips                         read-only
  float* x;             // (nv, nh)                                 out
  float* hist;          // (n_iterations + 1)                       out
  float* r;             // (nv, nh)                                 scratch
  float* q;             // (nv, nh)                                 scratch
  float* d;             // (2 ping/pong, nv, nh)                    scratch
  double* part;         // (2 dq/rr, gridDim.x)                     scratch
  int nv, nh, noff, pad, n_iterations;
  int disp[kMaxTaps];   // tap displacement in the shared tile
  // const mode: group g holds the taps at gdisp[group_end[g - 1]] ..
  // gdisp[group_end[g] - 1], value gval[g]; lc / rc the edge taps
  int ngroups;
  int group_end[kMaxTaps];
  int gdisp[kMaxTaps];
  float gval[kMaxTaps];
  float lc[kMaxTaps], rc[kMaxTaps];
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

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

// sum over the taps of e_s v(n + s), from 0 in tap order, skipping zero
// taps: an edge of the const operator, e the left (kRight false) or right
// edge taps.
template <bool kRight>
__device__ __forceinline__ float edge_sum(const Params& p, const float* sv) {
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s >= p.noff) break;
    const float e = kRight ? p.rc[s] : p.lc[s];
    if (e != 0.f) a = fadd(a, fmul(e, sv[p.disp[s]]));
  }
  return a;
}

// sum over all taps of strip_s(j) v(n + s), from 0 in tap order (a row
// strip of the const operator).
__device__ __forceinline__ float strip_sum(const Params& p, const float* strip,
                                           int j, const float* sv) {
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxTaps; ++s) {
    if (s >= p.noff) break;
    a = fadd(a, fmul(__ldg(strip + static_cast<size_t>(s) * p.nh + j),
                     sv[p.disp[s]]));
  }
  return a;
}

// (A v) at node (m, j); sv points at the node in the shared tile.
template <bool kCoef>
__device__ __forceinline__ float apply_at(const Params& p, const float* sv,
                                          int m, int j) {
  float q = 0.f;
  if constexpr (kCoef) {
    const size_t n = static_cast<size_t>(p.nv) * p.nh;
    const size_t e = static_cast<size_t>(m) * p.nh + j;
#pragma unroll
    for (int s = 0; s < kMaxTaps; ++s) {
      if (s >= p.noff) break;
      q = fadd(q, fmul(__ldg(p.c + static_cast<size_t>(s) * n + e),
                       sv[p.disp[s]]));
    }
    return q;
  }
  int t = 0;
  for (int g = 0; g < p.ngroups; ++g) {
    float sx = sv[p.gdisp[t]];
    for (++t; t < p.group_end[g]; ++t) sx = fadd(sx, sv[p.gdisp[t]]);
    q = fadd(q, fmul(p.gval[g], sx));
  }
  if (j == 0) q = fadd(q, edge_sum<false>(p, sv));
  if (j == p.nh - 1) q = fadd(q, edge_sum<true>(p, sv));
  if (m == 0) q = fadd(q, strip_sum(p, p.c, j, sv));
  if (m == p.nv - 1)
    q = fadd(q, strip_sum(p, p.c + static_cast<size_t>(p.noff) * p.nh, j, sv));
  return q;
}

// Phase A over the block's tiles.  kInit: stage x0 and form r0 = b - A x0,
// accumulating <r0, r0>.  Otherwise: stage d' = r + beta d_old, write d' for
// the tile's own nodes to d_new and q = A d', accumulating <d', q>.
// Returns this thread's partial sum.
template <bool kCoef, bool kInit>
__device__ double phase_apply(const Params& p, float* sv, const float* d_old,
                              float* d_new, float beta) {
  const int nv = p.nv, nh = p.nh, P = p.pad;
  const int ph = kTileCols + 2 * P, hr = kTileRows + 2 * P;
  const int tiles_h = (nh + kTileCols - 1) / kTileCols;
  const int ntiles = ((nv + kTileRows - 1) / kTileRows) * tiles_h;
  double acc = 0.0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_h) * kTileRows;
    const int j0 = (tile % tiles_h) * kTileCols;
    for (int k = threadIdx.x; k < hr * ph; k += kThreads) {
      const int lm = k / ph, lj = k - lm * ph;
      const int gm = m0 + lm - P, gj = j0 + lj - P;
      float v = 0.f;
      if (gm >= 0 && gm < nv && gj >= 0 && gj < nh) {
        const size_t e = static_cast<size_t>(gm) * nh + gj;
        if (kInit) {
          v = __ldg(p.x0 + e);
        } else {
          v = fadd(__ldcg(p.r + e), fmul(beta, __ldcg(d_old + e)));
          if (lm >= P && lm < P + kTileRows && lj >= P && lj < P + kTileCols)
            d_new[e] = v;
        }
      }
      sv[k] = v;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kTileRows * kTileCols; k += kThreads) {
      const int tm = k / kTileCols, tj = k - tm * kTileCols;
      const int gm = m0 + tm, gj = j0 + tj;
      if (gm >= nv || gj >= nh) continue;
      const int c = (tm + P) * ph + tj + P;
      const float aq = apply_at<kCoef>(p, sv + c, gm, gj);
      const size_t e = static_cast<size_t>(gm) * nh + gj;
      if (kInit) {
        const float r = fsub(__ldg(p.b + e), aq);
        p.r[e] = r;
        acc += static_cast<double>(r) * r;
      } else {
        p.q[e] = aq;
        acc += static_cast<double>(sv[c]) * aq;
      }
    }
    __syncthreads();
  }
  return acc;
}

// x += alpha d, r -= alpha q at one node; returns r^2 in float64 (exact).
__device__ __forceinline__ double update_node(float a, float d, float q,
                                              float& x, float& r) {
  x = fadd(x, fmul(a, d));
  r = fsub(r, fmul(a, q));
  return static_cast<double>(r) * r;
}

// Phase B: x += alpha d', r -= alpha q over all nodes; returns this thread's
// partial of <r, r>.
__device__ double phase_update(const Params& p, const float* dn, float a) {
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  // float4 over the first n / 4 * 4 nodes (the planes and the second d
  // buffer start 16-byte aligned when n is a multiple of 4; otherwise only
  // the scalar sweep runs), the rest one by one
  const size_t n4 = (n & 3) == 0 ? n / 4 : 0;
  const float4* d4 = reinterpret_cast<const float4*>(dn);
  const float4* q4 = reinterpret_cast<const float4*>(p.q);
  float4* x4 = reinterpret_cast<float4*>(p.x);
  float4* r4 = reinterpret_cast<float4*>(p.r);
  for (size_t v = t0; v < n4; v += stride) {
    const float4 d = __ldcg(d4 + v), q = __ldcg(q4 + v);
    float4 x = __ldcg(x4 + v), r = __ldcg(r4 + v);
    acc += update_node(a, d.x, q.x, x.x, r.x);
    acc += update_node(a, d.y, q.y, x.y, r.y);
    acc += update_node(a, d.z, q.z, x.z, r.z);
    acc += update_node(a, d.w, q.w, x.w, r.w);
    x4[v] = x;
    r4[v] = r;
  }
  for (size_t e = 4 * n4 + t0; e < n; e += stride) {
    float x = __ldcg(p.x + e), r = __ldcg(p.r + e);
    acc += update_node(a, __ldcg(dn + e), __ldcg(p.q + e), x, r);
    p.x[e] = x;
    p.r[e] = r;
  }
  return acc;
}

template <bool kCoef>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    stream_cg_real_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float tile[];
  __shared__ double red[kWarps];
  __shared__ float s_delta, s_alpha, s_beta;
  __shared__ int s_done;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(nblocks) * kThreads;
  double* const part_dq = p.part;
  double* const part_rr = p.part + nblocks;

  // init: x = x0, d = 0 (the ping buffer, read by iteration 0),
  // r0 = b - A x0 and the partials of <r0, r0>.
  for (size_t e = t0; e < n; e += stride) {
    p.x[e] = __ldg(p.x0 + e);
    p.d[e] = 0.f;
  }
  block_partial(phase_apply<kCoef, true>(p, tile, nullptr, nullptr, 0.f), red,
                part_rr + blockIdx.x);
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
    const float* d_old = p.d + static_cast<size_t>(it & 1) * n;
    float* d_new = p.d + static_cast<size_t>((it + 1) & 1) * n;
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
    block_partial(phase_apply<kCoef, false>(p, tile, d_old, d_new, s_beta),
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
    block_partial(phase_update(p, d_new, s_alpha), red, part_rr + blockIdx.x);
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
}

// Dynamic shared memory: one halo tile of d' (at most 18,432 bytes).
constexpr size_t smem_bytes(int pad) {
  return static_cast<size_t>(kTileRows + 2 * pad) * (kTileCols + 2 * pad) *
         sizeof(float);
}
static_assert(smem_bytes(kMaxPad) <= 48 * 1024, "halo tile past 48 KB");

const void* kernel_of(int coef) {
  return coef ? reinterpret_cast<const void*>(stream_cg_real_kernel<true>)
              : reinterpret_cast<const void*>(stream_cg_real_kernel<false>);
}

}  // namespace

extern "C" {

// Kernel limits: taps per stencil, largest |offset| component.
int tpcg_stream_real_limits(int* max_taps, int* max_pad) {
  *max_taps = kMaxTaps;
  *max_pad = kMaxPad;
  return 0;
}

// Grid size for an (nv, nh) grid on the current device in the given mode:
// one block per 16 x 128 tile where the card has room, at most kBlocksPerSm
// blocks per SM, never more than can be co-resident (a larger cooperative
// launch is refused).
int tpcg_stream_real_grid(int nv, int nh, int pad, int coef, int* grid_out) {
  if (nv < 1 || nh < 1 || pad < 0 || pad > kMaxPad)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(coef), kThreads, smem_bytes(pad));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long tiles =
      static_cast<long long>((nv + kTileRows - 1) / kTileRows) *
      ((nh + kTileCols - 1) / kTileCols);
  long long g = tiles;
  if (g > static_cast<long long>(per_sm) * sms) g = per_sm * sms;
  *grid_out = g < 1 ? 1 : static_cast<int>(g);
  return 0;
}

// b, x0, x, r, q: (nv, nh) floats; c: coef mode (noff, nv, nh) planes, const
// mode (2, noff, nh) bottom/top strips; d: (2, nv, nh); hist:
// n_iterations + 1; part: 2 * grid doubles.  offsets: host array of
// 2 * noff ints (dm, dj), |dm|, |dj| <= pad; taps: host array of 3 * noff
// floats (c, lc, rc; read in const mode only); group_of: host array of noff
// ints, the group of each interior tap (-1 for a zero tap), groups numbered
// in order of first appearance (const mode only).  grid: from
// tpcg_stream_real_grid in the same mode.
int tpcg_stream_real(const float* b, const float* x0, const float* c,
                     float* x, float* hist, float* r, float* q, float* d,
                     double* part, int nv, int nh, int noff,
                     const int* offsets, const float* taps,
                     const int* group_of, int coef, int pad, int n_iterations,
                     int grid, void* stream) {
  if (nv < 1 || nh < 1 || noff < 1 || noff > kMaxTaps || pad < 0 ||
      pad > kMaxPad || n_iterations < 0 || grid < 1)
    return cudaErrorInvalidValue;
  Params p{};
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
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * (kTileCols + 2 * pad) + dj;
  }
  if (!coef) {
    for (int s = 0; s < noff; ++s) {
      if (group_of[s] < -1 || group_of[s] >= noff) return cudaErrorInvalidValue;
      p.lc[s] = taps[noff + s];
      p.rc[s] = taps[2 * noff + s];
    }
    int t = 0;
    for (int g = 0; g < noff; ++g) {
      const int first = t;
      for (int s = 0; s < noff; ++s) {
        if (group_of[s] != g) continue;
        if (t == first) p.gval[g] = taps[s];
        p.gdisp[t++] = p.disp[s];
      }
      if (t == first) break;
      p.group_end[g] = t;
      p.ngroups = g + 1;
    }
  }
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_of(coef), dim3(grid), dim3(kThreads), args, smem_bytes(pad),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
