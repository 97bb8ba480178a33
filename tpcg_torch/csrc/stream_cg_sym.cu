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
// the state lives in device memory.  The csrc/stream_cg.cu design (constant
// taps) carries over; what is new is the operator.
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
// What bounds it on the H100: device-memory bytes.  Per node and iteration
// the state moves as in csrc/stream_cg.cu, ~82 B (phase A reads r and the
// old d with a 2-row, 2-column halo per 16 x 128 tile and writes d' and q;
// phase B reads x, d', r, q and writes x and r), and the half planes add
// 4 complex float32 values, 32 B, plus their mirrored reads at n - s: ~116 B
// against a floor of 80 B (x, r and d read and written once, and the
// coefficients read once).  At N = 4096 (16.8 M nodes) that floor is
// 1.34 GB an iteration, 0.40 ms at 3.35 TB/s.  At N = 1024 the state and
// the coefficients (~75 MB) no longer fit the 50 MB L2.
//
// What the design does about it:
//   * two grid barriers per iteration: phase A recomputes d' = r + beta d on
//     its tile's halo from r and the old d (ping-pong d buffers), with the
//     same non-contracting float operations (__fmul_rn, __fadd_rn) as the
//     owner, so every block applies A to bit-identical values;
//   * phase A stages d' for a 16 x 128 tile and its halo in shared memory
//     (18.7 KB at pad 1), so each node's neighbours read shared memory;
//   * the coefficients are not staged: c_s(n) and the mirrored c_s(n-s) are
//     read through the read-only path (__ldg), and L1 serves the overlap
//     (c_s(n-s) is a neighbour of a value the same or the previous warp
//     pass has just read).  Staging the four complex half planes with
//     their halo would take ~70 KB of shared memory a block and allow two
//     blocks per SM; this way a block needs the d' tile only and four fit
//     (at 64 registers a thread), which keeps more loads in flight -- what
//     the constant-tap kernel's measurements showed it lacks;
//   * dot products accumulate in float64 (the float32 products are exact
//     there) and are rounded to float32 once, as the plain version's are:
//     on this class COCG with float32 sums parts from COCG with float64
//     sums by a quarter of max|x| within 100 iterations (helm_fe_var,
//     omega 40, N = 1024), so a kernel with float32 sums could not be held
//     to its plain version at full size.
//     With float64 sums both nearly always round to the same float32 alpha
//     and beta; where the two float64 sums straddle a float32 rounding
//     boundary the scalars differ by one ulp, not by a float32-order
//     spread;
//   * the reduction order is fixed (per thread, warp shuffle, block, then
//     over blocks in block order, the same in every block), so every block
//     derives bit-identical alpha and beta and reruns agree bit for bit;
//     one RHS per launch, so a RHS's bits never depend on its batch;
//   * offsets into the planes are 64-bit (N = 4096 has 16.8 M nodes a plane).
// The stencil apply, the updates, the Smith division and the history use
// the same non-contracting operations (__fmul_rn, __fadd_rn, __fdiv_rn) in
// the order of the plain version, so with equal float32 dot products the
// kernel follows it bit for bit.  TMA panels, clusters, keeping q on
// chip and deferring the x update (JAX's qx) are the ways to cut the
// ~116 B per node toward the 80 B floor; none is in this first version.
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
constexpr int kMaxHalf = 16;
constexpr int kMaxPad = 8;

struct Params {
  const float* b;       // (2, nv, nh)                              read-only
  const float* x0;      // (2, nv, nh)                              read-only
  const float* c;       // (2 re/im, nh1, nv, nh) half planes       read-only
  float* x;             // (2, nv, nh)                              out
  float* hist;          // (n_iterations + 1)                       out
  float* r;             // (2, nv, nh)                              scratch
  float* q;             // (2, nv, nh)                              scratch
  float* d;             // (2 ping/pong, 2, nv, nh)                 scratch
  double* part;         // (2 dq/rr, gridDim.x, 2)                  scratch
  int nv, nh, nh1, pad, n_iterations;
  int dm[kMaxHalf], dj[kMaxHalf];  // half offsets; [0] is the centre
  int disp[kMaxHalf];   // dm * tile pitch + dj: displacement in the tile
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

// (A v) at node (m, j); sr / si point at the node in the shared tile.
__device__ __forceinline__ float2 apply_at(const Params& p, const float* sr,
                                           const float* si, int m, int j) {
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t e = static_cast<size_t>(m) * p.nh + j;
  const float* cre = p.c;
  const float* cim = p.c + static_cast<size_t>(p.nh1) * n;
  float qr = 0.f, qi = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxHalf; ++t) {
    if (t >= p.nh1) break;
    const size_t pt = static_cast<size_t>(t) * n;
    const int dsp = p.disp[t];
    // the down term c_t(n) v(n + s)
    const float car = __ldg(cre + pt + e), cai = __ldg(cim + pt + e);
    const float xr = sr[dsp], xi = si[dsp];
    qr = fsub(fadd(qr, fmul(car, xr)), fmul(cai, xi));
    qi = fadd(fadd(qi, fmul(car, xi)), fmul(cai, xr));
    if (t == 0) continue;  // the centre has no mirror
    // the mirrored up term c_t(n - s) v(n - s); 0 outside the grid
    const int mm = m - p.dm[t], jj = j - p.dj[t];
    float cbr = 0.f, cbi = 0.f;
    if (mm >= 0 && mm < p.nv && jj >= 0 && jj < p.nh) {
      const size_t eb = static_cast<size_t>(mm) * p.nh + jj;
      cbr = __ldg(cre + pt + eb);
      cbi = __ldg(cim + pt + eb);
    }
    const float yr = sr[-dsp], yi = si[-dsp];
    qr = fsub(fadd(qr, fmul(cbr, yr)), fmul(cbi, yi));
    qi = fadd(fadd(qi, fmul(cbr, yi)), fmul(cbi, yr));
  }
  return make_float2(qr, qi);
}

// Phase A over the block's tiles.  kInit: stage x0 and form r0 = b - A x0,
// accumulating <r0, r0>.  Otherwise: stage d' = r + beta d_old, write d' for
// the tile's own nodes to d_new and q = A d', accumulating <d', q>.
// Returns this thread's partial sum.
template <bool kInit>
__device__ double2 phase_apply(const Params& p, float* s_re, float* s_im,
                               const float* d_old, float* d_new,
                               float2 beta) {
  const int nv = p.nv, nh = p.nh, P = p.pad;
  const size_t n = static_cast<size_t>(nv) * nh;
  const int ph = kTileCols + 2 * P, hr = kTileRows + 2 * P;
  const int tiles_h = (nh + kTileCols - 1) / kTileCols;
  const int ntiles = ((nv + kTileRows - 1) / kTileRows) * tiles_h;
  double2 acc = make_double2(0.0, 0.0);
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
          vr = __ldg(p.x0 + e);
          vi = __ldg(p.x0 + n + e);
        } else {
          const float rr = __ldcg(p.r + e), ri = __ldcg(p.r + n + e);
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
        const float rr = fsub(__ldg(p.b + e), aq.x);
        const float ri = fsub(__ldg(p.b + n + e), aq.y);
        p.r[e] = rr;
        p.r[n + e] = ri;
        acc.x += static_cast<double>(rr) * rr - static_cast<double>(ri) * ri;
        acc.y += static_cast<double>(rr) * ri;
      } else {
        p.q[e] = aq.x;
        p.q[n + e] = aq.y;
        const double dr = s_re[c], di = s_im[c];
        acc.x += dr * aq.x - di * aq.y;
        acc.y += dr * aq.y + di * aq.x;
      }
    }
    __syncthreads();
  }
  return acc;
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

// Phase B: x += alpha d', r -= alpha q over all nodes; returns this
// thread's partial of (sum rr^2 - ri^2, sum rr ri).
__device__ double2 phase_update(const Params& p, const float* dn, float2 a) {
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  double2 acc = make_double2(0.0, 0.0);
  if ((n & 3) == 0) {
    // float4 sweep: planes start 16-byte aligned when n is a multiple of 4
    const size_t n4 = n / 4;
    const float4* d4 = reinterpret_cast<const float4*>(dn);
    const float4* q4 = reinterpret_cast<const float4*>(p.q);
    float4* x4 = reinterpret_cast<float4*>(p.x);
    float4* r4 = reinterpret_cast<float4*>(p.r);
    for (size_t v = t0; v < n4; v += stride) {
      const float4 dr = __ldcg(d4 + v), di = __ldcg(d4 + n4 + v);
      const float4 qr = __ldcg(q4 + v), qi = __ldcg(q4 + n4 + v);
      float4 xr = __ldcg(x4 + v), xi = __ldcg(x4 + n4 + v);
      float4 rr = __ldcg(r4 + v), ri = __ldcg(r4 + n4 + v);
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
      x4[n4 + v] = xi;
      r4[v] = rr;
      r4[n4 + v] = ri;
    }
    return acc;
  }
  for (size_t e = t0; e < n; e += stride) {
    float xr = __ldcg(p.x + e), xi = __ldcg(p.x + n + e);
    float rr = __ldcg(p.r + e), ri = __ldcg(p.r + n + e);
    const double2 t = update_node(a, __ldcg(dn + e), __ldcg(dn + n + e),
                                 __ldcg(p.q + e), __ldcg(p.q + n + e), xr, xi,
                                 rr, ri);
    acc.x += t.x;
    acc.y += t.y;
    p.x[e] = xr;
    p.x[n + e] = xi;
    p.r[e] = rr;
    p.r[n + e] = ri;
  }
  return acc;
}

// Four blocks an SM: the bound caps the kernel at 64 registers a thread (it
// builds there without spilling; unbounded it takes 80 and three blocks fit,
// 14% slower at N = 2048, probes/stream_sym_launch_bounds.py).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    stream_cg_sym_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float tile[];
  __shared__ double2 red[kWarps];
  __shared__ float2 s_delta, s_alpha, s_beta;
  __shared__ int s_done;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x;
  const size_t n = static_cast<size_t>(p.nv) * p.nh;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(nblocks) * kThreads;
  const int tile_len = (kTileRows + 2 * p.pad) * (kTileCols + 2 * p.pad);
  float* const s_re = tile;
  float* const s_im = tile + tile_len;
  double* const part_dq = p.part;
  double* const part_rr = p.part + 2 * static_cast<size_t>(nblocks);
  double* const mine_dq = part_dq + 2 * blockIdx.x;
  double* const mine_rr = part_rr + 2 * blockIdx.x;
  const float2 zero = make_float2(0.f, 0.f);

  // init: x = x0, d = 0 (the ping buffer, read by iteration 0),
  // r0 = b - A x0 and the partials of <r0, r0>.
  for (size_t e = t0; e < 2 * n; e += stride) {
    p.x[e] = __ldg(p.x0 + e);
    p.d[e] = 0.f;
  }
  block_partial(phase_apply<true>(p, s_re, s_im, nullptr, nullptr, zero), red,
                mine_rr);
  grid.sync();
  if (warp == 0) {
    const double2 t = grid_total(part_rr, nblocks);
    if (lane == 0) {
      s_delta = delta_of(t);
      s_beta = zero;
      if (blockIdx.x == 0) p.hist[0] = hist_of(s_delta);
    }
  }
  __syncthreads();

  for (int it = 0; it < p.n_iterations; ++it) {
    const float* d_old = p.d + static_cast<size_t>(it & 1) * 2 * n;
    float* d_new = p.d + static_cast<size_t>((it + 1) & 1) * 2 * n;
    // phase A: d' = r + beta d, q = A d', partials of <d', q>
    block_partial(phase_apply<false>(p, s_re, s_im, d_old, d_new, s_beta),
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

    // phase B: x += alpha d', r -= alpha q, partials of <r, r>
    const double2 pr = phase_update(p, d_new, s_alpha);
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
}

// Dynamic shared memory: the re and im planes of one halo tile of d' (at
// most 36,864 bytes, under the 48 KB a launch may take without opting in).
constexpr size_t smem_bytes(int pad) {
  return static_cast<size_t>(2) * (kTileRows + 2 * pad) *
         (kTileCols + 2 * pad) * sizeof(float);
}
static_assert(smem_bytes(kMaxPad) <= 48 * 1024, "halo tile past 48 KB");

}  // namespace

extern "C" {

// Kernel limits: half offsets (the centre included), largest |offset|
// component.
int tpcg_stream_sym_limits(int* max_half, int* max_pad) {
  *max_half = kMaxHalf;
  *max_pad = kMaxPad;
  return 0;
}

// Grid size for an (nv, nh) grid on the current device: one block per
// 16 x 128 tile where the card has room, at most kBlocksPerSm blocks per SM,
// never more than can be co-resident (a larger cooperative launch is
// refused).
int tpcg_stream_sym_grid(int nv, int nh, int pad, int* grid_out) {
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
      &per_sm, stream_cg_sym_kernel, kThreads, smem_bytes(pad));
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

// b, x0, x, r, q: (2, nv, nh) floats; c: (2, nh1, nv, nh) half planes; d:
// (2, 2, nv, nh); hist: n_iterations + 1; part: 4 * grid doubles.  offsets: host
// array of 2 * nh1 ints (dm, dj), the centre (0, 0) first and every other
// one greater than (0, 0), |dm|, |dj| <= pad.  grid: from
// tpcg_stream_sym_grid.
int tpcg_stream_sym(const float* b, const float* x0, const float* c, float* x,
                    float* hist, float* r, float* q, float* d, double* part,
                    int nv, int nh, int nh1, const int* offsets, int pad,
                    int n_iterations, int grid, void* stream) {
  if (nv < 1 || nh < 1 || nh1 < 1 || nh1 > kMaxHalf || pad < 0 ||
      pad > kMaxPad || n_iterations < 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (offsets[0] != 0 || offsets[1] != 0) return cudaErrorInvalidValue;
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
  p.nh1 = nh1;
  p.pad = pad;
  p.n_iterations = n_iterations;
  for (int t = 0; t < kMaxHalf; ++t) p.dm[t] = p.dj[t] = p.disp[t] = 0;
  for (int t = 0; t < nh1; ++t) {
    const int dm = offsets[2 * t], dj = offsets[2 * t + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    // every offset but the centre is lexicographically positive
    if (t > 0 && !(dm > 0 || (dm == 0 && dj > 0))) return cudaErrorInvalidValue;
    p.dm[t] = dm;
    p.dj[t] = dj;
    p.disp[t] = dm * (kTileCols + 2 * pad) + dj;
  }
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stream_cg_sym_kernel), dim3(grid),
      dim3(kThreads), args, smem_bytes(pad), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
