// Whole-solve fixed-iteration block COCG on a complex 2-D stencil, in one
// persistent cooperative launch.
//
// Replaces two Pallas kernels that keep the whole CG state in a TPU core's
// VMEM and run every iteration inside one pallas_call; the operator is the
// kernel's template parameter:
//   * tpcg/ops/fused_cg.py::fused_cg_stencil (kConst false, the `l2-coef`
//     path): per-node coefficient planes in the Karatsuba form;
//   * tpcg/ops/fused_cg_const.py::fused_cg_const_planes (kConst true, the
//     `l2-const` path): constant interior taps as kernel parameters, taps
//     with equal values summed first and multiplied once, in JAX's order,
//     then four boundary strips read through the read-only path where they
//     apply (rows 0 and nv-1, columns 0 and nh-1 of rows 1..nv-2); no
//     coefficient planes are read.  JAX's one-hot 128-lane edge blocks and
//     third Karatsuba plane exist for its vector units; the host keeps one
//     column and two planes (tpcg_torch.ops.fused_cg_const.prepare_const).
//
// What it computes (per RHS b of nb independent recurrences):
//   r0 = b - A x0, with x0 staged through the zero-bordered direction buffer
//   q = A d        coefficient planes: Karatsuba complex stencil apply in
//                  the tap order of `offsets`: m1 = Ar*dr, m2 = Ai*di,
//                  m3 = (Ar+Ai)*(dr+di), qr += m1 - m2, qi += m3 - m1 - m2;
//                  const: tpcg_torch.ops.fused_cg_const.apply_const_strips
//   alpha = delta / <d,q>, beta = delta' / delta   (Smith-scaled division)
//   done  = (delta == 0) | (<d,q> == 0) zeroes alpha and beta (freeze guard)
//   hist[it+1] = sqrt(sqrt(delta_r^2 + delta_i^2)), the JAX formula as is
// with unconjugated dots <u,v> = sum u*v.
//
// What bounds it on the H100: the data are small.  At N=128 the coefficient
// planes (3, 7, 128, 128) f32 take 1.4 MB and the CG state ~0.4 MB per RHS;
// at N=512 22 MB and ~8 MB (the const operator reads no planes: its strips
// are 4 (2 noff N) floats).  Both fit in the 50 MB L2, so device memory is
// not the bound.  What is: the latency of the three grid-wide barriers each
// iteration needs (after q = A d and the <d,q> partials; after the x, r
// update and the <r,r> partials; after the d update, which neighbours read),
// and L2 bandwidth for the taps and coefficients at the larger grids.
//
// What the design does about it:
//   * one launch for the whole solve: no launch gaps and no host round trip
//     for alpha and beta;
//   * the grid is no larger than the work needs and at most one block per
//     SM, so every block is co-resident and each barrier waits on few blocks;
//   * coefficients, b and x0 are the only read-only data and go through the
//     read-only cache (__ldg), where a block's slice of the coefficients can
//     stay between iterations;
//   * q, x and r are read and written only by the thread that owns the
//     element; the direction and the dot partials cross blocks and are read
//     with __ldcg (L2, coherent) after a grid barrier, never through the
//     non-coherent read-only path;
//   * dot products reduce in a fixed order (per thread, warp shuffle, shared
//     memory, then over blocks in block order, the same in every block), so
//     every block derives bit-identical alpha and beta and reruns agree.
// wgmma and TMA have no place here: there is no matrix product, and each
// element is touched a handful of times per iteration.
//
// Numerics: build without --use_fast_math, which would turn on
// flush-to-zero and approximate division and sqrt and so move the freeze
// guard and the Smith division.  nvcc contracts a*b+c into FMA by default;
// that moves results by an ulp against the plain PyTorch version
// (tpcg_torch.ops.fused_cg.fused_cg_stencil_plain), inside the stated
// tolerances.
//
// Plain C interface, loaded with ctypes (tpcg_torch/ops/_build.py).  Every
// entry point returns a cudaError_t as int; the caller allocates every
// buffer, and the launch goes on the stream it is given.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdlib>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 16;
constexpr int kMaxRhs = 32;

struct Params {
  const float* coef3;  // (3, noff, nv, nh): Ar, Ai, Ar+Ai      read-only
  const float* b;      // (2, nb, nv, nh)                       read-only
  const float* x0;     // (2, nb, nv, nh)                       read-only
  float* x;            // (2, nb, nv, nh)                       out
  float* hist;         // (n_iterations + 1, nb)                out
  float* r;            // (2, nb, nv, nh)                       scratch
  float* q;            // (2, nb, nv, nh)                       scratch
  float* dpad;         // (2, nb, nv + 2 pad, nh + 2 pad)       scratch
  float* part_dq;      // (gridDim.x, nb, 2) partials of <d,q>  scratch
  float* part_rr;      // (gridDim.x, nb, 2) partials of <r,r>  scratch
  int nv, nh, nb, noff, pad, n_iterations;
  int disp[kMaxTaps];  // tap displacement in dpad: dm * (nh + 2 pad) + dj
  // the const operator (kConst): strips [re, im] x noff x length, and the
  // interior tap groups: group g holds the taps gdisp[group_end[g - 1]] ..
  // gdisp[group_end[g] - 1] (displacements in dpad), value gr[g] + i gi[g]
  const float* sb;     // (2, noff, nh)      row 0                read-only
  const float* st;     // (2, noff, nh)      row nv - 1           read-only
  const float* sl;     // (2, noff, nv - 2)  column 0             read-only
  const float* sr;     // (2, noff, nv - 2)  column nh - 1        read-only
  int ngroups;
  int group_end[kMaxTaps];
  int gdisp[kMaxTaps];
  float gr[kMaxTaps], gi[kMaxTaps];
};

__device__ __forceinline__ float2 warp_sum(float2 v) {
  // xor butterfly: every lane ends with the same sum, since each step adds
  // the same two values in either order
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

// Sum over blocks of the partials of RHS rhs, by one warp, in a fixed order.
__device__ float2 grid_total(const float* part, int nblocks, int nb, int rhs) {
  const int lane = threadIdx.x & 31;
  float2 v = make_float2(0.f, 0.f);
  for (int g = lane; g < nblocks; g += 32) {
    const float* p = part + (static_cast<size_t>(g) * nb + rhs) * 2;
    v.x += __ldcg(p);
    v.y += __ldcg(p + 1);
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

// sum_s strip_s(k) d(n + s) over the taps, from 0 in tap order, for one
// ring strip of `len` values a tap and plane; dr and di point at node n.
__device__ __forceinline__ float2 ring_sum(const Params& p, const float* strip,
                                           int len, int k, const float* dr,
                                           const float* di) {
  float ar = 0.f, ai = 0.f;
  for (int s = 0; s < p.noff; ++s) {
    const float sr = __ldg(strip + static_cast<size_t>(s) * len + k);
    const float si = __ldg(strip + static_cast<size_t>(p.noff + s) * len + k);
    const float xr = __ldcg(dr + p.disp[s]), xi = __ldcg(di + p.disp[s]);
    ar = ar + (sr * xr - si * xi);
    ai = ai + (sr * xi + si * xr);
  }
  return make_float2(ar, ai);
}

// (A d)[e]: dr and di point at node e in the padded re and im planes of d.
template <bool kConst>
__device__ __forceinline__ float2 apply_at(const Params& p, int n, int e,
                                           const float* dr, const float* di) {
  float qr = 0.f, qi = 0.f;
  if constexpr (kConst) {
    int t = 0;
    for (int g = 0; g < p.ngroups; ++g) {
      float sxr = __ldcg(dr + p.gdisp[t]), sxi = __ldcg(di + p.gdisp[t]);
      for (++t; t < p.group_end[g]; ++t) {
        sxr = sxr + __ldcg(dr + p.gdisp[t]);
        sxi = sxi + __ldcg(di + p.gdisp[t]);
      }
      const float gr = p.gr[g], gi = p.gi[g];
      if (gr != 0.f) {
        qr = qr + gr * sxr;
        qi = qi + gr * sxi;
      }
      if (gi != 0.f) {
        qr = qr - gi * sxi;
        qi = qi + gi * sxr;
      }
    }
    const int m = e / p.nh, j = e - m * p.nh;
    float2 a;
    if (m == 0) {
      a = ring_sum(p, p.sb, p.nh, j, dr, di);
      qr = qr + a.x;
      qi = qi + a.y;
    }
    if (m == p.nv - 1) {
      a = ring_sum(p, p.st, p.nh, j, dr, di);
      qr = qr + a.x;
      qi = qi + a.y;
    }
    if (m > 0 && m < p.nv - 1 && j == 0) {
      a = ring_sum(p, p.sl, p.nv - 2, m - 1, dr, di);
      qr = qr + a.x;
      qi = qi + a.y;
    }
    if (m > 0 && m < p.nv - 1 && j == p.nh - 1) {
      a = ring_sum(p, p.sr, p.nv - 2, m - 1, dr, di);
      qr = qr + a.x;
      qi = qi + a.y;
    }
  } else {
    for (int s = 0; s < p.noff; ++s) {
      const float xr = __ldcg(dr + p.disp[s]);
      const float xi = __ldcg(di + p.disp[s]);
      const float ar = __ldg(p.coef3 + static_cast<size_t>(s) * n + e);
      const float ai =
          __ldg(p.coef3 + static_cast<size_t>(p.noff + s) * n + e);
      const float ars =
          __ldg(p.coef3 + static_cast<size_t>(2 * p.noff + s) * n + e);
      const float m1 = ar * xr;
      const float m2 = ai * xi;
      const float m3 = ars * (xr + xi);
      qr = qr + (m1 - m2);
      qi = qi + (m3 - m1 - m2);
    }
  }
  return make_float2(qr, qi);
}

template <bool kConst>
__global__ void __launch_bounds__(kThreads) fused_cg_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float2 red[kWarps];
  __shared__ float2 s_delta[kMaxRhs];
  __shared__ float2 s_alpha[kMaxRhs];
  __shared__ float2 s_beta[kMaxRhs];
  __shared__ int s_done[kMaxRhs];

  const int nv = p.nv, nh = p.nh, nb = p.nb, P = p.pad;
  const int n = nv * nh;
  const int ph = nh + 2 * P;
  const int pn = (nv + 2 * P) * ph;
  const int nblocks = gridDim.x;
  const int stride = nblocks * kThreads;
  const int t0 = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* const d_re = p.dpad;
  float* const d_im = p.dpad + static_cast<size_t>(nb) * pn;
  // element e of RHS rhs: plane offsets in (2, nb, nv, nh) and in dpad
  auto re_at = [&](int rhs, int e) { return static_cast<size_t>(rhs) * n + e; };
  auto im_at = [&](int rhs, int e) {
    return static_cast<size_t>(nb + rhs) * n + e;
  };
  auto pad_at = [&](int rhs, int e) {
    return static_cast<size_t>(rhs) * pn + (e / nh + P) * ph + e % nh + P;
  };
  auto part_at = [&](float* part, int rhs) {
    return part + (static_cast<size_t>(blockIdx.x) * nb + rhs) * 2;
  };

  // 1. zero the padded direction buffer; its border stays zero for the
  //    whole solve, so a tap that leaves the grid reads 0, never a
  //    neighbouring row, whatever the coefficient there holds.
  for (size_t i = t0; i < static_cast<size_t>(2) * nb * pn; i += stride)
    p.dpad[i] = 0.f;
  grid.sync();

  // 2. x = x0, staged through the padded buffer for A x0.
  for (int rhs = 0; rhs < nb; ++rhs)
    for (int e = t0; e < n; e += stride) {
      const size_t ir = re_at(rhs, e), ii = im_at(rhs, e), pi = pad_at(rhs, e);
      const float xr = __ldg(p.x0 + ir), xi = __ldg(p.x0 + ii);
      p.x[ir] = xr;
      p.x[ii] = xi;
      d_re[pi] = xr;
      d_im[pi] = xi;
    }
  grid.sync();

  // 3. r0 = b - A x0 and the partials of <r0, r0>.
  for (int rhs = 0; rhs < nb; ++rhs) {
    float2 acc = make_float2(0.f, 0.f);
    for (int e = t0; e < n; e += stride) {
      const size_t ir = re_at(rhs, e), ii = im_at(rhs, e), pi = pad_at(rhs, e);
      const float2 aq = apply_at<kConst>(p, n, e, d_re + pi, d_im + pi);
      const float rr = __ldg(p.b + ir) - aq.x;
      const float ri = __ldg(p.b + ii) - aq.y;
      p.r[ir] = rr;
      p.r[ii] = ri;
      acc.x += rr * rr - ri * ri;
      acc.y += rr * ri;
    }
    block_partial(acc, red, part_at(p.part_rr, rhs));
  }
  grid.sync();

  // 4. delta0 and hist[0]; d0 = r0 (every block is past its reads of x0).
  for (int rhs = warp; rhs < nb; rhs += kWarps) {
    const float2 t = grid_total(p.part_rr, nblocks, nb, rhs);
    if (lane == 0) {
      const float2 dl = make_float2(t.x, 2.f * t.y);
      s_delta[rhs] = dl;
      if (blockIdx.x == 0) p.hist[rhs] = sqrtf(sqrtf(dl.x * dl.x + dl.y * dl.y));
    }
  }
  for (int rhs = 0; rhs < nb; ++rhs)
    for (int e = t0; e < n; e += stride) {
      const size_t pi = pad_at(rhs, e);
      d_re[pi] = p.r[re_at(rhs, e)];
      d_im[pi] = p.r[im_at(rhs, e)];
    }
  grid.sync();

  for (int it = 0; it < p.n_iterations; ++it) {
    // phase 1: q = A d and the partials of <d, q>.
    for (int rhs = 0; rhs < nb; ++rhs) {
      float2 acc = make_float2(0.f, 0.f);
      for (int e = t0; e < n; e += stride) {
        const size_t ir = re_at(rhs, e), ii = im_at(rhs, e), pi = pad_at(rhs, e);
        const float2 aq = apply_at<kConst>(p, n, e, d_re + pi, d_im + pi);
        p.q[ir] = aq.x;
        p.q[ii] = aq.y;
        const float dr = __ldcg(d_re + pi), di = __ldcg(d_im + pi);
        acc.x += dr * aq.x - di * aq.y;
        acc.y += dr * aq.y + di * aq.x;
      }
      block_partial(acc, red, part_at(p.part_dq, rhs));
    }
    grid.sync();

    // phase 2: alpha (bit-identical in every block), x += alpha d,
    // r -= alpha q, and the partials of <r, r>.
    for (int rhs = warp; rhs < nb; rhs += kWarps) {
      const float2 dq = grid_total(p.part_dq, nblocks, nb, rhs);
      if (lane == 0) {
        const float2 dl = s_delta[rhs];
        const int done = (dl.x == 0.f && dl.y == 0.f) || (dq.x == 0.f && dq.y == 0.f);
        s_done[rhs] = done;
        s_alpha[rhs] = done ? make_float2(0.f, 0.f) : cdiv_smith(dl.x, dl.y, dq.x, dq.y);
      }
    }
    __syncthreads();
    for (int rhs = 0; rhs < nb; ++rhs) {
      const float2 a = s_alpha[rhs];
      float2 acc = make_float2(0.f, 0.f);
      for (int e = t0; e < n; e += stride) {
        const size_t ir = re_at(rhs, e), ii = im_at(rhs, e), pi = pad_at(rhs, e);
        const float dr = __ldcg(d_re + pi), di = __ldcg(d_im + pi);
        const float qr = p.q[ir], qi = p.q[ii];
        p.x[ir] = p.x[ir] + (a.x * dr - a.y * di);
        p.x[ii] = p.x[ii] + (a.x * di + a.y * dr);
        const float rr = p.r[ir] - (a.x * qr - a.y * qi);
        const float ri = p.r[ii] - (a.x * qi + a.y * qr);
        p.r[ir] = rr;
        p.r[ii] = ri;
        acc.x += rr * rr - ri * ri;
        acc.y += rr * ri;
      }
      block_partial(acc, red, part_at(p.part_rr, rhs));
    }
    grid.sync();

    // phase 3: beta, hist[it+1], d = r + beta d.
    for (int rhs = warp; rhs < nb; rhs += kWarps) {
      const float2 t = grid_total(p.part_rr, nblocks, nb, rhs);
      if (lane == 0) {
        const float2 dn = make_float2(t.x, 2.f * t.y);
        const float2 dl = s_delta[rhs];
        s_beta[rhs] = s_done[rhs] ? make_float2(0.f, 0.f)
                                  : cdiv_smith(dn.x, dn.y, dl.x, dl.y);
        s_delta[rhs] = dn;
        if (blockIdx.x == 0)
          p.hist[static_cast<size_t>(it + 1) * nb + rhs] =
              sqrtf(sqrtf(dn.x * dn.x + dn.y * dn.y));
      }
    }
    __syncthreads();
    for (int rhs = 0; rhs < nb; ++rhs) {
      const float2 be = s_beta[rhs];
      for (int e = t0; e < n; e += stride) {
        const size_t pi = pad_at(rhs, e);
        const float dr = __ldcg(d_re + pi), di = __ldcg(d_im + pi);
        d_re[pi] = p.r[re_at(rhs, e)] + (be.x * dr - be.y * di);
        d_im[pi] = p.r[im_at(rhs, e)] + (be.x * di + be.y * dr);
      }
    }
    grid.sync();
  }
}

// The fields both operators use; returns a cudaError_t.
int fill_params(Params& p, const float* b, const float* x0, float* x,
                float* hist, float* r, float* q, float* dpad, float* part_dq,
                float* part_rr, int nv, int nh, int nb, int noff,
                const int* offsets, int pad, int n_iterations, int grid) {
  if (nv < 1 || nh < 1 || nb < 1 || nb > kMaxRhs || noff < 1 ||
      noff > kMaxTaps || pad < 0 || n_iterations < 0 || grid < 1)
    return cudaErrorInvalidValue;
  p = Params{};
  p.b = b;
  p.x0 = x0;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.q = q;
  p.dpad = dpad;
  p.part_dq = part_dq;
  p.part_rr = part_rr;
  p.nv = nv;
  p.nh = nh;
  p.nb = nb;
  p.noff = noff;
  p.pad = pad;
  p.n_iterations = n_iterations;
  for (int s = 0; s < noff; ++s) {
    const int dm = offsets[2 * s], dj = offsets[2 * s + 1];
    if (std::abs(dm) > pad || std::abs(dj) > pad) return cudaErrorInvalidValue;
    p.disp[s] = dm * (nh + 2 * pad) + dj;
  }
  return cudaSuccess;
}

template <bool kConst>
int launch(const Params& p, int grid, void* stream) {
  Params arg = p;
  void* args[] = {&arg};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_cg_kernel<kConst>), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel limits: taps per stencil and RHS per launch.
int tpcg_fused_cg_limits(int* max_taps, int* max_rhs) {
  *max_taps = kMaxTaps;
  *max_rhs = kMaxRhs;
  return 0;
}

// Grid size for a grid of n nodes on the current device: enough blocks for
// one node per thread, at most one block per SM, never more than can be
// co-resident (a larger cooperative launch is refused).
int tpcg_fused_cg_grid(int n, int* grid_out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  // the smaller occupancy of the two operators' instances
  int per_sm_const = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_cg_kernel<false>, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm_const, fused_cg_kernel<true>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm_const < per_sm) per_sm = per_sm_const;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int g = (n + kThreads - 1) / kThreads;
  if (g > sms) g = sms;
  if (g > per_sm * sms) g = per_sm * sms;
  *grid_out = g < 1 ? 1 : g;
  return 0;
}

// offsets: host array of 2*noff ints (dm, dj).  grid: from tpcg_fused_cg_grid.
// part_dq and part_rr hold grid * nb * 2 floats each; dpad holds
// 2 * nb * (nv + 2 pad) * (nh + 2 pad) floats.
int tpcg_fused_cg_stencil(const float* coef3, const float* b, const float* x0,
                          float* x, float* hist, float* r, float* q,
                          float* dpad, float* part_dq, float* part_rr, int nv,
                          int nh, int nb, int noff, const int* offsets,
                          int pad, int n_iterations, int grid, void* stream) {
  Params p;
  const int err = fill_params(p, b, x0, x, hist, r, q, dpad, part_dq, part_rr,
                              nv, nh, nb, noff, offsets, pad, n_iterations,
                              grid);
  if (err != cudaSuccess) return err;
  p.coef3 = coef3;
  return launch<false>(p, grid, stream);
}

// The const operator (tpcg_torch.ops.fused_cg_const): sb, st (2, noff, nh)
// and sl, sr (2, noff, nv - 2) strips; taps: host array of 2 * noff floats
// (cr, ci); group_of: host array of noff ints, the group of each tap (-1 for
// a zero tap), groups numbered in order of first appearance.  The other
// arguments as tpcg_fused_cg_stencil's.
int tpcg_fused_cg_const(const float* sb, const float* st, const float* sl,
                        const float* sr, const float* b, const float* x0,
                        float* x, float* hist, float* r, float* q, float* dpad,
                        float* part_dq, float* part_rr, int nv, int nh, int nb,
                        int noff, const int* offsets, const float* taps,
                        const int* group_of, int pad, int n_iterations,
                        int grid, void* stream) {
  if (nv < 3) return cudaErrorInvalidValue;
  Params p;
  const int err = fill_params(p, b, x0, x, hist, r, q, dpad, part_dq, part_rr,
                              nv, nh, nb, noff, offsets, pad, n_iterations,
                              grid);
  if (err != cudaSuccess) return err;
  p.sb = sb;
  p.st = st;
  p.sl = sl;
  p.sr = sr;
  for (int s = 0; s < noff; ++s)
    if (group_of[s] < -1 || group_of[s] >= noff) return cudaErrorInvalidValue;
  int t = 0;
  for (int g = 0; g < noff; ++g) {
    const int first = t;
    for (int s = 0; s < noff; ++s) {
      if (group_of[s] != g) continue;
      if (t == first) {
        p.gr[g] = taps[s];
        p.gi[g] = taps[noff + s];
      }
      p.gdisp[t++] = p.disp[s];
    }
    if (t == first) break;
    p.group_end[g] = t;
    p.ngroups = g + 1;
  }
  return launch<true>(p, grid, stream);
}

const char* tpcg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
