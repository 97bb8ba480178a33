// Whole-solve fixed-iteration COCG on a small complex banded matrix in
// row-DIA storage: one thread block per RHS, everything in shared memory.
//
// Replaces tpcg/ops/fused_cg_dia.py::_build_fused_dia_cplx, the Pallas
// kernel that keeps the value planes and the whole CG state of one RHS in a
// TPU core's VMEM and runs every iteration inside one pallas_call with no
// grid (the mhd1280b class: complex n = 1,280, 17 diagonals).
//
// What it computes (per RHS, independently), as the JAX kernel does:
//   r0 = b - A x0, delta0 = <r0, r0>, hist[0] = sqrt(sqrt(|delta0|^2))
//   each iteration: d = r + beta d; q = A d (qr += vr*dr - vi*di,
//   qi += vr*di + vi*dr in tap order); done = (|delta|^2 == 0) |
//   (|<d,q>|^2 == 0), evaluated afresh each iteration; alpha = done ? 0 :
//   delta / <d,q>; x += alpha d; r -= alpha q; delta' = <r, r>;
//   hist[it+1] = sqrt(sqrt(|delta'|^2)); beta = done ? 0 : delta' / delta
// with unconjugated dots and Smith-scaled complex division.
//
// What bounds it on the H100: latency.  At the mhd1280b class one
// iteration is ~0.2 MFLOP on ~200 KB of data, far too little to fill the
// card; a multi-block kernel pays three grid barriers per iteration (about
// 9 us per iteration for the cooperative chain of tpcg_torch/csrc/
// fused_cg.cu).  Inside one SM the same three barriers are __syncthreads.
//
// What the design does about it: the TPU point of the kernel was "all
// resident, no grid", and its counterpart here is one block per RHS.  The
// value planes (2 x ndiag x n floats), x, r and the zero-bordered direction
// sit in dynamic shared memory (above 48 KB through
// cudaFuncSetAttribute), so after the initial load nothing touches device
// memory but the history; q stays in registers (at most kRows rows per
// thread); the whole iteration loop runs in the block with three
// __syncthreads per iteration; independent RHS are independent blocks, as
// the JAX wrapper lax.maps columns.  Every thread sums the 32 warp partials
// of a dot in the same fixed order, so all threads hold bit-identical
// scalars and reruns agree bit for bit.  The rule for what fits is the
// card's shared memory per block: tpcg_fused_dia_smem_bytes, mirrored by
// tpcg_torch.ops.fused_cg_dia.fused_dia_smem_bytes.
//
// Numerics: build without --use_fast_math (which would flush denormals to
// zero and move the |.|^2 == 0 freeze guard).  Plain C interface, loaded
// with ctypes (tpcg_torch/ops/_build.py); entry points return cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows per thread: n <= kRows * kThreads

struct Params {
  const float* vals;  // (2, ndiag, n)             read-only
  const int* offs;    // (ndiag)                   read-only
  const float* b;     // (2, nb, n)                read-only
  const float* x0;    // (2, nb, n)                read-only
  float* x;           // (2, nb, n)                out
  float* hist;        // (n_iterations + 1, nb)    out
  int n, ndiag, nb, pad, n_iterations;
};

// Dynamic shared memory of one block, in bytes: values, x, r, the padded
// direction (floats), then the tap offsets (ints).
size_t smem_bytes(int n, int ndiag, int pad) {
  const size_t pn = static_cast<size_t>(n) + 2 * pad;
  return sizeof(float) * (2 * static_cast<size_t>(ndiag) * n + 4 * n + 2 * pn) +
         sizeof(int) * static_cast<size_t>(ndiag);
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Block-wide sum; every thread returns the same bits (fixed order).
__device__ __forceinline__ float2 block_sum(float2 v, float2* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  return t;
}

__device__ __forceinline__ float2 cdiv_smith(float2 a, float2 b) {
  const float m = fmaxf(fabsf(b.x), fabsf(b.y));
  const float ms = m == 0.f ? 1.f : m;
  const float b0 = b.x / ms, b1 = b.y / ms;
  const float d = (b0 * b0 + b1 * b1) * ms;
  return make_float2((a.x * b0 + a.y * b1) / d, (a.y * b0 - a.x * b1) / d);
}

__device__ __forceinline__ bool mag2_zero(float2 v) {
  return v.x * v.x + v.y * v.y == 0.f;
}

__global__ void __launch_bounds__(kThreads, 1) fused_dia_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float2 red_dq[kWarps];
  __shared__ float2 red_rr[kWarps];
  const int n = p.n, nd = p.ndiag, nb = p.nb, pad = p.pad;
  const int pn = n + 2 * pad;
  const int rhs = blockIdx.x, tid = threadIdx.x;
  float* const s_vals = smem;                       // (2, nd, n)
  float* const s_x = s_vals + 2 * nd * n;           // (2, n)
  float* const s_r = s_x + 2 * n;                   // (2, n)
  float* const s_d = s_r + 2 * n;                   // (2, pn), zero border
  int* const s_off = reinterpret_cast<int*>(s_d + 2 * pn);
  const float* const b_re = p.b + static_cast<size_t>(rhs) * n;
  const float* const b_im = p.b + static_cast<size_t>(nb + rhs) * n;
  const float* const x0_re = p.x0 + static_cast<size_t>(rhs) * n;
  const float* const x0_im = p.x0 + static_cast<size_t>(nb + rhs) * n;

  // q = A d at row i, from the padded direction in shared memory
  auto apply = [&](int i) {
    float qr = 0.f, qi = 0.f;
    const float* dr = s_d + pad + i;
    const float* di = dr + pn;
    for (int k = 0; k < nd; ++k) {
      const int off = s_off[k];
      const float vr = s_vals[k * n + i], vi = s_vals[(nd + k) * n + i];
      const float wr = dr[off], wi = di[off];
      qr = qr + vr * wr - vi * wi;
      qi = qi + vr * wi + vi * wr;
    }
    return make_float2(qr, qi);
  };

  // 1. values and taps into shared memory; the direction buffer zeroed
  for (int e = tid; e < 2 * nd * n; e += kThreads) s_vals[e] = __ldg(p.vals + e);
  for (int k = tid; k < nd; k += kThreads) s_off[k] = __ldg(p.offs + k);
  for (int e = tid; e < 2 * pn; e += kThreads) s_d[e] = 0.f;
  __syncthreads();

  // 2. x = x0, staged through the direction buffer for A x0
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = tid + k * kThreads;
    if (i < n) {
      const float xr = __ldg(x0_re + i), xi = __ldg(x0_im + i);
      s_x[i] = xr;
      s_x[n + i] = xi;
      s_d[pad + i] = xr;
      s_d[pn + pad + i] = xi;
    }
  }
  __syncthreads();

  // 3. r0 = b - A x0, delta0 = <r0, r0>
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = tid + k * kThreads;
    if (i < n) {
      const float2 q = apply(i);
      const float rr = __ldg(b_re + i) - q.x, ri = __ldg(b_im + i) - q.y;
      s_r[i] = rr;
      s_r[n + i] = ri;
      acc.x += rr * rr - ri * ri;
      acc.y += rr * ri;
    }
  }
  float2 s = block_sum(acc, red_rr);
  float2 delta = make_float2(s.x, 2.f * s.y);
  if (tid == 0) p.hist[rhs] = sqrtf(sqrtf(delta.x * delta.x + delta.y * delta.y));
  // the direction starts at zero, so the first update gives d = r (the
  // block_sum barrier above ordered every read of x0 before this)
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = tid + k * kThreads;
    if (i < n) {
      s_d[pad + i] = 0.f;
      s_d[pn + pad + i] = 0.f;
    }
  }
  float2 beta = make_float2(0.f, 0.f);

  for (int it = 0; it < p.n_iterations; ++it) {
    // d = r + beta d
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = tid + k * kThreads;
      if (i < n) {
        const float dr = s_d[pad + i], di = s_d[pn + pad + i];
        s_d[pad + i] = s_r[i] + beta.x * dr - beta.y * di;
        s_d[pn + pad + i] = s_r[n + i] + beta.x * di + beta.y * dr;
      }
    }
    __syncthreads();

    // q = A d (kept in registers) and <d, q>
    float qr[kRows], qi[kRows];
    acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = tid + k * kThreads;
      qr[k] = qi[k] = 0.f;
      if (i < n) {
        const float2 q = apply(i);
        qr[k] = q.x;
        qi[k] = q.y;
        const float dr = s_d[pad + i], di = s_d[pn + pad + i];
        acc.x += dr * q.x - di * q.y;
        acc.y += dr * q.y + di * q.x;
      }
    }
    const float2 dq = block_sum(acc, red_dq);
    const bool done = mag2_zero(delta) || mag2_zero(dq);
    const float2 alpha = done ? make_float2(0.f, 0.f) : cdiv_smith(delta, dq);

    // x += alpha d, r -= alpha q, delta' = <r, r>
    acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = tid + k * kThreads;
      if (i < n) {
        const float dr = s_d[pad + i], di = s_d[pn + pad + i];
        s_x[i] = s_x[i] + alpha.x * dr - alpha.y * di;
        s_x[n + i] = s_x[n + i] + alpha.x * di + alpha.y * dr;
        const float rr = s_r[i] - (alpha.x * qr[k] - alpha.y * qi[k]);
        const float ri = s_r[n + i] - (alpha.x * qi[k] + alpha.y * qr[k]);
        s_r[i] = rr;
        s_r[n + i] = ri;
        acc.x += rr * rr - ri * ri;
        acc.y += rr * ri;
      }
    }
    s = block_sum(acc, red_rr);
    const float2 dn = make_float2(s.x, 2.f * s.y);
    if (tid == 0)
      p.hist[static_cast<size_t>(it + 1) * nb + rhs] =
          sqrtf(sqrtf(dn.x * dn.x + dn.y * dn.y));
    beta = done ? make_float2(0.f, 0.f) : cdiv_smith(dn, delta);
    delta = dn;
  }

  // x out (each thread wrote only its own rows of s_x)
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = tid + k * kThreads;
    if (i < n) {
      p.x[static_cast<size_t>(rhs) * n + i] = s_x[i];
      p.x[static_cast<size_t>(nb + rhs) * n + i] = s_x[n + i];
    }
  }
}

}  // namespace

extern "C" {

// Kernel limits: rows per matrix, and the shared memory one block may use
// on the current device (static part of the kernel already subtracted).
int tpcg_fused_dia_limits(int* max_rows, int* max_dyn_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_dia_kernel);
  if (err != cudaSuccess) return err;
  *max_rows = kRows * kThreads;
  *max_dyn_smem = optin - static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// vals: (2, ndiag, n); offs: device array of ndiag ints with
// |offs[k]| <= pad; b, x0, x: (2, nb, n); hist: (n_iterations + 1, nb).
// One block of kThreads threads per RHS.
int tpcg_fused_dia(const float* vals, const int* offs, const float* b,
                   const float* x0, float* x, float* hist, int n, int ndiag,
                   int nb, int pad, int n_iterations, void* stream) {
  if (n < 1 || n > kRows * kThreads || ndiag < 1 || nb < 1 || pad < 0 ||
      n_iterations < 0)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, ndiag, pad);
  cudaError_t err = cudaFuncSetAttribute(
      fused_dia_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  Params p;
  p.vals = vals;
  p.offs = offs;
  p.b = b;
  p.x0 = x0;
  p.x = x;
  p.hist = hist;
  p.n = n;
  p.ndiag = ndiag;
  p.nb = nb;
  p.pad = pad;
  p.n_iterations = n_iterations;
  fused_dia_kernel<<<nb, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
