// Fixed-iteration block CG (real) or COCG (complex) on a banded matrix in
// row-DIA storage, whole solve in one persistent cooperative launch.
//
// Replaces two Pallas kernels of tpcg/ops/stream_cg_dia.py:
//   * _build_dia_batch (and its nb=1 form _build_dia): real CG on a DIA
//     band, state resident in VMEM, the value diagonals streamed from HBM
//     once per iteration and applied to up to 8 RHS per fetch;
//   * _build_dia_cplx: the complex (two float planes) COCG twin, 1 RHS.
// Here one template covers both, for 1..8 RHS per launch.
//
// What it computes, per RHS b of nb independent recurrences:
//   q = A d      q[i] = sum_k vals[k, i] * d[i + off_k]   (row-DIA: data[d, i]
//                = A[i, i + off]); complex: qr += vr*dr - vi*di,
//                qi += vr*di + vi*dr
//   alpha = delta / <d,q>, beta = delta' / delta (complex: Smith division)
//   done |= (delta == 0) | (<d,q> == 0)            real freeze guard
//   done |= (|delta|^2 == 0) | (|<d,q>|^2 == 0)    complex freeze guard
//   latched per RHS until the next multiple of kLatchIters = 256 iterations
//   (JAX's latch lasts one call of _CHUNK = 256 iterations); a frozen RHS
//   keeps alpha = beta = 0 and its delta, so its direction is r and it
//   resumes from d = r where <d,q> reached 0 with delta not 0;
//   hist[it+1] = sqrt(delta) (real), sqrt(sqrt(|delta|^2)) (complex)
// with unconjugated dots <u,v> = sum u*v.
//
// What bounds it on the H100: bytes.  Each iteration reads every value
// once (the m_t1 class: 101 diagonals x 97,578 rows x 4 B = 39.4 MB; the
// parabolic class: 7 x 525,625 x 4 B = 14.7 MB) and, per RHS, the direction
// once per diagonal through L2, plus a few passes over the state.  With the
// state, m_t1 at 1 RHS sits just under the 50 MB L2 and above it at 8 RHS.
// The three grid barriers per iteration (after q = A d and the <d,q>
// partials; after the x, r update and the <r,r> partials; after the d
// update, which other rows read) add a fixed latency of a few microseconds.
//
// What the design does about it:
//   * it reads the matrix in its own row layout: across a warp, vals[k, i]
//     and d[i + off_k] are consecutive addresses, so every load is
//     coalesced and the TPU kernel's 128-lane column-major regrid and its
//     wrap-filled halo have no purpose here; the direction sits in a
//     zero-bordered buffer of length n + 2 max|off| instead;
//   * each value is loaded once per iteration and applied to all nb RHS of
//     the launch (the nb-fold value amortisation of _build_dia_batch);
//   * the tap list lives in shared memory, loaded once per launch, so the
//     101 diagonals of the m_t1 class cost no parameter space;
//   * one launch for the whole solve, no host round trip for the scalars;
//   * at most two blocks of 512 threads per SM, all co-resident; the grid
//     size depends on n only, so a RHS gives the same bits whatever the
//     launch's RHS count;
//   * dot products reduce in a fixed order (thread, warp shuffle, shared
//     memory, then over blocks in block order, the same in every block), so
//     every block derives bit-identical scalars and reruns agree bit for
//     bit.
// The direction, which other blocks write, is read with __ldcg (L2,
// coherent) after a grid barrier; values, b and x0 go through __ldg.
// wgmma and TMA have no place here: there is no matrix product.
//
// Numerics: build without --use_fast_math (which would flush denormals to
// zero and move the freeze guards).  Plain C interface, loaded with ctypes
// (tpcg_torch/ops/_build.py); every entry point returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxRhs = 8;
constexpr int kMaxDiags = 4096;
constexpr int kLatchIters = 256;  // tpcg/ops/stream_cg_dia.py::_CHUNK

struct Params {
  const float* vals;  // (P, ndiag, n)                      read-only
  const int* offs;    // (ndiag)                            read-only
  const float* b;     // (P, nb, n)                         read-only
  const float* x0;    // (P, nb, n)                         read-only
  float* x;           // (P, nb, n)                         out
  float* hist;        // (n_iterations + 1, nb)             out
  float* r;           // (P, nb, n)                         scratch
  float* q;           // (P, nb, n)                         scratch
  float* dpad;        // (P, nb, n + 2 pad)                 scratch
  float* part_dq;     // (gridDim.x, nb, 2) partials <d,q>  scratch
  float* part_rr;     // (gridDim.x, nb, 2) partials <r,r>  scratch
  int n, ndiag, pad, n_iterations;
};

__device__ __forceinline__ float2 warp_sum(float2 v) {
  // xor butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// Block-wide sums of acc[0..NB); block partial of RHS b goes to
// part[(blockIdx.x * NB + b) * 2 + {0, 1}].
template <int NB>
__device__ void block_partials(const float2 (&acc)[NB],
                               float2 (*red)[kMaxRhs], float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float2 v = warp_sum(acc[b]);
    if (lane == 0) red[warp][b] = v;
  }
  __syncthreads();
  if (warp < NB) {
    float2 w = lane < kWarps ? red[lane][warp] : make_float2(0.f, 0.f);
    w = warp_sum(w);
    if (lane == 0) {
      float* o = part + (static_cast<size_t>(blockIdx.x) * NB + warp) * 2;
      o[0] = w.x;
      o[1] = w.y;
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

// Smith-scaled complex division a / b (tpcg/ops/stream_cg.py::_smith_cdiv).
__device__ __forceinline__ float2 cdiv_smith(float2 a, float2 b) {
  const float m = fmaxf(fabsf(b.x), fabsf(b.y));
  const float ms = m == 0.f ? 1.f : m;
  const float b0 = b.x / ms, b1 = b.y / ms;
  const float d = (b0 * b0 + b1 * b1) * ms;
  return make_float2((a.x * b0 + a.y * b1) / d, (a.y * b0 - a.x * b1) / d);
}

// The freeze test of one scalar: exact zero (real), |.|^2 == 0 (complex,
// tpcg/ops/stream_cg.py::_mag2_zero).
template <bool CPLX>
__device__ __forceinline__ bool is_zero(float2 v) {
  return CPLX ? v.x * v.x + v.y * v.y == 0.f : v.x == 0.f;
}

template <bool CPLX>
__device__ __forceinline__ float2 div_scalar(float2 a, float2 b) {
  return CPLX ? cdiv_smith(a, b) : make_float2(a.x / b.x, 0.f);
}

template <bool CPLX>
__device__ __forceinline__ float hist_of(float2 dl) {
  return CPLX ? sqrtf(sqrtf(dl.x * dl.x + dl.y * dl.y)) : sqrtf(dl.x);
}

// (A d)[i] for the NB RHS; d0 points at element i of RHS 0, plane 0, in the
// padded direction buffer.
template <bool CPLX, int NB>
__device__ __forceinline__ void apply_row(const Params& p, const int* s_off,
                                          int i, size_t pn, const float* d0,
                                          float (&qr)[NB], float (&qi)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) qr[b] = qi[b] = 0.f;
  const float* d1 = d0 + NB * pn;  // plane 1 (complex only)
#pragma unroll 4
  for (int k = 0; k < p.ndiag; ++k) {
    const int off = s_off[k];
    const float vr = __ldg(p.vals + static_cast<size_t>(k) * p.n + i);
    if (CPLX) {
      const float vi =
          __ldg(p.vals + static_cast<size_t>(p.ndiag + k) * p.n + i);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float wr = __ldcg(d0 + b * pn + off);
        const float wi = __ldcg(d1 + b * pn + off);
        qr[b] = qr[b] + vr * wr - vi * wi;
        qi[b] = qi[b] + vr * wi + vi * wr;
      }
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b) qr[b] = qr[b] + vr * __ldcg(d0 + b * pn + off);
    }
  }
}

template <bool CPLX, int NB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    stream_dia_kernel(Params p) {
  constexpr int P = CPLX ? 2 : 1;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int s_off[];  // ndiag tap offsets
  __shared__ float2 red[kWarps][kMaxRhs];
  __shared__ float2 s_delta[NB];
  __shared__ float2 s_alpha[NB];
  __shared__ float2 s_beta[NB];
  __shared__ int s_done[NB];

  const int n = p.n, pad = p.pad;
  const size_t pn = static_cast<size_t>(n) + 2 * pad;
  const int nblocks = gridDim.x;
  const int stride = nblocks * kThreads;
  const int t0 = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // element i of RHS b, plane c: in (P, NB, n) and in dpad
  auto at = [&](int c, int b, int i) {
    return static_cast<size_t>(c * NB + b) * n + i;
  };
  auto pad_at = [&](int c, int b, int i) {
    return static_cast<size_t>(c * NB + b) * pn + pad + i;
  };

  // 1. taps to shared memory; zero the padded direction buffer, whose
  //    border stays zero for the whole solve.
  for (int k = threadIdx.x; k < p.ndiag; k += kThreads) s_off[k] = p.offs[k];
  if (threadIdx.x < NB) s_done[threadIdx.x] = 0;
  for (size_t e = t0; e < static_cast<size_t>(P) * NB * pn; e += stride)
    p.dpad[e] = 0.f;
  grid.sync();

  // 2. x = x0, staged through the padded buffer for A x0.
  for (int i = t0; i < n; i += stride) {
#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float v = __ldg(p.x0 + at(c, b, i));
        p.x[at(c, b, i)] = v;
        p.dpad[pad_at(c, b, i)] = v;
      }
    }
  }
  grid.sync();

  // 3. r0 = b - A x0 and the partials of <r0, r0>.
  {
    float2 acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = make_float2(0.f, 0.f);
    for (int i = t0; i < n; i += stride) {
      float qr[NB], qi[NB];
      apply_row<CPLX, NB>(p, s_off, i, pn, p.dpad + pad_at(0, 0, i), qr, qi);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float rr = __ldg(p.b + at(0, b, i)) - qr[b];
        p.r[at(0, b, i)] = rr;
        if (CPLX) {
          const float ri = __ldg(p.b + at(1, b, i)) - qi[b];
          p.r[at(1, b, i)] = ri;
          acc[b].x += rr * rr - ri * ri;
          acc[b].y += rr * ri;
        } else {
          acc[b].x += rr * rr;
        }
      }
    }
    block_partials<NB>(acc, red, p.part_rr);
  }
  grid.sync();

  // 4. delta0 and hist[0]; d0 = r0 (every block is past its reads of x0).
  if (warp < NB) {
    const float2 t = grid_total(p.part_rr, nblocks, NB, warp);
    if (lane == 0) {
      const float2 dl = make_float2(t.x, CPLX ? 2.f * t.y : 0.f);
      s_delta[warp] = dl;
      if (blockIdx.x == 0) p.hist[warp] = hist_of<CPLX>(dl);
    }
  }
  for (int i = t0; i < n; i += stride) {
#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
      for (int b = 0; b < NB; ++b) p.dpad[pad_at(c, b, i)] = p.r[at(c, b, i)];
    }
  }
  grid.sync();

  for (int it = 0; it < p.n_iterations; ++it) {
    // phase 1: q = A d and the partials of <d, q>.
    {
      float2 acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = make_float2(0.f, 0.f);
      for (int i = t0; i < n; i += stride) {
        float qr[NB], qi[NB];
        apply_row<CPLX, NB>(p, s_off, i, pn, p.dpad + pad_at(0, 0, i), qr, qi);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float dr = __ldcg(p.dpad + pad_at(0, b, i));
          p.q[at(0, b, i)] = qr[b];
          if (CPLX) {
            const float di = __ldcg(p.dpad + pad_at(1, b, i));
            p.q[at(1, b, i)] = qi[b];
            acc[b].x += dr * qr[b] - di * qi[b];
            acc[b].y += dr * qi[b] + di * qr[b];
          } else {
            acc[b].x += dr * qr[b];
          }
        }
      }
      block_partials<NB>(acc, red, p.part_dq);
    }
    grid.sync();

    // phase 2: alpha (bit-identical in every block), x += alpha d,
    // r -= alpha q, and the partials of <r, r>.
    if (warp < NB) {
      const float2 dq = grid_total(p.part_dq, nblocks, NB, warp);
      if (lane == 0) {
        const float2 dl = s_delta[warp];
        const int done = (s_done[warp] && it % kLatchIters != 0) ||
                         is_zero<CPLX>(dl) || is_zero<CPLX>(dq);
        s_done[warp] = done;
        s_alpha[warp] =
            done ? make_float2(0.f, 0.f) : div_scalar<CPLX>(dl, dq);
      }
    }
    __syncthreads();
    {
      float2 acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = make_float2(0.f, 0.f);
      for (int i = t0; i < n; i += stride) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float2 a = s_alpha[b];
          const size_t ir = at(0, b, i);
          const float dr = __ldcg(p.dpad + pad_at(0, b, i));
          if (CPLX) {
            const size_t ii = at(1, b, i);
            const float di = __ldcg(p.dpad + pad_at(1, b, i));
            const float qr = p.q[ir], qi = p.q[ii];
            p.x[ir] = p.x[ir] + a.x * dr - a.y * di;
            p.x[ii] = p.x[ii] + a.x * di + a.y * dr;
            const float rr = p.r[ir] - (a.x * qr - a.y * qi);
            const float ri = p.r[ii] - (a.x * qi + a.y * qr);
            p.r[ir] = rr;
            p.r[ii] = ri;
            acc[b].x += rr * rr - ri * ri;
            acc[b].y += rr * ri;
          } else {
            p.x[ir] = p.x[ir] + a.x * dr;
            const float rr = p.r[ir] - a.x * p.q[ir];
            p.r[ir] = rr;
            acc[b].x += rr * rr;
          }
        }
      }
      block_partials<NB>(acc, red, p.part_rr);
    }
    grid.sync();

    // phase 3: beta, delta (held while frozen), hist[it+1], d = r + beta d.
    if (warp < NB) {
      const float2 t = grid_total(p.part_rr, nblocks, NB, warp);
      if (lane == 0) {
        const float2 dn = make_float2(t.x, CPLX ? 2.f * t.y : 0.f);
        const float2 dl = s_delta[warp];
        const int done = s_done[warp];
        s_beta[warp] = done ? make_float2(0.f, 0.f) : div_scalar<CPLX>(dn, dl);
        const float2 keep = done ? dl : dn;
        s_delta[warp] = keep;
        if (blockIdx.x == 0)
          p.hist[static_cast<size_t>(it + 1) * NB + warp] = hist_of<CPLX>(keep);
      }
    }
    __syncthreads();
    for (int i = t0; i < n; i += stride) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float2 be = s_beta[b];
        const size_t pr = pad_at(0, b, i);
        const float dr = __ldcg(p.dpad + pr);
        if (CPLX) {
          const size_t pi = pad_at(1, b, i);
          const float di = __ldcg(p.dpad + pi);
          p.dpad[pr] = p.r[at(0, b, i)] + be.x * dr - be.y * di;
          p.dpad[pi] = p.r[at(1, b, i)] + be.x * di + be.y * dr;
        } else {
          p.dpad[pr] = p.r[at(0, b, i)] + be.x * dr;
        }
      }
    }
    grid.sync();
  }
}

using KernelFn = void (*)(Params);

template <bool CPLX>
KernelFn pick(int nb) {
  switch (nb) {
    case 1: return stream_dia_kernel<CPLX, 1>;
    case 2: return stream_dia_kernel<CPLX, 2>;
    case 3: return stream_dia_kernel<CPLX, 3>;
    case 4: return stream_dia_kernel<CPLX, 4>;
    case 5: return stream_dia_kernel<CPLX, 5>;
    case 6: return stream_dia_kernel<CPLX, 6>;
    case 7: return stream_dia_kernel<CPLX, 7>;
    case 8: return stream_dia_kernel<CPLX, 8>;
    default: return nullptr;
  }
}

KernelFn kernel_for(int cplx, int nb) {
  return cplx ? pick<true>(nb) : pick<false>(nb);
}

}  // namespace

extern "C" {

// Kernel limits: RHS per launch, diagonals per matrix.
int tpcg_stream_dia_limits(int* max_rhs, int* max_diags) {
  *max_rhs = kMaxRhs;
  *max_diags = kMaxDiags;
  return 0;
}

// Grid size for n rows on the current device: one row per thread where the
// card has room, at most kBlocksPerSm blocks per SM, never more than can be
// co-resident (a larger cooperative launch is refused).
int tpcg_stream_dia_grid(int cplx, int nb, int n, int ndiag, int* grid_out) {
  const KernelFn fn = kernel_for(cplx, nb);
  if (fn == nullptr || n < 1 || ndiag < 1 || ndiag > kMaxDiags)
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
      &per_sm, fn, kThreads, static_cast<size_t>(ndiag) * sizeof(int));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  int g = (n + kThreads - 1) / kThreads;
  if (g > per_sm * sms) g = per_sm * sms;
  *grid_out = g < 1 ? 1 : g;
  return 0;
}

// vals: (cplx ? 2 : 1, ndiag, n); offs: device array of ndiag ints with
// |offs[k]| <= pad; b, x0, x, r, q: (cplx ? 2 : 1, nb, n); dpad:
// (cplx ? 2 : 1, nb, n + 2 pad); hist: (n_iterations + 1, nb); part_dq and
// part_rr: grid * nb * 2 floats each.  grid: from tpcg_stream_dia_grid.
int tpcg_stream_dia(int cplx, const float* vals, const int* offs,
                    const float* b, const float* x0, float* x, float* hist,
                    float* r, float* q, float* dpad, float* part_dq,
                    float* part_rr, int n, int ndiag, int nb, int pad,
                    int n_iterations, int grid, void* stream) {
  const KernelFn fn = kernel_for(cplx, nb);
  if (fn == nullptr || n < 1 || ndiag < 1 || ndiag > kMaxDiags || pad < 0 ||
      n_iterations < 0 || grid < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.vals = vals;
  p.offs = offs;
  p.b = b;
  p.x0 = x0;
  p.x = x;
  p.hist = hist;
  p.r = r;
  p.q = q;
  p.dpad = dpad;
  p.part_dq = part_dq;
  p.part_rr = part_rr;
  p.n = n;
  p.ndiag = ndiag;
  p.pad = pad;
  p.n_iterations = n_iterations;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fn), dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(ndiag) * sizeof(int),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
