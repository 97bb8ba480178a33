// CSR sparse matrix times a block of right-hand sides, y = A X, float32,
// for matrices that no ordering makes banded.
//
// Replaces tpcg/ops/route_spmv.py::_routed_kernel_call (pallas_call at
// :138), the TPU's routing-network SpMV: y = sum_l vals_l * benes_l(x),
// each layer a Benes network of 2 log2(m) - 1 masked butterfly stages
// over a VMEM-resident x, with bit-packed masks streamed from HBM.  The
// network, the 1-bit mask packing and the power-of-two padding exist
// because the TPU has no usable gather (tpcg/ops/routing.py:1-12).  Hopper
// gathers through its L1 and L2 at full rate, so this kernel computes the
// same product from CSR, as the reference's vector-CSR kernel does
// (kernel/real/spmv.cl:5-50): no network, no masks, no padding.
//
// Mapping: one warp per row.  Lanes stride the row's nonzeros, read col
// and val once through the read-only path (__ldg) and gather x[col] for
// NC columns of the block, keeping NC partial sums in registers.  A
// __shfl_down_sync tree sums the lanes in a fixed order and lane 0 writes
// the row, so two launches give the same bits (no atomics).  Sums are
// float32, as JAX's layer sum is (route_spmv.py:133).  An empty row
// writes zeros.  The wrapper splits a block of more than 8 columns into
// launches of 8, 4, 2 and 1 columns.
//
// Complex instance: values as two float32 planes (re, im) in CSR order,
// x and y as (2, n, ldx) planes; four products per nonzero in one launch.
// It computes the function of JAX's routed_pair, which makes three
// Karatsuba passes over three value planes.
//
// What bounds it on the H100: bytes.  Each nonzero reads 8 B of col and
// val (12 B complex) and does 2 flops per column (8 complex); at the
// random-routed class (n = 97,578, nnz = 19.6 M) that is 157 MB a product
// against 39 MFLOP, ~47 us at 3.35 TB/s.  x (0.4 MB a column) stays in L2,
// so the gathers cost L2 traffic, not HBM bytes.  What it does about it:
// col and val are read once per launch, contiguous across a warp's lanes.
// Known waste: a row of ~7 nonzeros (the 1138_bus class) leaves 25 of 32
// lanes idle; row binning is later work.
//
// Numerics: build without --use_fast_math.  Plain C interface, loaded with
// ctypes (tpcg_torch/ops/_build.py); entry points return cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

struct Params {
  const int* row_ptr;  // (n + 1)                      read-only
  const int* col;      // (nnz)                        read-only
  const float* val;    // (nnz), complex: (2, nnz)     read-only
  const float* x;      // (n, ldx), complex: (2, n, ldx)  read-only
  float* y;            // as x                         out
  int n, nnz, ldx, c0;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    route_spmv_real(Params p) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.n) return;
  const int beg = __ldg(p.row_ptr + row);
  const int end = __ldg(p.row_ptr + row + 1);
  const float* x = p.x + p.c0;
  float acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = 0.0f;
  for (int j = beg + lane; j < end; j += 32) {
    const size_t c = static_cast<size_t>(__ldg(p.col + j)) * p.ldx;
    const float v = __ldg(p.val + j);
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = fmaf(v, __ldg(x + c + k), acc[k]);
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
    float* y = p.y + static_cast<size_t>(row) * p.ldx + p.c0;
#pragma unroll
    for (int k = 0; k < NC; ++k) y[k] = acc[k];
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    route_spmv_cplx(Params p) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.n) return;
  const int beg = __ldg(p.row_ptr + row);
  const int end = __ldg(p.row_ptr + row + 1);
  const size_t plane = static_cast<size_t>(p.n) * p.ldx;
  const float* xr = p.x + p.c0;
  const float* xi = xr + plane;
  float ar[NC], ai[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) ar[k] = ai[k] = 0.0f;
  for (int j = beg + lane; j < end; j += 32) {
    const size_t c = static_cast<size_t>(__ldg(p.col + j)) * p.ldx;
    const float vr = __ldg(p.val + j);
    const float vi = __ldg(p.val + p.nnz + j);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float wr = __ldg(xr + c + k);
      const float wi = __ldg(xi + c + k);
      ar[k] = fmaf(vr, wr, fmaf(-vi, wi, ar[k]));
      ai[k] = fmaf(vr, wi, fmaf(vi, wr, ai[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    ar[k] = warp_sum(ar[k]);
    ai[k] = warp_sum(ai[k]);
  }
  if (lane == 0) {
    float* yr = p.y + static_cast<size_t>(row) * p.ldx + p.c0;
    float* yi = yr + plane;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      yr[k] = ar[k];
      yi[k] = ai[k];
    }
  }
}

template <int NC>
void launch(const Params& p, int cplx, unsigned blocks, cudaStream_t s) {
  if (cplx)
    route_spmv_cplx<NC><<<blocks, kThreads, 0, s>>>(p);
  else
    route_spmv_real<NC><<<blocks, kThreads, 0, s>>>(p);
}

}  // namespace

extern "C" {

// y[:, c0:c0+nc] = A x[:, c0:c0+nc] for the CSR matrix (row_ptr, col,
// val) of n rows; x and y are (n, ldx) row-major (complex: (2, n, ldx)
// planes, val (2, nnz)).  nc is 1, 2, 4 or 8; 0 <= c0, c0 + nc <= ldx.
// Column indices must lie in [0, n) (the wrapper's containers check it).
int tpcg_route_spmv(const int* row_ptr, const int* col, const float* val,
                    const float* x, float* y, int n, int nnz, int ldx, int c0,
                    int nc, int cplx, void* stream) {
  if (n < 1 || nnz < 0 || c0 < 0 || ldx < c0 + nc) return cudaErrorInvalidValue;
  Params p;
  p.row_ptr = row_ptr;
  p.col = col;
  p.val = val;
  p.x = x;
  p.y = y;
  p.n = n;
  p.nnz = nnz;
  p.ldx = ldx;
  p.c0 = c0;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(n) + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1: launch<1>(p, cplx, blocks, s); break;
    case 2: launch<2>(p, cplx, blocks, s); break;
    case 4: launch<4>(p, cplx, blocks, s); break;
    case 8: launch<8>(p, cplx, blocks, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
