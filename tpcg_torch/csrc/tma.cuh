// TMA tile copies, mbarriers and proxy fences (PTX for sm_90a), and the
// host's tensor-map encoder, for the streaming kernels that feed their tiles
// by the Tensor Memory Accelerator (csrc/stream_cg.cu, csrc/stream_cg_coef.cu,
// csrc/stream_cg_sym.cu, csrc/stream_cg_real.cu).
// The encoder is cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so that the library need not link libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tpcg_tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of the given parity to complete; trap after ~20 s
// (a copy that never lands is a fault, not a hang).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// A 3-D tile copy of the map's box at coordinates (c0, c1, c2), completing
// on bar.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's generic-proxy accesses before later async-proxy
// (TMA) accesses, and the reverse.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's entry-point query; nullptr
// where the entry point is missing.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A map over `planes` float planes of (nv, nh) with row pitch `pitch` at
// base, read in boxes of (cols, rows, box_planes); out-of-bounds elements
// read 0.  plane_major = false orders the map's dimensions (columns,
// planes, rows), so that a box lands as [row][plane][column].
inline bool encode(EncodeTiled fn, CUtensorMap* map, const float* base,
                   int nh, int nv, int planes, int pitch, int cols, int rows,
                   int box_planes, bool plane_major = true) {
  const cuuint64_t row = static_cast<cuuint64_t>(pitch) * sizeof(float);
  const cuuint64_t pl = row * nv;
  const cuuint64_t dims[3] = {
      static_cast<cuuint64_t>(nh),
      static_cast<cuuint64_t>(plane_major ? nv : planes),
      static_cast<cuuint64_t>(plane_major ? planes : nv)};
  const cuuint64_t strides[2] = {plane_major ? row : pl,
                                 plane_major ? pl : row};
  const cuuint32_t box[3] = {
      static_cast<cuuint32_t>(cols),
      static_cast<cuuint32_t>(plane_major ? rows : box_planes),
      static_cast<cuuint32_t>(plane_major ? box_planes : rows)};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tpcg_tma
