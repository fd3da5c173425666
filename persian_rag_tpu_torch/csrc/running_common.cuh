// Device helpers shared by the running top-k kernels
// (flat_topk_running.cu, flat_topk_running_select.cu) and the maxonly
// stream (flat_topk_maxonly.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kIntMin = INT32_MIN;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may ask

__device__ __forceinline__ int score_to_ikey(float s) {
  const int i = __float_as_int(s);
  return i < 0 ? (i ^ 0x7FFFFFFF) : i;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// cn_mode: 0 none (dot), 1 cv = ||c||^2 (l2), 2 cv = the row's scale.
__device__ __forceinline__ float finish_score(float s, int cn_mode, float cv) {
  if (cn_mode == 1) return __fsub_rn(__fmul_rn(2.f, s), cv);
  if (cn_mode == 2) return __fmul_rn(s, cv);
  return s;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
