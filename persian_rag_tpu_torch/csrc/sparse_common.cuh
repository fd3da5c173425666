// Pieces shared by the lexical kernels (sparse_topk.cu: #10-#13;
// sparse_stage1.cu: #12's and #13's stage 1): the 64-bit ranking keys, the
// open-addressed table of a query block's terms, and the merge of a query's
// tile lists on the card.
//
// Ranking uses a 64-bit key (monotone f32 bits << 32 | ~column): keys are
// unique, so the largest keys are an exact, tie-ordered top-k (score
// descending, lower column first). -0 is canonicalised to +0 first, so that
// it ties with +0 as the float compare does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;

__device__ __forceinline__ unsigned long long make_key(float s, int col) {
  const float c = __fadd_rn(s, 0.0f);  // -0 -> +0
  const uint32_t u = __float_as_uint(c);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (uint32_t)(0xFFFFFFFFu - (uint32_t)col);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t ord = (uint32_t)(key >> 32);
  const uint32_t u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_col(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

// term ids -> table slots, Fibonacci hashing into 2^log_h slots
__device__ __forceinline__ unsigned term_slot(int id, int log_h) {
  return ((unsigned)id * 0x9E3779B1u) >> (32 - log_h);
}

// The number of term `id` in the block's table (slot {id, number}, -1
// empty), or -1 when no query of the block holds it.
__device__ __forceinline__ int term_number(const int2* table, int log_h,
                                           int id) {
  const unsigned mask = (1u << log_h) - 1u;
  for (unsigned h = term_slot(id, log_h);; h = (h + 1u) & mask) {
    const int2 e = table[h];
    if (e.x == id) return e.y;
    if (e.x < 0) return -1;
  }
}

// x rounded to bf16, to nearest even, and widened back (stage 1)
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The merge of a launch's lists: query b's n_lists lists of kt entries
// (each by score descending, then lower id; ids global) -> its top k in the
// same order, which a stable sort of the lists by score gives too. A warp a
// query: lane l keeps the heads of lists l, l + 32, ... in shared memory and
// the largest key among them; each of k rounds writes the warp's largest
// key, and the lane holding it advances that list. Keys are unique for real
// docs; among pads (id -1) the lowest lane advances.
__global__ void __launch_bounds__(32)
merge_tiles_kernel(const float* __restrict__ tile_s,
                   const int32_t* __restrict__ tile_i, int n_lists, int kt,
                   int k, float* __restrict__ out_s,
                   int32_t* __restrict__ out_i) {
  extern __shared__ unsigned short heads[];  // n_lists
  const int lane = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * n_lists * kt;
  const float* s = tile_s + row;
  const int32_t* ids = tile_i + row;
  for (int j = lane; j < n_lists; j += 32) heads[j] = 0;
  __syncwarp();
  unsigned long long best = 0ull;  // 0: no entry left
  int best_j = -1;
  auto rescan = [&]() {
    best = 0ull;
    best_j = -1;
    for (int j = lane; j < n_lists; j += 32) {
      const int h = heads[j];
      if (h >= kt) continue;
      const size_t e = (size_t)j * kt + h;
      const unsigned long long key = make_key(s[e], ids[e]);
      if (key > best) {
        best = key;
        best_j = j;
      }
    }
  };
  rescan();
  float* dst_s = out_s + (size_t)blockIdx.x * k;
  int32_t* dst_i = out_i + (size_t)blockIdx.x * k;
  for (int r = 0; r < k; ++r) {
    unsigned long long m = best;
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, x);
      m = other > m ? other : m;
    }
    const unsigned owner = __ballot_sync(0xffffffffu, best_j >= 0 && best == m);
    if (lane == 0) {
      dst_s[r] = m == 0ull ? kNegInf : key_score(m);
      dst_i[r] = m == 0ull ? -1 : key_col(m);
    }
    if (owner != 0u && lane == __ffs(owner) - 1) {
      ++heads[best_j];
      rescan();
    }
  }
}

// merge_tiles_kernel over n_q queries' lists, on stream st.
int launch_merge(const void* tile_s, const void* tile_i, int n_q, int n_lists,
                 int kt, int k, void* res_s, void* res_i, cudaStream_t st) {
  const size_t heads = (size_t)n_lists * sizeof(unsigned short);
  if (heads > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)heads);
    if (err != cudaSuccess) return (int)err;
  }
  merge_tiles_kernel<<<n_q, 32, heads, st>>>(
      static_cast<const float*>(tile_s), static_cast<const int32_t*>(tile_i),
      n_lists, kt, k, static_cast<float*>(res_s),
      static_cast<int32_t*>(res_i));
  return (int)cudaGetLastError();
}

}  // namespace
