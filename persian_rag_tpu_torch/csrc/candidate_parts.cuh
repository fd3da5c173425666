// The part-and-merge selection of the register-stream stage-1 kernels
// (flat_topk_candidates_x2.cu, flat_topk_candidates_int8.cu): a block scores
// one part of a tile's rows and selects each query's top ne1 keys of it; a
// second kernel merges a tile's parts. The tile's top ne1 lies in the union
// of its parts' top ne1, and keys inside a tile are unique (column bits) but
// INT_MIN, so the merge is exact and the last of the ne1 keys is the largest
// key left behind.
#pragma once

#include "row_stream.cuh"

namespace {

constexpr int kColMask = (1 << 11) - 1;
constexpr int kMaxNE1 = 8;        // n_easy + 1 <= 8
constexpr int kMaxTileN = 2048;   // the key's 11 column bits
constexpr int kSmallQ = 16;       // batches of at most this many: 16 a block
constexpr int kTinyQ = 8;         // and of at most this many: 8 a block

// keys: QB x ROWS (a part's keys for the block's queries q0 ..). A warp a
// query: its top ne1 keys, by rounds of a warp maximum (keys are unique but
// INT_MIN, so one lane holds each), to lists (n_q, n_tiles, parts, ne1).
template <int QB, int ROWS>
__device__ __forceinline__ void part_top(const int* keys, int q0, int n_q,
                                         int tile, int n_tiles, int parts,
                                         int part, int ne1,
                                         int32_t* __restrict__ lists) {
  constexpr int kPer = ROWS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < QB && q0 + b < n_q; b += kWarps) {
    int k[kPer];
    int best = kIntMin;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      k[i] = keys[b * ROWS + i * 32 + lane];
      best = max(best, k[i]);
    }
    int32_t* dst =
        lists + (((size_t)(q0 + b) * n_tiles + tile) * parts + part) * ne1;
    for (int r = 0; r < ne1; ++r) {
      const int m = warp_max(best);
      if (lane == 0) dst[r] = m;
      if (m != kIntMin && best == m) {  // this lane holds it: retire it
        best = kIntMin;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          k[i] = k[i] == m ? kIntMin : k[i];
          best = max(best, k[i]);
        }
      }
    }
  }
}

// A tile's top ne1 keys from its parts' lists (rows of parts * ne1 <= 64
// keys, one a (query, tile)): a warp a row, ne1 rounds of a warp maximum.
__global__ void __launch_bounds__(kThreads)
merge_parts_kernel(const int32_t* __restrict__ lists, int32_t* __restrict__ out,
                   int rows, int parts, int ne1) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int m_keys = parts * ne1;  // <= 64
  const int32_t* src = lists + (size_t)row * m_keys;
  int v0 = lane < m_keys ? src[lane] : kIntMin;
  int v1 = lane + 32 < m_keys ? src[lane + 32] : kIntMin;
  int32_t* dst = out + (size_t)row * ne1;
  for (int r = 0; r < ne1; ++r) {
    const int m = warp_max(max(v0, v1));
    if (lane == 0) dst[r] = m;
    if (m != kIntMin) {
      if (v0 == m) {
        v0 = kIntMin;
      } else if (v1 == m) {
        v1 = kIntMin;
      }
    }
  }
}

// The merge of a launch's parts (when a tile has more than one) into out:
// rows = n_q * n_tiles lists.
cudaError_t merge_parts(const int32_t* scratch, int32_t* out, int rows,
                        int parts, int ne1, cudaStream_t stream) {
  merge_parts_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      scratch, out, rows, parts, ne1);
  return cudaGetLastError();
}

}  // namespace
