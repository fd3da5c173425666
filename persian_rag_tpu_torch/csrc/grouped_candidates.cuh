// The grouped / lane-sliced stage 1 (#3) on the register stream:
// flat_topk_candidates.cu says what it computes and why it is shaped so.
// Its instantiations are split by row type over that file (bf16) and
// flat_topk_candidates_grouped_int8.cu, so that nvcc builds them in
// parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"

// One launch of the grouped kernel: prt_extract_candidates_grouped's
// arguments and the query window and shared memory worked out for them.
struct GroupedLaunch {
  const float* q;
  const void* c;
  const float* cv;  // ||c||^2 (cn_mode 1), row scales (2) or NULL (0)
  int cn_mode, trans;
  int32_t* out;
  int n_q, n, d, tile_n, n_easy, group, depth, qb, wslabs;
  size_t smem;
  cudaStream_t stream;
};

// The launch over bf16 and int8 rows, each in its own source.
cudaError_t grouped_bf16(const GroupedLaunch& l);
cudaError_t grouped_int8(const GroupedLaunch& l);

namespace {

constexpr int kColMask = (1 << 11) - 1;
constexpr int kMaxNE1 = 8;  // n_easy + 1 <= 8

// Merge the descending carry x[0..W) into the descending list of one
// (query, slot), l[e * C] for level e < levels (unique keys but INT_MIN):
// each level keeps the largest of itself and the carry, the rest moves on.
template <int W>
__device__ __forceinline__ void slot_merge(int* l, int C, int levels,
                                           int (&x)[W]) {
  for (int e = 0; e < levels; ++e) {
    int v = l[e * C];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int hi = max(x[j], v);
      v = min(x[j], v);
      x[j] = hi;
    }
    l[e * C] = x[0];
#pragma unroll
    for (int j = 0; j + 1 < W; ++j) x[j] = x[j + 1];
    x[W - 1] = v;
  }
}

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int hi = max(a, b);
  b = min(a, b);
  a = hi;
}

// Block (query block, tile): rows [col0, col0 + tile_cols) of c for
// queries q0 .. q0 + QB - 1 on stream_rows, each 256-row chunk's keys
// reduced into the per-(query, slot) top-levels table in shared memory
// (level e of query b's slot s at slots[b * width + e * C + s]); at the
// tile's end each query's n_easy ranks and bound from its table.
// Shared memory: the query window (wslabs KSE x QS f32, bf16-rounded), the
// ring, the table (QB x width int32). Two blocks an SM: 32, 16 or 8
// queries, within 128 registers a thread.
template <typename CT, int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 2)
extract_grouped_kernel(const float* __restrict__ q, const CT* __restrict__ c,
                       const float* __restrict__ cv, int cn_mode,
                       int32_t* __restrict__ out, int n_q, int n, int d,
                       int tile_n, int n_easy, int group, int depth,
                       int trans, int wslabs) {
  typedef StreamShape<QB> S;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + KSE - 1) / KSE * KSE;
  float* qs = reinterpret_cast<float*>(smem_raw);
  unsigned char* ring =
      smem_raw + (size_t)wslabs * KSE * S::QS * sizeof(float);
  int* slots = reinterpret_cast<int*>(ring + (size_t)S::STAGES * S::STAGE);
  const int C = tile_n / group;
  const int levels = min(depth, group);
  const int width = levels * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int col0 = tile * tile_n;
  const int tile_cols = min(tile_n, n - col0);
  const int qg = (warp % S::WQ) * S::TQ;  // the thread's first query
  const int half = warp / S::WQ;          // and its row half
  // A thread's rows i = 0..3 lie 32 i columns apart, so rows i and j share
  // a slot where C divides 32 (j - i): all four (p = 1), i and i + 2 (p =
  // 2), 0 and 3 (p = 3), or none (p = 4). Lanes of one row i hit C
  // consecutive slots: distinct where C >= 32, else in turns of C lanes.
  const int p = 32 % C == 0 ? 1 : 64 % C == 0 ? 2 : 96 % C == 0 ? 3 : 4;
  const int span = min(C, 32);

  for (int i = threadIdx.x; i < QB * width; i += kThreads) slots[i] = kIntMin;

  // slabs [slab0, slab0 + count) of the queries, 4 queries at one k a
  // thread, rounded to bf16
  auto load_q = [&](int slab0, int count) {
    const int k0 = slab0 * KSE, kn = count * KSE;
    for (int i = threadIdx.x; i < kn * (QB / 4); i += kThreads) {
      const int g = i / kn, kk = i - g * kn, k = k0 + kk;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = q0 + 4 * g + e;
        v[e] = round_bf16((j < n_q && k < d) ? q[(size_t)j * d + k] : 0.f);
      }
      *reinterpret_cast<float4*>(qs + kk * S::QS + 4 * g) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  stream_rows<CT, QB, ASYNC>(
      c, qs, ring, col0, col0 + tile_cols, n, d, dpad, wslabs, trans, false,
      load_q, [&](int row0, float (&acc)[S::TQ][S::TR]) {
        const int cb = row0 - col0;  // the thread's row 0 in the tile
        int key[S::TQ][S::TR];
#pragma unroll
        for (int i = 0; i < S::TR; ++i) {
          const int col = cb + 32 * i;
          const bool valid = col < tile_cols;
          const float rv = (cn_mode != 0 && valid) ? cv[col0 + col] : 0.f;
#pragma unroll
          for (int a = 0; a < S::TQ; ++a)
            key[a][i] = valid ? ((score_to_ikey(finish_score(acc[a][i],
                                                             cn_mode, rv)) &
                                  ~kColMask) |
                                 (tile_n - 1 - col))
                              : kIntMin;
        }
        // the row halves in turn (their rows may share slots); inside a
        // half, a thread's rows of one slot are merged in registers first,
        // then its slots one step at a time (another lane's row of another
        // step may share a slot)
        const int steps = p == 1 ? 1 : p == 2 ? 2 : S::TR;
        for (int ph = 0; ph < 2; ++ph) {
          if (half == ph) {
#pragma unroll
            for (int i = 0; i < S::TR; ++i) {
              if (i >= steps) break;  // warp-uniform
              int* l = slots + qg * width + (cb + 32 * i) % C;
              for (int base = 0; base < 32; base += span) {
                if (lane >= base && lane < base + span) {
#pragma unroll
                  for (int a = 0; a < S::TQ; ++a) {
                    if (p == 1) {  // all four rows: one slot
                      int x[4] = {key[a][0], key[a][1], key[a][2],
                                  key[a][3]};
                      sort2(x[0], x[1]);
                      sort2(x[2], x[3]);
                      sort2(x[0], x[2]);
                      sort2(x[1], x[3]);
                      sort2(x[1], x[2]);
                      slot_merge<4>(l + a * width, C, levels, x);
                    } else if (p == 2) {  // rows i and i + 2
                      int x[2] = {key[a][i], key[a][(i + 2) & 3]};
                      sort2(x[0], x[1]);
                      slot_merge<2>(l + a * width, C, levels, x);
                    } else {
                      int x[1] = {key[a][i]};
                      slot_merge<1>(l + a * width, C, levels, x);
                    }
                  }
                }
                __syncwarp();
              }
            }
          }
          if (ph == 0) __syncthreads();  // the first half's merges are in
        }
      });
  __syncthreads();  // the last chunk's merges are in

  // each query's n_easy ranks and bound, a warp a query: a pass per lane
  // over the table keeping its top n_easy + 1, then n_easy + 1 rounds of
  // a warp maximum (the tile's top n_easy + 1 lies in the union of the
  // lanes' top n_easy + 1; keys are unique but INT_MIN)
  const int deep_first = (levels - 1) * C;
  for (int b = warp; b < QB && q0 + b < n_q; b += kWarps) {
    const int* l = slots + b * width;
    int top[kMaxNE1];
#pragma unroll
    for (int e = 0; e < kMaxNE1; ++e) top[e] = kIntMin;
    int deep = kIntMin;
    for (int i = lane; i < width; i += 32) {
      int x = l[i];
      if (i >= deep_first) deep = max(deep, x);
#pragma unroll
      for (int e = 0; e < kMaxNE1; ++e) {
        const int hi = max(top[e], x);
        x = min(top[e], x);
        top[e] = hi;
      }
    }
    deep = warp_max(deep);
    if (depth > group) deep = kIntMin;  // nothing hides behind a slot
    // the last round's key, max'ed with the deepest level, is the bound
    int32_t* dst = out + ((size_t)(q0 + b) * n_tiles + tile) * (n_easy + 1);
    for (int e = 0; e <= n_easy; ++e) {
      int m = warp_max(top[0]);
      if (top[0] == m) {  // the (unique) owner pops
#pragma unroll
        for (int t = 0; t + 1 < kMaxNE1; ++t) top[t] = top[t + 1];
        top[kMaxNE1 - 1] = kIntMin;
      }
      if (e == n_easy) m = max(m, deep);
      if (lane == 0) dst[e] = m;
    }
  }
}

// A block's shared memory at QB queries for rows of kse K values a slab
// and a table of width keys a query: the query window, the ring, the
// table; 0 (and *wslabs 0) when not one slab of queries fits beside the
// ring and the table.
template <int QB>
size_t grouped_smem(int d, int kse, int width, int* wslabs) {
  typedef StreamShape<QB> S;
  const size_t slab = (size_t)kse * S::QS * sizeof(float);
  const size_t rest = (size_t)S::STAGES * S::STAGE +
                      (size_t)QB * width * sizeof(int);
  *wslabs = 0;
  if (rest + slab > kMaxSmem) return 0;
  *wslabs = window_slabs((d + kse - 1) / kse, slab, rest);
  return *wslabs * slab + rest;
}

size_t grouped_smem_at(int qb, int d, int kse, int width, int* wslabs) {
  switch (qb) {
    case 32: return grouped_smem<32>(d, kse, width, wslabs);
    case 16: return grouped_smem<16>(d, kse, width, wslabs);
    default: return grouped_smem<8>(d, kse, width, wslabs);
  }
}

template <typename CT, int QB, bool ASYNC>
cudaError_t launch_grouped_kernel(const GroupedLaunch& l) {
  auto kernel = extract_grouped_kernel<CT, QB, ASYNC>;
  const cudaError_t err = allow_smem(kernel, l.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((l.n_q + QB - 1) / QB, (l.n + l.tile_n - 1) / l.tile_n);
  kernel<<<grid, kThreads, l.smem, l.stream>>>(
      l.q, static_cast<const CT*>(l.c), l.cv, l.cn_mode, l.out, l.n_q, l.n,
      l.d, l.tile_n, l.n_easy, l.group, l.depth, l.trans, l.wslabs);
  return cudaGetLastError();
}

template <typename CT, int QB>
cudaError_t launch_grouped_qb(const GroupedLaunch& l) {
  // cp.async needs (n, d) rows of whole 16-byte pieces from an aligned base
  const bool async = !l.trans && ((size_t)l.d * sizeof(CT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(l.c) % 16 == 0;
  return async ? launch_grouped_kernel<CT, QB, true>(l)
               : launch_grouped_kernel<CT, QB, false>(l);
}

template <typename CT>
cudaError_t launch_grouped(const GroupedLaunch& l) {
  switch (l.qb) {
    case 32: return launch_grouped_qb<CT, 32>(l);
    case 16: return launch_grouped_qb<CT, 16>(l);
    default: return launch_grouped_qb<CT, 8>(l);
  }
}

}  // namespace
