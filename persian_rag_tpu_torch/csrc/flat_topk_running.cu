// Running top-k flat search: the regimes the two-stage path does not serve.
//
// Replaces the TPU Pallas kernels
//   persian_rag_tpu/ops/flat_topk.py::_topk_kernel       (mode "exact")
//   persian_rag_tpu/ops/flat_topk.py::_fast_topk_kernel  (mode "fast")
// reached through flat_topk_pallas, with _merge.py::merge_topk as their
// running merge. The port holds them to what they COMPUTE:
//
//   For every query, the k best corpus rows (k <= 128) by
//     s = q.c (dot), 2 q.c - ||c||^2 (l2), or scale[c] * q.c (int8 rows
//     with per-row scales), the contraction accumulated in f32; with bf16
//     compute both operands are rounded to bf16 first (products then exact).
//   exact: order (s descending, id ascending): bit-equal to a stable
//     descending sort of the kernel's own scores.
//   fast:  order (ikey(s) & ~0x7FF descending, id ascending), ikey the
//     monotone f32 -> int32 map: scores truncated to their top 21 bits, and
//     the returned score is the truncated one. A truncated tie keeps the
//     lower id, which is what the TPU kernel's strict '>' skips and
//     first-occurrence merges amount to.
//   Scores are returned in MAXIMIZE space; the wrapper maps l2 back.
//
// The TPU kernel walks the corpus tiles in grid order and carries the
// running top-k from one grid step to the next; its n_easy staging, residual
// proof and tile skip only cut the cost of that walk. Blocks on the GPU run
// in no order, so the walk becomes two passes over unique 64-bit keys
// (score order bits << 32 | ~id; exact mode folds -0 into +0, so that no two
// keys tie and every sort below is an exact ranking):
//   1. running_tile_kernel: one block per (16 queries, tile of 256 rows:
//      at d = 384 two such blocks share an SM, measured 1.25-1.8x faster on
//      the H100 than 512-row tiles, one block per SM). The queries live in
//      shared memory as f32, the tile streams
//      through shared memory 32 rows at a time (coalesced loads; any of f32,
//      bf16 or int8 rows widened to f32; odd row stride, so 32 lanes read 32
//      banks), each lane owns one row and accumulates its 2 queries with
//      f32 FMA on the CUDA cores in k order: no TF32, no tensor cores. The
//      tile's keys are sorted in shared memory (bitonic) and each query's
//      top k written out.
//   2. merge_kernel: one block per (query, group of lists) sorts the
//      group's keys and keeps the top k, level by level until one list is
//      left; the last level decodes scores and ids.
// The top k of a union of lists lies in the union of their top k, so the
// result equals one sort of all N keys.
//
// What bounds it on the H100: 2 Q N d f32 FLOPs on the CUDA cores against
// N d bytes of corpus (4, 2 or 1 bytes each). At Q = 64, N = 100k, d = 384
// over int8 rows that is 4.9 GFLOP against 38 MB: far above the CUDA cores'
// f32 ridge, so it is bound by f32 FMA rate and shared-memory operand traffic
// (one row word and one query pair per two FMAs), not by HBM. Only a
// tensor-core version would reach the bandwidth bound; its accumulation is
// not IEEE f32 in k order, so it would not keep exact mode's contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQB = 16;               // queries per block
constexpr int kQPW = kQB / kWarps;    // queries per warp
constexpr int kRows = 32;             // corpus rows per shared-memory chunk
constexpr int kMergeThreads = 512;
constexpr int kColMask = (1 << 11) - 1;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may ask

__device__ __forceinline__ int score_to_ikey(float s) {
  const int i = __float_as_int(s);
  return i < 0 ? (i ^ 0x7FFFFFFF) : i;
}

template <bool FAST>
__device__ __forceinline__ u64 make_key(float s, int id) {
  if (!FAST && s == 0.f) s = 0.f;     // -0 -> +0: equal scores, equal bits
  int ik = score_to_ikey(s);
  if (FAST) ik &= ~kColMask;
  const uint32_t hi = (uint32_t)ik ^ 0x80000000u;   // signed -> unsigned order
  return ((u64)hi << 32) | (uint32_t)~(uint32_t)id;
}

__device__ __forceinline__ float key_score(u64 key) {
  const int ik = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
  return __int_as_float(ik < 0 ? (ik ^ 0x7FFFFFFF) : ik);
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)~(uint32_t)(key & 0xFFFFFFFFull);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// cn_mode: 0 none (dot), 1 cn = ||c||^2 (l2), 2 cn = per-row scale.
// out: (n_q, n_tiles, kk) keys, each list descending, 0 = no row.
template <typename CT, bool FAST>
__global__ void __launch_bounds__(kThreads)
running_tile_kernel(const float* __restrict__ q, const CT* __restrict__ c,
                    const float* __restrict__ cn, int cn_mode, int bf16_compute,
                    u64* __restrict__ out, int n_q, int n, int d, int tile_n,
                    int n_tiles, int kk) {
  extern __shared__ u64 smem_u64[];
  const int dp = (d + 1) & ~1;        // d rounded up to even
  const int cstride = dp + 1;         // odd word stride: conflict-free rows
  u64* keys = smem_u64;                                     // kQB x tile_n
  float* qs = reinterpret_cast<float*>(keys + kQB * tile_n);  // kQB x dp
  float* cs = qs + kQB * dp;                                // kRows x cstride

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQB;
  const int tile = blockIdx.y;
  const int col0 = tile * tile_n;
  const int tile_cols = min(tile_n, n - col0);

  for (int i = tid; i < kQB * dp; i += kThreads) {
    const int r = i / dp;
    const int k = i - r * dp;
    float v = (q0 + r < n_q && k < d) ? q[(size_t)(q0 + r) * d + k] : 0.f;
    if (bf16_compute) v = round_bf16(v);
    qs[i] = v;
  }
  for (int i = tid; i < kQB * tile_n; i += kThreads) keys[i] = 0ull;

  for (int r0 = 0; r0 < tile_cols; r0 += kRows) {
    __syncthreads();  // previous chunk consumed (and queries, keys staged)
    for (int r = warp; r < kRows; r += kWarps) {
      const bool live = r0 + r < tile_cols;
      const CT* row = c + (size_t)(col0 + r0 + (live ? r : 0)) * d;
      for (int k = lane; k < dp; k += 32) {
        float v = 0.f;
        if (live && k < d) {
          v = to_f32(row[k]);
          if (bf16_compute) v = round_bf16(v);
        }
        cs[r * cstride + k] = v;
      }
    }
    __syncthreads();

    const int col = r0 + lane;  // column inside the tile
    float acc[kQPW];
#pragma unroll
    for (int j = 0; j < kQPW; ++j) acc[j] = 0.f;
    const float* crow = cs + lane * cstride;
    for (int k = 0; k < dp; k += 2) {
      const float c0 = crow[k];
      const float c1 = crow[k + 1];
#pragma unroll
      for (int j = 0; j < kQPW; ++j) {
        const float2 qv = *reinterpret_cast<const float2*>(
            qs + (warp * kQPW + j) * dp + k);
        acc[j] = fmaf(qv.x, c0, acc[j]);
        acc[j] = fmaf(qv.y, c1, acc[j]);
      }
    }

    if (col < tile_cols) {
      const float cv = cn_mode != 0 ? cn[col0 + col] : 0.f;
#pragma unroll
      for (int j = 0; j < kQPW; ++j) {
        float s = acc[j];
        if (cn_mode == 1) s = __fsub_rn(__fmul_rn(2.f, s), cv);
        if (cn_mode == 2) s = __fmul_rn(s, cv);
        keys[(warp * kQPW + j) * tile_n + col] = make_key<FAST>(s, col0 + col);
      }
    }
  }

  bitonic_desc(keys, tile_n, kQB);  // syncs before its first step and after

  for (int i = tid; i < kQB * kk; i += kThreads) {
    const int b = i / kk;
    const int r = i - b * kk;
    if (q0 + b < n_q) {
      out[((size_t)(q0 + b) * n_tiles + tile) * kk + r] = keys[b * tile_n + r];
    }
  }
}

// in: (n_q, n_lists, kk) keys. Block (g, query) sorts lists [g * group,
// (g + 1) * group) of its query in `seg` (a power of two) shared slots and
// writes the top kk: as keys to out_keys (n_q, n_groups, kk), or, on the
// last level (out_s given, one group), decoded to out_s / out_i (n_q, kk).
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const u64* __restrict__ in, u64* __restrict__ out_keys,
             float* __restrict__ out_s, int32_t* __restrict__ out_i,
             int n_lists, int kk, int group, int n_groups, int seg) {
  extern __shared__ u64 smem_u64[];
  u64* keys = smem_u64;
  const int g = blockIdx.x;
  const size_t qi = blockIdx.y;
  const int first = g * group;
  const int count = min(group, n_lists - first) * kk;
  const u64* src = in + (qi * n_lists + first) * kk;
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    keys[i] = i < count ? src[i] : 0ull;
  }
  bitonic_desc(keys, seg, 1);
  for (int r = threadIdx.x; r < kk; r += blockDim.x) {
    const u64 key = keys[r];
    if (out_s != nullptr) {
      out_s[qi * kk + r] = key == 0ull ? -3.0e38f : key_score(key);
      out_i[qi * kk + r] = key == 0ull ? -1 : key_id(key);
    } else {
      out_keys[(qi * n_groups + g) * kk + r] = key;
    }
  }
}

size_t tile_smem(int d, int tile_n) {
  const int dp = (d + 1) & ~1;
  return (size_t)kQB * tile_n * sizeof(u64) +
         ((size_t)kQB * dp + (size_t)kRows * (dp + 1)) * sizeof(float);
}

template <typename CT, bool FAST>
cudaError_t launch_tile(const float* q, const void* c, const float* cn,
                        int cn_mode, int bf16_compute, u64* out, int n_q,
                        int n, int d, int tile_n, int kk, cudaStream_t stream) {
  const size_t smem = tile_smem(d, tile_n);
  auto kernel = running_tile_kernel<CT, FAST>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = (n + tile_n - 1) / tile_n;
  const dim3 grid((n_q + kQB - 1) / kQB, n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const CT*>(c), cn, cn_mode, bf16_compute, out, n_q, n, d,
      tile_n, n_tiles, kk);
  return cudaGetLastError();
}

template <bool FAST>
cudaError_t launch_tile_ct(int corpus_type, const float* q, const void* c,
                           const float* cn, int cn_mode, int bf16_compute,
                           u64* out, int n_q, int n, int d, int tile_n, int kk,
                           cudaStream_t stream) {
  switch (corpus_type) {
    case 0:
      return launch_tile<float, FAST>(q, c, cn, cn_mode, bf16_compute, out,
                                      n_q, n, d, tile_n, kk, stream);
    case 1:
      return launch_tile<__nv_bfloat16, FAST>(q, c, cn, cn_mode, bf16_compute,
                                              out, n_q, n, d, tile_n, kk,
                                              stream);
    default:
      return launch_tile<int8_t, FAST>(q, c, cn, cn_mode, bf16_compute, out,
                                       n_q, n, d, tile_n, kk, stream);
  }
}

}  // namespace

// Shared memory the tile pass needs for rows of d values and tile_n rows
// per tile; the wrapper raises when its tile does not fit.
extern "C" long long prt_running_tile_smem(int d, int tile_n) {
  return (long long)tile_smem(d, tile_n);
}

// Pass 1. q: (n_q, d) f32; c: (n, d) rows of corpus_type 0 f32, 1 bf16,
// 2 int8; cn: (n,) f32 per cn_mode (0: unused, 1: ||c||^2, 2: row scales);
// out: (n_q, ceil(n / tile_n), k) keys. Returns a cudaError_t.
extern "C" int prt_running_tile_topk(const void* q, const void* c,
                                     const void* cn, void* out, int n_q, int n,
                                     int d, int k, int tile_n, int corpus_type,
                                     int cn_mode, int bf16_compute, int fast,
                                     void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k < 1 || k > 128 || k > n ||
      tile_n != 256 || corpus_type < 0 ||
      corpus_type > 2 || cn_mode < 0 || cn_mode > 2 ||
      (cn_mode != 0 && cn == nullptr) || tile_smem(d, tile_n) > kMaxSmem ||
      (n + tile_n - 1) / tile_n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* cnf = static_cast<const float*>(cn);
  u64* o = static_cast<u64*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast) {
    return (int)launch_tile_ct<true>(corpus_type, qf, c, cnf, cn_mode,
                                     bf16_compute, o, n_q, n, d, tile_n, k, s);
  }
  return (int)launch_tile_ct<false>(corpus_type, qf, c, cnf, cn_mode,
                                    bf16_compute, o, n_q, n, d, tile_n, k, s);
}

// Pass 2, one level. in: (n_q, n_lists, k) keys; groups of `group` lists
// are merged in `seg` shared slots (a power of two >= min(group, n_lists) *
// k, at most 16384). With out_s and out_i given (then group >= n_lists) the
// single merged list is decoded into them; else out_keys gets
// (n_q, ceil(n_lists / group), k) keys. Returns a cudaError_t.
extern "C" int prt_running_merge(const void* in, void* out_keys, void* out_s,
                                 void* out_i, int n_q, int n_lists, int k,
                                 int group, int seg, void* stream) {
  const bool last = out_s != nullptr;
  if (n_q <= 0 || n_q > 65535 || n_lists <= 0 || k < 1 || group < 1 ||
      seg < 2 || (seg & (seg - 1)) != 0 || seg > 16384 ||
      (long long)(group < n_lists ? group : n_lists) * k > seg || (last && out_i == nullptr) ||
      (last && group < n_lists) || (!last && out_keys == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_groups = (n_lists + group - 1) / group;
  const size_t smem = (size_t)seg * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_groups, n_q);
  merge_kernel<<<grid, kMergeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out_keys),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), n_lists, k,
      group, n_groups, seg);
  return (int)cudaGetLastError();
}
