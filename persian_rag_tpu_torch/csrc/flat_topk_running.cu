// Running top-k flat search: the regimes the two-stage path does not serve.
//
// Replaces the TPU Pallas kernels
//   persian_rag_tpu/ops/flat_topk.py::_topk_kernel             (mode "exact")
//   persian_rag_tpu/ops/flat_topk.py::_fast_topk_kernel        (mode "fast")
//   persian_rag_tpu/ops/flat_topk.py::_fast_insert_topk_kernel (mode "fasti")
//   persian_rag_tpu/ops/flat_topk.py::_fast_group_topk_kernel  (mode "fastg")
//   persian_rag_tpu/ops/flat_topk.py::_max_only_kernel         (mode "maxonly")
// reached through flat_topk_pallas, with _merge.py::merge_topk as their
// running merge. The port holds them to what they COMPUTE:
//
//   For every query, the k best corpus rows (k <= 128) by
//     s = q.c (dot), 2 q.c - ||c||^2 (l2), or scale[c] * q.c (int8 rows
//     with per-row scales), the contraction accumulated in f32; with bf16
//     compute both operands are rounded to bf16 first (products then exact).
//   exact: order (s descending, id ascending): bit-equal to a stable
//     descending sort of the kernel's own scores.
//   fast, fasti, fastg: order (ikey(s) & ~0x7FF descending, id ascending),
//     ikey the monotone f32 -> int32 map: scores truncated to their top 21
//     bits, and the returned score is the truncated one. A truncated tie
//     keeps the lower id, which is what the TPU kernel's strict '>' skips
//     and first-occurrence merges amount to. The three modes return the
//     same lists; they differ in how a tile's rows reach the running list.
//   maxonly: per query the largest s over the real rows (a floor: the
//     stream and the contraction without any top-k).
//   Scores are returned in MAXIMIZE space; the wrapper maps l2 back.
//
// The corpus is (N, d) or, with `trans`, (d, N) (the TPU's
// corpus_transposed layout). Only the staging of a 32-row chunk differs: in
// (d, N) the 32 lanes read 32 consecutive rows at one k (coalesced), not 32
// k of one row. The staged values and the FMA chain are the same, so both
// layouts give the same bits.
//
// Modes exact and fast (the TPU kernel walks the corpus tiles in grid order
// and carries the running top-k from one grid step to the next; its n_easy
// staging, residual proof and tile skip only cut the cost of that walk).
// Blocks on the GPU run in no order, so the walk becomes two passes over
// unique 64-bit keys (score order bits << 32 | ~id; exact mode folds -0
// into +0, so that no two keys tie and every sort below is an exact
// ranking):
//   1. running_select_kernel (flat_topk_running_select.cu, so that nvcc
//      builds its instantiations beside this file): a block streams one
//      segment of the corpus for its query block on stream_rows (the
//      register-blocked stream below) and keeps each query's running top k
//      in shared memory, its k-th key a threshold that only the keys above
//      it pass; each segment's lists are written out.
//   2. merge_kernel: one block per (query, group of lists) sorts the
//      group's keys and keeps the top k, level by level until one list is
//      left; the last level decodes scores and ids.
// The top k of a union of lists lies in the union of their top k, so the
// result equals one sort of all N keys.
//
// Modes fasti and fastg carry the TPU kernels' mechanism: a running list
// that each tile of 256 rows updates with a few extracted candidates, and a
// residual check that falls back to a full extraction in the rare tile
// where an unextracted row could still enter. A sequential walk over all N
// would leave the card empty (one block per 16 queries: 4 blocks at Q =
// 64), so N is cut into contiguous segments, enough for ~2 blocks per SM;
// segment_topk_kernel walks its segment's tiles in order, keeping each
// query's running list (unique 64-bit keys, as above) in shared memory,
// and merge_kernel merges the segment lists. The function is order-free,
// so the cut cannot change the result. A lane keeps its 8 packed tile keys
// per query in registers ((ikey & ~0x7FF) | reversed column, INT_MIN for a
// row past N); a rank is a warp shuffle-max and the owner's clear:
//   fasti: n_easy ranks are inserted one by one into the sorted list (one
//     shift per insertion); when the best key left beats the list's k-th
//     truncated score, ranks are extracted and inserted until one no
//     longer enters.
//   fastg: the tile is reduced to its per-slot top 2 (slot = column mod 16,
//     16 rows each: a lane's 8 keys share one slot and lanes l and l ^ 16
//     combine); n_easy ranks come from those 32 keys and merge into the
//     list by rank (binary search in the other list). When max(keys left,
//     max of the second level) beats the new list's k-th truncated score,
//     the tile's raw keys are extracted (up to k) and merged against the
//     PRE-merge list, as the TPU kernel does.
//   A rank that finds only INT_MIN ends the extraction: a row past N never
//   enters a list (the TPU kernels keyed such rows INT_MIN and decoded
//   them to NaN or 3e38 scores with duplicated ids when the last tile held
//   fewer real rows than n_easy; the port corrects that).
// maxonly (maxonly_kernel, in flat_topk_maxonly.cu so that nvcc builds it
// beside this file) keeps each query's maximum of the monotone int
// image of the scores of real rows only, with the row scales folded in
// (the TPU kernel scored pad rows 0 and ignored the scales; the port
// corrects both); a warp maximum and one atomicMax per (query, block)
// finish it, exact and order-free.
//
// What bounds them on the H100: 2 Q N d f32 FLOPs on the CUDA cores against
// N d bytes of corpus (4, 2 or 1 bytes each). At Q = 64, N = 100k, d = 384
// over int8 rows that is 4.9 GFLOP against 38 MB: far above the CUDA cores'
// f32 ridge, so the floor is the f32 FMA rate (0.073 ms at 67 TFLOP/s).
// chunk_dots, the stream of modes fasti and fastg (and of exact and fast
// before they moved to stream_rows), measured 12.5% of it on the H100 when
// maxonly ran on it too (0.588 ms): a lane owns one staged row and 2
// queries, so each FMA costs a shared-memory load; rows are staged a byte a
// lane and widened to f32 in shared memory; loads and FMAs do not overlap
// inside a block; and 16 queries a block stream the corpus Q / 16 times.
// maxonly, exact and fast run stream_rows (row_stream.cuh), the
// register-blocked stream fasti and fastg can take up: a
// block holds 64 queries (32 for rows wider than fit beside them) k-major in
// shared memory; its 8 warps are 4 query groups x 2 row halves, and a thread
// keeps 16 queries x 4 rows (8 x 4 at 32) of accumulators, so four broadcast
// float4 loads of queries and one 16-byte load of 16 int8 K values per row
// feed 64 FMAs per K value (about 15 FMAs per shared-memory load), and a row
// value widened in registers (a byte permute and a subtraction) feeds 16 FMAs.
// Rows stay in their own type in shared memory, arrive in 256-row chunks
// through a 3-stage cp.async ring of 64-byte row slabs (80-byte row stride: 8
// lanes reading 8 rows hit 8 bank groups), and are rounded to bf16 under bf16
// compute in registers; one block per SM streams its segment of the corpus
// once per 64 queries. Every accumulator is one fmaf chain from 0 in ascending
// k, chunk_dots' chain, so maxonly's best score is exact mode's first, bit for
// bit, in both layouts (the (d, N) layout and rows of other than whole 16
// bytes are staged by the threads instead). Only a tensor-core version would
// reach the bandwidth bound; its accumulation is not IEEE f32 in k order, so
// it would not keep exact mode's contract, nor the equality of the fast modes'
// keys with the plain versions'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "running_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kQB = 16;               // queries per block
constexpr int kQPW = kQB / kWarps;    // queries per warp
constexpr int kRows = 32;             // corpus rows per shared-memory chunk
constexpr int kMergeThreads = 512;
constexpr int kColMask = (1 << 11) - 1;
constexpr int kSegTile = 256;         // rows per tile of the segment kernels
constexpr int kChunks = kSegTile / kRows;
constexpr int kMaxEasy = 8;           // n_easy limit of the segment kernels
constexpr int kMaxPerLane = 4;        // list slots per lane: k <= 128

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

// K values [k0, k0 + kn) of the block's kQB queries into qs (kQB x kn f32,
// zero past d).
__device__ __forceinline__ void stage_queries(const float* __restrict__ q,
                                              float* qs, int q0, int n_q,
                                              int d, int k0, int kn,
                                              int bf16_compute) {
  for (int i = threadIdx.x; i < kQB * kn; i += kThreads) {
    const int r = i / kn;
    const int k = k0 + i - r * kn;
    float v = (q0 + r < n_q && k < d) ? q[(size_t)(q0 + r) * d + k] : 0.f;
    if (bf16_compute) v = round_bf16(v);
    qs[i] = v;
  }
}

// K values [k0, k0 + kn) of rows row0 .. row0 + live - 1 (live <= 32) into
// cs (kRows x cstride f32, zero padded), widened to f32 and, with bf16
// compute, rounded to bf16. c is (n, d) or, with trans, (d, n).
template <typename CT>
__device__ __forceinline__ void stage_chunk(const CT* __restrict__ c,
                                            float* cs, int cstride, int row0,
                                            int live, int n, int d, int k0,
                                            int kn, int trans,
                                            int bf16_compute) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (!trans) {
    for (int r = warp; r < kRows; r += kWarps) {
      const bool ok = r < live;
      const CT* row = c + (size_t)(row0 + (ok ? r : 0)) * d;
      for (int k = lane; k < kn; k += 32) {
        float v = 0.f;
        if (ok && k0 + k < d) {
          v = to_f32(row[k0 + k]);
          if (bf16_compute) v = round_bf16(v);
        }
        cs[r * cstride + k] = v;
      }
    }
  } else {
    const bool ok = lane < live;
    for (int k = warp; k < kn; k += kWarps) {
      float v = 0.f;
      if (ok && k0 + k < d) {
        v = to_f32(c[(size_t)(k0 + k) * n + row0 + lane]);
        if (bf16_compute) v = round_bf16(v);
      }
      cs[lane * cstride + k] = v;
    }
  }
}

// acc[j] += q_j . (the lane's staged row) over the kn (even) staged K
// values, for the warp's kQPW queries (qs: kQB x qstride): one f32 FMA
// chain in k order, the same in every kernel of this file. A row wider
// than a window is staged window by window, k ascending, each adding to
// the chain where the last left it.
__device__ __forceinline__ void chunk_dots(const float* qs, int qstride,
                                           const float* cs, int cstride,
                                           int kn, float (&acc)[kQPW]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* crow = cs + lane * cstride;
  for (int k = 0; k < kn; k += 2) {
    const float c0 = crow[k];
    const float c1 = crow[k + 1];
#pragma unroll
    for (int j = 0; j < kQPW; ++j) {
      const float2 qv = *reinterpret_cast<const float2*>(
          qs + (warp * kQPW + j) * qstride + k);
      acc[j] = fmaf(qv.x, c0, acc[j]);
      acc[j] = fmaf(qv.y, c1, acc[j]);
    }
  }
}

// The scores of the block's queries and the lane's row of the chunk at
// row0 (live rows): the whole width at once when the queries stay staged
// (kw = dp), else window by window, the queries' window staged beside the
// rows'. Syncs before it stages and after.
template <typename CT>
__device__ __forceinline__ void chunk_scores(
    const float* __restrict__ q, const CT* __restrict__ c, float* qs,
    float* cs, int q0, int n_q, int row0, int live, int n, int d, int dp,
    int kw, int trans, int bf16_compute, float (&acc)[kQPW]) {
#pragma unroll
  for (int j = 0; j < kQPW; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < dp; k0 += kw) {
    const int kn = min(kw, dp - k0);
    __syncthreads();  // the last chunk or window is consumed
    if (kw < dp) stage_queries(q, qs, q0, n_q, d, k0, kn, bf16_compute);
    stage_chunk(c, cs, kw + 1, row0, live, n, d, k0, kn, trans,
                bf16_compute);
    __syncthreads();
    chunk_dots(qs, kw < dp ? kn : dp, cs, kw + 1, kn, acc);
  }
}

// -- the segment kernels (fasti, fastg) ------------------------------

// The running key of a packed tile key of the tile whose first row is tile0.
__device__ __forceinline__ u64 tile_key_to_run(int key, int tile0) {
  const int id = tile0 + (kSegTile - 1 - (key & kColMask));
  const uint32_t hi = (uint32_t)(key & ~kColMask) ^ 0x80000000u;
  return ((u64)hi << 32) | (uint32_t)~(uint32_t)id;
}

// The truncated score bits of a running key, in the tile keys' space.
__device__ __forceinline__ int run_trunc(u64 key) {
  return (int)((uint32_t)(key >> 32) ^ 0x80000000u);
}

// Whether a tile key `rest` (a bound on every key of the tile not yet in
// the list) could enter a list whose k-th entry is kth: a row beats kth
// only with a larger truncated score, or an equal one and a lower id, which
// needs rest > trunc(kth) (a row of this tile with kth's truncated score
// and column bits 0 is the tile's last row: the highest id in play).
__device__ __forceinline__ bool could_enter(int rest, u64 kth) {
  return rest != kIntMin && (kth == 0ull || rest > run_trunc(kth));
}

// The largest of the lane's keys across the warp, cleared at its owner
// (keys are unique; INT_MIN, a row past N, is never taken).
__device__ __forceinline__ int take_max(int (&keys)[kChunks]) {
  int m = keys[0];
#pragma unroll
  for (int t = 1; t < kChunks; ++t) m = max(m, keys[t]);
  m = warp_max(m);
  if (m != kIntMin) {
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      if (keys[t] == m) keys[t] = kIntMin;
    }
  }
  return m;
}

__device__ __forceinline__ int rest_max(const int (&keys)[kChunks]) {
  int m = keys[0];
#pragma unroll
  for (int t = 1; t < kChunks; ++t) m = max(m, keys[t]);
  return warp_max(m);
}

// Insert b into the warp's descending list a[0..kk) (unique keys, 0 =
// empty) with one shift: entries above b stay, b takes the first slot
// below them, the rest move down one. A key at or below a[kk-1] is a no-op.
__device__ __forceinline__ void insert_sorted(u64* a, int kk, u64 b) {
  const int lane = threadIdx.x & 31;
  if (b <= a[kk - 1]) return;
  u64 cur[kMaxPerLane], prev[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int p = lane + 32 * i;
    cur[i] = p < kk ? a[p] : 0ull;
    prev[i] = (p < kk && p > 0) ? a[p - 1] : ~0ull;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int p = lane + 32 * i;
    if (p < kk) a[p] = cur[i] > b ? cur[i] : (prev[i] > b ? b : prev[i]);
  }
  __syncwarp();
}

// Entries of the descending list l[0..len) that are larger than x.
__device__ __forceinline__ int count_above(const u64* l, int len, u64 x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (l[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// out[0..kk) = the top kk of a[0..kk) and b[0..nb), two descending lists of
// unique keys with no key in common (0 = empty): each key's rank is its
// position plus the count above it in the other list.
__device__ __forceinline__ void merge_sorted(const u64* a, const u64* b,
                                             int nb, u64* out, int kk) {
  const int lane = threadIdx.x & 31;
  for (int p = lane; p < kk; p += 32) out[p] = 0ull;
  __syncwarp();
  for (int i = lane; i < kk; i += 32) {
    const u64 x = a[i];
    if (x == 0ull) continue;
    const int r = i + count_above(b, nb, x);
    if (r < kk) out[r] = x;
  }
  for (int i = lane; i < nb; i += 32) {
    const u64 x = b[i];
    if (x == 0ull) continue;
    const int r = i + count_above(a, kk, x);
    if (r < kk) out[r] = x;
  }
  __syncwarp();
}

// fasti: n_easy ranks inserted one by one; when the best key left could
// still enter, further ranks until one does not.
__device__ __forceinline__ void tile_insert(int (&keys)[kChunks], u64* a,
                                            int kk, int n_easy, int tile0) {
  const int easy = min(n_easy, kk);
  for (int e = 0; e < easy; ++e) {
    const int m = take_max(keys);
    if (m == kIntMin) return;
    insert_sorted(a, kk, tile_key_to_run(m, tile0));
  }
  if (easy == kk || !could_enter(rest_max(keys), a[kk - 1])) return;
  for (int r = 0; r < kk; ++r) {
    const int m = take_max(keys);
    if (m == kIntMin) return;
    const u64 b = tile_key_to_run(m, tile0);
    if (b <= a[kk - 1]) return;  // the ranks only fall from here
    insert_sorted(a, kk, b);
  }
}

// fastg: per-slot top 2 over 16 rows, n_easy ranks from the 32 reduced keys
// merged by rank into b_out; the full fallback merges the tile's raw ranks
// against the pre-merge list a. scratch: kk keys of the warp's own.
__device__ __forceinline__ void tile_group(int (&keys)[kChunks], const u64* a,
                                           u64* b_out, u64* scratch, int kk,
                                           int n_easy, int tile0) {
  const int lane = threadIdx.x & 31;
  // a lane's 8 rows (column 32 t + lane) all lie in slot lane & 15
  int m1 = kIntMin, m2 = kIntMin;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int x = keys[t];
    if (x > m1) {
      m2 = m1;
      m1 = x;
    } else {
      m2 = max(m2, x);
    }
  }
  const int p1 = __shfl_xor_sync(0xffffffffu, m1, 16);
  const int p2 = __shfl_xor_sync(0xffffffffu, m2, 16);
  const int r1 = max(m1, p1);
  const int r2 = m1 > p1 ? max(m2, p1) : max(p2, m1);
  int red = lane < 16 ? r1 : r2;  // the 2C = 32 reduced keys, one a lane
  const int max_r2 = warp_max(r2);

  const int easy = min(n_easy, kk);
  int ne = 0;
  for (; ne < easy; ++ne) {
    const int m = warp_max(red);
    if (m == kIntMin) break;
    if (red == m) red = kIntMin;
    if (lane == 0) scratch[ne] = tile_key_to_run(m, tile0);
  }
  __syncwarp();
  const int bound = max(warp_max(red), max_r2);
  merge_sorted(a, scratch, ne, b_out, kk);
  if (!could_enter(bound, b_out[kk - 1])) return;

  int nf = 0;
  for (; nf < kk; ++nf) {
    const int m = take_max(keys);
    if (m == kIntMin) break;
    const u64 b = tile_key_to_run(m, tile0);
    if (b <= a[kk - 1]) break;  // cannot enter the pre-merge list's top k
    if (lane == 0) scratch[nf] = b;
  }
  __syncwarp();
  merge_sorted(a, scratch, nf, b_out, kk);
}

// MODE 0 fasti, 1 fastg. Block (query block, segment) walks tiles
// [seg * tiles_per_seg, ...) of 256 rows in order; out: (n_q, n_seg, kk)
// keys, each list descending, 0 = no row.
template <typename CT, int MODE>
__global__ void __launch_bounds__(kThreads)
segment_topk_kernel(const float* __restrict__ q, const CT* __restrict__ c,
                    const float* __restrict__ cn, int cn_mode,
                    int bf16_compute, int trans, u64* __restrict__ out,
                    int n_q, int n, int d, int kk, int n_easy,
                    int tiles_per_seg, int n_seg, int kw) {
  extern __shared__ u64 smem_u64[];
  const int dp = (d + 1) & ~1;
  constexpr int kLists = MODE == 0 ? 1 : 3;  // fastg: two lists + scratch
  u64* lists = smem_u64;                      // kLists x kQB x kk
  float* qs = reinterpret_cast<float*>(lists + kLists * kQB * kk);
  float* cs = qs + kQB * kw;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kQB;
  const int seg = blockIdx.y;
  const int n_tiles = (n + kSegTile - 1) / kSegTile;
  const int tile_end = min(n_tiles, (seg + 1) * tiles_per_seg);

  if (kw == dp) stage_queries(q, qs, q0, n_q, d, 0, dp, bf16_compute);
  for (int i = tid; i < kLists * kQB * kk; i += kThreads) lists[i] = 0ull;
  int cur = 0;

  for (int tile = seg * tiles_per_seg; tile < tile_end; ++tile) {
    const int tile0 = tile * kSegTile;
    const int tile_cols = min(kSegTile, n - tile0);
    int keys[kQPW][kChunks];
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
#pragma unroll
      for (int j = 0; j < kQPW; ++j) keys[j][t] = kIntMin;
    }
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      const int r0 = t * kRows;
      if (r0 >= tile_cols) break;  // block-uniform
      float acc[kQPW];
      chunk_scores(q, c, qs, cs, q0, n_q, tile0 + r0,
                   min(kRows, tile_cols - r0), n, d, dp, kw, trans,
                   bf16_compute, acc);
      const int col = r0 + lane;
      if (col < tile_cols) {
        const float cv = cn_mode != 0 ? cn[tile0 + col] : 0.f;
#pragma unroll
        for (int j = 0; j < kQPW; ++j) {
          keys[j][t] =
              (score_to_ikey(finish_score(acc[j], cn_mode, cv)) & ~kColMask) |
              (kSegTile - 1 - col);
        }
      }
    }
    // each warp updates the lists of its own queries only
#pragma unroll
    for (int j = 0; j < kQPW; ++j) {
      const int row = warp * kQPW + j;
      if (MODE == 0) {
        tile_insert(keys[j], lists + (size_t)row * kk, kk, n_easy, tile0);
      } else {
        tile_group(keys[j], lists + (size_t)(cur * kQB + row) * kk,
                   lists + (size_t)((cur ^ 1) * kQB + row) * kk,
                   lists + (size_t)(2 * kQB + row) * kk, kk, n_easy, tile0);
      }
    }
    if (MODE == 1) cur ^= 1;
  }

#pragma unroll
  for (int j = 0; j < kQPW; ++j) {
    const int row = warp * kQPW + j;
    if (q0 + row >= n_q) continue;
    const u64* l = lists + (size_t)(cur * kQB + row) * kk;
    for (int r = lane; r < kk; r += 32) {
      out[((size_t)(q0 + row) * n_seg + seg) * kk + r] = l[r];
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

// The even K values of a window of the running kernels beside `fixed`
// bytes of keys or lists: the whole (even) width when 16 queries and a
// 32-row chunk of it fit a block's shared memory, else the most that fit,
// spread evenly over the windows.
int running_window(int d, size_t fixed) {
  const int dp = (d + 1) & ~1;
  const long long fit =
      (((long long)(kMaxSmem - fixed) / (long long)sizeof(float) - kRows) /
       (kQB + kRows)) & ~1LL;
  if (dp <= fit) return dp;
  const int windows = (int)((dp + fit - 1) / fit);
  return ((dp + windows - 1) / windows + 1) & ~1;
}

size_t stage_smem(int kw) {
  return ((size_t)kQB * kw + (size_t)kRows * (kw + 1)) * sizeof(float);
}

size_t segment_fixed(int kk, int mode) {
  return (size_t)(mode == 0 ? 1 : 3) * kQB * kk * sizeof(u64);
}

template <typename CT>
cudaError_t launch_segment(int mode, const float* q, const void* c,
                           const float* cn, int cn_mode, int bf16_compute,
                           int trans, void* out, int n_q, int n, int d,
                           int kk, int n_easy, int tiles_per_seg,
                           cudaStream_t stream) {
  const int kw = running_window(d, segment_fixed(kk, mode));
  const size_t smem = segment_fixed(kk, mode) + stage_smem(kw);
  const int n_tiles = (n + kSegTile - 1) / kSegTile;
  const int n_seg = (n_tiles + tiles_per_seg - 1) / tiles_per_seg;
  const dim3 grid((n_q + kQB - 1) / kQB, n_seg);
  auto kernel = mode == 0 ? segment_topk_kernel<CT, 0>
                          : segment_topk_kernel<CT, 1>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const CT*>(c), cn, cn_mode, bf16_compute, trans,
      static_cast<u64*>(out), n_q, n, d, kk, n_easy, tiles_per_seg, n_seg,
      kw);
  return cudaGetLastError();
}

}  // namespace

// The segment kernels. mode 0 (fasti) and 1 (fastg): out (n_q, n_seg, k)
// keys of each segment's running list, n_seg = ceil(ceil(n / 256) /
// tiles_per_seg), to be merged by prt_running_merge. q, c, cn, corpus_type,
// cn_mode, bf16_compute and trans as prt_running_tile_topk's
// (flat_topk_running_select.cu).
extern "C" int prt_running_segment(const void* q, const void* c,
                                   const void* cn, void* out, int n_q, int n,
                                   int d, int k, int corpus_type, int cn_mode,
                                   int bf16_compute, int trans, int mode,
                                   int n_easy, int tiles_per_seg,
                                   void* stream) {
  const int n_tiles = n > 0 ? (n + kSegTile - 1) / kSegTile : 0;
  if (n_q <= 0 || n <= 0 || d <= 0 || mode < 0 || mode > 1 || k < 1 ||
      k > 128 || k > n || n_easy < 1 || n_easy > kMaxEasy ||
      corpus_type < 0 || corpus_type > 2 || cn_mode < 0 || cn_mode > 2 ||
      (cn_mode != 0 && cn == nullptr) || tiles_per_seg < 1 ||
      (n_tiles + tiles_per_seg - 1) / tiles_per_seg > 65535 ||
      (long long)tiles_per_seg * kSegTile > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* cnf = static_cast<const float*>(cn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (corpus_type) {
    case 0:
      return (int)launch_segment<float>(mode, qf, c, cnf, cn_mode,
                                        bf16_compute, trans, out, n_q, n, d,
                                        k, n_easy, tiles_per_seg, s);
    case 1:
      return (int)launch_segment<__nv_bfloat16>(mode, qf, c, cnf, cn_mode,
                                                bf16_compute, trans, out, n_q,
                                                n, d, k, n_easy,
                                                tiles_per_seg, s);
    default:
      return (int)launch_segment<int8_t>(mode, qf, c, cnf, cn_mode,
                                         bf16_compute, trans, out, n_q, n, d,
                                         k, n_easy, tiles_per_seg, s);
  }
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
  const cudaError_t err = allow_smem(merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_groups, n_q);
  merge_kernel<<<grid, kMergeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out_keys),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), n_lists, k,
      group, n_groups, seg);
  return (int)cudaGetLastError();
}
