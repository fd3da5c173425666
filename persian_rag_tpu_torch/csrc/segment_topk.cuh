// The segment kernel of the running top-k's modes fasti and fastg (#7,
// #8): flat_topk_running.cu says what it computes and why it is shaped so.
// Its instantiations are split by row type over that file (f32) and
// flat_topk_running_segment_bf16.cu / _int8.cu, so that nvcc builds them
// in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"

// One launch of the segment kernel: prt_running_segment's arguments and
// the query window and shared memory worked out for them.
struct SegmentLaunch {
  const float* q;
  const void* c;
  const float* cn;
  int cn_mode, bf16_compute, trans, mode;
  unsigned long long* out;
  int n_q, n, d, kk, n_easy, qb, rows_per_seg, wslabs;
  size_t smem;
  cudaStream_t stream;
};

// The launch over f32, bf16 and int8 rows, each in its own source.
cudaError_t segment_f32(const SegmentLaunch& l);
cudaError_t segment_bf16(const SegmentLaunch& l);
cudaError_t segment_int8(const SegmentLaunch& l);

namespace {

typedef unsigned long long u64;

constexpr int kColMask = (1 << 11) - 1;
constexpr int kSegTile = 256;               // rows of a tile: one chunk
constexpr int kChunks = kSegTile / 32;      // a lane's keys of a tile
constexpr int kMaxEasy = 8;                 // n_easy limit
constexpr int kMaxPerLane = 4;              // list slots a lane: k <= 128

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

// MODE 0 fasti, 1 fastg. Block (query block, segment of rows_per_seg
// rows, whole 256-row tiles): the segment's tiles stream in order on
// stream_rows, a chunk being one tile; out: (n_q, n_seg, kk) keys of each
// query's list, descending, 0 = no row. Shared memory: the query window,
// the ring, the chunk's key tile (QB x 256 int32, column 32 t + lane of a
// query at t * 32 + lane), then the lists: fasti one a query, fastg two
// that a tile's merge alternates between and a scratch.
template <typename CT, int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, QB >= 32 ? 1 : 2)
segment_topk_kernel(const float* __restrict__ q, const CT* __restrict__ c,
                    const float* __restrict__ cn, int cn_mode,
                    int bf16_compute, int trans, int mode,
                    u64* __restrict__ out, int n_q, int n, int d, int kk,
                    int n_easy, int rows_per_seg, int n_seg, int wslabs) {
  typedef StreamShape<QB> S;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + KSE - 1) / KSE * KSE;
  float* qs = reinterpret_cast<float*>(smem_raw);  // a window, k-major
  unsigned char* ring =
      smem_raw + (size_t)wslabs * KSE * S::QS * sizeof(float);
  int* tile_keys = reinterpret_cast<int*>(ring + (size_t)S::STAGES * S::STAGE);
  u64* lists = reinterpret_cast<u64*>(tile_keys + QB * kSegTile);
  const int lists_n = mode == 0 ? 1 : 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;
  const int seg = blockIdx.y;
  const int row_first = seg * rows_per_seg;
  const int row_end = min(n, row_first + rows_per_seg);
  const int qg = (warp % S::WQ) * S::TQ;  // the thread's first query
  const int half = warp / S::WQ;          // and its row half
  // fastg: bit j set where the list of the warp's query warp + 8 j is the
  // second one (a skipped tile leaves a query's list where it is)
  unsigned cur = 0u;

  for (int i = threadIdx.x; i < lists_n * QB * kk; i += kThreads)
    lists[i] = 0ull;

  // slabs [slab0, slab0 + count) of the queries, 4 queries at one k a
  // thread (rounded to bf16 under bf16 compute)
  auto load_q = [&](int slab0, int count) {
    const int k0 = slab0 * KSE, kn = count * KSE;
    for (int i = threadIdx.x; i < kn * (QB / 4); i += kThreads) {
      const int g = i / kn, kx = i - g * kn, k = k0 + kx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = q0 + 4 * g + e;
        v[e] = (j < n_q && k < d) ? q[(size_t)j * d + k] : 0.f;
        if (bf16_compute) v[e] = round_bf16(v[e]);
      }
      *reinterpret_cast<float4*>(qs + kx * S::QS + 4 * g) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  stream_rows<CT, QB, ASYNC>(
      c, qs, ring, row_first, row_end, n, d, dpad, wslabs, trans,
      bf16_compute != 0, load_q, [&](int row0, float (&acc)[S::TQ][S::TR]) {
        const int col0 = half * 128 + lane;  // the thread's row 0 in the tile
        const int tile0 = row0 - col0;
#pragma unroll
        for (int i = 0; i < S::TR; ++i) {
          const int row = row0 + 32 * i, col = col0 + 32 * i;
          const bool live = row < row_end;
          const float cv = (cn_mode != 0 && live) ? cn[row] : 0.f;
#pragma unroll
          for (int a = 0; a < S::TQ; ++a)
            tile_keys[(qg + a) * kSegTile + col] =
                live ? (score_to_ikey(finish_score(acc[a][i], cn_mode, cv)) &
                        ~kColMask) | (kSegTile - 1 - col)
                     : kIntMin;
        }
        __syncthreads();  // the tile's keys are in
        // a warp a query: its 8 keys a lane; a query whose tile maximum
        // cannot enter its list leaves it as it is (every insert and every
        // merge would keep it), the rest run the TPU kernels' mechanism
#pragma unroll 1
        for (int j = 0, b = warp; b < QB && q0 + b < n_q; ++j, b += kWarps) {
          int keys[kChunks];
#pragma unroll
          for (int t = 0; t < kChunks; ++t)
            keys[t] = tile_keys[b * kSegTile + 32 * t + lane];
          const int side = (cur >> j) & 1u;
          u64* a = lists + (size_t)(side * QB + b) * kk;
          if (!could_enter(rest_max(keys), a[kk - 1])) continue;
          if (mode == 0) {
            tile_insert(keys, a, kk, n_easy, tile0);
          } else {
            tile_group(keys, a, lists + (size_t)((side ^ 1) * QB + b) * kk,
                       lists + (size_t)(2 * QB + b) * kk, kk, n_easy, tile0);
            cur ^= 1u << j;
          }
        }
      });
  // each warp writes the lists of its own queries
  for (int j = 0, b = warp; b < QB && q0 + b < n_q; ++j, b += kWarps) {
    const u64* l = lists + (size_t)(((cur >> j) & 1u) * QB + b) * kk;
    for (int r = lane; r < kk; r += 32)
      out[((size_t)(q0 + b) * n_seg + seg) * kk + r] = l[r];
  }
}

// The block's shared memory past the query window and the ring: the key
// tile and the lists.
size_t segment_bytes(int qb, int kk, int mode) {
  return (size_t)qb * kSegTile * sizeof(int) +
         (size_t)(mode == 0 ? 1 : 3) * qb * kk * sizeof(u64);
}

// A block's shared memory at QB queries: the query window (wslabs slabs),
// the ring, the key tile and the lists; 0 (and *wslabs 0) when not one
// slab of queries fits beside the rest.
template <int QB>
size_t segment_smem(int d, int corpus_type, int kk, int mode, int* wslabs) {
  typedef StreamShape<QB> S;
  const int kse = slab_values(corpus_type);
  const size_t slab = (size_t)kse * S::QS * sizeof(float);
  const size_t rest =
      (size_t)S::STAGES * S::STAGE + segment_bytes(QB, kk, mode);
  *wslabs = 0;
  if (rest + slab > kMaxSmem) return 0;
  *wslabs = window_slabs((d + kse - 1) / kse, slab, rest);
  return *wslabs * slab + rest;
}

size_t segment_smem_at(int qb, int d, int corpus_type, int kk, int mode,
                       int* wslabs) {
  switch (qb) {
    case 64: return segment_smem<64>(d, corpus_type, kk, mode, wslabs);
    case 32: return segment_smem<32>(d, corpus_type, kk, mode, wslabs);
    case 16: return segment_smem<16>(d, corpus_type, kk, mode, wslabs);
    default: return segment_smem<8>(d, corpus_type, kk, mode, wslabs);
  }
}

template <typename CT, int QB, bool ASYNC>
cudaError_t launch_segment_kernel(const SegmentLaunch& l) {
  auto kernel = segment_topk_kernel<CT, QB, ASYNC>;
  const cudaError_t err = allow_smem(kernel, l.smem);
  if (err != cudaSuccess) return err;
  const int n_seg = (l.n + l.rows_per_seg - 1) / l.rows_per_seg;
  const dim3 grid((l.n_q + QB - 1) / QB, n_seg);
  kernel<<<grid, kThreads, l.smem, l.stream>>>(
      l.q, static_cast<const CT*>(l.c), l.cn, l.cn_mode, l.bf16_compute,
      l.trans, l.mode, l.out, l.n_q, l.n, l.d, l.kk, l.n_easy,
      l.rows_per_seg, n_seg, l.wslabs);
  return cudaGetLastError();
}

template <typename CT, int QB>
cudaError_t launch_segment_qb(const SegmentLaunch& l) {
  // cp.async needs (n, d) rows of whole 16-byte pieces from an aligned base
  const bool async = !l.trans && ((size_t)l.d * sizeof(CT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(l.c) % 16 == 0;
  return async ? launch_segment_kernel<CT, QB, true>(l)
               : launch_segment_kernel<CT, QB, false>(l);
}

template <typename CT>
cudaError_t launch_segment(const SegmentLaunch& l) {
  switch (l.qb) {
    case 64: return launch_segment_qb<CT, 64>(l);
    case 32: return launch_segment_qb<CT, 32>(l);
    case 16: return launch_segment_qb<CT, 16>(l);
    default: return launch_segment_qb<CT, 8>(l);
  }
}

}  // namespace
