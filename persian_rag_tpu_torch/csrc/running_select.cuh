// The select kernel of the running top-k's modes exact and fast (#5, #6):
// flat_topk_running_select.cu says what it computes and why it is shaped
// so. Its instantiations are split by row type over that file and
// flat_topk_running_select_bf16.cu / _int8.cu, so that nvcc builds them in
// parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"

// One launch of the select kernel: prt_running_tile_topk's arguments and
// the query window and shared memory it worked out.
struct RunningSelectLaunch {
  const float* q;
  const void* c;
  const float* cn;
  int cn_mode, bf16_compute, fast, trans;
  unsigned long long* out;
  int n_q, n, d, kk, qb, qcap, rows_per_seg, wslabs;
  size_t smem;
  cudaStream_t stream;
};

// The launch over f32, bf16 and int8 rows, each in its own source.
cudaError_t running_select_f32(const RunningSelectLaunch& l);
cudaError_t running_select_bf16(const RunningSelectLaunch& l);
cudaError_t running_select_int8(const RunningSelectLaunch& l);

namespace {

typedef unsigned long long u64;

constexpr int kColMask = (1 << 11) - 1;
constexpr int kMaxK = 128;
constexpr int kPerLane = kMaxK / 32;   // a list's or queue's keys a lane

// The high word of a score's key: its order bits.
__device__ __forceinline__ uint32_t key_hi(float s, int fast) {
  if (!fast && s == 0.f) s = 0.f;     // -0 -> +0: equal scores, equal bits
  int ik = score_to_ikey(s);
  if (fast) ik &= ~kColMask;
  return (uint32_t)ik ^ 0x80000000u;  // signed -> unsigned order
}

__device__ __forceinline__ u64 make_key(uint32_t hi, int id) {
  return ((u64)hi << 32) | (uint32_t)~(uint32_t)id;
}

// Keys of the descending list l[0..len) (unique keys, then zeros) above x.
__device__ __forceinline__ int count_above(const u64* l, int len, u64 x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (l[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// N sets of the warp's 32 values, v[j] across the lanes, each sorted
// descending (bitonic, by shuffles, the sets side by side): lane i gets
// each set's (i + 1)-th largest.
template <typename T, int N>
__device__ __forceinline__ void warp_sort_desc(T (&v)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T o = __shfl_xor_sync(0xffffffffu, v[j], stride);
        v[j] = keep_max ? (v[j] > o ? v[j] : o) : (v[j] < o ? v[j] : o);
      }
    }
  }
}

// One warp merges a query's queued keys, unsorted, into its descending
// list[0..kk) (unique keys, zero = no row) in place: m0 keys at q0 (the
// first row half's) and m1 at q1 (the second's), m0 + m1 <= qcap; sorted
// is the warp's scratch of qcap keys. No key is in both, so each key's
// place is its rank in its own list plus the keys above it in the other (a
// place past kk drops it); a list's zero tail stays zero. Up to 32 keys
// on each side (k <= 32) a lane holds one of each and the ranks come from
// one pass of shuffles; past that, from the sorted queue and binary
// searches in shared memory.
__device__ __forceinline__ void merge_queue(u64* list, int kk, const u64* q0,
                                            int m0, const u64* q1, int m1,
                                            u64* sorted) {
  const int lane = threadIdx.x & 31;
  const int m = m0 + m1;
  auto queued = [&](int p) { return p < m0 ? q0[p] : q1[p - m0]; };
  if (kk <= 32 && m <= 32) {  // warp-uniform
    const u64 x = lane < kk ? list[lane] : 0ull;
    const u64 y = lane < m ? queued(lane) : 0ull;
    int px = lane, py = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const u64 xj = __shfl_sync(0xffffffffu, x, j);
      const u64 yj = __shfl_sync(0xffffffffu, y, j);
      px += yj > x;            // queue keys above the list's key
      py += (yj > y) + (xj > y);  // keys above the queued key
    }
    __syncwarp();  // every read of the list is done
    if (x != 0ull && px < kk) list[px] = x;
    if (lane < m && py < kk) list[py] = y;
    __syncwarp();
    return;
  }
  const int my = (m + 31) >> 5, mx = (kk + 31) >> 5;  // keys a lane, <= 4
  u64 y[kPerLane], x[kPerLane];
  int ry[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int p = lane + 32 * j;
    y[j] = p < m ? queued(p) : 0ull;
    ry[j] = 0;
  }
#pragma unroll 4
  for (int p = 0; p < m; ++p) {  // a broadcast a step
    const u64 v = queued(p);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (j < my) ry[j] += v > y[j];
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int p = lane + 32 * j;
    if (p < m) sorted[ry[j]] = y[j];
    x[j] = p < kk ? list[p] : 0ull;
  }
  __syncwarp();
  int px[kPerLane], py[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int p = lane + 32 * j;
    px[j] = j < mx && x[j] != 0ull ? p + count_above(sorted, m, x[j]) : kk;
    py[j] = j < my && p < m ? ry[j] + count_above(list, kk, y[j]) : kk;
  }
  __syncwarp();  // every read of the list is done
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (px[j] < kk) list[px[j]] = x[j];
    if (py[j] < kk) list[py[j]] = y[j];
  }
  __syncwarp();
}

// Block (query block, segment of rows_per_seg rows): the segment's top kk
// keys of each of its QB queries to out (n_q, n_seg, kk), descending, 0 =
// no row. qcap: a queue's keys (a multiple of 32, kk <= qcap <= 128).
// (32 or 64 queries: one block an SM, as shared memory allows; 16 or 8: two,
// within 128 registers a thread)
template <typename CT, int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, QB >= 32 ? 1 : 2)
running_select_kernel(const float* __restrict__ q, const CT* __restrict__ c,
                      const float* __restrict__ cn, int cn_mode,
                      int bf16_compute, int fast, int trans,
                      u64* __restrict__ out, int n_q, int n, int d, int kk,
                      int qcap, int rows_per_seg, int n_seg, int wslabs) {
  typedef StreamShape<QB> S;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + KSE - 1) / KSE * KSE;
  float* qs = reinterpret_cast<float*>(smem_raw);  // a window, k-major
  unsigned char* ring =
      smem_raw + (size_t)wslabs * KSE * S::QS * sizeof(float);
  u64* lists = reinterpret_cast<u64*>(ring + (size_t)S::STAGES * S::STAGE);
  u64* queue = lists + QB * kk;                    // QB x 2 x qcap / 2
  u64* sorted = queue + QB * qcap;                 // kWarps x qcap
  u64* thr = sorted + kWarps * qcap;               // QB thresholds
  int* cnt = reinterpret_cast<int*>(thr + QB);     // 2 x QB queue counts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;
  const int seg = blockIdx.y;
  const int row_first = seg * rows_per_seg;
  const int row_end = min(n, row_first + rows_per_seg);
  const int qg = (warp % S::WQ) * S::TQ;  // the thread's first query
  const int half = warp / S::WQ;          // and its row half
  const int cap = qcap / 2;               // a row half's share of a queue

  for (int i = threadIdx.x; i < QB * kk; i += kThreads) lists[i] = 0ull;
  for (int i = threadIdx.x; i < QB; i += kThreads) thr[i] = 0ull;

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
        // the keys' high words in registers, a (query, row) each; a row
        // past the segment has no key
        uint32_t h[S::TQ][S::TR];
        unsigned live = 0u;
#pragma unroll
        for (int i = 0; i < S::TR; ++i) {
          const int row = row0 + 32 * i;
          const float cv = (cn_mode != 0 && row < row_end) ? cn[row] : 0.f;
          if (row < row_end) live |= 1u << i;
#pragma unroll
          for (int a = 0; a < S::TQ; ++a)
            h[a][i] = key_hi(finish_score(acc[a][i], cn_mode, cv), fast);
        }
        auto key = [&](int a, int i) {
          return ((live >> i) & 1u) ? make_key(h[a][i], row0 + 32 * i)
                                    : 0ull;
        };
        // A query whose list is not yet full (threshold 0) first takes a
        // bound from this chunk: of the warp's 32 lane maxima, the kk-th
        // largest high word (kk <= 32) has kk real keys at or above it, so
        // no key of a lower high word can enter; the threshold becomes the
        // larger of the two row halves' bounds, and the merges keep it
        // when their k-th key is lower. A first chunk then queues about 2
        // kk keys a query instead of all 256. The queries' sorts run side
        // by side, one shuffle stage at a time.
        if (kk <= 32 &&
            __syncthreads_or(lane == 0 && thr[qg] == 0ull)) {
          uint32_t lm[S::TQ];
#pragma unroll
          for (int a = 0; a < S::TQ; ++a) {
            lm[a] = 0u;
#pragma unroll
            for (int i = 0; i < S::TR; ++i)
              if ((live >> i) & 1u) lm[a] = max(lm[a], h[a][i]);
          }
          warp_sort_desc(lm);
#pragma unroll
          for (int a = 0; a < S::TQ; ++a) {
            const uint32_t kth = __shfl_sync(0xffffffffu, lm[a], kk - 1);
            if (lane == 0 && kth != 0u)
              atomicMax(thr + qg + a, ((u64)kth << 32) - 1ull);
          }
          __syncthreads();  // both row halves' bounds are in
        }
        // Every key above its query's threshold goes to its row half's
        // share of the query's queue, a slot by a ballot's prefix (the
        // warp holds the half's rows: no atomics); a key a full share
        // turns away stays pending for the next round, after the merge.
        u64 pend = 0ull;  // a block's padding queries queue nothing
#pragma unroll
        for (int a = 0; a < S::TQ; ++a)
          if (q0 + qg + a < n_q) pend |= (u64)live << (a * S::TR);
        do {
#pragma unroll
          for (int a = 0; a < S::TQ; ++a) {
            const u64 t = thr[qg + a];
            u64* share = queue + (qg + a) * qcap + half * cap;
            int taken = 0;
#pragma unroll
            for (int i = 0; i < S::TR; ++i) {
              const u64 bit = 1ull << (a * S::TR + i);
              const bool up = (pend & bit) && key(a, i) > t;
              const unsigned ups = __ballot_sync(0xffffffffu, up);
              if (!up) pend &= ~bit;
              const int pos = taken + __popc(ups & ((1u << lane) - 1u));
              if (up && pos < cap) {
                share[pos] = key(a, i);
                pend &= ~bit;
              }
              taken += __popc(ups);
            }
            if (lane == 0) cnt[half * QB + qg + a] = min(taken, cap);
          }
          __syncthreads();  // every queue is filled
#pragma unroll 1
          for (int b = warp; b < QB; b += kWarps) {  // a warp a query
            const int m0 = cnt[b], m1 = cnt[QB + b];
            if (m0 + m1 == 0) continue;
            merge_queue(lists + b * kk, kk, queue + b * qcap, m0,
                        queue + b * qcap + cap, m1, sorted + warp * qcap);
            if (lane == 0) {
              const u64 kth = lists[b * kk + kk - 1];
              if (kth > thr[b]) thr[b] = kth;
            }
          }
        } while (__syncthreads_or(pend != 0ull));
      });
  __syncthreads();
  for (int i = threadIdx.x; i < QB * kk; i += kThreads) {
    const int b = i / kk, r = i - b * kk;
    if (q0 + b < n_q)
      out[((size_t)(q0 + b) * n_seg + seg) * kk + r] = lists[i];
  }
}

template <typename CT, int QB, bool ASYNC>
cudaError_t launch_select_kernel(const RunningSelectLaunch& l) {
  auto kernel = running_select_kernel<CT, QB, ASYNC>;
  const cudaError_t err = allow_smem(kernel, l.smem);
  if (err != cudaSuccess) return err;
  const int n_seg = (l.n + l.rows_per_seg - 1) / l.rows_per_seg;
  const dim3 grid((l.n_q + QB - 1) / QB, n_seg);
  kernel<<<grid, kThreads, l.smem, l.stream>>>(
      l.q, static_cast<const CT*>(l.c), l.cn, l.cn_mode, l.bf16_compute,
      l.fast, l.trans, l.out, l.n_q, l.n, l.d, l.kk, l.qcap, l.rows_per_seg,
      n_seg, l.wslabs);
  return cudaGetLastError();
}

template <typename CT, int QB>
cudaError_t launch_select_qb(const RunningSelectLaunch& l) {
  // cp.async needs (n, d) rows of whole 16-byte pieces from an aligned base
  const bool async = !l.trans && ((size_t)l.d * sizeof(CT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(l.c) % 16 == 0;
  return async ? launch_select_kernel<CT, QB, true>(l)
               : launch_select_kernel<CT, QB, false>(l);
}

template <typename CT>
cudaError_t launch_select(const RunningSelectLaunch& l) {
  switch (l.qb) {
    case 64: return launch_select_qb<CT, 64>(l);
    case 32: return launch_select_qb<CT, 32>(l);
    case 16: return launch_select_qb<CT, 16>(l);
    default: return launch_select_qb<CT, 8>(l);
  }
}

}  // namespace
