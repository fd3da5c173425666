// The maxonly floor of the running top-k: each query's largest score.
//
// Replaces the TPU Pallas kernel
//   persian_rag_tpu/ops/flat_topk.py::_max_only_kernel   (mode "maxonly")
// reached through flat_topk_pallas(mode="maxonly"); the port reaches it
// through flat_topk_running(mode="maxonly") and flat_topk(mode="maxonly").
// It computes, per query, max over the real rows of s = q.c (dot),
// 2 q.c - ||c||^2 (l2) or scale[c] * q.c (int8 rows with per-row scales),
// the contraction accumulated in f32 (both operands rounded to bf16 first
// with bf16 compute), returned in maximize space. The TPU kernel scored pad
// rows 0 and ignored the scales; the port corrects both.
//
// The design and what bounds it on the H100 are in the header of
// flat_topk_running.cu (the family's file); the stream itself is
// row_stream.cuh. The kernel lives in its own file so that nvcc builds its
// twelve instantiations (corpus type x queries per block x copy path) in
// parallel with the other sources.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stream.cuh"

namespace {

// a block's shared memory; *wslabs gets its query window's slabs
size_t maxonly_smem(int d, int corpus_type, int qb, int* wslabs) {
  return qb == 64 ? stream_smem<64>(d, corpus_type, wslabs)
                  : stream_smem<32>(d, corpus_type, wslabs);
}

// maxonly: out (n_q,) int32, set to INT_MIN by the caller, receives the
// monotone int image of each query's largest score over the real rows.
// Block (query block, segment of rows_per_seg rows).
template <typename CT, int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1)
maxonly_kernel(const float* __restrict__ q, const CT* __restrict__ c,
               const float* __restrict__ cn, int cn_mode, int bf16_compute,
               int trans, int* __restrict__ out, int n_q, int n, int d,
               int rows_per_seg, int wslabs) {
  typedef StreamShape<QB> S;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + KSE - 1) / KSE * KSE;
  float* qs = reinterpret_cast<float*>(smem_raw);  // a window, k-major
  unsigned char* ring =
      smem_raw + (size_t)wslabs * KSE * S::QS * sizeof(float);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QB;
  const int row_first = blockIdx.y * rows_per_seg;
  const int row_end = min(n, row_first + rows_per_seg);

  // slabs [slab0, slab0 + count) of the queries, 4 queries at one k a
  // thread: consecutive threads read consecutive k (a wide row's windows
  // are staged again for each chunk of rows)
  auto load_q = [&](int slab0, int count) {
    const int k0 = slab0 * KSE, kn = count * KSE;
    for (int i = threadIdx.x; i < kn * (QB / 4); i += kThreads) {
      const int g = i / kn, kk = i - g * kn, k = k0 + kk;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = q0 + 4 * g + e;
        v[e] = (j < n_q && k < d) ? q[(size_t)j * d + k] : 0.f;
        if (bf16_compute) v[e] = round_bf16(v[e]);
      }
      *reinterpret_cast<float4*>(qs + kk * S::QS + 4 * g) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  int best[S::TQ];
#pragma unroll
  for (int a = 0; a < S::TQ; ++a) best[a] = kIntMin;
  stream_rows<CT, QB, ASYNC>(
      c, qs, ring, row_first, row_end, n, d, dpad, wslabs, trans,
      bf16_compute != 0, load_q, [&](int row0, float (&acc)[S::TQ][S::TR]) {
#pragma unroll
        for (int i = 0; i < S::TR; ++i) {
          const int row = row0 + 32 * i;
          if (row < row_end) {
            const float cv = cn_mode != 0 ? cn[row] : 0.f;
#pragma unroll
            for (int a = 0; a < S::TQ; ++a)
              best[a] = max(best[a], score_to_ikey(
                                         finish_score(acc[a][i], cn_mode, cv)));
          }
        }
      });
  // a warp maximum per query, then the row halves', one atomicMax a query
  int* half_max = reinterpret_cast<int*>(ring + (size_t)S::STAGES * S::STAGE);
#pragma unroll
  for (int a = 0; a < S::TQ; ++a) {
    const int m = warp_max(best[a]);
    if (lane == 0)
      half_max[(warp / S::WQ) * QB + (warp % S::WQ) * S::TQ + a] = m;
  }
  __syncthreads();
  if ((int)threadIdx.x < QB && q0 + (int)threadIdx.x < n_q) {
    int m = half_max[threadIdx.x];
#pragma unroll
    for (int h = 1; h < S::WR; ++h) m = max(m, half_max[h * QB + threadIdx.x]);
    if (m != kIntMin) atomicMax(out + q0 + threadIdx.x, m);
  }
}

template <typename CT, int QB, bool ASYNC>
cudaError_t launch_maxonly_kernel(const float* q, const void* c,
                                  const float* cn, int cn_mode,
                                  int bf16_compute, int trans, int* out,
                                  int n_q, int n, int d, int rows_per_seg,
                                  size_t smem, int wslabs,
                                  cudaStream_t stream) {
  auto kernel = maxonly_kernel<CT, QB, ASYNC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + QB - 1) / QB, (n + rows_per_seg - 1) / rows_per_seg);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const CT*>(c), cn, cn_mode, bf16_compute, trans, out,
      n_q, n, d, rows_per_seg, wslabs);
  return cudaGetLastError();
}

template <typename CT>
cudaError_t launch_maxonly(const float* q, const void* c, const float* cn,
                           int cn_mode, int bf16_compute, int trans, int* out,
                           int n_q, int n, int d, int qb, int rows_per_seg,
                           size_t smem, int wslabs, cudaStream_t stream) {
  // cp.async needs (n, d) rows of whole 16-byte pieces from an aligned base
  const bool async = !trans && ((size_t)d * sizeof(CT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (qb == 64)
    return async ? launch_maxonly_kernel<CT, 64, true>(
                       q, c, cn, cn_mode, bf16_compute, trans, out, n_q, n, d,
                       rows_per_seg, smem, wslabs, stream)
                 : launch_maxonly_kernel<CT, 64, false>(
                       q, c, cn, cn_mode, bf16_compute, trans, out, n_q, n, d,
                       rows_per_seg, smem, wslabs, stream);
  return async ? launch_maxonly_kernel<CT, 32, true>(
                     q, c, cn, cn_mode, bf16_compute, trans, out, n_q, n, d,
                     rows_per_seg, smem, wslabs, stream)
               : launch_maxonly_kernel<CT, 32, false>(
                     q, c, cn, cn_mode, bf16_compute, trans, out, n_q, n, d,
                     rows_per_seg, smem, wslabs, stream);
}

}  // namespace

// maxonly: out (n_q,) int32, preset to INT_MIN, receives the monotone int
// image of each query's largest score over the real rows, row values folded
// in as cn_mode says. qb (64 or 32) queries per block, rows_per_seg rows per
// segment (at most 65,535 segments); any d (the queries staged a window at a
// time past what a block's shared memory holds). Other arguments as
// prt_running_tile_topk.
extern "C" int prt_running_maxonly(const void* q, const void* c,
                                   const void* cn, void* out, int n_q, int n,
                                   int d, int corpus_type, int cn_mode,
                                   int bf16_compute, int trans, int qb,
                                   int rows_per_seg, void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || corpus_type < 0 || corpus_type > 2 ||
      cn_mode < 0 || cn_mode > 2 || (cn_mode != 0 && cn == nullptr) ||
      (qb != 64 && qb != 32) || rows_per_seg < 1 ||
      (n + (long long)rows_per_seg - 1) / rows_per_seg > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* cnf = static_cast<const float*>(cn);
  int* o = static_cast<int*>(out);
  int wslabs = 0;
  const size_t smem = maxonly_smem(d, corpus_type, qb, &wslabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (corpus_type) {
    case 0:
      return (int)launch_maxonly<float>(qf, c, cnf, cn_mode, bf16_compute,
                                        trans, o, n_q, n, d, qb, rows_per_seg,
                                        smem, wslabs, s);
    case 1:
      return (int)launch_maxonly<__nv_bfloat16>(
          qf, c, cnf, cn_mode, bf16_compute, trans, o, n_q, n, d, qb,
          rows_per_seg, smem, wslabs, s);
    default:
      return (int)launch_maxonly<int8_t>(qf, c, cnf, cn_mode, bf16_compute,
                                         trans, o, n_q, n, d, qb, rows_per_seg,
                                         smem, wslabs, s);
  }
}

