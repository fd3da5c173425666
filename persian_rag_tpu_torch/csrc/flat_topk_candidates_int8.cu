// Stage 1 over int8 rows with per-row scales (#4): the int8 tier's
// candidate generation.
//
// Replaces the row_scaled use of the TPU Pallas kernel
//   persian_rag_tpu/ops/flat_topk.py::_extract_candidates_kernel
// reached through flat_topk_scaled_candidates. It keeps the contract of
// flat_topk_candidates.cu (that file's header): for every (query, corpus
// tile of tile_n <= 2048 columns), the tile's top n_easy packed keys in
// descending order, then the (n_easy+1)-th key, the largest key left
// behind. key = (ikey(s) & ~0x7FF) | (tile_n - 1 - col), s = scale[c] *
// sum_k bf16(q_k) c_k; columns at or beyond n get INT_MIN.
//
// Arithmetic: each score is ONE f32 chain from +0, k ascending, of the
// products bf16(q_k) c_k (exact in f32: 8 x 7 significand bits) added by
// fmaf, then one __fmul_rn by the row's scale: the chain of the earlier
// kernel, so the keys are its keys bit for bit (the zero pads past d add
// exact zeros to a chain that is never -0). The order depends on d alone,
// so a query's keys do not depend on the batch, the query block or the
// layout; flat_topk.int8_chain_candidates mirrors the chain on any device.
// No tensor cores (flat_topk_candidates.cu's header says why).
//
// What bounds it on the H100: the f32 FMAs, 2 Q N d (4.9 GFLOP at Q = 64,
// N = 100k, d = 384: 0.073 ms at 67 TFLOP/s) against N d bytes of rows.
// The earlier kernel gave a lane one row and two queries, a shared-memory
// query load for two FMAs with no copy in flight, and 16 queries a block: a
// request of 1-16 queries ran 49 blocks on 132 SMs. Here, as the bf16x2
// stage 1 (flat_topk_candidates_x2.cu) does:
//   * the rows stream through a cp.async ring (row_stream.cuh, stream_rows
//     over int8_t, the stream of the maxonly kernel), widened exactly to
//     f32 in registers, against the query block held k-major in shared
//     memory; a thread keeps a TQ x 4 tile of chains;
//   * a block scores one 256-row part of a tile for its query block and
//     selects each query's top n_easy+1 of it; a second kernel merges a
//     tile's parts (candidate_parts.cuh): at tile 2,048 a request of 1-16
//     queries runs 392 blocks over 100k rows;
//   * 64 queries a block above 32 queries (10% faster than 32 at Q = 64
//     and 512 on the H100, one block an SM), 32 above 16, 8 up to 8, else
//     16. Any d: past what a block's shared memory holds (d = 576 at 64
//     queries, 2,368 at 16) the queries are staged a window at a time
//     (stream_rows), each value still once a block.
// The (d, n) layout runs the same chain through the stream's loads by the
// threads (no cp.async), so both layouts give the same keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_parts.cuh"

namespace {

constexpr int kKSE = kSlabBytes;  // int8 K values of a slab

// The stream over int8 rows, scores times the row scales (the body is
// candidate_parts.cuh's stream_candidates, shared with #1).
template <int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1)
extract_candidates_int8_kernel(const float* __restrict__ q,
                               const int8_t* __restrict__ c,
                               const float* __restrict__ scale, int cn_mode,
                               int32_t* __restrict__ lists, int n_q, int n,
                               int d, int tile_n, int ne1, int trans,
                               int wslabs) {
  stream_candidates<int8_t, QB, ASYNC>(q, c, scale, cn_mode, lists, n_q, n,
                                       d, tile_n, ne1, trans, wslabs);
}

}  // namespace

// q: (n_q, d) f32; c: (n, d) int8 rows, or (d, n) with trans; scale: (n,)
// f32 per-row scales (dot metric only); scratch: (n_q, ceil(n / tile_n),
// parts, n_easy + 1) int32 where the geometry has more than one part, else
// unused; out: (n_q, ceil(n / tile_n), n_easy + 1) int32. Returns a
// cudaError_t.
extern "C" int prt_extract_candidates_int8(const void* q, const void* c,
                                           const void* scale, void* scratch,
                                           void* out, int n_q, int n, int d,
                                           int tile_n, int n_easy, int trans,
                                           void* stream) {
  StreamGeometry g;
  if (c == nullptr || scale == nullptr || n_easy < 1 ||
      n_easy + 1 > kMaxNE1 ||
      !stream_geometry<kKSE>(n_q, n, d, tile_n, &g) ||
      (g.parts > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const int8_t* cc = static_cast<const int8_t*>(c);
  const float* sf = static_cast<const float*>(scale);
  int32_t* sc = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // cp.async needs (n, d) rows of whole 16-byte pieces from a 16-byte
  // aligned base
  const bool async = !trans && d % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const int ne1 = n_easy + 1;
#define PRT_INT8(QB)                                                        \
  return (int)(async ? launch_stream(extract_candidates_int8_kernel<QB, true>, \
                                     g, qf, cc, sf, 2, sc, o, n_q, n, d,     \
                                     tile_n, ne1, trans, s)                  \
                     : launch_stream(                                        \
                           extract_candidates_int8_kernel<QB, false>, g, qf, \
                           cc, sf, 2, sc, o, n_q, n, d, tile_n, ne1, trans,  \
                           s))
  switch (g.qb) {
    case 64: PRT_INT8(64);
    case 32: PRT_INT8(32);
    case 16: PRT_INT8(16);
    default: PRT_INT8(8);
  }
#undef PRT_INT8
}

// The launch prt_extract_candidates_int8 makes, into geo[6]: queries a
// block, rows a block, blocks a tile (its parts), blocks, threads a block,
// shared memory bytes a block. Returns cudaErrorInvalidValue when no launch
// fits (a tile past 2,048 rows or not of whole 32-row steps, the grid).
extern "C" int prt_extract_candidates_int8_geometry(int n_q, int n, int d,
                                                    int tile_n, int* geo) {
  StreamGeometry g;
  if (geo == nullptr || !stream_geometry<kKSE>(n_q, n, d, tile_n, &g))
    return (int)cudaErrorInvalidValue;
  report_stream(g, geo);
  return 0;
}
