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
//   * 64 queries a block above 32 queries (d <= 576; 10% faster than 32 at
//     Q = 64 and 512 on the H100, one block an SM), 32 above 16, 8 up to 8,
//     else 16.
// The (d, n) layout runs the same chain through the stream's loads by the
// threads (no cp.async), so both layouts give the same keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_parts.cuh"

namespace {

constexpr int kKSE = kSlabBytes;  // int8 K values of a slab
constexpr int kBigQ = 32;         // batches of more than this: 64 a block

// the queries, then the ring or, once the stream is done, the keys
template <int QB>
size_t int8_smem(int d) {
  typedef StreamShape<QB> S;
  const size_t dpad = (size_t)(d + kKSE - 1) / kKSE * kKSE;
  const size_t ring = (size_t)S::STAGES * S::STAGE;
  const size_t keys = (size_t)QB * S::ROWS * sizeof(int);
  return dpad * S::QS * sizeof(float) + (ring > keys ? ring : keys);
}

// The query block for n_q queries of width d: 64 above kBigQ queries when
// it fits, else as the bf16x2 stage 1 picks it; 0 when none fits a block's
// shared memory.
int int8_queries(int n_q, int d) {
  if (n_q > kBigQ && int8_smem<64>(d) <= kMaxSmem) return 64;
  if (n_q > kSmallQ && int8_smem<32>(d) <= kMaxSmem) return 32;
  if (n_q <= kTinyQ) return int8_smem<8>(d) <= kMaxSmem ? 8 : 0;
  return int8_smem<16>(d) <= kMaxSmem ? 16 : 0;
}

// Block (part * query block, tile): rows [part * ROWS, (part + 1) * ROWS)
// of the tile for queries q0 .. q0 + QB - 1, whose top ne1 keys go to
// lists (n_q, n_tiles, parts, ne1), or, for a tile of one part, to out.
// Shared memory: the queries (dpad x QS f32, bf16-rounded), then the ring,
// whose space holds the keys (QB x ROWS) once the stream is done.
template <int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1)
extract_candidates_int8_kernel(const float* __restrict__ q,
                               const int8_t* __restrict__ c,
                               const float* __restrict__ scale,
                               int32_t* __restrict__ lists, int n_q, int n,
                               int d, int tile_n, int ne1, int trans) {
  typedef StreamShape<QB> S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + kKSE - 1) / kKSE * kKSE;
  float* qs = reinterpret_cast<float*>(smem_raw);
  unsigned char* ring = smem_raw + (size_t)dpad * S::QS * sizeof(float);
  const int parts = (tile_n + S::ROWS - 1) / S::ROWS;
  const int part = blockIdx.x % parts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = (blockIdx.x / parts) * QB;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int col0 = tile * tile_n;
  const int tile_cols = min(tile_n, n - col0);
  const int p0 = part * S::ROWS;  // the part's first column in the tile
  const int p_end = min(tile_cols, p0 + S::ROWS);

  // 4 queries at one k a thread, rounded to bf16
  for (int i = threadIdx.x; i < dpad * (QB / 4); i += kThreads) {
    const int g = i / dpad, k = i - g * dpad;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = q0 + 4 * g + e;
      v[e] = round_bf16((j < n_q && k < d) ? q[(size_t)j * d + k] : 0.f);
    }
    *reinterpret_cast<float4*>(qs + k * S::QS + 4 * g) =
        make_float4(v[0], v[1], v[2], v[3]);
  }

  // the part is one chunk: its scores stay in registers until the ring is
  // free
  float res[S::TQ][S::TR];
#pragma unroll
  for (int a = 0; a < S::TQ; ++a)
#pragma unroll
    for (int i = 0; i < S::TR; ++i) res[a][i] = 0.f;
  stream_rows<int8_t, QB, ASYNC>(
      c, qs, ring, col0 + p0, col0 + max(p_end, p0), n, d, dpad, trans,
      false, [&](int, float (&acc)[S::TQ][S::TR]) {
#pragma unroll
        for (int a = 0; a < S::TQ; ++a)
#pragma unroll
          for (int i = 0; i < S::TR; ++i) res[a][i] = acc[a][i];
      });
  __syncthreads();  // every warp is done with the ring

  int* keys = reinterpret_cast<int*>(ring);  // QB x ROWS
  const int r0 = (warp / S::WQ) * 32 * S::TR + lane;
#pragma unroll
  for (int i = 0; i < S::TR; ++i) {
    const int r = r0 + 32 * i;  // the row in the part
    const int col = p0 + r;     // and in the tile
    const bool valid = col < p_end;
    const float sc = valid ? scale[col0 + col] : 0.f;
#pragma unroll
    for (int a = 0; a < S::TQ; ++a) {
      const float s = __fmul_rn(res[a][i], sc);
      keys[((warp % S::WQ) * S::TQ + a) * S::ROWS + r] =
          valid ? ((score_to_ikey(s) & ~kColMask) | (tile_n - 1 - col))
                : kIntMin;
    }
  }
  __syncthreads();
  part_top<QB, S::ROWS>(keys, q0, n_q, tile, n_tiles, parts, part, ne1,
                        lists);
}

// The launch for n_q queries of width d over n rows in tiles of tile_n.
struct Int8Geometry {
  int qb, parts, q_blocks, n_tiles;
  size_t smem;
};

bool int8_geometry(int n_q, int n, int d, int tile_n, Int8Geometry* g) {
  if (n_q <= 0 || n <= 0 || d <= 0 || tile_n <= 0 || tile_n > kMaxTileN ||
      tile_n % 32 != 0) {
    return false;
  }
  const int qb = int8_queries(n_q, d);
  const long long n_tiles = ((long long)n + tile_n - 1) / tile_n;
  const int parts = (tile_n + StreamShape<32>::ROWS - 1) /
                    StreamShape<32>::ROWS;
  const long long q_blocks = ((long long)n_q + qb - 1) / (qb > 0 ? qb : 1);
  if (qb == 0 || n_tiles > 65535 || q_blocks * parts > 2147483647LL)
    return false;
  *g = {qb, parts, (int)q_blocks, (int)n_tiles,
        qb == 64   ? int8_smem<64>(d)
        : qb == 32 ? int8_smem<32>(d)
        : qb == 16 ? int8_smem<16>(d)
                   : int8_smem<8>(d)};
  return true;
}

template <int QB, bool ASYNC>
cudaError_t launch_int8(const Int8Geometry& g, const float* q,
                        const int8_t* c, const float* scale, int32_t* scratch,
                        int32_t* out, int n_q, int n, int d, int tile_n,
                        int ne1, int trans, cudaStream_t stream) {
  auto kernel = extract_candidates_int8_kernel<QB, ASYNC>;
  cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.parts * g.q_blocks, g.n_tiles);
  kernel<<<grid, kThreads, g.smem, stream>>>(
      q, c, scale, g.parts > 1 ? scratch : out, n_q, n, d, tile_n, ne1,
      trans);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.parts == 1) return err;
  return merge_parts(scratch, out, n_q * g.n_tiles, g.parts, ne1, stream);
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
  Int8Geometry g;
  if (c == nullptr || scale == nullptr || n_easy < 1 ||
      n_easy + 1 > kMaxNE1 || !int8_geometry(n_q, n, d, tile_n, &g) ||
      (g.parts > 1 && scratch == nullptr) ||
      (long long)n_q * g.n_tiles > 2147483647LL / kMaxNE1) {
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
  return (int)(async ? launch_int8<QB, true>(g, qf, cc, sf, sc, o, n_q, n,  \
                                             d, tile_n, ne1, trans, s)      \
                     : launch_int8<QB, false>(g, qf, cc, sf, sc, o, n_q, n, \
                                              d, tile_n, ne1, trans, s))
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
// fits (d past the shared memory, a tile past 2,048 rows or not of whole
// 32-row steps, the grid).
extern "C" int prt_extract_candidates_int8_geometry(int n_q, int n, int d,
                                                    int tile_n, int* geo) {
  Int8Geometry g;
  if (geo == nullptr || !int8_geometry(n_q, n, d, tile_n, &g))
    return (int)cudaErrorInvalidValue;
  geo[0] = g.qb;
  geo[1] = StreamShape<32>::ROWS;
  geo[2] = g.parts;
  geo[3] = g.parts * g.q_blocks * g.n_tiles;
  geo[4] = kThreads;
  geo[5] = (int)g.smem;
  return 0;
}
