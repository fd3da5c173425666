// Stage 1 of the two-stage exact flat search over the bf16x2 image (#2).
//
// Replaces the TPU Pallas kernel
//   persian_rag_tpu/ops/flat_topk.py::_extract_candidates_x2_kernel
// reached through flat_topk_candidates(corpus_lo=...). It keeps the contract
// of flat_topk_candidates.cu (that file's header): for every (query, corpus
// tile of tile_n <= 2048 columns), the tile's top n_easy packed keys in
// descending order, then the (n_easy+1)-th key, the largest key left behind.
// key = (ikey(s) & ~0x7FF) | (tile_n - 1 - col); s = q_hi.c_hi + q_hi.c_lo
// + q_lo.c_hi with q_hi = bf16(q), q_lo = bf16(q - q_hi); for l2, 2 s -
// ||c||^2. Columns at or beyond n get INT_MIN.
//
// Arithmetic, and why the proof's bound stays valid: each score is ONE f32
// chain from +0 of 3d products, k ascending, qh c_hi, qh c_lo, ql c_hi a k
// (row_stream.cuh, stream_rows_x2). Products of two bf16 values are exact
// in f32, and fmaf adds each with one rounding to nearest: exact products
// added with IEEE round-to-nearest f32 in a fixed order, which is what
// _bf16x2_matmul_eps(d) bounds (flat_topk_candidates.cu's header gives the
// margin: one sum of 3d terms is far inside the bound's slack). No tensor
// cores: their accumulation does not round each addition to nearest f32.
// The order depends on d alone, so a query's keys do not depend on the
// batch, the query block or the call; flat_topk.bf16x2_chain_candidates
// mirrors the chain on any device.
//
// What bounds it on the H100: the f32 FMAs, 6 Q N d FLOPs (14.7 GFLOP at
// Q = 64, N = 100k, d = 384: 0.220 ms at 67 TFLOP/s) against 4 N d bytes of
// hi and lo rows (0.046 ms at 3.35 TB/s). The earlier kernel gave a lane one
// row and two queries, six shared-memory loads for twelve FMAs with no copy
// in flight: 4.7x the FMA floor. Here:
//   * the rows stream through a cp.async ring, hi and lo slabs side by side,
//     against the query block held k-major in shared memory as f32 hi and lo
//     parts; a thread keeps a TQ x 4 tile of chains (TQ = 8 at 32 queries a
//     block), so per k it issues 3 TQ 4 FMAs for 2 TQ broadcast loads of
//     queries, one row load a 8 k and 8 bit operations widening the rows
//     (the loads are not what holds it: float4 query loads timed the same);
//   * a block scores one 256-row part of a tile for its query block: it
//     writes its keys to shared memory and selects each query's top
//     n_easy+1 of its part (a warp a query, rounds of a warp maximum) into a
//     scratch list; a second kernel merges a tile's parts (a warp a query
//     and tile). So a served request of 1-16 queries launches 392 blocks over
//     a 100k corpus (the earlier kernel 98, on 132 SMs), and 64 queries 784.
//     (A cluster of a tile's parts, merged through distributed shared
//     memory, held only 30 clusters of 4 at once on the H100: 120 SMs);
//   * 32 queries a block above 16 queries, 8 up to 8, else 16, so a small
//     request wastes less of a thread's tile. Any d fits: past what a
//     block's shared memory holds (d = 512 at 32 queries, 928 at 16, 1,568
//     at 8) the queries are staged a window at a time
//     (prt_extract_candidates_bf16x2_geometry), each value still once a
//     block.
// The tile's top n_easy+1 lies in the union of its parts' top n_easy+1, and
// keys inside a tile are unique (column bits), so the merge is exact and the
// (n_easy+1)-th key is the largest key left behind. On the H100 it runs at
// about 2x the FMA floor from 64 queries up and 2x the byte bound at 8 and
// fewer (PERF.md section 6); a persistent block an SM whose ring runs on from
// part to part, a third ring stage, 128-byte slabs and the three products in
// three passes each timed within 3% of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_parts.cuh"

namespace {

// A block's shared memory: the window of both query parts, then the ring;
// *wslabs gets the window's slabs (of 32 K values).
template <int QB>
size_t x2_smem(int d, int* wslabs) {
  typedef StreamShapeX2<QB> S;
  const size_t rest = (size_t)S::STAGES * S::STAGE;
  const size_t slab = 2 * (size_t)32 * S::QS * sizeof(float);
  *wslabs = window_slabs((d + 31) / 32, slab, rest);
  return *wslabs * slab + rest;
}

// The query block for n_q queries: 32 above kSmallQ queries, 8 up to
// kTinyQ, else 16. Any d fits it (the queries staged a window at a time
// where the whole width does not).
int x2_queries(int n_q) {
  if (n_q > kSmallQ) return 32;
  return n_q <= kTinyQ ? 8 : 16;
}

// Block (part * query block, tile): rows [part * ROWS, (part + 1) * ROWS)
// of the tile for queries q0 .. q0 + QB - 1, whose top ne1 keys go to
// lists (n_q, n_tiles, parts, ne1), or, for a tile of one part, to out.
// Shared memory: a window of wslabs slabs of qh and of ql (wslabs 32 x QS
// f32 each), then the ring, whose space holds the keys (QB x ROWS) once the
// stream is done.
template <int QB, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 1)
extract_candidates_x2_kernel(const float* __restrict__ q,
                             const __nv_bfloat16* __restrict__ c_hi,
                             const __nv_bfloat16* __restrict__ c_lo,
                             const float* __restrict__ cn,
                             int32_t* __restrict__ lists, int n_q, int n,
                             int d, int tile_n, int ne1, int wslabs) {
  typedef StreamShapeX2<QB> S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + 31) / 32 * 32;
  const int wk = wslabs * 32;
  float* qh = reinterpret_cast<float*>(smem_raw);
  float* ql = qh + (size_t)wk * S::QS;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ql + (size_t)wk *
                                                                  S::QS);
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

  // slabs [slab0, slab0 + count) of the queries, 4 queries at one k a
  // thread, split into their bf16 parts
  auto load_q = [&](int slab0, int count) {
    const int k0 = slab0 * 32, kn = count * 32;
    for (int i = threadIdx.x; i < kn * (QB / 4); i += kThreads) {
      const int g = i / kn, kk = i - g * kn, k = k0 + kk;
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = q0 + 4 * g + e;
        const float v = (j < n_q && k < d) ? q[(size_t)j * d + k] : 0.f;
        h[e] = round_bf16(v);
        l[e] = round_bf16(v - h[e]);
      }
      *reinterpret_cast<float4*>(qh + kk * S::QS + 4 * g) =
          make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(ql + kk * S::QS + 4 * g) =
          make_float4(l[0], l[1], l[2], l[3]);
    }
  };

  // the part is one chunk: its scores stay in registers until the ring is
  // free
  float res[S::TQ][S::TR];
#pragma unroll
  for (int a = 0; a < S::TQ; ++a)
#pragma unroll
    for (int i = 0; i < S::TR; ++i) res[a][i] = 0.f;
  stream_rows_x2<QB, ASYNC>(
      c_hi, c_lo, qh, ql, ring, col0 + p0, col0 + max(p_end, p0), d, dpad,
      wslabs, load_q, [&](int, float (&acc)[S::TQ][S::TR]) {
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
    const float cv = (cn != nullptr && valid) ? cn[col0 + col] : 0.f;
#pragma unroll
    for (int a = 0; a < S::TQ; ++a) {
      float s = res[a][i];
      if (cn != nullptr) s = __fsub_rn(__fmul_rn(2.f, s), cv);
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
struct X2Geometry {
  int qb, parts, q_blocks, n_tiles, wslabs;
  size_t smem;
};

bool x2_geometry(int n_q, int n, int d, int tile_n, X2Geometry* g) {
  if (n_q <= 0 || n <= 0 || d <= 0 || tile_n <= 0 || tile_n > kMaxTileN ||
      tile_n % 32 != 0) {
    return false;
  }
  const int qb = x2_queries(n_q);
  const long long n_tiles = ((long long)n + tile_n - 1) / tile_n;
  const int parts = (tile_n + StreamShapeX2<32>::ROWS - 1) /
                    StreamShapeX2<32>::ROWS;
  const long long q_blocks = ((long long)n_q + qb - 1) / qb;
  if (n_tiles > 65535 || q_blocks * parts > 2147483647LL) return false;
  int w = 0;
  const size_t smem = qb == 32   ? x2_smem<32>(d, &w)
                      : qb == 16 ? x2_smem<16>(d, &w)
                                 : x2_smem<8>(d, &w);
  *g = {qb, parts, (int)q_blocks, (int)n_tiles, w, smem};
  return true;
}

template <int QB, bool ASYNC>
cudaError_t launch_x2(const X2Geometry& g, const float* q,
                      const __nv_bfloat16* c_hi, const __nv_bfloat16* c_lo,
                      const float* cn, int32_t* scratch, int32_t* out,
                      int n_q, int n, int d, int tile_n, int ne1,
                      cudaStream_t stream) {
  auto kernel = extract_candidates_x2_kernel<QB, ASYNC>;
  cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.parts * g.q_blocks, g.n_tiles);
  kernel<<<grid, kThreads, g.smem, stream>>>(q, c_hi, c_lo, cn,
                                             g.parts > 1 ? scratch : out, n_q,
                                             n, d, tile_n, ne1, g.wslabs);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.parts == 1) return err;
  return merge_parts(scratch, out, n_q * g.n_tiles, g.parts, ne1, stream);
}

}  // namespace

// q: (n_q, d) f32; c_hi, c_lo: (n, d) bf16 rows and their residues; cn:
// (n,) f32 ||c||^2 for l2, NULL for dot; scratch: (n_q, ceil(n / tile_n),
// parts, n_easy + 1) int32 where the geometry has more than one part, else
// unused; out: (n_q, ceil(n / tile_n), n_easy + 1) int32. Returns a
// cudaError_t.
extern "C" int prt_extract_candidates_bf16x2(const void* q, const void* c_hi,
                                             const void* c_lo, const void* cn,
                                             void* scratch, void* out,
                                             int n_q, int n, int d,
                                             int tile_n, int n_easy,
                                             void* stream) {
  X2Geometry g;
  if (c_hi == nullptr || c_lo == nullptr || n_easy < 1 ||
      n_easy + 1 > kMaxNE1 || !x2_geometry(n_q, n, d, tile_n, &g) ||
      (g.parts > 1 && scratch == nullptr) ||
      (long long)n_q * g.n_tiles > 2147483647LL / kMaxNE1) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(c_hi);
  const __nv_bfloat16* l = static_cast<const __nv_bfloat16*>(c_lo);
  const float* cnf = static_cast<const float*>(cn);
  int32_t* sc = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // cp.async needs rows of whole 16-byte pieces from 16-byte aligned bases
  const bool async = d % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(c_hi) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(c_lo) % 16 == 0;
  const int ne1 = n_easy + 1;
#define PRT_X2(QB)                                                           \
  return (int)(async ? launch_x2<QB, true>(g, qf, h, l, cnf, sc, o, n_q, n,  \
                                           d, tile_n, ne1, s)                \
                     : launch_x2<QB, false>(g, qf, h, l, cnf, sc, o, n_q, n, \
                                            d, tile_n, ne1, s))
  switch (g.qb) {
    case 32: PRT_X2(32);
    case 16: PRT_X2(16);
    default: PRT_X2(8);
  }
#undef PRT_X2
}

// The launch prt_extract_candidates_bf16x2 makes, into geo[6]: queries a
// block, rows a block, blocks a tile (its parts), blocks, threads a block,
// shared memory bytes a block. Returns cudaErrorInvalidValue when no launch
// fits (a tile past 2,048 rows or not of whole 32-row steps, the grid).
extern "C" int prt_extract_candidates_bf16x2_geometry(int n_q, int n, int d,
                                                      int tile_n, int* geo) {
  X2Geometry g;
  if (geo == nullptr || !x2_geometry(n_q, n, d, tile_n, &g))
    return (int)cudaErrorInvalidValue;
  geo[0] = g.qb;
  geo[1] = StreamShapeX2<32>::ROWS;
  geo[2] = g.parts;
  geo[3] = g.parts * g.q_blocks * g.n_tiles;
  geo[4] = kThreads;
  geo[5] = (int)g.smem;
  return 0;
}
