// The part-and-merge selection of the register-stream stage-1 kernels
// (flat_topk_candidates_x2.cu, flat_topk_candidates_int8.cu,
// flat_topk_candidates_bf16.cu): a block scores one part of a tile's rows
// and selects each query's top ne1 keys of it; a second kernel merges a
// tile's parts. The tile's top ne1 lies in the union of its parts' top ne1,
// and keys inside a tile are unique (column bits) but INT_MIN, so the merge
// is exact and the last of the ne1 keys is the largest key left behind.
// The one-chain stage 1 over int8 or bf16 rows (stream_candidates below)
// is shared by the int8 and bf16 kernels.
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

// The one-chain stage 1 over rows of type CT (int8 with row scales, #4; or
// bf16, #1): each score is ONE f32 chain from +0, k ascending, of the
// products bf16(q_k) c_k by fmaf (exact in f32: 8 x 8 significand bits at
// most), then finish_score: cn_mode 0 the chain (dot), 1 2 s - ||c||^2
// (l2, cv the row's squared norm), 2 s * scale (cv the row's scale), each
// with one rounding to nearest. The zero pads past d add exact zeros to a
// chain that is never -0, so the order, and a score's bits, depend on d
// alone: not on the batch, the query block or the layout.
constexpr int kBigQ = 32;  // batches of more than this: 64 a block

// The query block for n_q queries: 64 above kBigQ queries, 32 above
// kSmallQ, 8 up to kTinyQ, else 16. Any d fits it: the queries are staged
// a window at a time where the whole width does not (stream_rows).
int stream_cand_queries(int n_q) {
  if (n_q > kBigQ) return 64;
  if (n_q > kSmallQ) return 32;
  return n_q <= kTinyQ ? 8 : 16;
}

// A block's shared memory for rows of KSE values a 64-byte slab: the query
// window, then the ring or, once the stream is done, the keys; *wslabs
// gets the window's slabs.
template <int QB, int KSE>
size_t stream_cand_smem(int d, int* wslabs) {
  typedef StreamShape<QB> S;
  const size_t ring = (size_t)S::STAGES * S::STAGE;
  const size_t keys = (size_t)QB * S::ROWS * sizeof(int);
  const size_t rest = ring > keys ? ring : keys;
  const size_t slab = (size_t)KSE * S::QS * sizeof(float);
  *wslabs = window_slabs((d + KSE - 1) / KSE, slab, rest);
  return *wslabs * slab + rest;
}

// The launch for n_q queries of width d over n rows in tiles of tile_n.
struct StreamGeometry {
  int qb, parts, q_blocks, n_tiles, wslabs;
  size_t smem;
};

template <int KSE>
bool stream_geometry(int n_q, int n, int d, int tile_n, StreamGeometry* g) {
  if (n_q <= 0 || n <= 0 || d <= 0 || tile_n <= 0 || tile_n > kMaxTileN ||
      tile_n % 32 != 0) {
    return false;
  }
  const int qb = stream_cand_queries(n_q);
  const long long n_tiles = ((long long)n + tile_n - 1) / tile_n;
  const int parts = (tile_n + StreamShape<32>::ROWS - 1) /
                    StreamShape<32>::ROWS;
  const long long q_blocks = ((long long)n_q + qb - 1) / qb;
  if (n_tiles > 65535 || q_blocks * parts > 2147483647LL ||
      (long long)n_q * n_tiles > 2147483647LL / kMaxNE1)
    return false;
  int w = 0;
  const size_t smem = qb == 64   ? stream_cand_smem<64, KSE>(d, &w)
                      : qb == 32 ? stream_cand_smem<32, KSE>(d, &w)
                      : qb == 16 ? stream_cand_smem<16, KSE>(d, &w)
                                 : stream_cand_smem<8, KSE>(d, &w);
  *g = {qb, parts, (int)q_blocks, (int)n_tiles, w, smem};
  return true;
}

// geo[6]: queries a block, rows a block, blocks a tile (its parts), blocks,
// threads a block, shared memory bytes a block
void report_stream(const StreamGeometry& g, int* geo) {
  geo[0] = g.qb;
  geo[1] = StreamShape<32>::ROWS;
  geo[2] = g.parts;
  geo[3] = g.parts * g.q_blocks * g.n_tiles;
  geo[4] = kThreads;
  geo[5] = (int)g.smem;
}

// Block (part * query block, tile): rows [part * ROWS, (part + 1) * ROWS)
// of the tile for queries q0 .. q0 + QB - 1, whose top ne1 keys go to
// lists (n_q, n_tiles, parts, ne1), or, for a tile of one part, to out.
// Shared memory: a window of wslabs slabs of the queries (wslabs KSE x QS
// f32, bf16-rounded), then the ring, whose space holds the keys (QB x
// ROWS) once the stream is done. The block is one chunk of rows, so each
// query value is staged once, windowed or not.
template <typename CT, int QB, bool ASYNC>
__device__ __forceinline__ void stream_candidates(
    const float* __restrict__ q, const CT* __restrict__ c,
    const float* __restrict__ cv, int cn_mode, int32_t* __restrict__ lists,
    int n_q, int n, int d, int tile_n, int ne1, int trans, int wslabs) {
  typedef StreamShape<QB> S;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = (d + KSE - 1) / KSE * KSE;
  float* qs = reinterpret_cast<float*>(smem_raw);
  unsigned char* ring = smem_raw + (size_t)wslabs * KSE * S::QS * sizeof(float);
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

  // the part is one chunk: its scores stay in registers until the ring is
  // free
  float res[S::TQ][S::TR];
#pragma unroll
  for (int a = 0; a < S::TQ; ++a)
#pragma unroll
    for (int i = 0; i < S::TR; ++i) res[a][i] = 0.f;
  stream_rows<CT, QB, ASYNC>(
      c, qs, ring, col0 + p0, col0 + max(p_end, p0), n, d, dpad, wslabs,
      trans, false, load_q, [&](int, float (&acc)[S::TQ][S::TR]) {
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
    const float rv = (cn_mode != 0 && valid) ? cv[col0 + col] : 0.f;
#pragma unroll
    for (int a = 0; a < S::TQ; ++a) {
      const float s = finish_score(res[a][i], cn_mode, rv);
      keys[((warp % S::WQ) * S::TQ + a) * S::ROWS + r] =
          valid ? ((score_to_ikey(s) & ~kColMask) | (tile_n - 1 - col))
                : kIntMin;
    }
  }
  __syncthreads();
  part_top<QB, S::ROWS>(keys, q0, n_q, tile, n_tiles, parts, part, ne1,
                        lists);
}

// One launch of a streamed stage-1 kernel at geometry g, then the merge of
// its parts into out when a tile has more than one.
template <typename Kernel, typename CT>
cudaError_t launch_stream(Kernel kernel, const StreamGeometry& g,
                          const float* q, const CT* c, const float* cv,
                          int cn_mode, int32_t* scratch, int32_t* out,
                          int n_q, int n, int d, int tile_n, int ne1,
                          int trans, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.parts * g.q_blocks, g.n_tiles);
  kernel<<<grid, kThreads, g.smem, stream>>>(
      q, c, cv, cn_mode, g.parts > 1 ? scratch : out, n_q, n, d, tile_n, ne1,
      trans, g.wslabs);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.parts == 1) return err;
  return merge_parts(scratch, out, n_q * g.n_tiles, g.parts, ne1, stream);
}

}  // namespace
