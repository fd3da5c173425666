// Stage 1 of the two-stage exact flat search: per-tile candidate extraction,
// and the contract every stage-1 kernel of the port keeps.
//
// Replaces the TPU Pallas kernel
//   persian_rag_tpu/ops/flat_topk.py::_extract_candidates_grouped_kernel
//     (grouped, and the lane-sliced branch of _extract_candidates_kernel:
//     see below)
// reached through flat_topk_candidates, and its row_scaled use over an
// int8 corpus. The port holds them to the TPU kernels' CONTRACT, not to
// their blocks. The other stage-1 kernels keep the same contract in their
// own files: the bf16 stage 1 (_extract_candidates_kernel) in
// flat_topk_candidates_bf16.cu, the bf16x2 stage 1
// (_extract_candidates_x2_kernel) in flat_topk_candidates_x2.cu, and the
// row_scaled use of the first kernel (flat_topk_scaled_candidates, the int8
// tier's candidate generation) in flat_topk_candidates_int8.cu.
//
//   For every (query, corpus tile of tile_n <= 2048 columns) the kernel
//   writes the tile's top n_easy packed keys in descending order, then the
//   tile's (n_easy+1)-th key: a bound on every key it did not extract.
//   key = (ikey(s) & ~0x7FF) | (tile_n - 1 - col), with ikey the monotone
//   f32 -> int32 map, s = q.c (dot), 2 q.c - ||c||^2 (l2), or, for int8
//   rows with per-row scales, s = scale[c] * sum_k bf16(q_k) c_k. Columns at or
//   beyond n get INT_MIN. Keys inside a tile are unique (column bits), so
//   the (n_easy+1)-th key is exactly the largest key left behind — a valid
//   bound, and at least as tight as the TPU kernel's.
//
// The grouped kernel (group G, depth D) first reduces the tile: column
// g C + s (C = tile_n / G) belongs to slot s, and each slot keeps its best
// D keys. The n_easy ranks come from those D C keys, and the bound is
// max(the (n_easy+1)-th of them, the largest key of the deepest level):
// every key hidden behind its slot's top D is at most that slot's D-th. The
// TPU's grouped kernel is depth 2 (group = G is (G, 2)); its lane-sliced
// branch (lane_slots = S, lane_depth = D) is the same reduction with slot
// s = column mod C over S parts, so it is (S, D) here.
//
// The corpus is (N, d) or, with `trans`, (d, N) (the TPU's
// corpus_transposed layout). In (d, N) the staging lanes read consecutive
// rows at one k; the staged pairs and the FMA chain are the same, so both
// layouts give the same keys.
//
// Output layout: out[q][tile][0..n_easy] int32, (n_q, n_tiles, n_easy+1).
//
// Arithmetic, and why the existing proof bounds stay valid:
//   * bf16: s = sum_k bf16(q_k) * c_k, c_k bf16. Products of two bf16
//     values are exact in f32 (8-bit x 8-bit significands), and the kernel
//     accumulates them with IEEE f32 FMA on the CUDA cores, so
//     _bf16_matmul_eps(d) (exact products, f32 accumulation in any order)
//     bounds |s - q.c| as on the TPU.
//   * bf16x2 (flat_topk_candidates_x2.cu): s = sum_k (q_hi c_hi + q_hi c_lo
//     + q_lo c_hi) with q_lo = bf16(q - q_hi), accumulated as ONE f32 sum of
//     3d exact products (the TPU sums three d-term matmuls). One sum of 3d
//     terms adds at most (3d-1) 2^-24 sum|p_i|, and sum|p_i| <= (1 + 2^-8 +
//     2^-17) ||q|| ||c||; _bf16x2_matmul_eps(d) budgets 3(d-1) 2^-24 plus a
//     25% slack of the whole bound. The excess, about (2 + 3d 2^-8) 2^-24
//     relative (2.7e-7 at d = 384 against a slack of 2.0e-5), sits far
//     inside that slack.
//   * int8 row-scaled (the grouped kernel here; flat_topk_candidates_int8.cu
//     for the int8 tier): the int8 values are exact in bf16, so the rows
//     are converted once while they are staged and the same bf16 loop
//     runs; bf16 x int8 products are exact in f32 (8 + 7 significand
//     bits), the sum is one f32 FMA chain in k order, then one f32 multiply
//     by the row's scale. No proof rests on this variant (the int8 tier
//     refines its candidates exactly); a library matmul sums in another
//     order, so a key may differ from the plain version's by one quantum.
//   * Tensor-core (wgmma / mma) accumulation is NOT used: Hopper's tensor
//     cores do not round each addition to nearest f32, so a kernel that
//     uses them must re-derive both bounds first.
//
// What bounds it on the H100: the scores are f32 FMAs on the CUDA cores,
// 2 Q N d FLOPs against 2 N d bytes of corpus. At Q = 64, N = 100k,
// d = 384 that is 4.9 GFLOP over a 77 MB bf16 image:
// 64 FLOP per byte, above the CUDA cores' f32 ridge (~20 FLOP/byte at
// 67 TFLOP/s and 3.35 TB/s), so it is bound by f32 issue and shared-memory
// operand traffic, not by HBM. (Only a tensor-core version would reach the
// bandwidth bound of streaming the 77 MB image; the int8 variant streams
// half the bytes through the same loop, so it is further from it.) The
// design keeps every operand in shared memory and every key in registers:
//   * one block per (16-query block, corpus tile); blockIdx.x walks the
//     query blocks so blocks running together share a corpus tile in L2;
//   * the query block lives in shared memory as bf16-rounded f32, read as
//     warp-wide broadcasts;
//   * the tile streams through shared memory 32 rows at a time with
//     coalesced loads; rows are padded to an odd word stride so the 32
//     lanes (one row each) read 32 distinct banks;
//   * any d: past what fits beside the key table (d = 790 at tile 2,048
//     with group <= depth, 1,686 at group 16, depth 2) the queries and the
//     chunk are staged in even windows of K values, the queries' window
//     beside the rows' (grouped_window), each chain carried across the
//     windows k ascending from +0, so the keys keep their bits;
//   * each key goes into its slot's top-D list in shared memory (kQB x D C
//     ints: 24 KB at tile 2048, S 16, D 3) by a bubble insert. The lanes of
//     one chunk hold consecutive columns, so any C of them update distinct
//     slots: for C < 32 they take turns in 32 / C rounds. The tile's end is
//     one pass per lane over the D C keys keeping its top n_easy+1 in
//     registers, then n_easy+1 rounds of shuffle-max and pop (the tile's
//     top n_easy+1 lies in the union of the per-lane top n_easy+1, so the
//     merge is exact).
// No (Q, N) score matrix is ever written: the output is (n_easy+1) ints
// per (query, tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQB = 16;               // queries per block
constexpr int kQPW = kQB / kWarps;    // queries per warp
constexpr int kRows = 32;             // corpus rows per shared-memory chunk
constexpr int kColMask = (1 << 11) - 1;
constexpr int kIntMin = INT32_MIN;
constexpr int kMaxNE1 = 8;            // n_easy + 1 <= 8
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may ask

__device__ __forceinline__ int score_to_ikey(float s) {
  const int i = __float_as_int(s);
  return i < 0 ? (i ^ 0x7FFFFFFF) : i;
}

__device__ __forceinline__ __nv_bfloat162 load_pair(
    const __nv_bfloat16* __restrict__ row, int k, int d, bool even_d) {
  if (even_d) {
    return *reinterpret_cast<const __nv_bfloat162*>(row + k);
  }
  __nv_bfloat162 v;
  v.x = row[k];
  v.y = (k + 1 < d) ? row[k + 1] : __float2bfloat16_rn(0.f);
  return v;
}

// int8 rows: two values widened to bf16 (exact) as they are staged.
__device__ __forceinline__ __nv_bfloat162 load_pair(
    const int8_t* __restrict__ row, int k, int d, bool even_d) {
  float x, y;
  if (even_d) {
    const char2 v = *reinterpret_cast<const char2*>(row + k);
    x = (float)v.x;
    y = (float)v.y;
  } else {
    x = (float)row[k];
    y = (k + 1 < d) ? (float)row[k + 1] : 0.f;
  }
  return __floats2bfloat162_rn(x, y);
}

// (d, n) layout: values k and k + 1 of row `row`, n apart.
__device__ __forceinline__ __nv_bfloat162 load_pair_t(
    const __nv_bfloat16* __restrict__ c, size_t row, int k, int n, int d) {
  __nv_bfloat162 v;
  v.x = c[(size_t)k * n + row];
  v.y = (k + 1 < d) ? c[(size_t)(k + 1) * n + row] : __float2bfloat16_rn(0.f);
  return v;
}

__device__ __forceinline__ __nv_bfloat162 load_pair_t(
    const int8_t* __restrict__ c, size_t row, int k, int n, int d) {
  const float x = (float)c[(size_t)k * n + row];
  const float y = (k + 1 < d) ? (float)c[(size_t)(k + 1) * n + row] : 0.f;
  return __floats2bfloat162_rn(x, y);
}

// K values [k0, k0 + kn) (k0 and kn even, k0 + kn <= d rounded up to even)
// of rows row0 .. row0 + live - 1 (live <= 32) of c, as bf16 pairs, into cs
// (kRows x cstride pairs, zero padded). c is (n, d) or, TRANS, (d, n): then
// consecutive threads take consecutive rows at one k.
template <bool TRANS, typename CT>
__device__ __forceinline__ void stage_pairs(const CT* __restrict__ c,
                                            __nv_bfloat162* cs, int cstride,
                                            int row0, int live, int n, int d,
                                            int k0, int kn) {
  const int pairs = kn / 2;
  const bool even_d = (d & 1) == 0;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  for (int i = threadIdx.x; i < kRows * pairs; i += kThreads) {
    const int r = TRANS ? i % kRows : i / pairs;
    const int p = TRANS ? i / kRows : i - r * pairs;
    const int k = k0 + 2 * p;
    __nv_bfloat162 h = zero2;
    if (r < live) {
      h = TRANS ? load_pair_t(c, (size_t)(row0 + r), k, n, d)
                : load_pair(c + (size_t)(row0 + r) * d, k, d, even_d);
    }
    cs[r * cstride + p] = h;
  }
}

// K values [k0, k0 + kn) of the block's kQB queries, bf16-rounded, into qs
// (kQB x kn f32, zero past d).
__device__ __forceinline__ void stage_queries(const float* __restrict__ q,
                                              float* qs, int q0, int n_q,
                                              int d, int k0, int kn) {
  for (int i = threadIdx.x; i < kQB * kn; i += kThreads) {
    const int r = i / kn;
    const int k = k0 + i - r * kn;
    const float v = (q0 + r < n_q && k < d) ? q[(size_t)(q0 + r) * d + k] : 0.f;
    qs[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
}

// Grouped / lane-sliced extraction: slot s = col mod C (C = tile_n / group)
// keeps its best `levels` = min(depth, group) keys in shared memory, level
// e of the warp's query at slots[e * C + s]; then n_easy ranks and the
// bound come from those levels * C keys. depth > group leaves no hidden
// key, so there the deepest level is empty (INT_MIN), as in the TPU kernel.
// kw (even) K values a window: the whole (even) width when the queries
// and a chunk of it fit beside the slots (queries staged once), else each
// chunk walks its windows in k order, the queries' window staged beside
// the rows' (grouped_window).
template <typename CT, bool SCALED, bool TRANS>
__global__ void __launch_bounds__(kThreads)
extract_grouped_kernel(const float* __restrict__ q, const CT* __restrict__ c,
                       const float* __restrict__ cn, int32_t* __restrict__ out,
                       int n_q, int n, int d, int tile_n, int n_tiles,
                       int n_easy, int group, int depth, int kw) {
  extern __shared__ float smem[];
  const int dp = (d + 1) & ~1;
  const int cstride = kw / 2 + 1;
  const int C = tile_n / group;
  const int levels = min(depth, group);
  const int width = levels * C;
  float* qs = smem;
  __nv_bfloat162* cs = reinterpret_cast<__nv_bfloat162*>(smem + kQB * kw);
  int* slots = reinterpret_cast<int*>(cs + kRows * cstride);  // kQB x width

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQB;
  const int tile = blockIdx.y;
  const int col0 = tile * tile_n;
  const int tile_cols = min(tile_n, n - col0);

  if (kw == dp) stage_queries(q, qs, q0, n_q, d, 0, dp);
  for (int i = threadIdx.x; i < kQB * width; i += kThreads) slots[i] = kIntMin;

  for (int r0 = 0; r0 < tile_cols; r0 += kRows) {
    const int live = min(kRows, tile_cols - r0);
    float acc[kQPW];
#pragma unroll
    for (int j = 0; j < kQPW; ++j) acc[j] = 0.f;
    // one f32 chain a (query, row), k ascending across the windows
    for (int k0 = 0; k0 < dp; k0 += kw) {
      const int kn = min(kw, dp - k0);
      const int qstride = kw < dp ? kn : dp;
      __syncthreads();  // the last window or chunk consumed (slots staged)
      if (kw < dp) stage_queries(q, qs, q0, n_q, d, k0, kn);
      stage_pairs<TRANS>(c, cs, cstride, col0 + r0, live, n, d, k0, kn);
      __syncthreads();
      const __nv_bfloat162* crow = cs + lane * cstride;
      for (int p = 0; p < kn / 2; ++p) {
        const float2 ch = __bfloat1622float2(crow[p]);
#pragma unroll
        for (int j = 0; j < kQPW; ++j) {
          const int qr = (warp * kQPW + j) * qstride + 2 * p;
          const float2 qh = *reinterpret_cast<const float2*>(qs + qr);
          acc[j] = fmaf(qh.x, ch.x, acc[j]);
          acc[j] = fmaf(qh.y, ch.y, acc[j]);
        }
      }
    }

    const int col = r0 + lane;
    const bool valid = col < tile_cols;
    const float cnorm = (cn != nullptr && valid) ? cn[col0 + col] : 0.f;
    const int s = col % C;
    // any C consecutive columns fall in distinct slots: lanes take turns
    for (int base = 0; base < kRows; base += C) {
      if (lane >= base && lane < base + C && valid) {
#pragma unroll
        for (int j = 0; j < kQPW; ++j) {
          float sc = acc[j];
          if (SCALED) {
            sc = __fmul_rn(sc, cnorm);
          } else if (cn != nullptr) {
            sc = __fsub_rn(__fmul_rn(2.f, sc), cnorm);
          }
          int* l = slots + (warp * kQPW + j) * width + s;
          int x = (score_to_ikey(sc) & ~kColMask) | (tile_n - 1 - col);
          for (int e = 0; e < levels; ++e) {  // bubble insert
            const int cur = l[e * C];
            l[e * C] = max(cur, x);
            x = min(cur, x);
          }
        }
      }
      __syncwarp();
    }
  }

  const int deep_first = (levels - 1) * C;
#pragma unroll
  for (int j = 0; j < kQPW; ++j) {
    const int qi = q0 + warp * kQPW + j;
    const int* l = slots + (warp * kQPW + j) * width;
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      deep = max(deep, __shfl_xor_sync(0xffffffffu, deep, off));
    }
    if (depth > group) deep = kIntMin;
    // n_easy + 1 rounds of shuffle-max; the (unique) owner pops; the last
    // round's key, max'ed with the deepest level, is the bound
    int32_t* dst = out + ((size_t)qi * n_tiles + tile) * (n_easy + 1);
    for (int e = 0; e <= n_easy; ++e) {
      int m = top[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (top[0] == m) {
#pragma unroll
        for (int t = 0; t + 1 < kMaxNE1; ++t) top[t] = top[t + 1];
        top[kMaxNE1 - 1] = kIntMin;
      }
      if (e == n_easy) m = max(m, deep);
      if (lane == 0 && qi < n_q) dst[e] = m;
    }
  }
}

// The key table of a grouped block: kQB queries x min(depth, group) levels
// x tile_n / group slots.
size_t slot_bytes(int tile_n, int group, int depth) {
  const int levels = depth < group ? depth : group;
  return (size_t)kQB * levels * (tile_n / group) * sizeof(int);
}

// A grouped block's staging of kw K values: the queries' window (kQB x kw
// f32) and a 32-row chunk of it as bf16 pairs (odd pair stride kw / 2 + 1).
size_t staging_bytes(int kw) {
  return (size_t)kQB * kw * sizeof(float) +
         (size_t)kRows * (kw / 2 + 1) * sizeof(__nv_bfloat162);
}

// The even K values of a grouped block's window beside its key table: the
// whole (even) width when it fits, else the most that fit, spread evenly
// over the windows; 0 when the key table alone leaves no room for a pair.
int grouped_window(int d, int tile_n, int group, int depth) {
  // staging_bytes(kw) = 128 kw + 128 bytes for an even kw
  const long long room = (long long)kMaxSmem -
                         (long long)slot_bytes(tile_n, group, depth) -
                         (long long)staging_bytes(0);
  const long long fit = room < 256 ? 0 : (room / 128) & ~1LL;
  const int dp = (d + 1) & ~1;
  if (fit < 2) return 0;
  if (dp <= fit) return dp;
  const int windows = (int)((dp + fit - 1) / fit);
  return ((dp + windows - 1) / windows + 1) & ~1;
}

size_t grouped_smem(int kw, int tile_n, int group, int depth) {
  return staging_bytes(kw) + slot_bytes(tile_n, group, depth);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int n_q, int n, int d, int tile_n, int n_easy) {
  return n_q <= 0 || n <= 0 || d <= 0 || tile_n <= 0 || tile_n > 2048 ||
         tile_n % kRows != 0 || n_easy < 1 || n_easy > 7 ||
         (n + tile_n - 1) / tile_n > 65535;
}

template <typename CT, bool SCALED, bool TRANS>
int launch_grouped(const void* q, const void* c, const void* cn, void* out,
                   int n_q, int n, int d, int tile_n, int n_easy, int group,
                   int depth, int kw, void* stream) {
  const size_t smem = grouped_smem(kw, tile_n, group, depth);
  auto kernel = extract_grouped_kernel<CT, SCALED, TRANS>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + tile_n - 1) / tile_n;
  const dim3 grid((n_q + kQB - 1) / kQB, n_tiles);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const CT*>(c),
      static_cast<const float*>(cn), static_cast<int32_t*>(out), n_q, n, d,
      tile_n, n_tiles, n_easy, group, depth, kw);
  return (int)cudaGetLastError();
}

template <typename CT, bool SCALED>
int launch_grouped_layout(const void* q, const void* c, const void* cn,
                          void* out, int n_q, int n, int d, int tile_n,
                          int n_easy, int group, int depth, int kw, int trans,
                          void* stream) {
  return trans ? launch_grouped<CT, SCALED, true>(q, c, cn, out, n_q, n, d,
                                                  tile_n, n_easy, group,
                                                  depth, kw, stream)
               : launch_grouped<CT, SCALED, false>(q, c, cn, out, n_q, n, d,
                                                   tile_n, n_easy, group,
                                                   depth, kw, stream);
}

}  // namespace

// The grouped kernel's staging for rows of width d, into geo[2]: the K
// values of a window (d rounded up to even when the queries are staged
// whole) and the shared memory bytes of a block. Returns
// cudaErrorInvalidValue when the key table alone leaves no room for a
// window, or on a bad shape.
extern "C" int prt_grouped_geometry(int d, int tile_n, int group, int depth,
                                    int* geo) {
  if (geo == nullptr || d <= 0 || tile_n <= 0 || group < 1 ||
      tile_n % group != 0 || depth < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int kw = grouped_window(d, tile_n, group, depth);
  if (kw == 0) return (int)cudaErrorInvalidValue;
  geo[0] = kw;
  geo[1] = (int)grouped_smem(kw, tile_n, group, depth);
  return 0;
}

// The grouped / lane-sliced kernel. c: bf16 rows with cn ||c||^2 (l2) or
// NULL (dot), or, with scaled, int8 rows with cn their per-row scales; (n, d)
// or, with trans, (d, n). group divides tile_n; depth >= 1; any d (the
// queries and rows staged a window of K values at a time past what fits
// beside the key table). out as above.
extern "C" int prt_extract_candidates_grouped(const void* q, const void* c,
                                              const void* cn, void* out,
                                              int n_q, int n, int d,
                                              int tile_n, int n_easy,
                                              int group, int depth,
                                              int scaled, int trans,
                                              void* stream) {
  if (bad_shape(n_q, n, d, tile_n, n_easy) || group < 1 ||
      tile_n % group != 0 || depth < 1 || (scaled && cn == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int kw = grouped_window(d, tile_n, group, depth);
  if (kw == 0) return (int)cudaErrorInvalidValue;  // the key table alone
  if (scaled) {
    return launch_grouped_layout<int8_t, true>(q, c, cn, out, n_q, n, d,
                                               tile_n, n_easy, group, depth,
                                               kw, trans, stream);
  }
  return launch_grouped_layout<__nv_bfloat16, false>(
      q, c, cn, out, n_q, n, d, tile_n, n_easy, group, depth, kw, trans,
      stream);
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
