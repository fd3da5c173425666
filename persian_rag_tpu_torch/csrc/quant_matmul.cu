// Weight-streaming quantized matmuls for quantized decode serving.
//
// Replaces the TPU Pallas kernels
//   persian_rag_tpu/ops/quant_matmul.py::_w8a16_kernel     (prt_w8a16)
//   persian_rag_tpu/ops/quant_matmul.py::_w8a16_nt_kernel  (prt_w8a16_nt)
//   persian_rag_tpu/ops/quant_matmul.py::_w8a16_2d_kernel  (prt_w8a16_splitk)
//   persian_rag_tpu/ops/quant_matmul.py::_w4a16_kernel     (prt_w4a16)
//   persian_rag_tpu/ops/quant_matmul.py::_w8a8_kernel      (prt_w8a8)
//   scripts/bench_matvec_probe.py, w8a16_2d_call's kernel (prt_w8a16_tile2d)
// reached through w8a16_matmul / w8a16_matmul_nt / w4a16_matmul /
// w8a8_matmul, and the last through w8a16_2d (the matvec probe's tile arms).
// The port holds them to what they COMPUTE:
//
//   out[b, n] = (sum_k x[b, k] * w[k, n]) * scale[n]      (w stored (K, N))
//   out[b, n] = (sum_k x[b, k] * w[n, k]) * scale[n]      (nt: w stored (N, K))
//   out[b, n] = (sum_{i<K/2} x[b, i] lo(p[i, n]) + x[b, K/2 + i] hi(p[i, n]))
//               * scale[n]                               (int4: p (K/2, N))
//   out[b, n] = f32(sum_k xq[b, k] * w[k, n], in int32) * scale[n]   (w8a8)
//
// with x bf16 (int8 for w8a8), w int8 or int4 nibbles, the sum and the result
// in f32, 1 <= b <= 256 rows. An int8 or int4 value is exact in f32 and a
// bf16 x int8 product has at most 16 significand bits, so every product is
// exact in f32: the only rounding is in the f32 sum, and the only difference
// from the plain PyTorch version is the order of that sum. The w8a8 sum is
// exact in int32 (|acc| <= 127^2 K), so prt_w8a8 equals its plain version bit
// for bit.
//
// A row's result does not depend on the batch it sits in: every accumulator
// walks K in an order fixed by (K, N) alone (per thread k ascending, then a
// butterfly over the lanes, then the warps or the K chunks in index order), and
// rows never mix. So a one-token step, a row of a batched step and a row of a
// speculative verify block give the same bits for the same activations. No
// floating-point atomics anywhere: the split-K partials are summed in chunk
// order by a second kernel (prt_w8a16_splitk) or by the tile grid's last block
// (prt_w8a16_tile2d).
//
// What bounds them on the H100: bytes. A decode step reads each weight once
// (K N bytes, K N / 2 for int4) against 2 B K N operations, 2 B (int4: 4 B)
// operations per byte with B <= 8 on the served path, far below the CUDA
// cores' ridge. The design is therefore about keeping 16-byte weight loads in
// flight:
//   * (K, N) weights (prt_w8a16, prt_w8a16_splitk, prt_w4a16, prt_w8a8): a
//     block owns a strip of 64 columns; its 256 threads are 4 across the strip
//     (16 columns = one 16-byte load each) by 64 down K, so one warp reads 8
//     rows of 64 contiguous bytes. Up to 8 activation rows wait in shared
//     memory (2,048 bf16 K values, or 1,024 of each K half for int4, or 4,096
//     int8 values for w8a8, at a time); a thread keeps rows x 16 accumulators
//     in registers. prt_w8a16 walks all of K in one block (N / 64 blocks);
//     prt_w8a16_splitk gives each block one K chunk (N / 64 x K / chunk
//     blocks, which is what fills the card for the K = 8192 down projection)
//     and writes an f32 partial per chunk, which splitk_reduce_kernel sums in
//     chunk order and scales.
//   * int4 (prt_w4a16): one 16-byte load of a packed row gives 32 weights,
//     the low nibbles (row i) and the high ones (row i + K/2) of 16 columns,
//     so a thread reads x[b, i] and x[b, K/2 + i] for each packed row and
//     streams half the bytes of int8. Nibbles become f32 exactly through the
//     same mantissa trick as int8 below. The JAX routing sends the K = 8192
//     down projection here too (N / 64 = 32 blocks of 4,096 packed rows).
//   * w8a8 (prt_w8a8): a thread takes 4 K rows at a time, transposes the 4 x
//     16 bytes with byte permutes into one word of 4 K values per column, and
//     __dp4a adds their products to int32 accumulators.
//   * (N, K) weights (prt_w8a16_nt, the tied lm_head over the embedding's own
//     table): a block owns 64 output rows, a warp walks two of them at a time,
//     lanes stride K with 16-byte loads, a butterfly reduces the lanes.
//   * More than 8 activation rows: the block passes over its own weights once
//     per group of 8 rows; the repeats hit the L2 cache (a block's share is
//     128 KB at K = 2048).
//   * (K, N) weights on a caller's (block_n, block_k) tile grid
//     (prt_w8a16_tile2d, the probe's schedule): block (i, j) owns a block_n x
//     block_k tile; its threads are block_n / 16 across (one 16-byte load
//     each) by the rest down the tile. Its f32 partial P_j goes to scratch;
//     the block that draws the column block's last ticket (a per-column-block
//     counter taken with atomicAdd after __threadfence, the CUDA sample
//     threadFenceReduction) sums P_0 .. P_{K/block_k - 1} in j order, scales
//     and resets the counter to 0, all in one launch. The order of every sum
//     is fixed by (K, N, block_n, block_k), never by the order the blocks
//     arrive in.
// The int8 / int4 -> f32 widening uses byte permutes into the mantissa of 2^23
// (full rate) instead of integer-to-float conversions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 2048;             // K values of x staged in shared memory
constexpr int kTN = 64;               // columns per block, (K, N) weights
constexpr int kTX = kTN / 16;         // threads across a strip
constexpr int kKY = kThreads / kTX;   // K slices of a block
constexpr int kNB = 64;               // output rows per block, (N, K) weights
constexpr int kNP = 2;                // output rows a warp walks together
constexpr int kPairs = kNB / kWarps / kNP;
constexpr int kKH = kKC / 2;          // packed int4 rows staged per pass
constexpr int kKC8 = 4096;            // K values of int8 x staged (w8a8)

// four biased bytes of a word -> four f32, exactly: the word 0x4B0000uu is
// the float 2^23 + u for each byte u, and `bias` is 2^23 plus the byte bias.
__device__ __forceinline__ void biased_to_f32x4(uint32_t u, float bias,
                                                float* f) {
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias;
}

// four int8 of a word -> four f32: (byte ^ 0x80) is byte + 128 unsigned
__device__ __forceinline__ void unpack_s8x4(uint32_t word, float* f) {
  biased_to_f32x4(word ^ 0x80808080u, 8388736.f, f);
}

__device__ __forceinline__ void unpack_s8x16(const int4& v, float* f) {
  unpack_s8x4((uint32_t)v.x, f);
  unpack_s8x4((uint32_t)v.y, f + 4);
  unpack_s8x4((uint32_t)v.z, f + 8);
  unpack_s8x4((uint32_t)v.w, f + 12);
}

// four packed bytes of a word -> the four low nibbles and the four high
// nibbles as f32: (nibble ^ 8) is the signed int4 value + 8 unsigned
__device__ __forceinline__ void unpack_s4x8(uint32_t word, float* lo,
                                            float* hi) {
  biased_to_f32x4((word & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f, lo);
  biased_to_f32x4(((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f, hi);
}

__device__ __forceinline__ void unpack_s4x32(const uint4& v, float* lo,
                                             float* hi) {
  unpack_s4x8(v.x, lo, hi);
  unpack_s4x8(v.y, lo + 4, hi + 4);
  unpack_s4x8(v.z, lo + 8, hi + 8);
  unpack_s4x8(v.w, lo + 12, hi + 12);
}

// two bf16 of a word (element 0 in the low half) -> two f32
__device__ __forceinline__ void unpack_bf16x2(uint32_t word, float* f) {
  f[0] = __uint_as_float(word << 16);
  f[1] = __uint_as_float(word & 0xFFFF0000u);
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& v, float* f) {
  unpack_bf16x2(v.x, f);
  unpack_bf16x2(v.y, f + 2);
  unpack_bf16x2(v.z, f + 4);
  unpack_bf16x2(v.w, f + 6);
}

// Rows r0 .. r0 + R of x, K values kc0 .. kc0 + kn, into xs (R, kKC) as bf16;
// rows past b are zeros. kn is a multiple of 8.
template <int R>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        __nv_bfloat16* xs, int b, int k, int r0,
                                        int kc0, int kn) {
  const int vecs = kn / 8;
  for (int v = threadIdx.x; v < R * vecs; v += kThreads) {
    const int r = v / vecs, c = v - r * vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < b)
      val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * k + kc0 + c * 8);
    *reinterpret_cast<uint4*>(xs + r * kKC + c * 8) = val;
  }
}

// The end of a strip pass: each thread's R x 16 accumulators of the block's
// 64 columns are summed over the K slices (the 8 of a warp by a butterfly,
// then the warps in index order) and rows r0 .. r0 + R of out (b, n) get the
// sum (times scale[n] when SCALE) at columns n0 .. n0 + 64. smem is shared
// scratch of at least kWarps * R * kTN accumulators; every read of it before
// the call must be over (the first __syncthreads below orders them).
template <int R, bool SCALE, typename T>
__device__ __forceinline__ void strip_store(T (&acc)[R][16], void* smem,
                                            const float* __restrict__ scale,
                                            float* __restrict__ out, int b,
                                            int n, int r0, int n0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the 8 K slices of a warp (lanes that differ in bits 2..4), then the warps
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      T v = acc[r][c];
      v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
      v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
      v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
      acc[r][c] = v;
    }
  __syncthreads();                          // the staged x is read no more
  T* red = reinterpret_cast<T*>(smem);      // (kWarps, R, kTN)
  if (lane < kTX) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        red[(warp * R + r) * kTN + lane * 16 + c] = acc[r][c];
  }
  __syncthreads();
  for (int o = tid; o < R * kTN; o += kThreads) {
    const int r = o / kTN, c = o - r * kTN;
    if (r0 + r < b) {
      T s = red[r * kTN + c];
      for (int wi = 1; wi < kWarps; ++wi) s += red[(wi * R + r) * kTN + c];
      const float v = static_cast<float>(s);
      out[(size_t)(r0 + r) * n + n0 + c] = SCALE ? v * scale[n0 + c] : v;
    }
  }
}

// (K, N) weights. Block (strip, chunk) sums K values [chunk * k_chunk,
// (chunk + 1) * k_chunk) of its 64 columns for every row. SCALE: the chunk is
// all of K and out (b, n) gets sum * scale; else out is the (chunks, b, n)
// partial buffer. U weight loads per thread are in flight before their use.
template <int R, int U, bool SCALE>
__global__ void __launch_bounds__(kThreads)
w8a16_strip_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w, const float* __restrict__ scale,
                   float* __restrict__ out, int b, int k, int n, int k_chunk) {
  __shared__ __align__(16) __nv_bfloat16 xs[R * kKC];
  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1), ky = tid / kTX;
  const int n0 = blockIdx.x * kTN;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const int8_t* wcol = w + n0 + tx * 16;

  for (int r0 = 0; r0 < b; r0 += R) {
    float acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

    for (int kc0 = k_begin; kc0 < k_end; kc0 += kKC) {
      const int kn = min(kKC, k_end - kc0);
      __syncthreads();
      stage_x<R>(x, xs, b, k, r0, kc0, kn);
      __syncthreads();
      for (int kk = ky; kk < kn; kk += kKY * U) {
        int4 wv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kKY;
          wv[u] = make_int4(0, 0, 0, 0);
          if (kr < kn)
            wv[u] = __ldg(reinterpret_cast<const int4*>(
                wcol + (size_t)(kc0 + kr) * n));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kKY;
          if (kr < kn) {
            float wf[16];
            unpack_s8x16(wv[u], wf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xv = __bfloat162float(xs[r * kKC + kr]);
#pragma unroll
              for (int c = 0; c < 16; ++c)
                acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
            }
          }
        }
      }
    }

    // SCALE: out (b, n); else the chunk's (b, n) slice of the partials
    strip_store<R, SCALE>(acc, xs, scale,
                          SCALE ? out : out + (size_t)blockIdx.y * b * n, b, n,
                          r0, n0);
  }
}

// int4 (K/2, N) packed weights: out (b, n) = sum over packed rows i of
// x[b, i] lo(p[i, n]) + x[b, K/2 + i] hi(p[i, n]), times scale[n]. Row r of
// xs holds the K values kc0 .. kc0 + kn of the low half, then those of the
// high half.
template <int R, int U>
__global__ void __launch_bounds__(kThreads)
w4a16_strip_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ w, const float* __restrict__ scale,
                   float* __restrict__ out, int b, int k, int n) {
  __shared__ __align__(16) __nv_bfloat16 xs[R * kKC];
  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1), ky = tid / kTX;
  const int n0 = blockIdx.x * kTN;
  const int kh = k / 2;
  const uint8_t* wcol = w + n0 + tx * 16;

  for (int r0 = 0; r0 < b; r0 += R) {
    float acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

    for (int kc0 = 0; kc0 < kh; kc0 += kKH) {
      const int kn = min(kKH, kh - kc0);
      __syncthreads();
      stage_x<R>(x, xs, b, k, r0, kc0, kn);
      stage_x<R>(x, xs + kKH, b, k, r0, kh + kc0, kn);
      __syncthreads();
      for (int kk = ky; kk < kn; kk += kKY * U) {
        uint4 wv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kKY;
          wv[u] = make_uint4(0u, 0u, 0u, 0u);
          if (kr < kn)
            wv[u] = __ldg(reinterpret_cast<const uint4*>(
                wcol + (size_t)(kc0 + kr) * n));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kKY;
          if (kr < kn) {
            float lo[16], hi[16];
            unpack_s4x32(wv[u], lo, hi);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xl = __bfloat162float(xs[r * kKC + kr]);
              const float xh = __bfloat162float(xs[r * kKC + kKH + kr]);
#pragma unroll
              for (int c = 0; c < 16; ++c) {
                acc[r][c] = fmaf(xl, lo[c], acc[r][c]);
                acc[r][c] = fmaf(xh, hi[c], acc[r][c]);
              }
            }
          }
        }
      }
    }
    strip_store<R, true>(acc, xs, scale, out, b, n, r0, n0);
  }
}

// the 4 x 4 bytes of words a, b, c, d (K rows k .. k + 3, 4 columns) -> one
// word per column holding its 4 K values, row k in the low byte
__device__ __forceinline__ void transpose_s8x4x4(uint32_t a, uint32_t b,
                                                 uint32_t c, uint32_t d,
                                                 uint32_t* col) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(c, d, 0x5140);
  const uint32_t t2 = __byte_perm(a, b, 0x7362), t3 = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// w8a8: out (b, n) = f32(sum_k xq[b, k] w[k, n], in int32) * scale[n]. Each
// thread takes K rows 4 at a time; xs holds 4,096 K values of each row.
template <int R, int U>
__global__ void __launch_bounds__(kThreads)
w8a8_strip_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int b, int k, int n) {
  __shared__ __align__(16) int8_t xs[R * kKC8];
  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1), ky = tid / kTX;
  const int n0 = blockIdx.x * kTN;
  const int8_t* wcol = w + n0 + tx * 16;

  for (int r0 = 0; r0 < b; r0 += R) {
    int acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0;

    for (int kc0 = 0; kc0 < k; kc0 += kKC8) {
      const int kn = min(kKC8, k - kc0);
      const int vecs = kn / 16;
      __syncthreads();
      for (int v = tid; v < R * vecs; v += kThreads) {
        const int r = v / vecs, c = v - r * vecs;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < b)
          val = *reinterpret_cast<const uint4*>(
              xq + (size_t)(r0 + r) * k + kc0 + c * 16);
        *reinterpret_cast<uint4*>(xs + r * kKC8 + c * 16) = val;
      }
      __syncthreads();
      for (int kk = ky * 4; kk < kn; kk += kKY * 4 * U) {
        uint4 wv[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kKY * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wv[u][j] = make_uint4(0u, 0u, 0u, 0u);
            if (kr < kn)
              wv[u][j] = __ldg(reinterpret_cast<const uint4*>(
                  wcol + (size_t)(kc0 + kr + j) * n));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kKY * 4;
          if (kr < kn) {
            uint32_t col[16];
            transpose_s8x4x4(wv[u][0].x, wv[u][1].x, wv[u][2].x, wv[u][3].x,
                             col);
            transpose_s8x4x4(wv[u][0].y, wv[u][1].y, wv[u][2].y, wv[u][3].y,
                             col + 4);
            transpose_s8x4x4(wv[u][0].z, wv[u][1].z, wv[u][2].z, wv[u][3].z,
                             col + 8);
            transpose_s8x4x4(wv[u][0].w, wv[u][1].w, wv[u][2].w, wv[u][3].w,
                             col + 12);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int xw = *reinterpret_cast<const int*>(xs + r * kKC8 + kr);
#pragma unroll
              for (int c = 0; c < 16; ++c)
                acc[r][c] = __dp4a(xw, static_cast<int>(col[c]), acc[r][c]);
            }
          }
        }
      }
    }
    strip_store<R, true>(acc, xs, scale, out, b, n, r0, n0);
  }
}

// out (b, n) = (sum over chunks, in chunk order, of part (chunks, b, n)) * scale
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int b, int n,
                                     int chunks) {
  const size_t total = (size_t)b * n;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int c = 1; c < chunks; ++c) s += part[(size_t)c * total + i];
  out[i] = s * scale[i % n];
}

// (K, N) weights on a (n / bn, k / bk) grid. Block (i, j) sums K rows
// [j bk, (j + 1) bk) of columns [i bn, (i + 1) bn) for every row into
// part (k / bk, b, n); the last block of column block i to finish sums the
// partials in j order into out (b, n), times scale, and resets tickets[i].
// Thread (tx, ky): columns tx * 16 .. + 16, K rows ky, ky + KY, ... of the
// tile with KY = kThreads / (bn / 16); threads past KY slices idle.
template <int R, int U>
__global__ void __launch_bounds__(kThreads)
w8a16_tile2d_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ part,
                    unsigned int* __restrict__ tickets,
                    float* __restrict__ out, int b, int k, int n, int bn,
                    int bk) {
  // R rows of staged x, or one row's K-slice partials (kThreads x 16
  // floats) in the same bytes
  constexpr int kXBytes = R * kKC * 2, kRedBytes = kThreads * 16 * 4;
  __shared__ __align__(16)
      unsigned char smem[kXBytes > kRedBytes ? kXBytes : kRedBytes];
  __shared__ float grp[kThreads];  // the groups' sums of one row
  __shared__ bool last;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // (KY, bn), aliases xs
  const int tid = threadIdx.x;
  const int tx_n = bn / 16, ky_n = kThreads / tx_n;
  const int tx = tid % tx_n, ky = tid / tx_n;
  const bool active = ky < ky_n;
  // bn < kThreads: each column's slices in kThreads / bn groups
  const int groups = bn < kThreads ? kThreads / bn : 1;
  const int per_group = (ky_n + groups - 1) / groups;
  const int n0 = blockIdx.x * bn, k0 = blockIdx.y * bk;
  const size_t plane = (size_t)b * n;
  float* pj = part + (size_t)blockIdx.y * plane;
  const int8_t* wcol = w + n0 + tx * 16;

  for (int r0 = 0; r0 < b; r0 += R) {
    float acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

    for (int kc0 = k0; kc0 < k0 + bk; kc0 += kKC) {
      const int kn = min(kKC, k0 + bk - kc0);
      __syncthreads();
      stage_x<R>(x, xs, b, k, r0, kc0, kn);
      __syncthreads();
      if (!active) continue;
      for (int kk = ky; kk < kn; kk += ky_n * U) {
        int4 wv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * ky_n;
          wv[u] = make_int4(0, 0, 0, 0);
          if (kr < kn)
            wv[u] = __ldg(reinterpret_cast<const int4*>(
                wcol + (size_t)(kc0 + kr) * n));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * ky_n;
          if (kr < kn) {
            float wf[16];
            unpack_s8x16(wv[u], wf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xv = __bfloat162float(xs[r * kKC + kr]);
#pragma unroll
              for (int c = 0; c < 16; ++c)
                acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
            }
          }
        }
      }
    }

    // the K slices of each row summed into P_j in slice order: in groups of
    // per_group slices by groups x bn threads, then the groups by bn
#pragma unroll
    for (int r = 0; r < R; ++r) {
      __syncthreads();  // the staged x, or the previous row's slices, is read
      if (active) {
        float4* dst = reinterpret_cast<float4*>(red + ky * bn + tx * 16);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dst[c] = make_float4(acc[r][4 * c], acc[r][4 * c + 1],
                               acc[r][4 * c + 2], acc[r][4 * c + 3]);
      }
      __syncthreads();
      for (int o = tid; o < groups * bn; o += kThreads) {
        const int q = o / bn, c = o - q * bn;
        const int y0 = q * per_group, y1 = min(ky_n, y0 + per_group);
        float s = red[y0 * bn + c];
        for (int y = y0 + 1; y < y1; ++y) s += red[y * bn + c];
        if (groups > 1)
          grp[o] = s;
        else if (r0 + r < b)
          pj[(size_t)(r0 + r) * n + n0 + c] = s;
      }
      if (groups > 1) {
        __syncthreads();
        if (tid < bn && r0 + r < b) {
          float s = grp[tid];
          for (int q = 1; q < groups; ++q) s += grp[q * bn + tid];
          pj[(size_t)(r0 + r) * n + n0 + tid] = s;
        }
      }
    }
  }

  // every thread's partials are visible device-wide before its block's ticket
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 4 columns a thread, each summed over j in order
  const int nk = gridDim.y, bn4 = bn / 4;
  for (int o = tid; o < b * bn4; o += kThreads) {
    const int row = o / bn4, c = 4 * (o - row * bn4);
    const size_t i = (size_t)row * n + n0 + c;
    float4 s = __ldcg(reinterpret_cast<const float4*>(part + i));
#pragma unroll 8
    for (int j = 1; j < nk; ++j) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(part + (size_t)j * plane + i));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + c);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
  }
  if (tid == 0) tickets[blockIdx.x] = 0u;  // ready for the next launch
}

// (N, K) weights: out (b, n) = (x . w[n, :]) * scale[n].
template <int R>
__global__ void __launch_bounds__(kThreads)
w8a16_nt_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out, int b,
                int k, int n) {
  __shared__ __align__(16) __nv_bfloat16 xs[R * kKC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_base = blockIdx.x * kNB + warp * (kNB / kWarps);

  for (int r0 = 0; r0 < b; r0 += R) {
    float acc[kPairs][kNP][R];
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int j = 0; j < kNP; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[p][j][r] = 0.f;

    for (int kc0 = 0; kc0 < k; kc0 += kKC) {
      const int kn = min(kKC, k - kc0);
      __syncthreads();
      stage_x<R>(x, xs, b, k, r0, kc0, kn);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int row = n_base + p * kNP;
        for (int kk = lane * 16; kk < kn; kk += 32 * 16) {
          float wf[kNP][16];
#pragma unroll
          for (int j = 0; j < kNP; ++j) {
            int4 wv = make_int4(0, 0, 0, 0);
            if (row + j < n)
              wv = __ldg(reinterpret_cast<const int4*>(
                  w + (size_t)(row + j) * k + kc0 + kk));
            unpack_s8x16(wv, wf[j]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float xf[16];
            unpack_bf16x8(
                *reinterpret_cast<const uint4*>(xs + r * kKC + kk), xf);
            unpack_bf16x8(
                *reinterpret_cast<const uint4*>(xs + r * kKC + kk + 8), xf + 8);
#pragma unroll
            for (int j = 0; j < kNP; ++j)
#pragma unroll
              for (int i = 0; i < 16; ++i)
                acc[p][j][r] = fmaf(xf[i], wf[j][i], acc[p][j][r]);
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int j = 0; j < kNP; ++j) {
        const int row = n_base + p * kNP + j;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v = acc[p][j][r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
          if (lane == 0 && row < n && r0 + r < b)
            out[(size_t)(r0 + r) * n + row] = v * scale[row];
        }
      }
  }
}

template <bool SCALE>
cudaError_t launch_strip(const __nv_bfloat16* x, const int8_t* w,
                         const float* scale, float* out, int b, int k, int n,
                         int k_chunk, cudaStream_t stream) {
  const dim3 grid(n / kTN, (k + k_chunk - 1) / k_chunk);
  if (b == 1)
    w8a16_strip_kernel<1, 4, SCALE><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, b, k, n, k_chunk);
  else if (b == 2)
    w8a16_strip_kernel<2, 4, SCALE><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, b, k, n, k_chunk);
  else if (b <= 4)
    w8a16_strip_kernel<4, 4, SCALE><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, b, k, n, k_chunk);
  else
    w8a16_strip_kernel<8, 2, SCALE><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, b, k, n, k_chunk);
  return cudaGetLastError();
}

bool bad_shape(int b, int k, int n, int n_multiple) {
  return b < 1 || k < 16 || k % 16 != 0 || n < n_multiple ||
         n % n_multiple != 0;
}

}  // namespace

// x (b, k) bf16, w (k, n) int8, scale (n) f32 -> out (b, n) f32.
// k % 16 == 0, n % 64 == 0; every pointer 16-byte aligned.
extern "C" int prt_w8a16(const void* x, const void* w, const void* scale,
                         void* out, int b, int k, int n, void* stream) {
  if (bad_shape(b, k, n, kTN)) return (int)cudaErrorInvalidValue;
  return (int)launch_strip<true>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), b, k, n, k,
      static_cast<cudaStream_t>(stream));
}

// As prt_w8a16 with K cut into chunks of k_chunk (a multiple of 16): part is
// scratch of ceil(k / k_chunk) * b * n floats.
extern "C" int prt_w8a16_splitk(const void* x, const void* w, const void* scale,
                                void* part, void* out, int b, int k, int n,
                                int k_chunk, void* stream) {
  if (bad_shape(b, k, n, kTN) || k_chunk < 16 || k_chunk % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (k + k_chunk - 1) / k_chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_strip<false>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(part), b, k, n,
      k_chunk, s);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)b * n;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<float*>(out), b, n, chunks);
  return (int)cudaGetLastError();
}

// As prt_w8a16 on a (n / block_n, k / block_k) grid of tiles, in one launch:
// 1 <= b <= 256; block_n a multiple of 64, at most 4,096, dividing n;
// block_k a multiple of 16 dividing k, k / block_k <= 65,535; part is
// scratch of (k / block_k) * b * n floats, tickets n / block_n counters that
// are 0 at entry (and are left 0); every pointer 16-byte aligned. tickets and
// part must not be shared with a launch that may run at the same time.
extern "C" int prt_w8a16_tile2d(const void* x, const void* w,
                                const void* scale, void* part, void* tickets,
                                void* out, int b, int k, int n, int block_n,
                                int block_k, void* stream) {
  const void* ptrs[] = {x, w, scale, part, tickets, out};
  for (const void* p : ptrs)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  if (b < 1 || b > 256 || block_n < kTN || block_n > 4096 ||
      block_n % kTN != 0 || n < block_n || n % block_n != 0 ||
      block_k < 16 || block_k % 16 != 0 || k < block_k || k % block_k != 0 ||
      k / block_k > 65535)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / block_n, k / block_k);
  if (b == 1)
    w8a16_tile2d_kernel<1, 4><<<grid, kThreads, 0, s>>>(
        xb, wb, sc, pt, tk, o, b, k, n, block_n, block_k);
  else if (b == 2)
    w8a16_tile2d_kernel<2, 4><<<grid, kThreads, 0, s>>>(
        xb, wb, sc, pt, tk, o, b, k, n, block_n, block_k);
  else if (b <= 4)
    w8a16_tile2d_kernel<4, 4><<<grid, kThreads, 0, s>>>(
        xb, wb, sc, pt, tk, o, b, k, n, block_n, block_k);
  else
    w8a16_tile2d_kernel<8, 2><<<grid, kThreads, 0, s>>>(
        xb, wb, sc, pt, tk, o, b, k, n, block_n, block_k);
  return (int)cudaGetLastError();
}

// x (b, k) bf16, w (n, k) int8, scale (n) f32 -> out (b, n) f32.
// k % 16 == 0; every pointer 16-byte aligned.
extern "C" int prt_w8a16_nt(const void* x, const void* w, const void* scale,
                            void* out, int b, int k, int n, void* stream) {
  if (bad_shape(b, k, n, 1)) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + kNB - 1) / kNB;
  if (b == 1)
    w8a16_nt_kernel<1><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else if (b == 2)
    w8a16_nt_kernel<2><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else if (b <= 4)
    w8a16_nt_kernel<4><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else
    w8a16_nt_kernel<8><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  return (int)cudaGetLastError();
}

// x (b, k) bf16, packed (k / 2, n) int8 (int4 pairs, K-half layout), scale
// (n) f32 -> out (b, n) f32. k % 32 == 0, n % 64 == 0; every pointer 16-byte
// aligned.
extern "C" int prt_w4a16(const void* x, const void* w, const void* scale,
                         void* out, int b, int k, int n, void* stream) {
  if (b < 1 || k < 32 || k % 32 != 0 || n < kTN || n % kTN != 0)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = n / kTN;
  if (b == 1)
    w4a16_strip_kernel<1, 4><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else if (b == 2)
    w4a16_strip_kernel<2, 4><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else if (b <= 4)
    w4a16_strip_kernel<4, 4><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else
    w4a16_strip_kernel<8, 2><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  return (int)cudaGetLastError();
}

// xq (b, k) int8, w (k, n) int8, scale (n) f32 -> out (b, n) f32, the int32
// sum times scale (the caller applies the activation scale). k % 16 == 0,
// n % 64 == 0; every pointer 16-byte aligned.
extern "C" int prt_w8a8(const void* xq, const void* w, const void* scale,
                        void* out, int b, int k, int n, void* stream) {
  if (bad_shape(b, k, n, kTN)) return (int)cudaErrorInvalidValue;
  const int8_t* xb = static_cast<const int8_t*>(xq);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = n / kTN;
  if (b == 1)
    w8a8_strip_kernel<1, 2><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else if (b == 2)
    w8a8_strip_kernel<2, 2><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else if (b <= 4)
    w8a8_strip_kernel<4, 2><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  else
    w8a8_strip_kernel<8, 1><<<grid, kThreads, 0, s>>>(xb, wb, sc, o, b, k, n);
  return (int)cudaGetLastError();
}
