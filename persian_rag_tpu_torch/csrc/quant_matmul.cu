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
// in f32, 1 <= b <= 256 rows, any K (#15: a multiple of 16). An int8 or int4 value is exact in f32 and a
// bf16 x int8 product has at most 16 significand bits, so every product is
// exact in f32: the only rounding is in the f32 sum, and the only difference
// from the plain PyTorch version is the order of that sum. The w8a8 sum is
// exact in int32 (|acc| <= 127^2 K < 2^31 for K <= 133,144), so prt_w8a8
// equals its plain version bit for bit.
//
// A row's result does not depend on the batch it sits in: every accumulator
// walks K in an order fixed by (K, N) alone (per thread k ascending, then a
// butterfly over the lanes, then the warps or the K chunks in index order;
// prt_w8a16_nt: the tensor cores' 16-value steps in K order; prt_w8a8:
// exact int32 sums, whose order cannot matter), and rows never mix. So a one-token step, a row of a batched step and a row of a
// speculative verify block give the same bits for the same activations. No
// floating-point atomics anywhere: the split-K partials are summed in chunk
// order by the last block of each strip (prt_w8a16, prt_w8a16_splitk,
// prt_w4a16, prt_w8a16_tile2d).
//
// What bounds them on the H100: bytes. A decode step reads each weight once
// (K N bytes, K N / 2 for int4) against 2 B K N operations, 2 B (int4: 4 B)
// operations per byte with B <= 8 on the served path, far below the ridge.
// The design is therefore about keeping 16-byte weight loads in flight, and
// about issuing few enough instructions per byte that the loads, not the
// issue slots, set the pace:
//   * (K, N) weights cut into K chunks (prt_w8a16, every int8 layer
//     projection but the down one; prt_w8a16_splitk, the K = 8192 down
//     projection; prt_w4a16, every int4 projection): one strip per block
//     walking all of K left most of the card idle (prt_w8a16 ran so on 128
//     blocks at gate / up, 32 at q / o and 8 at k / v, 24% of its byte bound
//     at gate / up; 32 blocks at the down projection, 8 at the int4 k / v
//     projections), and #17's earlier grid of
//     strips x 1,024-row chunks at 16 columns a thread kept 8 x 16
//     accumulators, so one block fitted an SM and 256 blocks ran as two
//     waves, followed by a second launch that summed the partials. So the
//     unit is a strip times a chunk of weight rows, the chunk count a
//     function of (K, N) alone (ops/quant_matmul.py w8a16_splitk_geometry,
//     w4a16_geometry: about 256 blocks), in one launch: each block writes
//     its chunk's partial and the last block of each strip (a per-strip
//     ticket, as prt_w8a16_tile2d's) sums them in chunk order and scales. A
//     thread takes 8 columns (one 8-byte load of a row) and every 32nd row
//     of its chunk, so at 8 rows it keeps 64 accumulators and two blocks
//     share an SM (__launch_bounds__(256, 2)): the 256 blocks run in one
//     wave. The first step's loads are issued before x is staged. At up
//     to 8 rows (one pass over the weights) each load asks the L2 for the
//     256 bytes around it (ld.global.nc.L2::256B): a warp's load covers 64
//     bytes of each of 4 rows, and whole 256-byte runs of a row reach
//     device memory together (2% at up to 8 rows); more rows read each chunk
//     again from the L2 on every pass, where the hint made 256 rows slower,
//     so they load without it. int8 and
//     int4 share the kernel body: an int4 packed row holds the low nibbles
//     (row i) and the high ones (row i + K/2) of its columns, so a thread
//     reads x[b, i] and x[b, K/2 + i] for each packed row and streams half
//     the bytes of int8. The weights stream through registers: a cp.async
//     ring stopped at ~1.1 TB/s (tile2d below).
//   * w8a8 (prt_w8a8, #16): bytes at up to 8 rows, like the others; at 256
//     rows the bound of the 2 B K N int8 operations (4.3 us at the H100's
//     int8 tensor-core peak) comes close to that of the K N bytes (5.0 us
//     at 3.35 TB/s). Its earlier kernel walked all of K in one block of a
//     64-column strip (128 blocks at gate / up, 32 on 132 SMs at down),
//     staged x behind a barrier before the first weight load, kept 16 KB an
//     SM in flight without overlap between rounds, and ran __dp4a on the
//     CUDA cores once per group of 8 rows (32 passes over the weights at 256
//     rows): 36% of its byte bound at 8 rows on an H100 80GB HBM3 at 700 W.
//     Now the unit is a strip times a chunk of K rows (w8a8_geometry: 256
//     units at both Llama shapes), and the products run on the int8 tensor
//     cores, mma.sync m16n8k32 s8 -> s32, as the TPU kernel's run on its
//     matrix unit: a lane loads 8 bytes of each of 8 K rows and transposes
//     them with byte permutes (the (K, N) layout is N-major, which neither
//     ldmatrix, b16 only, nor wgmma, K-major 8-bit operands only, reads),
//     which gives its A fragments under a fixed K permutation that x's B
//     fragment (one 8-byte load of a row) repeats. A block holds its span's
//     weights in registers, so the weights stream once at any row count:
//     up to 16 rows a block takes 2,048 K rows of its strip (128 blocks,
//     one an SM, at both Llama shapes, all its loads issued at once), more
//     take 1,024 and walk the rows 32 a pass. The spans' int32 sums combine
//     exactly in any order (red.global into a zeroed scratch, the last
//     block of a strip scales them): no floating-point atomics. Slower on
//     the H100 and dropped (scripts/quant_ab.py --variants, PERF.md §6):
//     one n8 tile at up to 8 rows (the two-tile instance streams faster,
//     its second tile's products skipped), two blocks an SM of 1,024 rows,
//     and the weights' loads without the L2 256-byte fetch hint.
//   * (N, K) weights (prt_w8a16_nt, the tied lm_head over the embedding's own
//     table, 128,256 x 2,048 at Llama-3.2-1B): on the CUDA cores a lane
//     issued ~15 instructions per weight byte at 8 rows (128 FMA, 64 bf16
//     unpacks of x, the weights' widening), so 8 rows took 2.7x the time of
//     one for the same bytes: bound by instructions, not memory. The product
//     goes to the tensor cores instead, as the TPU kernel's goes to its
//     matrix unit: mma.sync m16n8k16 (bf16 in, f32 out) with A = 16 weight
//     rows x 16 K values, widened exactly to bf16 in registers (|v| <= 127
//     fits bf16's 8 significant bits), and B = the same 16 K values of 8
//     activation rows. The (N, K) layout is exactly the mma's row-major A: a
//     quad of lanes reads 256 contiguous bytes of a row with four 16-byte
//     loads, and each lane's 16 bytes of rows g and g + 8 feed four
//     consecutive mma steps under a fixed K permutation that x's fragment
//     repeats (from shared memory, two 16-byte loads per 64 K values, reused
//     by every weight tile of the warp). A step's loads are issued before
//     the previous step's products, so a lane keeps 128 bytes in flight.
//     At one n8 tile, runs of 64 bytes of a row a step took 1.4-1.6x the
//     time of runs of 256 bytes; those, with the L2 256-byte fetch hint (each
//     load asks for the 256 bytes around it; 4% without), stream the
//     weights as fast as the CUDA-core kernel did at one row, at any row
//     count up to 8. The grid is persistent (one block per slot of the
//     card, each warp walking its groups of rows as one stream): no faster
//     than a block a group at up to 8 rows, 14% faster at 256 rows (the
//     lm_head on the H100; scripts/quant_ab.py over edited copies of this
//     file). 9 to 256 rows take up to 8 n8 tiles (64 rows) per pass over
//     the weights, two m16 tiles a warp sharing each x fragment. Every bf16
//     product is exact in f32; the tensor cores' sum of a step may truncate
//     where a sequential f32 sum rounds, about 2^-23 relative at each of
//     K / 16 steps, well inside the (K + 2) 2^-24 sum |x w| bound the port
//     holds every kernel to.
//   * (K, N) weights summed in a caller's K tiles of block_k rows
//     (prt_w8a16_tile2d, the probe's schedule): the tile sets the order of
//     the sum, not the unit of work. One block of the TPU's tile grid (32
//     at the down projection's (2048, 256) tile) streamed ~15 GB/s on the
//     H100: too few blocks, too few bytes in flight, the FMA of a whole
//     tile on one SM and 2 MB of partials summed by one block. So the unit
//     is a 64-column strip times a chunk of one K tile (the tile cut only
//     while the grid would hold fewer than two units per SM), and a block
//     streams a run of consecutive chunks of its strip, as few as leave at
//     most two blocks per SM (256 blocks of 64 KB at the down projection).
//     Each warp copies and reads its own 8 K rows of every 64-row stage
//     through its own 8-stage cp.async ring in shared memory (28 KB of a
//     block in flight, no block-wide barrier per stage); x sits K-major in
//     shared memory, so one load gives a K value's 8 rows; a thread keeps
//     rows x 8 columns of f32 FMA on the CUDA cores (bf16 x int8 products
//     are exact in f32: no tensor cores needed at 8 rows); at each chunk's
//     end a shuffle reduce-scatter sums the 4 K slices of a warp and the 8
//     warps follow in index order, while the rings keep loading; the last
//     block of each strip (a per-strip ticket taken with atomicAdd after
//     __threadfence, the CUDA sample threadFenceReduction) sums the strip's
//     partials with float4 loads, 16 in flight, each tile's chunks in
//     order, then the tiles in order, scales and resets the ticket: 32
//     strips of 64 KB in parallel, not 2 MB through one SM. The order of
//     every sum is fixed by (K, N, block_k) alone, never by block_n, the
//     run or the order the blocks arrive in.
//   * More than 8 activation rows on the CUDA cores: the block passes over
//     its own weights once per group of 8 rows; the repeats hit the L2 cache
//     when the block's share is small (128 KB at K = 2048).
// The int8 / int4 -> f32 widening uses byte permutes into the mantissa of 2^23
// (full rate) instead of integer-to-float conversions; int8 -> bf16 (the mma's
// A) puts the low 7 bits under 0x43 (128 + m) and subtracts 128 or 256 by the
// sign bit in one bf16x2 FMA, 7 instructions per 4 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 2048;             // K values of x staged in shared memory
constexpr int kTN = 64;               // columns per block, (K, N) weights
constexpr int kKH = kKC / 2;          // packed int4 rows staged per pass

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

// four packed bytes of a word -> the four low nibbles and the four high
// nibbles as f32: (nibble ^ 8) is the signed int4 value + 8 unsigned
__device__ __forceinline__ void unpack_s4x8(uint32_t word, float* lo,
                                            float* hi) {
  biased_to_f32x4((word & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f, lo);
  biased_to_f32x4(((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f, hi);
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

// 16 (8) bytes of weights read once: no L1 line, and the L2 fetches the 256
// bytes around them from device memory in one request
__device__ __forceinline__ int4 ldg_stream(const int8_t* p) {
  int4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// HINT false: a plain read-only load
template <bool HINT>
__device__ __forceinline__ uint2 ldg_stream8(const uint8_t* p) {
  if (!HINT) return __ldg(reinterpret_cast<const uint2*>(p));
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// Rows r0 .. r0 + R of x (rows of xk values), K values kc0 .. kc0 + kn
// rounded up to a multiple of 8, into xs (R rows of S values) as bf16; rows
// past b are zeros. kc0 and xk are multiples of 8 and kc0 + kn <= xk
// rounded down to one.
template <int R, int S = kKC>
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        __nv_bfloat16* xs, int b, int xk,
                                        int r0, int kc0, int kn) {
  const int vecs = (kn + 7) / 8;
  for (int v = threadIdx.x; v < R * vecs; v += kThreads) {
    const int r = v / vecs, c = v - r * vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < b)
      val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * xk + kc0 +
                                            c * 8);
    *reinterpret_cast<uint4*>(xs + r * S + c * 8) = val;
  }
}

// The end of a strip pass: each thread's R x C accumulators of the block's
// 64 columns (64 / C threads across the strip, the lanes of a warp that
// differ in the higher bits taking other K slices) are summed over the K
// slices (those of a warp by a butterfly, then the warps in index order)
// and rows r0 .. r0 + R of out (b, n) get the sum (times scale[n] when
// SCALE) at columns n0 .. n0 + 64. smem is shared scratch of at least
// kWarps * R * kTN accumulators; every read of it before the call must be
// over (the first __syncthreads below orders them).
template <int R, bool SCALE, int C, typename T>
__device__ __forceinline__ void strip_store(T (&acc)[R][C], void* smem,
                                            const float* __restrict__ scale,
                                            float* __restrict__ out, int b,
                                            int n, int r0, int n0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the K slices of a warp (lanes that differ in bits log2(64 / C)..4),
  // then the warps
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T v = acc[r][c];
#pragma unroll
      for (int m = kTN / C; m < 32; m <<= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, m);
      acc[r][c] = v;
    }
  __syncthreads();                          // the staged x is read no more
  T* red = reinterpret_cast<T*>(smem);      // (kWarps, R, kTN)
  if (lane < kTN / C) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        red[(warp * R + r) * kTN + lane * C + c] = acc[r][c];
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

// (K, N) weights cut into chunks of rows, int8 (INT4 false: w (K, N), out
// (b, n) = sum_k x[b, k] w[k, n] times scale[n]) or int4 (INT4: packed
// (K/2, N), out (b, n) = sum over packed rows i of x[b, i] lo(p[i, n]) +
// x[b, K/2 + i] hi(p[i, n]), times scale[n]). Block (strip, chunk) of a 1-D
// grid (chunks fastest) sums weight rows [chunk * k_chunk, (chunk + 1) *
// k_chunk) of its 64 columns for every row, passes of R rows at a time.
// Thread (tx, ky) = (tid % 8, tid / 8) takes the 8 columns at n0 + 8 tx (one
// 8-byte load of a row: 8 int8 values, or 8 low and 8 high nibbles) and rows
// ky, ky + 32, ... of the chunk, so it keeps R x 8 accumulators and two
// blocks fit an SM at R = 8. Row r of xs holds the chunk's K values (int4:
// those of the low half, then those of the high half). One chunk: out gets
// the scaled sum. Else the chunk's sum goes to its (b, n) plane of part, and
// the last block of the strip to finish (a per-strip ticket taken with
// atomicAdd after __threadfence) sums the planes in chunk order, scales and
// resets the ticket. U weight loads per thread are in flight before their
// use. Any K: weight rows at or past the last are never read, and x comes
// with each row (int4: each half) padded with zeros to a multiple of 16
// values (x_layout below), so a 16-byte load of x never passes its row. The
// body of prt_w8a16 (#14), prt_w8a16_splitk (#17) and prt_w4a16 (#18); each
// launches it under a kernel symbol of its own (below), so that a profile
// tells the three apart.
constexpr int kW4TX = 8;                   // threads across a strip
constexpr int kW4KY = kThreads / kW4TX;    // K slices of a block

// The padded x the split-K entries and prt_w8a8 read for a K of k: rows of
// *xk values, the high half of an int4 row (x[b, K/2 + i]) from value *xh.
// int8 weights: each row padded to a multiple of 16; int4: each half.
__device__ __forceinline__ void x_layout(int k, bool int4, int* xk,
                                        int* xh) {
  const int half = int4 ? (k / 2 + 15) & ~15 : 0;
  *xk = int4 ? 2 * half : (k + 15) & ~15;
  *xh = half;
}

template <int R, int U, bool INT4, bool HINT>
__device__ __forceinline__ void strip_splitk(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ part,
    unsigned int* __restrict__ tickets, float* __restrict__ out, int b, int k,
    int n, int k_chunk, int chunks) {
  // weight rows whose x a pass stages: int4 the packed rows i of both halves
  constexpr int kStage = INT4 ? kKH : kKC;
  __shared__ __align__(16) __nv_bfloat16 xs[R * kKC];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int tx = tid % kW4TX, ky = tid / kW4TX;
  const int chunk = blockIdx.x % chunks, strip = blockIdx.x / chunks;
  const int n0 = strip * kTN;
  const int kh = INT4 ? k / 2 : k;  // weight rows
  int xk, xh;
  x_layout(k, INT4, &xk, &xh);
  const int p_begin = chunk * k_chunk, p_end = min(kh, p_begin + k_chunk);
  const size_t plane = (size_t)b * n;
  const uint8_t* wcol = w + n0 + tx * 8;

  for (int r0 = 0; r0 < b; r0 += R) {
    float acc[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int kc0 = p_begin; kc0 < p_end; kc0 += kStage) {
      const int kn = min(kStage, p_end - kc0);
      uint2 wv[U];
      // the U loads of step kk (rows kk, kk + 32, ...) into wv
      auto fetch = [&](int kk) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kW4KY;
          wv[u] = make_uint2(0u, 0u);
          if (kr < kn)
            wv[u] = ldg_stream8<HINT>(wcol + (size_t)(kc0 + kr) * n);
        }
      };
      fetch(ky);  // the first step's weights are in flight while x is staged
      __syncthreads();
      stage_x<R>(x, xs, b, xk, r0, kc0, kn);
      if (INT4) stage_x<R>(x, xs + kKH, b, xk, r0, xh + kc0, kn);
      __syncthreads();
      for (int kk = ky; kk < kn; kk += kW4KY * U) {
        if (kk != ky) fetch(kk);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kr = kk + u * kW4KY;
          if (kr < kn) {
            if (INT4) {
              float lo[8], hi[8];
              unpack_s4x8(wv[u].x, lo, hi);
              unpack_s4x8(wv[u].y, lo + 4, hi + 4);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float xl = __bfloat162float(xs[r * kKC + kr]);
                const float xh = __bfloat162float(xs[r * kKC + kKH + kr]);
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                  acc[r][c] = fmaf(xl, lo[c], acc[r][c]);
                  acc[r][c] = fmaf(xh, hi[c], acc[r][c]);
                }
              }
            } else {
              float wf[8];
              unpack_s8x4(wv[u].x, wf);
              unpack_s8x4(wv[u].y, wf + 4);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float xv = __bfloat162float(xs[r * kKC + kr]);
#pragma unroll
                for (int c = 0; c < 8; ++c)
                  acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
              }
            }
          }
        }
      }
    }
    if (chunks == 1)
      strip_store<R, true>(acc, xs, scale, out, b, n, r0, n0);
    else
      strip_store<R, false>(acc, xs, scale, part + (size_t)chunk * plane, b,
                            n, r0, n0);
  }
  if (chunks == 1) return;

  // every thread's partials are visible device-wide before its block's ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + strip, 1u) == (unsigned)chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 4 columns a thread, the chunks in index order, kLoads planes loaded at
  // a time
  constexpr int kQuads = kTN / 4, kLoads = 8;
  for (int o = tid; o < b * kQuads; o += kThreads) {
    const int row = o / kQuads, c = 4 * (o - row * kQuads);
    const float* src = part + (size_t)row * n + n0 + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < chunks; c0 += kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        if (c0 + i < chunks)
          v[i] = __ldcg(
              reinterpret_cast<const float4*>(src + (size_t)(c0 + i) * plane));
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        if (c0 + i >= chunks) break;
        if (c0 + i == 0) {
          s = v[i];
        } else {
          s.x += v[i].x;
          s.y += v[i].y;
          s.z += v[i].z;
          s.w += v[i].w;
        }
      }
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + c);
    *reinterpret_cast<float4*>(out + (size_t)row * n + n0 + c) =
        make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
  }
  if (tid == 0) tickets[strip] = 0u;  // ready for the next launch
}

// strip_splitk under the symbol of its entry (prt_w8a16_kernel is #14,
// prt_w8a16_splitk_kernel #17, prt_w4a16_kernel #18)
#define PRT_SPLITK_KERNEL(NAME, INT4)                                         \
  template <int R, int U, bool HINT>                                          \
  __global__ void __launch_bounds__(kThreads, 2) NAME(                        \
      const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,     \
      const float* __restrict__ scale, float* __restrict__ part,              \
      unsigned int* __restrict__ tickets, float* __restrict__ out, int b,     \
      int k, int n, int k_chunk, int chunks) {                                \
    strip_splitk<R, U, INT4, HINT>(x, w, scale, part, tickets, out, b, k, n,  \
                                   k_chunk, chunks);                          \
  }
PRT_SPLITK_KERNEL(prt_w8a16_kernel, false)
PRT_SPLITK_KERNEL(prt_w8a16_splitk_kernel, false)
PRT_SPLITK_KERNEL(prt_w4a16_kernel, true)
#undef PRT_SPLITK_KERNEL

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

// c (16 x 8, s32) += a (16 x 32, s8, row-major) . b (32 x 8, s8, col-major)
__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w8a8 on the int8 tensor cores: out (b, n) = f32(sum_k xq[b, k] w[k, n], in
// int32) * scale[n], with w (k, n) and xq's rows padded with zeros to kx =
// k rounded up to 16 values. Block (strip, span) of a (n / 64, spans) grid
// takes a 64-column strip and K rows [span k_span, (span + 1) k_span),
// k_span <= 32 * 8 * S (whole chunks of ops/quant_matmul.py w8a8_geometry);
// its warp v takes the span's 32-row steps v, v + 8, ..., S of them.
//
// The block reads its weights once and keeps them in registers as the
// mma's A fragments, so more activation rows cost x loads and products,
// never another pass over the weights. Lane (g, t) = (lane / 4, lane % 4)
// loads 8 bytes (columns 8 g .. 8 g + 7 of the strip) of each of the rows
// k0 + 8 t .. k0 + 8 t + 7 of a step, all its steps' loads at once, and
// transposes each 4 x 4 block of bytes into one word of 4 K values per
// column (transpose_s8x4x4): for its 8 columns, K values 8 t .. 8 t + 3
// (lo) and 8 t + 4 .. 8 t + 7 (hi). Those are its A fragments of m16n8k32
// as they stand, under the K permutation slot 4 t + e -> 8 t + e, slot
// 16 + 4 t + e -> 8 t + 4 + e (a sum over all 32 slots is the same): tile
// i's row g is column 8 g + 2 i, its row g + 8 column 8 g + 2 i + 1, a =
// {lo[2i], lo[2i+1], hi[2i], hi[2i+1]}. The B fragment of n8 tile j is then
// the 8 bytes of activation row 8 j + g at k0 + 8 t, one load: x's
// row-major rows are the col-major B as they stand. D's element e of tile
// (i, j) is column 8 g + 2 i + e / 2, row 8 j + 2 t + e % 2.
//
// The rows run in passes of 8 NT (NT n8 tiles); a pass's x loads are issued
// with the weights' (the first), during the previous pass (PREFETCH) or
// after its products. At the end of a pass the 8 K slices of the strip are
// summed by shared-memory int32 atomics, laid out so that the 32 atomics of
// an instruction meet 32 banks. One span: the pass's rows are scaled into
// out. Else each span adds its sums into `sums` (an int32 (b, n) scratch
// that is 0 at entry) with red.global, and after the last pass the last block
// of the strip to finish (a ticket taken with atomicAdd after
// __threadfence) scales the strip's sums into out, zeroes them and resets
// the ticket. int32 sums are exact while |acc| <= 127^2 k < 2^31, k <=
// 133,144 (the JAX kernel's int32 has the same limit), so every order of
// them gives the same bits: a row alone equals the row inside a batch, and
// the kernel equals its plain version.
constexpr int kW8A8MaxK = 133144;
constexpr int kW8A8ChunkMax = 32 * kWarps * 4;  // 1,024 rows: 4 steps a warp

// One block an SM: its S steps of weights take 16 S registers a lane as
// loads, then as A fragments.
template <int NT, int S, bool PREFETCH>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                const float* __restrict__ scale, int* __restrict__ sums,
                unsigned int* __restrict__ tickets, float* __restrict__ out,
                int b, int k, int n, int k_span) {
  constexpr int kRows = 8 * NT;      // activation rows of a pass
  constexpr int kRS = kTN + 4;       // a row of red, padded
  __shared__ int red[kRows * kRS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = blockIdx.x, spans = gridDim.y;
  const int n0 = strip * kTN;
  int kx, unused;
  x_layout(k, false, &kx, &unused);
  const int kb = blockIdx.y * k_span, ke = min(k, kb + k_span);
  const int passes = (b + kRows - 1) / kRows;
  // the first of this lane's 8 K rows in step u (past ke: no step)
  auto k_of = [&](int u) { return kb + 32 * (warp + kWarps * u) + 8 * t; };

  // x of the pass from row r0 into xr (zeros past ke or b)
  uint2 xr[S][NT];
  auto fetch_x = [&](int r0) {
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int kk = k_of(u);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = r0 + 8 * j + g;
        xr[u][j] = make_uint2(0u, 0u);
        if (kk < ke && r < b)
          xr[u][j] = __ldg(
              reinterpret_cast<const uint2*>(xq + (size_t)r * kx + kk));
      }
    }
  };
  // the span's weights, once, and the first pass's x
  uint32_t a[S][4][4];
  {
    uint2 wr[S][8];
    const uint8_t* wl = reinterpret_cast<const uint8_t*>(w) + n0 + 8 * g;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int kk = k_of(u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wr[u][j] = make_uint2(0u, 0u);
        if (kk + j < ke)
          wr[u][j] = ldg_stream8<true>(wl + (size_t)(kk + j) * n);
      }
    }
    fetch_x(0);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      uint32_t lo[8], hi[8];
      transpose_s8x4x4(wr[u][0].x, wr[u][1].x, wr[u][2].x, wr[u][3].x, lo);
      transpose_s8x4x4(wr[u][0].y, wr[u][1].y, wr[u][2].y, wr[u][3].y,
                       lo + 4);
      transpose_s8x4x4(wr[u][4].x, wr[u][5].x, wr[u][6].x, wr[u][7].x, hi);
      transpose_s8x4x4(wr[u][4].y, wr[u][5].y, wr[u][6].y, wr[u][7].y,
                       hi + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[u][i][0] = lo[2 * i];
        a[u][i][1] = lo[2 * i + 1];
        a[u][i][2] = hi[2 * i];
        a[u][i][3] = hi[2 * i + 1];
      }
    }
  }

  for (int p = 0; p < passes; ++p) {
    const int r0 = p * kRows;
    uint2 xb[S][NT];
#pragma unroll
    for (int u = 0; u < S; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j) xb[u][j] = xr[u][j];
    if (PREFETCH && p + 1 < passes) fetch_x(r0 + kRows);
    int acc[4][NT][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if (kb + 32 * (warp + kWarps * u) >= ke) break;  // warp-uniform
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (r0 + 8 * j >= b) break;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_s8_16832(acc[i][j], a[u][i], xb[u][j].x, xb[u][j].y);
      }
    }
    if (!PREFETCH && p + 1 < passes) fetch_x(r0 + kRows);

    // the strip's 8 K slices: (row r, column 8 g' + m) at red[r kRS + 8 m
    // + g']
    __syncthreads();  // the previous pass's sums are read
    for (int o = tid; o < kRows * kRS; o += kThreads) red[o] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (r0 + 8 * j >= b) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          atomicAdd(&red[(8 * j + 2 * t + (e & 1)) * kRS +
                         8 * (2 * i + (e >> 1)) + g],
                    acc[i][j][e]);
    }
    __syncthreads();
    for (int o = tid; o < min(kRows, b - r0) * kTN; o += kThreads) {
      const int r = o / kTN, c = o % kTN;
      const int v = red[r * kRS + 8 * (c % 8) + c / 8];
      const size_t at = (size_t)(r0 + r) * n + n0 + c;
      if (spans == 1)
        out[at] = static_cast<float>(v) * scale[n0 + c];
      else
        atomicAdd(sums + at, v);
    }
  }
  if (spans == 1) return;

  // every thread's adds are done device-wide before the block's ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + strip, 1u) == (unsigned)spans - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = tid; o < b * (kTN / 4); o += kThreads) {
    const int row = o / (kTN / 4), c = n0 + 4 * (o % (kTN / 4));
    int4* src = reinterpret_cast<int4*>(sums + (size_t)row * n + c);
    const int4 s = __ldcg(src);
    const float4 sc = *reinterpret_cast<const float4*>(scale + c);
    *reinterpret_cast<float4*>(out + (size_t)row * n + c) = make_float4(
        static_cast<float>(s.x) * sc.x, static_cast<float>(s.y) * sc.y,
        static_cast<float>(s.z) * sc.z, static_cast<float>(s.w) * sc.w);
    *src = make_int4(0, 0, 0, 0);  // 0 for the next launch
  }
  if (tid == 0) tickets[strip] = 0u;  // ready for the next launch
}

// One launch: a block per strip and span of as many whole chunks as its
// warps hold (S steps each)
template <int NT, int S, bool PREFETCH>
cudaError_t launch_w8a8(const int8_t* xq, const int8_t* w, const float* scale,
                        int* sums, unsigned int* tickets, float* out, int b,
                        int k, int n, int k_chunk, cudaStream_t stream) {
  const int k_span = k_chunk * max(1, 32 * kWarps * S / k_chunk);
  const int spans = (k + k_span - 1) / k_span;
  if (spans > 65535) return cudaErrorInvalidValue;
  w8a8_mma_kernel<NT, S, PREFETCH>
      <<<dim3((unsigned)(n / kTN), (unsigned)spans), kThreads, 0, stream>>>(
          xq, w, scale, sums, tickets, out, b, k, n, k_span);
  return cudaGetLastError();
}

// 16 bytes of device memory into shared memory without a register (Ampere's
// cp.async, L1 bypassed); src_bytes 0 writes 16 zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// until at most N of this thread's newest copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (K, N) weights summed in K tiles of block_k rows, a tile cut into `split`
// chunks of k_chunk = block_k / split rows. Block (strip s, run u), runs
// fastest in the 1-D grid, takes the strip's kStripN columns over `run`
// consecutive chunks from chunk u * run, for every row, and writes each
// chunk's partial to part (k / k_chunk, b, n). The last block of strip s
// to finish sums the partials in order (tile j's chunks in order into P_j,
// then the P_j in j order) into out (b, n), times scale, and resets
// tickets[s]. The weights stream in stages of kRingRows K rows; warp w
// copies and reads its own 8 rows of every stage (lane l copies 16 bytes
// of row w * 8 + l / 4) through its own ring of kRingStages stages, so a
// warp waits for its own copies only (a block-wide barrier per stage
// would wait for the slowest of 256 copies). Thread (tx, s) of warp w
// takes 8 columns at tx * 8 and rows w * 8 + s and w * 8 + s + 4 of every
// stage, so every accumulator walks its chunk in K order; at a chunk's end
// its 32 K slices are summed by a shuffle reduce-scatter over the 4 of a
// warp, then the 8 warps in index order, while the rings keep loading.
// Every sum's order is fixed by (K, N, block_k) alone: not by run, block_n
// or block arrival.
constexpr int kStripN = 64;            // columns of a tile2d block
constexpr int kTileTX = kStripN / 8;   // threads across a strip
constexpr int kRingRows = 64;          // K rows of a stage, 8 a warp
constexpr int kWarpRows = kRingRows / kWarps;
constexpr int kRingStages = 8;
constexpr int kStageBytes = kRingRows * kStripN;
constexpr int kRingBytes = kRingStages * kStageBytes;
constexpr int kRunMax = 1024;          // K rows of x a block stages

template <int R>
constexpr int tile2d_smem() {  // rings, staged x, two chunks' slice sums
  return kRingBytes + R * kRunMax * 2 + 2 * kWarps * R * kStripN * 4;
}

// R bf16 values in one shared-memory access
template <int R> struct XVec { typedef uint4 type; };
template <> struct XVec<4> { typedef uint2 type; };
template <> struct XVec<2> { typedef uint32_t type; };
template <> struct XVec<1> { typedef uint16_t type; };

// the R bf16 of x at one K value (staged K-major, R to a K value) as f32
template <int R>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float* f) {
  if (R == 8) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(p), f);
  } else if (R == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(v.x, f);
    unpack_bf16x2(v.y, f + 2);
  } else if (R == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), f);
  } else {
    f[0] = __bfloat162float(*p);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
w8a16_tile2d_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ part,
                    unsigned int* __restrict__ tickets,
                    float* __restrict__ out, int b, int k, int n, int split,
                    int k_chunk, int run) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  unsigned char* ring = tile_smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(tile_smem + kRingBytes);
  float* red2 =
      reinterpret_cast<float*>(tile_smem + kRingBytes + R * kRunMax * 2);
  __shared__ bool last;
  const int chunks = k / k_chunk, runs = (chunks + run - 1) / run;
  const int u = blockIdx.x % runs, strip = blockIdx.x / runs;
  const int c_first = u * run, n_ch = min(run, chunks - c_first);
  const int n0 = strip * kStripN, k0 = c_first * k_chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane % kTileTX, sl = lane / kTileTX;
  const int per_chunk = (k_chunk + kRingRows - 1) / kRingRows;  // stages
  const int stages = n_ch * per_chunk;
  const size_t plane = (size_t)b * n;
  // this lane's copy: row warp * 8 + lane / 4 of a stage, 16 bytes at
  // (lane % 4) 16; its reads: rows warp * 8 + sl and + 4
  const int cp_row = warp * kWarpRows + (lane >> 2);
  const int8_t* cp_src = w + (size_t)k0 * n + n0 + (lane & 3) * 16;
  unsigned char* cp_dst = ring + cp_row * kStripN + (lane & 3) * 16;
  const int rd_row = warp * kWarpRows + sl;
  auto issue = [&](int t) {
    const int cc = t / per_chunk;
    const int row = (t - cc * per_chunk) * kRingRows + cp_row;
    const bool ok = row < k_chunk;
    cp_async16(cp_dst + (t % kRingStages) * kStageBytes,
               ok ? cp_src + (size_t)(cc * k_chunk + row) * n : w, ok ? 16 : 0);
  };

  for (int r0 = 0; r0 < b; r0 += R) {
    __syncthreads();  // the previous pass's x and slice sums are read
#pragma unroll
    for (int t = 0; t < kRingStages - 1; ++t) {
      if (t < stages) issue(t);
      cp_async_commit();
    }
    // x K-major: the R rows' values of K value kk at xs[kk R ...], one
    // K value a thread (its R stores land in 16 consecutive bytes at R = 8)
    for (int kk = tid; kk < n_ch * k_chunk; kk += kThreads) {
      union {
        uint16_t h[R];
        typename XVec<R>::type vec;
      } v;
#pragma unroll
      for (int r = 0; r < R; ++r)
        v.h[r] = r0 + r < b ? reinterpret_cast<const uint16_t*>(
                                  x)[(size_t)(r0 + r) * k + k0 + kk]
                            : (uint16_t)0;
      *reinterpret_cast<typename XVec<R>::type*>(xs + kk * R) = v.vec;
    }
    __syncthreads();  // x is staged
    float acc[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int t = 0; t < stages; ++t) {
      cp_async_wait<kRingStages - 2>();
      __syncwarp();  // the warp's rows of stage t landed; t - 1 is consumed
      if (t + kRingStages - 1 < stages) issue(t + kRingStages - 1);
      cp_async_commit();
      const int cc = t / per_chunk, st = t - cc * per_chunk;
      const unsigned char* sb = ring + (t % kRingStages) * kStageBytes;
      const __nv_bfloat16* xc = xs + cc * k_chunk * R;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = rd_row + h * 4, kk = st * kRingRows + kr;
        if (kk < k_chunk) {
          const uint2 wv =
              *reinterpret_cast<const uint2*>(sb + kr * kStripN + tx * 8);
          float wf[8];
          unpack_s8x4(wv.x, wf);
          unpack_s8x4(wv.y, wf + 4);
          float xv[R];
          load_x<R>(xc + kk * R, xv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = fmaf(xv[r], wf[c], acc[r][c]);
        }
      }
      if (st < per_chunk - 1) continue;
      // chunk cc is in. The 4 K slices of a warp (lanes that differ in bits
      // 3..4) by a reduce-scatter: a lane keeps half of its R x 8 values
      // and adds its partner's half (lane ^ 16), then a quarter (lane ^ 8);
      // a float sum of two commutes, so each value's bits are fixed. Then
      // the warps in index order, into the chunk's partial.
      constexpr int kV = R * 8, kH = kV / 2, kQ = kV / 4;
      const bool hi16 = lane & 16, hi8 = lane & 8;
      float half[kH], quarter[kQ];
#pragma unroll
      for (int i = 0; i < kH; ++i) {
        const float mine = hi16 ? acc[(kH + i) / 8][(kH + i) % 8]
                                : acc[i / 8][i % 8];
        const float theirs = hi16 ? acc[i / 8][i % 8]
                                  : acc[(kH + i) / 8][(kH + i) % 8];
        half[i] = mine + __shfl_xor_sync(0xFFFFFFFFu, theirs, 16);
      }
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float mine = hi8 ? half[kQ + i] : half[i];
        const float theirs = hi8 ? half[i] : half[kQ + i];
        quarter[i] = mine + __shfl_xor_sync(0xFFFFFFFFu, theirs, 8);
      }
      // quarter[i] is value e = (2 hi16 + hi8) kQ + i: row e / 8, column
      // tx * 8 + e % 8; the chunks alternate between two buffers, so the
      // next chunk's writes never meet this one's reads
      float* red = red2 + (cc & 1) * (kWarps * R * kStripN);
      const int e0 = ((hi16 ? 2 : 0) + (hi8 ? 1 : 0)) * kQ;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int e = e0 + i;
        red[(warp * R + e / 8) * kStripN + tx * 8 + e % 8] = quarter[i];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      __syncthreads();
      float* pc = part + (size_t)(c_first + cc) * plane;
      for (int o = tid; o < R * kStripN; o += kThreads) {
        const int r = o / kStripN, c = o - r * kStripN;
        if (r0 + r < b) {
          float s = red[r * kStripN + c];
#pragma unroll
          for (int wi = 1; wi < kWarps; ++wi)
            s += red[(wi * R + r) * kStripN + c];
          pc[(size_t)(r0 + r) * n + n0 + c] = s;
        }
      }
    }
    cp_async_wait<0>();
  }

  // every thread's partials are visible device-wide before its block's ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + strip, 1u) == (unsigned)runs - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 4 columns a thread: tile j's chunks in order, then the tiles in order,
  // kLoads partials loaded at a time
  constexpr int kQuads = kStripN / 4, kLoads = 16;
  for (int o = tid; o < b * kQuads; o += kThreads) {
    const int row = o / kQuads, c = 4 * (o - row * kQuads);
    const float* src = part + (size_t)row * n + n0 + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), p = s;
    for (int c0 = 0; c0 < chunks; c0 += kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        if (c0 + i < chunks)
          v[i] = __ldcg(
              reinterpret_cast<const float4*>(src + (size_t)(c0 + i) * plane));
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int ch = c0 + i;
        if (ch >= chunks) break;
        const int t = ch % split;
        if (t == 0) {
          p = v[i];
        } else {
          p.x += v[i].x;
          p.y += v[i].y;
          p.z += v[i].z;
          p.w += v[i].w;
        }
        if (t < split - 1) continue;
        if (ch == split - 1) {
          s = p;
        } else {
          s.x += p.x;
          s.y += p.y;
          s.z += p.z;
          s.w += p.w;
        }
      }
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + c);
    *reinterpret_cast<float4*>(out + (size_t)row * n + n0 + c) =
        make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
  }
  if (tid == 0) tickets[strip] = 0u;  // ready for the next launch
}

template <int R>
cudaError_t launch_tile2d(const __nv_bfloat16* x, const int8_t* w,
                          const float* scale, float* part,
                          unsigned int* tickets, float* out, int b, int k,
                          int n, int split, int k_chunk, int run,
                          cudaStream_t stream) {
  constexpr int smem = tile2d_smem<R>();
  const cudaError_t err = cudaFuncSetAttribute(
      w8a16_tile2d_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int runs = (k / k_chunk + run - 1) / run;
  w8a16_tile2d_kernel<R><<<(unsigned)(runs * (n / kStripN)), kThreads, smem,
                           stream>>>(x, w, scale, part, tickets, out, b, k, n,
                                     split, k_chunk, run);
  return cudaGetLastError();
}

// four int8 of a word (K values 0..3, value 0 in the low byte) -> two bf16x2,
// exactly: even = {v0, v2}, odd = {v1, v3} (the lower K value in the low
// half). Under the high byte 0x43 the 7 bits m below are the bf16 128 + m;
// the byte's sign bit picks a bias of -128 (0xC300) or -256 (0xC380), and
// (128 + m) - bias is an integer of at most 8 significant bits, exact in a
// bf16 FMA.
__device__ __forceinline__ void s8x4_to_bf16x2x2(uint32_t w, uint32_t& even,
                                                 uint32_t& odd) {
  const uint32_t one = 0x3F803F80u;  // {1.0, 1.0}
  const uint32_t wo = w >> 8;
  const uint32_t ve = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t be = (w & 0x00800080u) | 0xC300C300u;
  const uint32_t vo = (wo & 0x007F007Fu) | 0x43004300u;
  const uint32_t bo = (wo & 0x00800080u) | 0xC300C300u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(even) : "r"(ve), "r"(one), "r"(be));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(odd) : "r"(vo), "r"(one), "r"(bo));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (N, K) weights on the tensor cores: out (b, n) = (x . w[n, :]) * scale[n].
// The weight rows fall into groups of kWarps * 16 T rows; a block takes
// groups blockIdx.x, + gridDim.x, ... (a persistent grid of as many blocks
// as fit the card at once), warp v of a block rows v 16 T .. of each group,
// T m16 tiles; lane (g, t) = (lane / 4, lane % 4). A step is 64 V K values
// of one group: for each u < V, lane t loads the 16 bytes at 64 u + 16 t of
// rows g and g + 8 of each tile (a quad reads 64 V contiguous bytes of a row
// at once), and word q of them (K values 64 u + 16 t + 4 q .. + 3) feeds
// mma step 4 u + q, its values 0 and 2 in the fragment's columns 2 t,
// 2 t + 1 and its values 1 and 3 in 2 t + 8, 2 t + 9. x's fragment (col g =
// activation row g of an n8 tile) takes the same values from the lane's 16
// K values of that row in shared memory. So every output element sums the
// K / 16 mma steps in K order, whatever the batch, the tile count, the grid
// or the pass. A block's steps run group after group as one stream: the
// next step's loads are issued once this step's weights are widened, before
// its products, across the groups' boundaries (a block that walked one
// group and left drained its loads at each exit); each load asks the L2 for
// the 256 bytes around it. A pass takes 8 NT activation rows; x waits in shared memory
// 16,384 / (8 NT) K values at a time (32 KB; staged once a pass when all
// of K fits), rows padded by 16 bytes so that a quarter warp's 16-byte
// loads meet no bank twice.
template <int NT, int T, int V, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
w8a16_nt_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int b, int k, int n) {
  constexpr int kRows = 8 * NT;          // activation rows of a pass
  constexpr int kXC = 16384 / kRows;     // K values of x staged at a time
  constexpr int kXS = kXC + 8;           // padded row of xs
  constexpr int kStepK = 64 * V;         // K values of a step
  constexpr int kGroupRows = kWarps * 16 * T;
  static_assert(kXC % kStepK == 0, "a step's x lies in one staged chunk");
  __shared__ __align__(16) __nv_bfloat16 xs[kRows * kXS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (k + kStepK - 1) / kStepK;
  const int groups = (n + kGroupRows - 1) / kGroupRows;
  const int mine = (groups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * steps;        // this block's steps, every pass
  const bool whole_x = k <= kXC;         // x staged once a pass
  // the first weight row of this lane in its block's group gi
  auto row_of = [&](int gi) {
    return (blockIdx.x + gi * gridDim.x) * kGroupRows + warp * 16 * T + g;
  };
  // the loads of step (gi, s) into v; past K, N or the block's groups zeros
  auto fetch = [&](int gi, int s, int4 (&v)[T][2][V]) {
    const int row = gi < mine ? row_of(gi) : n;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int kk = s * kStepK + 64 * u + 16 * t;
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 16 * i + 8 * h;
          v[i][h][u] = make_int4(0, 0, 0, 0);
          if (kk < k && r < n)
            v[i][h][u] = ldg_stream(w + (size_t)r * k + kk);
        }
    }
  };

  for (int r0 = 0; r0 < b; r0 += kRows) {
    float acc[T][NT][4];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    int4 wr[T][2][V];
    fetch(0, 0, wr);
    int gi = 0, s = 0;   // the step in wr: group gi, step s

    for (int f = 0; f < total; ++f) {
      const int kx = (s * kStepK) % kXC;
      if (kx == 0 && (gi == 0 || !whole_x)) {
        // the next K values of x (the step's weights are in flight
        // meanwhile)
        __syncthreads();
        stage_x<kRows, kXS>(x, xs, b, k, r0, s * kStepK,
                            min(kXC, k - s * kStepK));
        __syncthreads();
      }
      // the step's weights as bf16 A fragments: a[i][u][q] of tile i,
      // mma step 4 u + q
      uint32_t a[T][V][4][4];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int4 lo = wr[i][0][u], hi = wr[i][1][u];
          const uint32_t wl[4] = {(uint32_t)lo.x, (uint32_t)lo.y,
                                  (uint32_t)lo.z, (uint32_t)lo.w};
          const uint32_t wh[4] = {(uint32_t)hi.x, (uint32_t)hi.y,
                                  (uint32_t)hi.z, (uint32_t)hi.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            s8x4_to_bf16x2x2(wl[q], a[i][u][q][0], a[i][u][q][2]);
            s8x4_to_bf16x2x2(wh[q], a[i][u][q][1], a[i][u][q][3]);
          }
        }
      fetch(s + 1 < steps ? gi : gi + 1, s + 1 < steps ? s + 1 : 0, wr);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const bool kin = s * kStepK + 64 * u + 16 * t < k;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
          if (kin) {
            const __nv_bfloat16* xp =
                xs + (8 * j + g) * kXS + kx + 64 * u + 16 * t;
            x0 = *reinterpret_cast<const uint4*>(xp);
            x1 = *reinterpret_cast<const uint4*>(xp + 8);
          }
          const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w,
                                  x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t b0 =
                __byte_perm(xw[2 * q], xw[2 * q + 1], 0x5410);
            const uint32_t b1 =
                __byte_perm(xw[2 * q], xw[2 * q + 1], 0x7632);
#pragma unroll
            for (int i = 0; i < T; ++i)
              mma_bf16_16816(acc[i][j], a[i][u][q], b0, b1);
          }
        }
      }
      if (++s < steps) continue;
      // group gi is summed. c0, c1: weight row g, activation rows 2 t,
      // 2 t + 1; c2, c3: row g + 8
      const int row = row_of(gi);
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 16 * i + 8 * h;
          const float sc = r < n ? __ldg(scale + r) : 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int br = r0 + 8 * j + 2 * t + e;
              if (r < n && br < b)
                out[(size_t)br * n + r] = acc[i][j][2 * h + e] * sc;
            }
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
          }
        }
      s = 0;
      ++gi;
    }
  }
}

// One instantiation of w8a16_nt_mma_kernel and its grid
template <int NT, int T, int V, int MINB>
struct NtKernel {
  static constexpr int kTiles = NT;
  static constexpr int kGroupRows = kWarps * 16 * T;

  // the persistent grid over n weight rows, on the current device: as many
  // blocks as fit the card at once, at most one a group
  static cudaError_t grid(int n, int* groups, int* blocks) {
    static int per_sm = 0;
    if (per_sm == 0) {
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, w8a16_nt_mma_kernel<NT, T, V, MINB>, kThreads, 0);
      if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *groups = (n + kGroupRows - 1) / kGroupRows;
    *blocks = min(*groups, max(1, per_sm * sms));
    return cudaSuccess;
  }

  static cudaError_t launch(const __nv_bfloat16* x, const int8_t* w,
                            const float* scale, float* out, int b, int k,
                            int n, cudaStream_t stream) {
    int groups = 0, blocks = 0;
    const cudaError_t err = grid(n, &groups, &blocks);
    if (err != cudaSuccess) return err;
    w8a16_nt_mma_kernel<NT, T, V, MINB>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(x, w, scale, out, b, k, n);
    return cudaGetLastError();
  }
};

// f(the NtKernel for b activation rows). One n8 tile: a warp holds one m16
// tile and reads 256 bytes of a row a step (the loads set the pace); more:
// two m16 tiles a warp share each x fragment, 128 bytes a step (registers)
template <typename F>
cudaError_t with_nt_kernel(int b, F&& f) {
  if (b <= 8) return f(NtKernel<1, 1, 4, 2>());
  if (b <= 16) return f(NtKernel<2, 2, 2, 2>());
  if (b <= 32) return f(NtKernel<4, 2, 2, 1>());
  return f(NtKernel<8, 2, 2, 1>());
}

// the split-K entries, each with the kernel symbol of its own
enum SplitKEntry { kEntryW8A16, kEntryW8A16SplitK, kEntryW4A16 };

template <int R, int U, SplitKEntry E, bool HINT>
cudaError_t launch_splitk(const __nv_bfloat16* x, const uint8_t* w,
                          const float* scale, float* part,
                          unsigned int* tickets, float* out, int b, int k,
                          int n, int k_chunk, int chunks, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n / kTN) * chunks);
  if constexpr (E == kEntryW8A16)
    prt_w8a16_kernel<R, U, HINT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, part, tickets, out, b, k, n, k_chunk, chunks);
  else if constexpr (E == kEntryW8A16SplitK)
    prt_w8a16_splitk_kernel<R, U, HINT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, part, tickets, out, b, k, n, k_chunk, chunks);
  else
    prt_w4a16_kernel<R, U, HINT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, part, tickets, out, b, k, n, k_chunk, chunks);
  return cudaGetLastError();
}

// The split-K entries' limits: 1 <= b <= 256, k a multiple of kdiv (int4:
// whole packed rows), n a multiple of 64, k_chunk a multiple of 16 (of the
// k / kdiv weight rows); with more than one chunk, part (chunks * b * n
// floats) and tickets (n / 64) too must be 16-byte aligned. Sets chunks.
bool bad_splitk(const void* const (&ptrs)[6], int b, int k, int n,
                int k_chunk, int kdiv, int* chunks) {
  if (b < 1 || b > 256 || k < kdiv || k % kdiv != 0 || n < kTN ||
      n % kTN != 0 || k_chunk < 16 || k_chunk % 16 != 0)
    return true;
  *chunks = (k / kdiv + k_chunk - 1) / k_chunk;
  if ((long long)*chunks * (n / kTN) > 2147483647LL) return true;
  for (int i = 0; i < (*chunks > 1 ? 6 : 4); ++i)
    if (ptrs[i] == nullptr || reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return true;
  return false;
}

// R rows a pass, U loads in flight a thread, by the row count; the L2
// 256-byte fetch hint on one pass over the weights only (more than 8 rows
// read each chunk again from the L2, where the hint made them slower)
template <SplitKEntry E>
cudaError_t dispatch_splitk(const void* x, const void* w, const void* scale,
                            void* part, void* tickets, void* out, int b,
                            int k, int n, int k_chunk, int chunks,
                            cudaStream_t s) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  float* o = static_cast<float*>(out);
  constexpr int U8 = E == kEntryW4A16 ? 4 : 8;
  if (b == 1)
    return launch_splitk<1, 8, E, true>(xb, wb, sc, pt, tk, o, b, k, n,
                                           k_chunk, chunks, s);
  if (b == 2)
    return launch_splitk<2, 8, E, true>(xb, wb, sc, pt, tk, o, b, k, n,
                                           k_chunk, chunks, s);
  if (b <= 4)
    return launch_splitk<4, 4, E, true>(xb, wb, sc, pt, tk, o, b, k, n,
                                           k_chunk, chunks, s);
  if (b <= 8)
    return launch_splitk<8, U8, E, true>(xb, wb, sc, pt, tk, o, b, k, n,
                                            k_chunk, chunks, s);
  return launch_splitk<8, U8, E, false>(xb, wb, sc, pt, tk, o, b, k, n,
                                           k_chunk, chunks, s);
}

}  // namespace

// x (b, k) bf16, w (k, n) int8, scale (n) f32 -> out (b, n) f32, in one
// launch over 64-column strips times chunks of k_chunk K rows (a multiple
// of 16), the chunks' partials summed in chunk order by the last block of
// each strip: 1 <= b <= 256, any k >= 1, n % 64 == 0; x's rows padded with
// zeros to a multiple of 16 values (x_layout). With more than one
// chunk, part is scratch of chunks * b * n floats and tickets n / 64
// counters that are 0 at entry (and are left 0); neither may be shared with
// a launch that may run at the same time. Every pointer 16-byte aligned.
extern "C" int prt_w8a16(const void* x, const void* w, const void* scale,
                         void* part, void* tickets, void* out, int b, int k,
                         int n, int k_chunk, void* stream) {
  const void* const ptrs[6] = {x, w, scale, out, part, tickets};
  int chunks = 0;
  if (bad_splitk(ptrs, b, k, n, k_chunk, 1, &chunks))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_splitk<kEntryW8A16>(x, w, scale, part, tickets, out, b,
                                           k, n, k_chunk, chunks,
                                           static_cast<cudaStream_t>(stream));
}

// As prt_w8a16 (the same body and limits), for the K >= 8192 products that
// the routing sends to the TPU's split-K kernel.
extern "C" int prt_w8a16_splitk(const void* x, const void* w, const void* scale,
                                void* part, void* tickets, void* out, int b,
                                int k, int n, int k_chunk, void* stream) {
  const void* const ptrs[6] = {x, w, scale, out, part, tickets};
  int chunks = 0;
  if (bad_splitk(ptrs, b, k, n, k_chunk, 1, &chunks))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_splitk<kEntryW8A16SplitK>(
      x, w, scale, part, tickets, out, b, k, n, k_chunk, chunks,
      static_cast<cudaStream_t>(stream));
}

// As prt_w8a16, summed over K tiles of block_k rows in tile order, in one
// launch: 1 <= b <= 256; block_n a multiple of 64, at most 4,096, dividing n
// (it does not change the result: a column's sum depends on the K tiles
// alone); block_k a multiple of 16 dividing k, k / block_k <= 65,535; each
// tile cut into block_k / k_chunk chunks of k_chunk rows (a multiple of 16
// dividing block_k), a block summing `run` consecutive chunks (run *
// k_chunk <= 1,024); part is scratch of (k / k_chunk) * b * n floats,
// tickets n / 64 counters that are 0 at entry (and are left 0); every
// pointer 16-byte aligned. tickets and part must not be shared with a
// launch that may run at the same time.
extern "C" int prt_w8a16_tile2d(const void* x, const void* w,
                                const void* scale, void* part, void* tickets,
                                void* out, int b, int k, int n, int block_n,
                                int block_k, int k_chunk, int run,
                                void* stream) {
  const void* ptrs[] = {x, w, scale, part, tickets, out};
  for (const void* p : ptrs)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  if (b < 1 || b > 256 || block_n < kTN || block_n > 4096 ||
      block_n % kTN != 0 || n < block_n || n % block_n != 0 ||
      block_k < 16 || block_k % 16 != 0 || k < block_k || k % block_k != 0 ||
      k / block_k > 65535 || k_chunk < 16 || k_chunk % 16 != 0 ||
      block_k % k_chunk != 0 || run < 1 || (long long)run * k_chunk > kRunMax ||
      (long long)((k / k_chunk + run - 1) / run) * (n / kStripN) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split = block_k / k_chunk;
  if (b == 1)
    return (int)launch_tile2d<1>(xb, wb, sc, pt, tk, o, b, k, n, split,
                                 k_chunk, run, s);
  if (b == 2)
    return (int)launch_tile2d<2>(xb, wb, sc, pt, tk, o, b, k, n, split,
                                 k_chunk, run, s);
  if (b <= 4)
    return (int)launch_tile2d<4>(xb, wb, sc, pt, tk, o, b, k, n, split,
                                 k_chunk, run, s);
  return (int)launch_tile2d<8>(xb, wb, sc, pt, tk, o, b, k, n, split, k_chunk,
                               run, s);
}

// x (b, k) bf16, w (n, k) int8, scale (n) f32 -> out (b, n) f32, on the
// tensor cores: k % 16 == 0, any n; every pointer 16-byte aligned. 1-8 rows
// take one n8 tile, up to 16 two, up to 32 four, more 8 a pass (64 rows).
extern "C" int prt_w8a16_nt(const void* x, const void* w, const void* scale,
                            void* out, int b, int k, int n, void* stream) {
  if (b < 1 || k < 16 || k % 16 != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_nt_kernel(
      b, [&](auto kern) { return kern.launch(xb, wb, sc, o, b, k, n, s); });
}

// The launch prt_w8a16_nt makes for b rows over n weight rows on the
// current device, into geo[5]: n8 tiles a pass, weight rows of a group,
// groups, blocks of the persistent grid, passes over the weights.
extern "C" int prt_w8a16_nt_geometry(int b, int n, int* geo) {
  if (b < 1 || n < 1 || geo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)with_nt_kernel(b, [&](auto kern) {
    using K = decltype(kern);
    geo[0] = K::kTiles;
    geo[1] = K::kGroupRows;
    geo[4] = (b + 8 * K::kTiles - 1) / (8 * K::kTiles);
    return K::grid(n, geo + 2, geo + 3);
  });
}

// x (b, k) bf16, packed (k / 2, n) int8 (int4 pairs, K-half layout), scale
// (n) f32 -> out (b, n) f32, in one launch: 1 <= b <= 256, any even k,
// n % 64 == 0; each half of x's rows padded with zeros to a multiple of 16
// values (x_layout); the k / 2 packed rows cut into chunks of k_chunk (a
// multiple of 16), one block per 64-column strip and chunk. With more than one
// chunk, part is scratch of chunks * b * n floats and tickets n / 64
// counters that are 0 at entry (and are left 0); neither may be shared
// with a launch that may run at the same time. Every pointer 16-byte
// aligned.
extern "C" int prt_w4a16(const void* x, const void* w, const void* scale,
                         void* part, void* tickets, void* out, int b, int k,
                         int n, int k_chunk, void* stream) {
  const void* const ptrs[6] = {x, w, scale, out, part, tickets};
  int chunks = 0;
  if (bad_splitk(ptrs, b, k, n, k_chunk, 2, &chunks))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_splitk<kEntryW4A16>(x, w, scale, part, tickets, out, b,
                                           k, n, k_chunk, chunks,
                                           static_cast<cudaStream_t>(stream));
}

// xq (b, k) int8 with each row padded with zeros to a multiple of 16 values
// (x_layout), w (k, n) int8, scale (n) f32 -> out (b, n) f32, the int32 sum
// times scale (the caller applies the activation scale), on the int8 tensor
// cores in one launch over 64-column strips times spans of whole chunks of
// k_chunk K rows (a multiple of 16, at most 1,024): 1 <= b <= 256, 1 <= k
// <= 133,144, n % 64 == 0. With more than one chunk, sums is an int32
// scratch of b * n and tickets n / 64 counters, both 0 at entry (and left
// 0); neither may be shared with a launch that may run at the same time.
// Every pointer 16-byte aligned. Up
// to 16 rows take two n8 tiles (one pass over the rows; at up to 8 rows the
// second tile's products are skipped, and its instance streams faster on the
// H100 than a one-tile one) in spans of up to 2,048 K rows; more take four
// n8 tiles a pass (32 rows, the next pass's x loaded during this one) in
// spans of up to 1,024 K rows.
extern "C" int prt_w8a8(const void* xq, const void* w, const void* scale,
                        void* sums, void* tickets, void* out, int b, int k,
                        int n, int k_chunk, void* stream) {
  const void* const ptrs[6] = {xq, w, scale, out, sums, tickets};
  int chunks = 0;
  if (k > kW8A8MaxK || k_chunk > kW8A8ChunkMax ||
      bad_splitk(ptrs, b, k, n, k_chunk, 1, &chunks))
    return (int)cudaErrorInvalidValue;
  const int8_t* xb = static_cast<const int8_t*>(xq);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  int* sm = static_cast<int*>(sums);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 16)
    return (int)launch_w8a8<2, 8, false>(xb, wb, sc, sm, tk, o, b, k, n,
                                         k_chunk, s);
  return (int)launch_w8a8<4, 4, true>(xb, wb, sc, sm, tk, o, b, k, n, k_chunk,
                                      s);
}
