// The register-blocked f32 stream of the running top-k family: rows of a
// corpus streamed through a cp.async ring in shared memory against a
// block of queries held k-major, each (query, row) score one fmaf chain in
// ascending k (the chain of flat_topk_running.cu's chunk_dots). maxonly
// (flat_topk_maxonly.cu) runs it; the other modes can take it up.
#pragma once

#include "running_common.cuh"

namespace {

// 16 bytes of device memory into shared memory without a register (cp.async,
// L1 bypassed); src_bytes 0 writes 16 zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned sd = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sd),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kSlabBytes = 64;     // bytes of one row's K values in a stage
constexpr int kSlabStride = 80;    // a staged row's stride: 5 x 16 bytes, so
                                   // 8 lanes reading 8 rows hit 8 bank groups

// QB queries per block times ROWS = 256 rows per chunk: warp w takes the
// TQ = QB / 4 queries of group w % 4 and the 128 rows of half w / 4, a
// lane TR = 4 of them (lane + 32 i): TQ x TR accumulators a thread (64 at
// QB = 64). The queries are stored k-major with a stride of QS = QB + 4
// floats, so the float4 stores of 8 lanes at 8 consecutive k hit 8 bank
// groups. 64 queries take 3 ring stages, 32 (rows too wide for 64) take 2.
template <int QB>
struct StreamShape {
  static constexpr int WQ = 4;              // query groups of the warps
  static constexpr int WR = kWarps / WQ;    // row halves of the warps
  static constexpr int TQ = QB / WQ;
  static constexpr int TR = 4;
  static constexpr int ROWS = WR * 32 * TR;
  static constexpr int QS = QB + 4;
  static constexpr int STAGE = ROWS * kSlabStride;
  static constexpr int STAGES = QB == 64 ? 3 : 2;
};

// raw element bits of a corpus type (zero bits are +0 in every type)
template <typename CT> struct RawOf { typedef CT type; };
template <> struct RawOf<__nv_bfloat16> { typedef uint16_t type; };

// one 32-bit word of staged row values -> its 4 / sizeof(CT) values as f32
// (rounded to bf16 when `round`: only f32 rows change by it)
__device__ __forceinline__ void widen_word(uint32_t u, float* f, bool,
                                           const int8_t*) {
  // (byte ^ 0x80) is byte + 128 unsigned; the word 0x4B0000uu is 2^23 + u
  const uint32_t b = u ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
}
__device__ __forceinline__ void widen_word(uint32_t u, float* f, bool,
                                           const __nv_bfloat16*) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xFFFF0000u);
}
__device__ __forceinline__ void widen_word(uint32_t u, float* f, bool round,
                                           const float*) {
  f[0] = round ? round_bf16(__uint_as_float(u)) : __uint_as_float(u);
}

// The register-blocked f32 stream, written for the running kernels: rows
// [row_first, row_end) of c ((n, d), or (d, n) with trans) in chunks of
// ROWS rows, each chunk's K values in slabs of 64 bytes a row through a
// ring of STAGES stages in shared memory (cp.async 16 bytes at a time when
// ASYNC: (n, d) rows of a multiple of 16 bytes; else loaded and stored by
// the threads). qs holds the block's QB queries k-major (dpad x QS f32,
// zero past d). Thread (warp, lane) keeps acc[a][i] = query
// ((warp % WQ) TQ + a) . row (row0 + 32 i), row0 = chunk0 + (warp / WQ)
// 32 TR + lane: one fmaf chain from 0 in ascending k, the chain of
// chunk_dots, so each score has its bits (the zero pads past d leave a
// chain unchanged). finish(row0, acc) runs when a chunk's last slab is
// in; acc is then reset.
template <typename CT, int QB, bool ASYNC, typename Finish>
__device__ __forceinline__ void stream_rows(const CT* __restrict__ c,
                                            const float* qs,
                                            unsigned char* ring,
                                            int row_first, int row_end, int n,
                                            int d, int dpad, int trans,
                                            bool round, Finish finish) {
  typedef StreamShape<QB> S;
  typedef typename RawOf<CT>::type Raw;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);  // K values of a slab
  constexpr int KPW = 4 / (int)sizeof(CT);           // K values of a word
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane_row = (warp / S::WQ) * 32 * S::TR;  // the warp's rows
  const int slabs = dpad / KSE;
  const int total = (row_end - row_first + S::ROWS - 1) / S::ROWS * slabs;
  const size_t row_bytes = (size_t)d * sizeof(CT);
  const unsigned char* cb = reinterpret_cast<const unsigned char*>(c);

  auto stage = [&](int t) {
    const int ch = t / slabs, sl = t - ch * slabs;
    const int r_base = row_first + ch * S::ROWS;
    unsigned char* dst = ring + (t % S::STAGES) * S::STAGE;
    if (ASYNC) {
      for (int p = tid; p < S::ROWS * 4; p += kThreads) {
        const int r = p >> 2, piece = p & 3, row = r_base + r;
        const size_t byte = (size_t)sl * kSlabBytes + piece * 16;
        const bool ok = row < row_end && byte < row_bytes;
        cp_async16(dst + r * kSlabStride + piece * 16,
                   ok ? cb + (size_t)row * row_bytes + byte : cb, ok ? 16 : 0);
      }
    } else {
      const Raw* cr = reinterpret_cast<const Raw*>(c);
      for (int e = tid; e < S::ROWS * KSE; e += kThreads) {
        const int r = trans ? e % S::ROWS : e / KSE;
        const int kk = trans ? e / S::ROWS : e % KSE;
        const int row = r_base + r, k = sl * KSE + kk;
        Raw v = 0;
        if (row < row_end && k < d)
          v = trans ? cr[(size_t)k * n + row] : cr[(size_t)row * d + k];
        *reinterpret_cast<Raw*>(dst + r * kSlabStride + kk * sizeof(CT)) = v;
      }
    }
  };

  float acc[S::TQ][S::TR];
#pragma unroll
  for (int a = 0; a < S::TQ; ++a)
#pragma unroll
    for (int i = 0; i < S::TR; ++i) acc[a][i] = 0.f;
  if (ASYNC) {
#pragma unroll
    for (int t = 0; t < S::STAGES - 1; ++t) {
      if (t < total) stage(t);
      cp_async_commit();
    }
  }
  for (int t = 0; t < total; ++t) {
    if (ASYNC) {
      cp_async_wait<S::STAGES - 2>();
      __syncthreads();  // stage t landed; stage t - 1 is consumed
      if (t + S::STAGES - 1 < total) stage(t + S::STAGES - 1);
      cp_async_commit();
    } else {
      __syncthreads();  // stage t - STAGES is consumed
      stage(t);
      __syncthreads();
    }
    const int ch = t / slabs, sl = t - ch * slabs;
    const unsigned char* sb = ring + (t % S::STAGES) * S::STAGE;
    const float* qk = qs + (size_t)sl * KSE * S::QS + (warp % S::WQ) * S::TQ;
    const unsigned char* sr = sb + (lane_row + lane) * kSlabStride;
#pragma unroll 1
    for (int v = 0; v < kSlabBytes / 16; ++v) {
      uint4 raw[S::TR];
#pragma unroll
      for (int i = 0; i < S::TR; ++i)
        raw[i] = *reinterpret_cast<const uint4*>(sr + 32 * i * kSlabStride +
                                                 v * 16);
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        float cf[S::TR][KPW];
#pragma unroll
        for (int i = 0; i < S::TR; ++i) {
          const uint32_t u = wd == 0 ? raw[i].x
                           : wd == 1 ? raw[i].y
                           : wd == 2 ? raw[i].z : raw[i].w;
          widen_word(u, cf[i], round, (const CT*)nullptr);
        }
#pragma unroll
        for (int e = 0; e < KPW; ++e) {
          const float* qrow = qk + ((v * 4 + wd) * KPW + e) * S::QS;
          float qv[S::TQ];
#pragma unroll
          for (int a = 0; a < S::TQ; a += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qrow + a);
            qv[a] = q4.x;
            qv[a + 1] = q4.y;
            qv[a + 2] = q4.z;
            qv[a + 3] = q4.w;
          }
#pragma unroll
          for (int a = 0; a < S::TQ; ++a)
#pragma unroll
            for (int i = 0; i < S::TR; ++i)
              acc[a][i] = fmaf(qv[a], cf[i][e], acc[a][i]);
        }
      }
    }
    if (sl == slabs - 1) {
      finish(row_first + ch * S::ROWS + lane_row + lane, acc);
#pragma unroll
      for (int a = 0; a < S::TQ; ++a)
#pragma unroll
        for (int i = 0; i < S::TR; ++i) acc[a][i] = 0.f;
    }
  }
  if (ASYNC) cp_async_wait<0>();
}

// K values a stage slab holds per row, for corpus type 0 f32, 1 bf16, 2
// int8 (the staged queries are padded to a multiple of it).
int slab_values(int corpus_type) {
  return kSlabBytes / (corpus_type == 0 ? 4 : corpus_type == 1 ? 2 : 1);
}

// the staged queries, the ring, and the row halves' maxima of a block
template <int QB>
size_t stream_smem(int d, int corpus_type) {
  typedef StreamShape<QB> S;
  const int kse = slab_values(corpus_type);
  const size_t dpad = (size_t)(d + kse - 1) / kse * kse;
  return dpad * S::QS * sizeof(float) + (size_t)S::STAGES * S::STAGE +
         (size_t)S::WR * QB * sizeof(int);
}

}  // namespace
