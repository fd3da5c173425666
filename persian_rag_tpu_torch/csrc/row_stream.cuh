// The register-blocked f32 stream of the dense kernels: rows of a corpus
// streamed through a cp.async ring in shared memory against a block of
// queries held k-major, each (query, row) score one fmaf chain from +0 in
// ascending k (the chain of the 32-row chunk loops the kernels ran before,
// so their keys kept their bits when they moved onto it). maxonly
// (flat_topk_maxonly.cu), exact and fast (flat_topk_running_select.cu),
// fasti and fastg (segment_topk.cuh), and the int8, bf16 and grouped stage
// 1 (candidate_parts.cuh, grouped_candidates.cuh) run it. Its x2 form
// (stream_rows_x2) streams bf16 rows beside their bf16 residues for the
// bf16x2 stage 1 (flat_topk_candidates_x2.cu).
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
// groups. 64 queries take 3 ring stages, 32, 16 and 8 take 2.
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
// the threads). qs holds a window of the block's QB queries k-major:
// wslabs slabs of K values (wslabs KSE x QS f32, zero past d), which
// load_q(slab0, count) stages from slab slab0 on. A width of at most wslabs
// slabs is staged once; a wider one a window at a time, each chunk walking
// its windows in k order (the staging sits between the ring's barriers), so
// that any d fits a block's shared memory. Thread (warp, lane) keeps
// acc[a][i] = query ((warp % WQ) TQ + a) . row (row0 + 32 i), row0 = chunk0
// + (warp / WQ) 32 TR + lane: one fmaf chain from 0 in ascending k, so
// each score has its bits whatever the window or the block (the zero pads
// past d leave a chain unchanged). finish(row0, acc) runs when a chunk's
// last slab is in; acc is then reset.
template <typename CT, int QB, bool ASYNC, typename LoadQ, typename Finish>
__device__ __forceinline__ void stream_rows(const CT* __restrict__ c,
                                            const float* qs,
                                            unsigned char* ring,
                                            int row_first, int row_end, int n,
                                            int d, int dpad, int wslabs,
                                            int trans, bool round,
                                            LoadQ load_q, Finish finish) {
  typedef StreamShape<QB> S;
  typedef typename RawOf<CT>::type Raw;
  constexpr int KSE = kSlabBytes / (int)sizeof(CT);  // K values of a slab
  constexpr int KPW = 4 / (int)sizeof(CT);           // K values of a word
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane_row = (warp / S::WQ) * 32 * S::TR;  // the warp's rows
  const int slabs = dpad / KSE;
  const bool windowed = wslabs < slabs;
  const int total = (row_end - row_first + S::ROWS - 1) / S::ROWS * slabs;
  const size_t row_bytes = (size_t)d * sizeof(CT);
  const unsigned char* cb = reinterpret_cast<const unsigned char*>(c);
  load_q(0, windowed ? wslabs : slabs);  // seen after the loop's barrier

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
    const int ch = t / slabs, sl = t - ch * slabs;
    // a window's first slab past the first: its queries replace the last
    // window's once every warp is done with them
    const bool reload = windowed && t > 0 && sl % wslabs == 0;
    if (ASYNC) {
      cp_async_wait<S::STAGES - 2>();
      __syncthreads();  // stage t landed; stage t - 1 is consumed
      if (t + S::STAGES - 1 < total) stage(t + S::STAGES - 1);
      cp_async_commit();
      if (reload) {
        load_q(sl, min(wslabs, slabs - sl));
        __syncthreads();
      }
    } else {
      __syncthreads();  // stage t - STAGES is consumed
      stage(t);
      if (reload) load_q(sl, min(wslabs, slabs - sl));
      __syncthreads();
    }
    const int wsl = windowed ? sl % wslabs : sl;
    const unsigned char* sb = ring + (t % S::STAGES) * S::STAGE;
    const float* qk = qs + (size_t)wsl * KSE * S::QS + (warp % S::WQ) * S::TQ;
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
          if constexpr (S::TQ % 4 == 0) {
#pragma unroll
            for (int a = 0; a < S::TQ; a += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qrow + a);
              qv[a] = q4.x;
              qv[a + 1] = q4.y;
              qv[a + 2] = q4.z;
              qv[a + 3] = q4.w;
            }
          } else {  // QB = 8: two queries a warp
#pragma unroll
            for (int a = 0; a < S::TQ; ++a) qv[a] = qrow[a];
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

// stream_rows' shape for the x2 form: QB queries (32, 16 or 8) times ROWS =
// 256 rows a chunk, the warps laid out as StreamShape's; a stage holds the
// chunk's slab of the rows (hi) and the same slab of their residues (lo).
template <int QB>
struct StreamShapeX2 {
  static constexpr int WQ = 4;
  static constexpr int WR = kWarps / WQ;
  static constexpr int TQ = QB / WQ;
  static constexpr int TR = 4;
  static constexpr int ROWS = WR * 32 * TR;
  static constexpr int QS = QB + 4;
  static constexpr int HALF = ROWS * kSlabStride;  // the lo slab's offset
  static constexpr int STAGE = 2 * HALF;
  static constexpr int STAGES = 2;
};

// The x2 form of stream_rows over (n, d) bf16 rows c_hi and their bf16
// residues c_lo: rows [row_first, row_end) in chunks of ROWS, each chunk's
// 32 K values a slab, hi and lo side by side, through a ring of STAGES
// stages (cp.async when ASYNC: rows of a multiple of 16 bytes from 16-byte
// aligned bases; else loaded and stored by the threads). qh and ql hold a
// window of wslabs slabs of the block's QB queries' bf16 parts k-major
// (wslabs 32 x QS f32 each, zero past d), staged by load_q(slab0, count) as
// stream_rows stages its queries, so that any d fits.
// Thread (warp, lane) keeps acc[a][i] for query (warp % WQ) TQ + a and row
// row0 + 32 i as stream_rows does: ONE fmaf chain from +0 in ascending k,
// three products a k in the order qh c_hi, qh c_lo, ql c_hi. The order is
// fixed by d alone (the zero pads past d add +0 to a chain that is never
// -0), so a score has the same bits in every block and batch. The products
// of two bf16 values are exact in f32, so every step adds one exact
// product with one rounding to nearest. finish(row0, acc) runs when a
// chunk's last slab is in; acc is then reset.
template <int QB, bool ASYNC, typename LoadQ, typename Finish>
__device__ __forceinline__ void stream_rows_x2(
    const __nv_bfloat16* __restrict__ c_hi,
    const __nv_bfloat16* __restrict__ c_lo, const float* qh, const float* ql,
    unsigned char* ring, int row_first, int row_end, int d, int dpad,
    int wslabs, LoadQ load_q, Finish finish) {
  typedef StreamShapeX2<QB> S;
  constexpr int KSE = kSlabBytes / 2;  // K values of a slab
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane_row = (warp / S::WQ) * 32 * S::TR;
  const int slabs = dpad / KSE;
  const bool windowed = wslabs < slabs;
  const int total = row_end > row_first
                        ? (row_end - row_first + S::ROWS - 1) / S::ROWS * slabs
                        : 0;
  const size_t row_bytes = (size_t)d * 2;
  load_q(0, windowed ? wslabs : slabs);  // seen after the loop's barrier

  auto stage = [&](int t) {
    const int ch = t / slabs, sl = t - ch * slabs;
    const int r_base = row_first + ch * S::ROWS;
    unsigned char* dst = ring + (t % S::STAGES) * S::STAGE;
    if (ASYNC) {
      for (int p = tid; p < 2 * S::ROWS * 4; p += kThreads) {
        const int half = p / (S::ROWS * 4), pr = p - half * S::ROWS * 4;
        const int r = pr >> 2, piece = pr & 3, row = r_base + r;
        const size_t byte = (size_t)sl * kSlabBytes + piece * 16;
        const bool ok = row < row_end && byte < row_bytes;
        const unsigned char* cb =
            reinterpret_cast<const unsigned char*>(half ? c_lo : c_hi);
        cp_async16(dst + half * S::HALF + r * kSlabStride + piece * 16,
                   ok ? cb + (size_t)row * row_bytes + byte : cb, ok ? 16 : 0);
      }
    } else {
      const uint16_t* hr = reinterpret_cast<const uint16_t*>(c_hi);
      const uint16_t* lr = reinterpret_cast<const uint16_t*>(c_lo);
      for (int e = tid; e < S::ROWS * KSE; e += kThreads) {
        const int r = e / KSE, kk = e - r * KSE;
        const int row = r_base + r, k = sl * KSE + kk;
        uint16_t h = 0, l = 0;
        if (row < row_end && k < d) {
          h = hr[(size_t)row * d + k];
          l = lr[(size_t)row * d + k];
        }
        *reinterpret_cast<uint16_t*>(dst + r * kSlabStride + kk * 2) = h;
        *reinterpret_cast<uint16_t*>(dst + S::HALF + r * kSlabStride +
                                     kk * 2) = l;
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
    const int ch = t / slabs, sl = t - ch * slabs;
    const bool reload = windowed && t > 0 && sl % wslabs == 0;
    if (ASYNC) {
      cp_async_wait<S::STAGES - 2>();
      __syncthreads();  // stage t landed; stage t - 1 is consumed
      if (t + S::STAGES - 1 < total) stage(t + S::STAGES - 1);
      cp_async_commit();
      if (reload) {
        load_q(sl, min(wslabs, slabs - sl));
        __syncthreads();
      }
    } else {
      __syncthreads();  // stage t - STAGES is consumed
      stage(t);
      if (reload) load_q(sl, min(wslabs, slabs - sl));
      __syncthreads();
    }
    const int wsl = windowed ? sl % wslabs : sl;
    const unsigned char* sb = ring + (t % S::STAGES) * S::STAGE;
    const int qoff = wsl * KSE * S::QS + (warp % S::WQ) * S::TQ;
    const unsigned char* sr = sb + (lane_row + lane) * kSlabStride;
#pragma unroll
    for (int v = 0; v < kSlabBytes / 16; ++v) {
      uint4 rh[S::TR], rl[S::TR];
#pragma unroll
      for (int i = 0; i < S::TR; ++i) {
        rh[i] = *reinterpret_cast<const uint4*>(sr + 32 * i * kSlabStride +
                                                v * 16);
        rl[i] = *reinterpret_cast<const uint4*>(sr + S::HALF +
                                                32 * i * kSlabStride + v * 16);
      }
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // a word's low bf16 is the lower k
          float chv[S::TR], clv[S::TR];
#pragma unroll
          for (int i = 0; i < S::TR; ++i) {
            const uint32_t uh = wd == 0 ? rh[i].x : wd == 1 ? rh[i].y
                              : wd == 2 ? rh[i].z : rh[i].w;
            const uint32_t ul = wd == 0 ? rl[i].x : wd == 1 ? rl[i].y
                              : wd == 2 ? rl[i].z : rl[i].w;
            chv[i] = __uint_as_float(e == 0 ? uh << 16 : uh & 0xFFFF0000u);
            clv[i] = __uint_as_float(e == 0 ? ul << 16 : ul & 0xFFFF0000u);
          }
          const int kq = qoff + ((v * 4 + wd) * 2 + e) * S::QS;
          float qhv[S::TQ], qlv[S::TQ];
#pragma unroll
          for (int a = 0; a < S::TQ; ++a) {  // broadcasts: a warp's lanes
            qhv[a] = qh[kq + a];             // read one query group
            qlv[a] = ql[kq + a];
          }
#pragma unroll
          for (int a = 0; a < S::TQ; ++a)
#pragma unroll
            for (int i = 0; i < S::TR; ++i) {
              acc[a][i] = fmaf(qhv[a], chv[i], acc[a][i]);
              acc[a][i] = fmaf(qhv[a], clv[i], acc[a][i]);
              acc[a][i] = fmaf(qlv[a], chv[i], acc[a][i]);
            }
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

// The slabs of a query window: all of d's when they fit beside `rest`
// bytes of a block's shared memory, else the most that fit, spread evenly
// over the windows. `slab_bytes` is one slab of the staged queries.
int window_slabs(int slabs, size_t slab_bytes, size_t rest) {
  const int fit = (int)((kMaxSmem - rest) / slab_bytes);
  if (slabs <= fit) return slabs;
  const int windows = (slabs + fit - 1) / fit;
  return (slabs + windows - 1) / windows;
}

// maxonly's block: the staged query window, the ring, and the row halves'
// maxima; *wslabs gets the window's slabs
template <int QB>
size_t stream_smem(int d, int corpus_type, int* wslabs) {
  typedef StreamShape<QB> S;
  const int kse = slab_values(corpus_type);
  const size_t slab = (size_t)kse * S::QS * sizeof(float);
  const size_t rest =
      (size_t)S::STAGES * S::STAGE + (size_t)S::WR * QB * sizeof(int);
  *wslabs = window_slabs((d + kse - 1) / kse, slab, rest);
  return *wslabs * slab + rest;
}

}  // namespace
