// Stage 1 of two-pass union serving on the tensor cores: #12's and #13's
// stage1=True.
//
// Replaces the stage-1 branch of the TPU kernels of
// persian_rag_tpu/ops/sparse_scores.py:
//   _sparse_topk_union_kernel, stage1=True (:663-673)
//       -> prt_sparse_topk_union_stage1 (the flat ELL, S = 1)
//   _sparse_topk_union_hashed_kernel, stage1=True (:1009-1016)
//       -> prt_sparse_topk_union_hashed_stage1 (the hashed segments)
// reached through persian_rag_tpu_torch/ops/sparse_scores.py. The TPU
// multiplies qw (B x UC, rounded to bf16) by D (UC x TN, rounded to bf16),
// D built by comparing the union's ids with the doc rows, in one MXU pass
// with f32 accumulation, and leaves the order of the sum open. So does this
// kernel: a score is the sum of exact bf16 products, accumulated in f32 by
// mma.sync.m16n8k16 (bf16 in, f32 out). It matches the plain version
// (persian_rag_tpu_torch/ops/sparse_scores.py, _union_stage1_topk_plain)
// within the two-pass proof's bound (_twopass_rel_bound there, whose
// docstring derives the tensor cores' term), not bit for bit. The exact
// modes (#12, #13) stay on sparse_topk.cu's walks.
//
// Weights. stage1_cells_kernel gives each query slot that holds a term for
// the first time in its row that term's weight: the row's values for it
// summed from +0 in slot order, rounded to bf16 (union_prep's qw, rounded).
// Every other slot, and every pad, is {-1, 0}. A block a row sorts the row's
// (id, slot) keys (in shared memory up to kRowKeys slots, else in the
// scratch), so a run of equal ids lists its slots in order and its first
// key names the first slot: O(T log^2 T) a row, for any T.
//
// Blocks. A block takes a block of QB queries and walks doc tiles of TN
// docs, blockIdx.y, + gridDim.y, ... (as many blocks as fill the card at
// once; the query blocks of a tile are launched side by side, so that the
// later ones may find its rows in the L2). Its queries' live slots
// ("cells", query-major) are taken in
// passes of at most kCellsMax. A pass puts the distinct terms of its cells
// into an open-addressed table in shared memory and numbers them in the
// union's order, (id % S, id) (a bitonic sort of the pass's terms: the
// numbering, and so the bits of every score, do not depend on the order in
// which threads arrived). The pass's terms are taken in chunks of DK
// numbers (DK a multiple of 16). The block holds qw (QB x max(DK, 256),
// bf16: the whole pass's weights where its union has at most that many
// terms, else the
// chunk's) and D (DK x TN, bf16) in shared memory. For each chunk D is
// zeroed, and every slot of the tile's docs in the chunk's segments probes
// the table; a slot whose term is in the chunk writes its value as bf16
// under its term's number (a doc's ids are unique, so no two slots write
// one entry). Then each warp multiplies its 32 queries by its TN /
// (WARPS / (QB / 32)) docs: ldmatrix fragments, mma.sync, f32 accumulators
// in registers across chunks and passes. A chunk that no slot of the tile
// hit is skipped (it adds exactly 0). When the block's queries are one
// pass, the table (and a resident qw) is built once for all its tiles. So
// a query of any T runs, in passes, and a pass of any union, in chunks.
//
// Selection. For k <= kRunMax each warp keeps, for each of its queries, a
// running list of the block's top 32 keys (an entry a lane, sorted, in
// shared memory between tiles); a tile's scores are staged in shared memory
// and the docs' keys (sparse_common.cuh: score bits, then lower id) that
// beat the list's k-th are inserted one by one when they are few, else
// sorted and merged 32 at a time (bitonic, across the warp's lanes: a
// tile's first candidates are many, later ones few). Each block writes one
// list a query, and merge_tiles_kernel merges a query's gridDim.y lists
// (not one a tile: the walk selected kt of every tile and merged ~391
// lists a query). A list's insertions number ~k (1 + ln(n / k)) for n
// docs; so where the walk takes more than one round of tiles, a first
// launch takes one tile a block (a sample of gridDim.y tiles), their lists
// are merged, and the sample's k-th key floors every list of the second
// launch (the other rounds): a doc below it cannot be in the top k, since
// the sample's k docs beat it. The sample's merged top k joins the final
// merge as one more list. For a
// longer k, tiles of kSortTN docs sort their keys (bitonic) and write their
// top min(k, kSortTN) each, merged as the walk's tile lists are. A doc that
// shares no term with a query scores exactly +0 (only zero products), and
// zero ties rank lower id first; pads are -3e38, id -1.
//
// Bound. Not the bytes, nor the tensor cores' rate (the product is ~2 B
// U_b N FLOPs, a few percent of the card's bf16 rate): the latency of a
// block's phases between barriers (the doc slots' loads and probes, D's
// zeroing, the mma.sync chains) and the instructions of the selection
// (records of a running list: ~k (1 + ln(n / k)) insertions for n docs).
// On C16 (100,000 x 16) at B = 512 the product is 0.22 of the kernel's
// 0.38 ms and the running lists' selection the rest (after the sampled
// floor); on C's hashed bucket (90,689 x 8 x 32) the product is 0.61 of
// 0.79 ms, mostly the loads of the doc rows, which each query block reads
// again (NVIDIA H100, 700 W; lex_ab.py --variants product; PERF.md section
// 6). The geometry is fixed by the constants below, picked by measuring
// copies of this file with other constants
// (persian_rag_tpu_torch/scripts/lex_ab.py --variants all): 64 queries a
// block, 256 threads; the flat ELL 128 docs a tile and chunks of 128 terms,
// the hashed segments 64 docs and 256 terms (one chunk for a served union).
// At B = 512 each other choice was slower: on C16 64- or 256-doc tiles,
// 256-term chunks, 32 or 128 queries a block or 512 threads by 19-120%; on
// C's bucket 128-doc tiles by 135%, 128-term chunks by 37%, 128 queries a
// block by 12%. A lane's slots kept in registers across chunks, and the
// next k-step's fragments loaded during this one's products, spilled and
// were slower too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bitonic.cuh"
#include "sparse_common.cuh"

namespace {

constexpr int kRunMax = 32;       // the longest list kept running (a lane each)
constexpr int kCellsMax = 2048;   // query cells a pass
constexpr int kRangesMax = kCellsMax / 16;  // chunks a pass, at most
constexpr int kRowKeys = 4096;    // a row's slots sorted in shared memory
constexpr int kMaxT = 1 << 20;    // query slots a row, at most
constexpr size_t kSmemMax = 232448;
constexpr int kProbe = 8;         // slots a lane loads before it probes

// The launch (the header's Bound says why): queries and warps a block; for
// k <= kRunMax the flat ELL's tile and chunk, and the hashed segments'
// (whose wide rows a second chunk would read again); for k > kRunMax the
// sort mode's tile (the chunk as the layout's)
constexpr int kQB = 64;
constexpr int kBlockWarps = 8;
constexpr int kFlatTN = 128, kFlatDK = 128;
constexpr int kHashedTN = 64, kHashedDK = 256;
constexpr int kSortTN = 256;

// Shared memory of a block, byte offsets: the region (D, DK x (TN + 8)
// bf16; between chunks the staged scores or keys, and a pass's sort buffer),
// qw (QB x (qw_terms + 8) bf16), the table (2^log_h {id, number}), each cell's
// term number, each chunk's segment range, the running lists (QB x 32
// keys), each warp's merge buffer (32 keys), the queries' floor keys and
// the pass's term count.
struct Stage1Smem {
  size_t region, qw, table, cell_num, ranges, lists, wbuf, floor, misc,
      total;
};

__host__ __device__ inline size_t pow2_at_least(size_t x) {
  size_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The union terms whose weights qw holds at once: a pass's whole union
// up to this many, else a chunk's.
__host__ __device__ inline int qw_terms(int dk) { return dk > 256 ? dk : 256; }

__host__ __device__ inline Stage1Smem stage1_smem(int qb, int tn, int warps,
                                                  int dk, int cp, int log_h,
                                                  bool running) {
  const size_t d_bytes = (size_t)dk * (tn + 8) * 2;
  const size_t staged = running ? (size_t)qb * (tn + 8) * 4
                                : (size_t)qb * tn * 8;
  const size_t sorted = pow2_at_least((size_t)cp) * 8;
  size_t region = d_bytes > staged ? d_bytes : staged;
  region = region > sorted ? region : sorted;
  Stage1Smem m;
  m.region = 0;
  m.qw = region;
  m.table = m.qw + (size_t)qb * (qw_terms(dk) + 8) * 2;
  m.cell_num = m.table + ((size_t)8 << log_h);
  m.ranges = m.cell_num + (size_t)cp * 4;
  m.lists = m.ranges + (size_t)kRangesMax * 8;
  m.wbuf = m.lists + (running ? (size_t)qb * 32 * 8 : 0);
  m.floor = m.wbuf + (size_t)warps * 32 * 8;
  m.misc = m.floor + (running ? (size_t)qb * 8 : 0);
  m.total = m.misc + 16;
  return m;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ void sort_asc(long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1));
        const long long x = a[i];
        const long long y = a[i + stride];
        if ((i & size) == 0 ? x > y : x < y) {
          a[i] = y;
          a[i + stride] = x;
        }
      }
    }
  }
  __syncthreads();
}

// A query row's first slots of each term: {id, bf16-rounded weight bits}
// (the row's values for the id summed from +0 in slot order), else {-1, 0}.
// A block a row: the row's keys id << 32 | slot sorted ascending (in shared
// memory, or in keys_g, pow2_at_least(t_q) a row, past kRowKeys slots); the
// first key of each id's run names its first slot and its run lists its
// slots in order.
__global__ void __launch_bounds__(256)
stage1_cells_kernel(const int32_t* __restrict__ q_ids,
                    const float* __restrict__ q_vals, int2* __restrict__ cells,
                    long long* __restrict__ keys_g, int t_q) {
  constexpr long long kPad = 0x7FFFFFFFFFFFFFFFLL;
  __shared__ long long keys_s[kRowKeys];
  const int span = (int)pow2_at_least((size_t)t_q);
  long long* keys =
      span <= kRowKeys ? keys_s : keys_g + (size_t)blockIdx.x * span;
  const int32_t* row = q_ids + (size_t)blockIdx.x * t_q;
  const float* vrow = q_vals + (size_t)blockIdx.x * t_q;
  int2* crow = cells + (size_t)blockIdx.x * t_q;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const int id = t < t_q ? row[t] : -1;
    keys[t] = id >= 0 ? ((long long)id << 32) | t : kPad;
    if (t < t_q) crow[t] = make_int2(-1, 0);
  }
  sort_asc(keys, span);  // its barriers also order the writes above
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long key = keys[i];
    const int id = (int)(key >> 32);
    if (key == kPad || (i > 0 && (int)(keys[i - 1] >> 32) == id)) continue;
    float w = 0.f;
    for (int j = i; j < span && keys[j] != kPad && (int)(keys[j] >> 32) == id;
         ++j)
      w = __fadd_rn(w, vrow[(int)(keys[j] & 0xFFFFFFFFLL)]);
    crow[(int)(key & 0xFFFFFFFFLL)] =
        make_int2(id, __float_as_int(bf16_round(w)));
  }
}

// The term numbers of kProbe doc slots (-1: a pad, or a term no cell of the
// pass holds): their first probes at once (they are independent), then the
// few that met another term walk on.
__device__ __forceinline__ void probe_slots(const int2* table, int log_h,
                                            const int (&id)[kProbe],
                                            int (&num)[kProbe]) {
  const unsigned mask = (1u << log_h) - 1u;
  unsigned h[kProbe];
  int2 e[kProbe];
#pragma unroll
  for (int u = 0; u < kProbe; ++u) {
    h[u] = term_slot(id[u], log_h);
    e[u] = id[u] >= 0 ? table[h[u]] : make_int2(-1, -1);
  }
#pragma unroll
  for (int u = 0; u < kProbe; ++u) {
    while (e[u].x >= 0 && e[u].x != id[u]) {
      h[u] = (h[u] + 1u) & mask;
      e[u] = table[h[u]];
    }
    num[u] = e[u].x >= 0 ? e[u].y : -1;
  }
}

// The slots of the chunk's terms [k0, k0 + ucur) into D: their values
// written as bf16 under their term's number, column d (a doc's ids are
// unique: no two slots write one entry). True when one was.
__device__ __forceinline__ bool scatter_slots(const int (&d)[kProbe],
                                              const int (&num)[kProbe],
                                              const float (&v)[kProbe],
                                              int k0, int ucur,
                                              __nv_bfloat16* dmat, int ds) {
  bool hit = false;
#pragma unroll
  for (int u = 0; u < kProbe; ++u) {
    const unsigned x = (unsigned)(num[u] - k0);
    if (x < (unsigned)ucur) {
      dmat[(size_t)x * ds + d[u]] = __float2bfloat16_rn(v[u]);
      hit = true;
    }
  }
  return hit;
}

// 32 keys, one a lane, sorted descending across the warp (bitonic).
__device__ __forceinline__ unsigned long long warp_sort_desc(
    unsigned long long x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long v = __shfl_xor_sync(0xffffffffu, x, j);
      const bool keep_max = ((lane & k) == 0) == ((lane & j) == 0);
      x = keep_max ? (x > v ? x : v) : (x < v ? x : v);
    }
  return x;
}

// The top 32 of two descending warp lists a and b: max(a, reversed b) is
// bitonic and holds them; its half-cleaners sort it descending.
__device__ __forceinline__ unsigned long long warp_merge_desc(
    unsigned long long a, unsigned long long b, int lane) {
  const unsigned long long rev = __shfl_sync(0xffffffffu, b, 31 - lane);
  unsigned long long x = a > rev ? a : rev;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const unsigned long long v = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) == 0 ? (x > v ? x : v) : (x < v ? x : v);
  }
  return x;
}

// Candidates of a tile for one running list up to this many are inserted
// one by one; more are sorted and merged 32 at a time.
constexpr int kInsertMax = 4;

// A tile's staged scores (staged, QB x (TN + 8) f32) into the block's
// running lists (the header's Selection). Warp w updates the lists of
// queries w, w + WARPS, ...: first which lists have a key of the tile that
// beats their k-th (all at once: independent loads), then for each of those
// the keys that beat the k-th (each taken once) are inserted one by one
// where at most kInsertMax are left, else the first 32 of them are sorted
// and merged into the list.
template <int QB, int TN, int WARPS>
__device__ __forceinline__ void update_lists(
    const float* staged, unsigned long long* lists,
    const unsigned long long* floor_key, unsigned long long* wbuf, int kt,
    int nb, int col0, int n) {
  constexpr int kWarps = WARPS;
  constexpr int SS = TN + 8;
  constexpr int kKeys = TN / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned busy = 0u;
#pragma unroll
  for (int j = 0; j < QB / kWarps; ++j) {
    const int q = warp + kWarps * j;
    if (q >= nb) break;
    const unsigned long long kth =
        __shfl_sync(0xffffffffu, lists[32 * q + lane], kt - 1);
    const unsigned long long thr =
        kth > floor_key[q] ? kth : floor_key[q];
    bool beat = false;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int doc = col0 + 32 * i + lane;
      beat |= doc < n &&
              make_key(staged[(size_t)q * SS + 32 * i + lane], doc) > thr;
    }
    busy |= __any_sync(0xffffffffu, beat) ? 1u << j : 0u;
  }
  for (; busy != 0u; busy &= busy - 1u) {
    const int q = warp + kWarps * (__ffs(busy) - 1);
    unsigned long long l = lists[32 * q + lane];
    const float* srow = staged + (size_t)q * SS;
    unsigned long long key[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int doc = col0 + 32 * i + lane;
      key[i] = doc < n ? make_key(srow[32 * i + lane], doc) : 0ull;
    }
    unsigned taken = 0u;  // bit i: key[i] went into a merge
    for (;;) {
      const unsigned long long fl = floor_key[q];
      unsigned long long thr = __shfl_sync(0xffffffffu, l, kt - 1);
      thr = thr > fl ? thr : fl;
      unsigned m[kKeys];
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        m[i] = __ballot_sync(0xffffffffu,
                             key[i] > thr && !((taken >> i) & 1u));
        cnt += __popc(m[i]);
      }
      if (cnt == 0) break;
      if (cnt <= kInsertMax) {
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          for (unsigned mm = m[i]; mm != 0u; mm &= mm - 1u) {
            const unsigned long long cand =
                __shfl_sync(0xffffffffu, key[i], __ffs(mm) - 1);
            if (cand <= thr) continue;
            // the lanes above it keep theirs, the rest move down one
            const int pos =
                __popc(__ballot_sync(0xffffffffu, l > cand));
            const unsigned long long up =
                __shfl_up_sync(0xffffffffu, l, 1);
            l = lane < pos ? l : (lane == pos ? cand : up);
            thr = __shfl_sync(0xffffffffu, l, kt - 1);
            thr = thr > fl ? thr : fl;
          }
        }
        break;
      }
      int base = 0;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int rank =
            base + __popc(m[i] & ((1u << lane) - 1u));
        if (((m[i] >> lane) & 1u) && rank < 32) {
          wbuf[rank] = key[i];
          taken |= 1u << i;
        }
        base += __popc(m[i]);
      }
      __syncwarp();
      const unsigned long long x = lane < cnt ? wbuf[lane] : 0ull;
      __syncwarp();
      l = warp_merge_desc(l, warp_sort_desc(x, lane), lane);
    }
    lists[32 * q + lane] = l;
  }
}

template <int QB, int TN, int WARPS>
struct Stage1Traits {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kWM = QB / 32;        // warps along the queries
  static constexpr int kWN = WARPS / kWM;    // warps along the docs
  static constexpr int kWTN = TN / kWN;      // docs a warp
  static constexpr int kNT = kWTN / 8;       // n8 tiles a warp
  // two blocks of 8 warps an SM where 128 registers hold a thread's
  // accumulators
  static constexpr int kMinBlocks = WARPS == 8 && QB * TN <= 64 * 128 ? 2 : 1;
  static_assert(kWM * kWN == WARPS && kNT % 2 == 0, "warp layout");
};

// The stage-1 kernel (the header says how) over rounds [round0, round1) of
// the tile walk (tile blockIdx.y + gridDim.y round). cells (n_q, t_q) from
// stage1_cells_kernel; out (n_q, n_lists, kt): running mode (kt <=
// kRunMax) a list per block, list blockIdx.y, else a list per tile. With
// floor_s / floor_i ((n_q, kt), a merged top kt of other docs; running mode
// only) a doc enters a list only if its key beats the floor's k-th.
template <int QB, int TN, int WARPS>
__global__ void __launch_bounds__(32 * WARPS,
                                  (Stage1Traits<QB, TN, WARPS>::kMinBlocks))
stage1_mma_kernel(const int2* __restrict__ cells,
                  const int32_t* __restrict__ doc_ids,
                  const float* __restrict__ doc_vals, float* __restrict__ out_s,
                  int32_t* __restrict__ out_i, int n_q, int t_q, int n,
                  int s_n, int ls, int kt, int n_lists, int dk, int cp,
                  int log_h, int round0, int round1,
                  const float* __restrict__ floor_s,
                  const int32_t* __restrict__ floor_i) {
  using Tr = Stage1Traits<QB, TN, WARPS>;
  constexpr int kThreads = Tr::kThreads;
  constexpr int kWarps = WARPS;
  constexpr int kNT = Tr::kNT;
  constexpr int DS = TN + 8;  // D's row (a term), bf16: ldmatrix meets no
  constexpr int SS = TN + 8;  // bank twice; staged scores' row, f32
  const int qwc = qw_terms(dk);          // qw's resident terms
  const int qs = qwc + 8;                // qw's row (a query), bf16
  const bool running = kt <= kRunMax;
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage1Smem lay = stage1_smem(QB, TN, WARPS, dk, cp, log_h, running);
  __nv_bfloat16* dmat = reinterpret_cast<__nv_bfloat16*>(smem + lay.region);
  float* staged = reinterpret_cast<float*>(smem + lay.region);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + lay.region);
  long long* sorted = reinterpret_cast<long long*>(smem + lay.region);
  __nv_bfloat16* qw = reinterpret_cast<__nv_bfloat16*>(smem + lay.qw);
  int2* table = reinterpret_cast<int2*>(smem + lay.table);
  int* cell_num = reinterpret_cast<int*>(smem + lay.cell_num);
  int2* ranges = reinterpret_cast<int2*>(smem + lay.ranges);
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(smem + lay.lists);
  unsigned long long* floor_key =
      reinterpret_cast<unsigned long long*>(smem + lay.floor);
  int* s_u = reinterpret_cast<int*>(smem + lay.misc);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % Tr::kWM;
  const int wn = warp / Tr::kWM;
  unsigned long long* wbuf =
      reinterpret_cast<unsigned long long*>(smem + lay.wbuf) + 32 * warp;
  const int q0 = blockIdx.x * QB;
  const int nb = min(QB, n_q - q0);
  const int n_tiles = (n + TN - 1) / TN;
  const int lrow = s_n * ls;
  const int n_cells = nb * t_q;
  const int n_passes = (n_cells + cp - 1) / cp;
  const int2* cells_b = cells + (size_t)q0 * t_q;
  const int n_slots = 1 << log_h;
  const unsigned mask = (unsigned)n_slots - 1u;
  if (running) {  // query b's list: lists[32 b + entry], descending
    for (int i = tid; i < QB * 32; i += kThreads) lists[i] = 0ull;
    for (int b = tid; b < QB; b += kThreads) {
      const size_t f = (size_t)(q0 + b) * kt + kt - 1;
      floor_key[b] = floor_s != nullptr && b < nb && floor_i[f] >= 0
                         ? make_key(floor_s[f], floor_i[f])
                         : 0ull;
    }
  }

  bool table_built = false;  // one pass: the table lasts for every tile
  bool qw_built = false;     // qw holds the pass's weights
  bool d_dirty = true;       // the region holds something other than zeros

  for (int round = round0, tile = blockIdx.y + gridDim.y * round0;
       round < round1 && tile < n_tiles; ++round, tile += gridDim.y) {
    const int col0 = tile * TN;
    float acc[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

    for (int pass = 0; pass < n_passes; ++pass) {
      const int c_lo = pass * cp;
      const int c_n = min(cp, n_cells - c_lo);
      if (!table_built) {
        // the pass's distinct terms into the table, numbered in the union's
        // order (id % S, id)
        for (int i = tid; i < n_slots; i += kThreads)
          table[i] = make_int2(-1, -1);
        if (tid == 0) *s_u = 0;
        __syncthreads();
        for (int c = tid; c < c_n; c += kThreads) {
          const int id = cells_b[c_lo + c].x;
          if (id < 0) continue;
          for (unsigned h = term_slot(id, log_h);; h = (h + 1u) & mask) {
            const int prev = atomicCAS(&table[h].x, -1, id);
            if (prev == -1 || prev == id) break;
          }
        }
        __syncthreads();
        for (int i = tid; i < n_slots; i += kThreads) {
          const int id = table[i].x;
          if (id >= 0)
            sorted[atomicAdd(s_u, 1)] = ((long long)(id % s_n) << 32) | id;
        }
        __syncthreads();
        const int u = *s_u;
        const int span = (int)pow2_at_least((size_t)(u > 0 ? u : 1));
        for (int i = u + tid; i < span; i += kThreads)
          sorted[i] = 0x7FFFFFFFFFFFFFFFLL;
        sort_asc(sorted, span);
        for (int i = tid; i < u; i += kThreads) {
          const int id = (int)(sorted[i] & 0xFFFFFFFFLL);
          unsigned h = term_slot(id, log_h);
          while (table[h].x != id) h = (h + 1u) & mask;
          table[h].y = i;
        }
        for (int ch = tid; ch * dk < u; ch += kThreads) {
          const int last = min(u, (ch + 1) * dk) - 1;
          ranges[ch] = make_int2((int)(sorted[ch * dk] >> 32),
                                 (int)(sorted[last] >> 32));
        }
        __syncthreads();
        for (int c = tid; c < c_n; c += kThreads) {
          const int id = cells_b[c_lo + c].x;
          cell_num[c] = id >= 0 ? term_number(table, log_h, id) : -1;
        }
        __syncthreads();
        table_built = n_passes == 1;
        qw_built = false;
        d_dirty = true;
      }
      const int u_pass = *s_u;
      const int n_chunks = (u_pass + dk - 1) / dk;
      const bool resident = u_pass <= qwc;  // qw holds the pass's terms
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int k0 = ch * dk;
        const int ucur = min(dk, u_pass - k0);
        if (!qw_built) {
          // the pass's weights (resident: every chunk's, at their number;
          // else this chunk's, at number - k0)
          const int w0 = resident ? 0 : k0;
          const int wn_ = resident ? u_pass : ucur;
          uint4* q4 = reinterpret_cast<uint4*>(qw);
          for (int i = tid; i < QB * qs / 8; i += kThreads)
            q4[i] = make_uint4(0u, 0u, 0u, 0u);
          __syncthreads();
          for (int c = tid; c < c_n; c += kThreads) {
            const int num = cell_num[c] - w0;
            if (num < 0 || num >= wn_) continue;
            const int b = (c_lo + c) / t_q;
            qw[(size_t)b * qs + num] = __float2bfloat16_rn(
                __int_as_float(cells_b[c_lo + c].y));
          }
          qw_built = resident;  // a later pass builds its own
        }
        if (d_dirty) {
          uint4* d4 = reinterpret_cast<uint4*>(dmat);
          for (int i = tid; i < dk * DS / 8; i += kThreads)
            d4[i] = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();  // qw written, D zero
        bool hit = false;
        {
          // the tile's slots in the chunk's segments: [lo, hi) of each row
          const int2 rg = ranges[ch];
          const int lo = rg.x * ls;
          const int hi = (rg.y + 1) * ls;
          const int w = hi - lo;
          if (w <= 32) {
            int wl = 0;
            while ((1 << wl) < w) ++wl;
            const int dpw = 32 >> wl;
            const int step = kWarps * dpw;
            const int rounds = (TN + step - 1) / step;
            const int s = lo + (lane & ((1 << wl) - 1));
            const int d0 = warp * dpw + (lane >> wl);
            for (int r0 = 0; r0 < rounds; r0 += kProbe) {
              int d[kProbe], id[kProbe], num[kProbe];
              float v[kProbe];
#pragma unroll
              for (int u = 0; u < kProbe; ++u) {
                d[u] = d0 + step * (r0 + u);
                const int doc = col0 + d[u];
                const size_t at = (size_t)doc * lrow + s;
                const bool ok = d[u] < TN && s < hi && doc < n;
                id[u] = ok ? __ldg(doc_ids + at) : -1;
                v[u] = ok ? __ldg(doc_vals + at) : 0.f;
              }
              probe_slots(table, log_h, id, num);
              hit |= scatter_slots(d, num, v, k0, ucur, dmat, DS);
            }
          } else {
            // a warp a doc, kProbe slots a lane a step; the next step's
            // slots are in flight during this step's probes
            const int per_doc = (w + 32 * kProbe - 1) / (32 * kProbe);
            const int steps = TN / kWarps * per_doc;
            int d_next, id_next[kProbe];
            float v_next[kProbe];
            auto fetch = [&](int st) {
              const int j = st / per_doc;
              const int p = st - j * per_doc;
              d_next = warp + kWarps * j;
              const int doc = col0 + d_next;
#pragma unroll
              for (int u = 0; u < kProbe; ++u) {
                const int sl = lo + (p * kProbe + u) * 32 + lane;
                const size_t at = (size_t)doc * lrow + sl;
                const bool ok = doc < n && sl < hi;
                id_next[u] = ok ? __ldg(doc_ids + at) : -1;
                v_next[u] = ok ? __ldg(doc_vals + at) : 0.f;
              }
            };
            fetch(0);
            for (int st = 0; st < steps; ++st) {
              int d[kProbe], id[kProbe], num[kProbe];
              float v[kProbe];
#pragma unroll
              for (int u = 0; u < kProbe; ++u) {
                d[u] = d_next;
                id[u] = id_next[u];
                v[u] = v_next[u];
              }
              if (st + 1 < steps) fetch(st + 1);
              probe_slots(table, log_h, id, num);
              hit |= scatter_slots(d, num, v, k0, ucur, dmat, DS);
            }
          }
        }
        if (__syncthreads_or(hit)) {
          // the product: warp (wm, wn) takes queries wm 32 .. + 31 and docs
          // wn kWTN .. + kWTN - 1, k-steps of 16 numbers
          const int nk = (ucur + 15) >> 4;
          const int qc0 = resident ? k0 : 0;
          for (int ks = 0; ks < nk; ++ks) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4(a[mt],
                      qw + (size_t)(wm * 32 + mt * 16 + (lane & 15)) * qs +
                          qc0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np) {
              uint32_t b[4];
              ldsm_x4_trans(b, dmat +
                                   (size_t)(ks * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * DS +
                                   wn * Tr::kWTN + np * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
                mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
              }
            }
          }
          d_dirty = true;
        } else {
          d_dirty = false;
        }
        __syncthreads();  // D and qw read
      }
    }

    // the tile's scores: fragment (mt, nt) holds rows wm 32 + 16 mt + lane / 4
    // (+ 8) and cols wn kWTN + 8 nt + 2 (lane % 4) (+ 1)
    const int row0 = wm * 32 + (lane >> 2);
    const int colw = wn * Tr::kWTN + 2 * (lane & 3);
    d_dirty = true;
    if (running) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int r = row0 + 16 * mt;
          const int c = colw + 8 * nt;
          *reinterpret_cast<float2*>(staged + (size_t)r * SS + c) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(staged + (size_t)(r + 8) * SS + c) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      __syncthreads();
      update_lists<QB, TN, WARPS>(staged, lists, floor_key, wbuf, kt, nb,
                                  col0, n);
      __syncthreads();  // the staged scores read
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = row0 + 16 * mt + 8 * (r >> 1);
            const int c = colw + 8 * nt + (r & 1);
            const int doc = col0 + c;
            keys[(size_t)row * TN + c] =
                row < nb && doc < n ? make_key(acc[mt][nt][r], doc) : 0ull;
          }
      bitonic_desc(keys, TN, nb);
      for (int i = tid; i < nb * kt; i += kThreads) {
        const int b = i / kt;
        const int r = i - b * kt;
        const unsigned long long key = keys[(size_t)b * TN + r];
        const size_t o = ((size_t)(q0 + b) * n_lists + tile) * kt + r;
        out_s[o] = key == 0ull ? kNegInf : key_score(key);
        out_i[o] = key == 0ull ? -1 : key_col(key);
      }
      __syncthreads();  // the keys read
    }
  }
  if (running) {
    for (int i = tid; i < nb * kt; i += kThreads) {
      const int q = i / kt;
      const int r = i - q * kt;
      const unsigned long long l = lists[32 * q + r];
      const size_t o = ((size_t)(q0 + q) * n_lists + blockIdx.y) * kt + r;
      out_s[o] = l == 0ull ? kNegInf : key_score(l);
      out_i[o] = l == 0ull ? -1 : key_col(l);
    }
  }
}

typedef void (*Stage1Kernel)(const int2*, const int32_t*, const float*,
                             float*, int32_t*, int, int, int, int, int, int,
                             int, int, int, int, int, int, const float*,
                             const int32_t*);

struct Stage1Geometry {
  int qb, tile, threads, dk, cp, log_h, qblocks, groups, lists, kt, per_sm;
  size_t smem;
  Stage1Kernel kernel;
  bool sample;  // running mode, more tiles than a round: a sample round
  // scratch, byte offsets: the cells, the rows' sort keys (rows past
  // kRowKeys slots), the sample round's lists and their merged top kt (the
  // floor), then the lists of the final merge
  size_t cells_at, keys_at, sample_at, floor_at, lists_at, scratch;
};

// Blocks an SM of `kernel` at `smem` bytes on `device` (the occupancy API,
// asked once: it costs the host more than a launch), the kernel allowed
// the most shared memory a block may have.
struct Occupancy {
  Stage1Kernel kernel;
  size_t smem;
  int threads, device, per_sm;
};
std::mutex g_occupancy_mu;
Occupancy g_occupancy[64];
int g_occupancy_n = 0;

int blocks_per_sm(Stage1Kernel kernel, size_t smem, int threads, int device,
                  int* per_sm) {
  std::lock_guard<std::mutex> lock(g_occupancy_mu);
  const int held = g_occupancy_n < 64 ? g_occupancy_n : 64;
  for (int i = 0; i < held; ++i) {
    const Occupancy& o = g_occupancy[i];
    if (o.kernel == kernel && o.smem == smem && o.threads == threads &&
        o.device == device) {
      *per_sm = o.per_sm;
      return 0;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  g_occupancy[g_occupancy_n++ % 64] = {kernel, smem, threads, device,
                                       *per_sm};
  return 0;
}

// The launch for n_q queries of t_q slots over n docs of s_n segments at k,
// on the current device: the layout's tile and chunk for k <= kRunMax, the
// sort mode's tile for a longer k; the table of the pass's cells; the
// largest grid that runs at once (blocks an SM by the occupancy API), at
// most a block a tile. cudaErrorInvalidValue where no launch fits.
int stage1_geometry(int n_q, int t_q, int n, int s_n, int k,
                    Stage1Geometry* g) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n_q <= 0 || t_q <= 0 || t_q > kMaxT || n <= 0 || s_n <= 0 || k <= 0 ||
      k > n)
    return bad;
  const bool running = k <= kRunMax;
  const bool hashed = s_n > 1;
  g->qb = kQB;
  g->threads = 32 * kBlockWarps;
  g->dk = hashed ? kHashedDK : kFlatDK;
  if (!running) {
    g->tile = kSortTN;
    g->kernel = stage1_mma_kernel<kQB, kSortTN, kBlockWarps>;
  } else if (hashed) {
    g->tile = kHashedTN;
    g->kernel = stage1_mma_kernel<kQB, kHashedTN, kBlockWarps>;
  } else {
    g->tile = kFlatTN;
    g->kernel = stage1_mma_kernel<kQB, kFlatTN, kBlockWarps>;
  }
  const long long n_tiles = ((long long)n + g->tile - 1) / g->tile;
  g->kt = running ? k : (k < g->tile ? k : g->tile);
  if (!running && n_tiles > 65535) return bad;  // the merge's list heads
  const long long cells = (long long)(kQB < n_q ? kQB : n_q) * t_q;
  g->cp = (int)((cells < kCellsMax ? cells : kCellsMax) + 3) / 4 * 4;
  g->log_h = 5;
  while ((1 << g->log_h) < 2 * g->cp) ++g->log_h;
  g->smem = stage1_smem(kQB, g->tile, kBlockWarps, g->dk, g->cp, g->log_h,
                        running).total;
  if (g->smem > kSmemMax) return bad;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int occ =
      blocks_per_sm(g->kernel, g->smem, g->threads, device, &g->per_sm);
  if (occ != 0) return occ;
  if (g->per_sm < 1) return bad;
  g->qblocks = (n_q + kQB - 1) / kQB;
  long long groups =
      ((long long)g->per_sm * sms + g->qblocks - 1) / g->qblocks;
  groups = groups < n_tiles ? groups : n_tiles;
  groups = groups < 65535 ? groups : 65535;
  g->groups = (int)(groups > 0 ? groups : 1);
  // running mode past one round: the first round's tiles (one a block)
  // are a sample whose merged k-th key floors the other rounds' lists, the
  // sample's top kt joining the final merge as one more list
  g->sample = running && n_tiles > g->groups;
  g->lists = !running ? (int)n_tiles : g->groups + (g->sample ? 1 : 0);
  const size_t entry = 8, rows = (size_t)n_q;
  const size_t span = pow2_at_least((size_t)t_q);
  g->cells_at = 0;
  g->keys_at = rows * t_q * 8;
  g->sample_at = g->keys_at + (span > (size_t)kRowKeys ? rows * span * 8 : 0);
  g->floor_at =
      g->sample_at + (g->sample ? rows * g->groups * g->kt * entry : 0);
  g->lists_at = g->floor_at + (g->sample ? rows * g->kt * entry : 0);
  g->scratch = g->lists_at + rows * g->lists * g->kt * entry;
  return 0;
}

// A list array of n_q rows of `lists` lists of kt entries: scores, then
// ids, at `at` bytes into the scratch.
struct Lists {
  float* s;
  int32_t* i;
};
Lists lists_at(void* scratch, size_t at, int n_q, int lists, int kt) {
  char* base = static_cast<char*>(scratch) + at;
  float* s = reinterpret_cast<float*>(base);
  return {s, reinterpret_cast<int32_t*>(s + (size_t)n_q * lists * kt)};
}

// The rows, the kernel (with a sample round first where the geometry has
// one) and the merge on `stream`, in a scratch of scratch_bytes (at least
// the geometry's, else cudaErrorInvalidValue).
int launch_stage1(const void* q_ids, const void* q_vals, const void* doc_ids,
                  const void* doc_vals, void* scratch, long long scratch_bytes,
                  void* res_s, void* res_i, int n_q, int t_q, int n, int s_n,
                  int ls, int k, void* stream) {
  if (s_n <= 0 || ls <= 0 || (long long)s_n * ls > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Stage1Geometry g;
  const int err = stage1_geometry(n_q, t_q, n, s_n, k, &g);
  if (err != 0) return err;
  if (scratch_bytes < 0 || (size_t)scratch_bytes < g.scratch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  int2* cells = reinterpret_cast<int2*>(base + g.cells_at);
  stage1_cells_kernel<<<n_q, 256, 0, st>>>(
      static_cast<const int32_t*>(q_ids), static_cast<const float*>(q_vals),
      cells, reinterpret_cast<long long*>(base + g.keys_at), t_q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.qblocks, g.groups);
  auto run = [&](Lists out, int n_lists, int round0, int round1,
                 const Lists* floor) {
    g.kernel<<<grid, g.threads, g.smem, st>>>(
        cells, static_cast<const int32_t*>(doc_ids),
        static_cast<const float*>(doc_vals), out.s, out.i, n_q, t_q, n, s_n,
        ls, g.kt, n_lists, g.dk, g.cp, g.log_h, round0, round1,
        floor != nullptr ? floor->s : nullptr,
        floor != nullptr ? floor->i : nullptr);
    return cudaGetLastError();
  };
  const Lists lists = lists_at(scratch, g.lists_at, n_q, g.lists, g.kt);
  if (!g.sample) {
    e = run(lists, g.lists, 0, 1 << 30, nullptr);
  } else {
    const Lists sample = lists_at(scratch, g.sample_at, n_q, g.groups, g.kt);
    const Lists floor = lists_at(scratch, g.floor_at, n_q, 1, g.kt);
    e = run(sample, g.groups, 0, 1, nullptr);
    if (e == cudaSuccess)
      e = (cudaError_t)launch_merge(sample.s, sample.i, n_q, g.groups, g.kt,
                                    g.kt, floor.s, floor.i, st);
    if (e == cudaSuccess) e = run(lists, g.lists, 1, 1 << 30, &floor);
    // the sample's merged top kt: the final merge's last list of a row
    const size_t pitch = (size_t)g.lists * g.kt * 4, width = (size_t)g.kt * 4;
    const size_t last = (size_t)g.groups * g.kt;
    if (e == cudaSuccess)
      e = cudaMemcpy2DAsync(lists.s + last, pitch, floor.s, width, width, n_q,
                            cudaMemcpyDeviceToDevice, st);
    if (e == cudaSuccess)
      e = cudaMemcpy2DAsync(lists.i + last, pitch, floor.i, width, width, n_q,
                            cudaMemcpyDeviceToDevice, st);
  }
  if (e != cudaSuccess) return (int)e;
  return launch_merge(lists.s, lists.i, n_q, g.lists, g.kt, k, res_s, res_i,
                      st);
}

}  // namespace

// q_ids (n_q, t_q) int32 (negative = pad), q_vals (n_q, t_q) f32; doc_ids /
// doc_vals (n, s_n, ls) (the flat ELL: s_n = 1); scratch of scratch_bytes,
// at least what prt_sparse_stage1_geometry reports for the same arguments
// on the same device; res_s / res_i (n_q, k) the merged top k, 1 <= k <= n.
// Each returns a cudaError_t.
extern "C" int prt_sparse_topk_union_stage1(
    const void* q_ids, const void* q_vals, const void* doc_ids,
    const void* doc_vals, void* scratch, long long scratch_bytes, void* res_s,
    void* res_i, int n_q, int t_q, int n, int s_n, int ls, int k,
    void* stream) {
  if (s_n != 1) return (int)cudaErrorInvalidValue;
  return launch_stage1(q_ids, q_vals, doc_ids, doc_vals, scratch,
                       scratch_bytes, res_s, res_i, n_q, t_q, n, s_n, ls, k,
                       stream);
}

extern "C" int prt_sparse_topk_union_hashed_stage1(
    const void* q_ids, const void* q_vals, const void* doc_ids,
    const void* doc_vals, void* scratch, long long scratch_bytes, void* res_s,
    void* res_i, int n_q, int t_q, int n, int s_n, int ls, int k,
    void* stream) {
  return launch_stage1(q_ids, q_vals, doc_ids, doc_vals, scratch,
                       scratch_bytes, res_s, res_i, n_q, t_q, n, s_n, ls, k,
                       stream);
}

// geo[12]: queries a block, docs a tile, threads a block, shared memory
// bytes, query blocks, blocks a query block (the grid's y), lists a query
// of the final merge, entries a list (kt), union terms a chunk, query cells
// a pass, blocks an SM, scratch bytes; for s_n segments a row (the flat
// ELL: 1), on the current device.
extern "C" int prt_sparse_stage1_geometry(int n_q, int t_q, int n, int s_n,
                                          int k, long long* geo) {
  Stage1Geometry g;
  if (geo == nullptr) return (int)cudaErrorInvalidValue;
  const int err = stage1_geometry(n_q, t_q, n, s_n, k, &g);
  if (err != 0) return err;
  const long long out[12] = {g.qb,     g.tile,    g.threads, (long long)g.smem,
                             g.qblocks, g.groups, g.lists, g.kt, g.dk, g.cp,
                             g.per_sm, (long long)g.scratch};
  for (int i = 0; i < 12; ++i) geo[i] = out[i];
  return 0;
}
