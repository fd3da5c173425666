// Lexical (BM25 / TF-IDF) top-k over a padded sparse ELL corpus.
//
// Replaces the TPU Pallas kernels of persian_rag_tpu/ops/sparse_scores.py:
//   _sparse_topk_kernel               -> prt_sparse_topk
//   _sparse_topk_hashed_kernel        -> prt_sparse_topk_hashed
//   _sparse_topk_union_kernel         -> prt_sparse_topk_union
//   _sparse_topk_union_hashed_kernel  -> prt_sparse_topk_union_hashed
// reached through persian_rag_tpu_torch/ops/sparse_scores.py. They keep the
// TPU kernels' contract, not their blocks. The union kernels' stage1=True
// mode is a kernel of its own (sparse_stage1.cu).
//
// Layout. Docs are doc-major (N, S, Ls): segment g of a doc holds its term
// ids with tid % S == g (-1 pad) and their f32 contributions. The flat ELL
// is the case S = 1, Ls = L. A doc's term ids are unique (the builders
// count terms per doc), so a query term matches at most one slot.
//
// Output. Each block scores one corpus tile for a block of queries and
// writes, per query, the tile's top kt entries (score descending, lower
// doc id first; id -1 and score -3e38 where the tile has fewer docs) to
// out[(b, tile, r)]. #10-#13 merge a query's tiles on the card
// (merge_tiles_kernel), ties keeping the lower id across tiles as well.
// Ranking uses sparse_common.cuh's unique 64-bit keys, so a bitonic sort of
// the keys is an exact, tie-ordered top-k.
//
// Per-term kernels (#10, #11): score[b, n] = sum over query slots t, IN
// SLOT ORDER, of q_val[b, t] * doc_val[n, slot of q_id[b, t]], each product
// and each sum rounded to nearest f32 (__fmul_rn / __fadd_rn, no FMA
// contraction). That is the plain version's arithmetic (carry + q * c per
// slot), so the two agree bit for bit. Query pads (id < 0) are skipped.
//   #11 (the hashed segments) and #10 (the flat ELL, one segment) run one
//   body, under a kernel symbol each. It walks the docs, not B * T ballots a
//   doc (the earlier #10 ran B * N * T warp ballots over a shared-memory
//   copy of each row, at 23 blocks for its largest bucket on 132 SMs).
//   A block takes a tile of docs and a block of up to 64 queries, and first
//   puts the block's live query terms into an open-addressed table in shared
//   memory (each distinct term once, numbered), and maps every (query,
//   slot) to its term's number. A warp then
//   takes a doc: its lanes read the doc's S * Ls slots with coalesced loads
//   (the next doc's loads are in flight meanwhile; the segments are a TPU
//   mechanic and need no walk of their own), probe the table for all their
//   live slots at once, and store each hit's value under the term's number,
//   stamped with the doc (a doc's ids are unique: no two lanes store one
//   term). Then lanes take the queries and sum each query's slots in slot
//   order, where the term was stamped with this doc: a term that several
//   queries hold, or one query twice, is found once and counted in every
//   slot it fills. A tile's top kt <= 32 are selected by a warp a query (kt
//   rounds of a warp maximum), longer lists sort the tile. So the corpus
//   streams from device memory at most once per query block (the query
//   blocks of a tile are launched side by side, so that the later ones may
//   find it in the L2), and a doc costs one table probe a live slot plus
//   B * T / 32 slot steps a lane. What bounds it is not the bytes (~5x their
//   bound at 64 queries) but chains of dependent shared-memory reads at 16
//   warps an SM: issuing a doc's first probes together, and selecting
//   instead of sorting, took a third off
//   (persian_rag_tpu_torch/scripts/lex_ab.py). The C entry picks the query
//   block, the threads and the table from (B, T) alone
//   (prt_sparse_topk_hashed_geometry): the largest block whose shared memory
//   lets two blocks share an SM (32 queries at T = 8-16; 64 at one block an
//   SM, and 16 at four, were slower on the H100), else one, shrinking the
//   block and then the warps for a long query; it admits every T the earlier
//   kernels admitted, and more. #11 takes tiles of 256 docs. #10's buckets
//   are small (5,664 docs at most in the reference corpus), so its C entry
//   (prt_sparse_topk_geometry) also halves the tile, down to 32, until the
//   grid holds two blocks an SM: a served request of 1-16 queries then runs
//   177 blocks there, not 23. The tile changes neither a score nor the
//   merged list: each tile gives its top min(k, tile) by unique keys.
//
// Union kernels (#12, #13): the batch's distinct terms in the union's
// order (union_prep: ascending id; union_prep_hashed: by (id % S, id)), and
// qw (B, U), each query's weight per union term (a term a query holds twice
// summed in slot order: union_prep's index_put_). A union score is one f32
// chain from +0 over the union terms in that order, fmaf(qw[b, a], D[a, n],
// acc), D[a, n] the doc's value for term a (0 when it lacks it): another
// order than the per-term kernels', so union scores agree with them to f32
// rounding. No TF32, no tensor cores (a bf16 product moves BM25 scores by up
// to 0.11, as the JAX package measured).
//   #12 (the flat ELL) runs the per-term body over the doc tiles of #10
//   (prt_sparse_topk_geometry), its selection and its merge, and #13 (the
//   hashed segments) the same body over #11's launch
//   (prt_sparse_topk_hashed_geometry), a doc's S * Ls slots read as one
//   row. Only the slot map differs: it gives each query its distinct terms
//   in the union's order (each slot's rank among the query's slots by
//   union_key), with the weight qw would hold, and the sum is an fmaf. So a
//   query's chain runs over the terms that it holds and the doc holds, in
//   union order. Every term it skips adds fmaf(w, 0, acc) or fmaf(0, v,
//   acc), which is acc itself (a chain from +0 is never -0): the scores are
//   the dense chain's bit for bit, at work in proportion to the hits, and
//   the doc rows need no order. The block builds its queries' part of the
//   union itself: union_prep's ~40 torch calls cost the wrapper more host
//   time than the walk takes on the card (PERF.md, section 6). The earlier
//   #13 ran the dense chain over every union term for every doc: 2 B U N
//   FLOPs whatever the hits, 5.5x #11's time on the same bucket.
//   The walk keeps the block's query slots in shared memory. A query of
//   more slots than a block holds (T past ~6,200 at one query a block) is
//   walked in passes (lookup_geometry's slots a pass): each pass takes the
//   next slots (per term: slot order; union: the next ranks in the union's
//   order), builds their table and walks the tile's docs, and a (query,
//   doc) chain carries on from the last pass in the keys' space. So every
//   entry takes any T, each in its own order and bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "sparse_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// per-term kernels: the largest and the smallest doc tile, and the blocks
// that fill the card: two for each of the H100's 132 SMs (#10 shrinks its
// tile until its grid has them)
constexpr int kTN = 256;
constexpr int kMinTN = 32;
constexpr int kFillBlocks = 2 * 132;
// #11: the most queries of a block, slots a lane reads per step, the longest
// per-tile list it selects without sorting the tile, shared memory a block
// may use, and the most that lets two blocks share an SM (228 KB an SM, 1 KB
// of it reserved per block)
constexpr int kLookupQB = 64;
constexpr int kLookupSlots = 8;
constexpr int kSelectMax = 32;
constexpr size_t kSmemMax = 232448;
constexpr size_t kSmemTwo = 233472 / 2 - 1024;

// Write each query's top kt keys of the tile (key 0 = no doc).
__device__ void write_top(const unsigned long long* keys, int tn, int nb,
                          int q0, int tile, int n_tiles, int col0, int kt,
                          float* out_s, int32_t* out_i) {
  for (int i = threadIdx.x; i < nb * kt; i += blockDim.x) {
    const int b = i / kt;
    const int r = i - b * kt;
    const unsigned long long key = keys[(size_t)b * tn + r];
    const size_t o = ((size_t)(q0 + b) * n_tiles + tile) * kt + r;
    if (key == 0ull) {
      out_s[o] = kNegInf;
      out_i[o] = -1;
    } else {
      out_s[o] = key_score(key);
      out_i[o] = col0 + key_col(key);
    }
  }
}

// As write_top for the first nb rows of TN keys, without sorting them (for
// kt <= kSelectMax): a warp takes a row, a lane TN / 32 of its keys, and
// each of kt rounds writes the warp's largest key and retires it. Keys are
// unique but 0 (no doc), so one lane holds each; 0 writes a pad, as
// write_top.
template <int TN>
__device__ void select_top(unsigned long long* keys, int nb, int q0, int tile,
                           int n_tiles, int col0, int kt, float* out_s,
                           int32_t* out_i) {
  constexpr int kPer = TN / 32;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  __syncthreads();  // every doc's key is stored
  for (int b = threadIdx.x >> 5; b < nb; b += warps) {
    unsigned long long k[kPer];
    unsigned long long best = 0ull;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      k[i] = keys[(size_t)b * TN + i * 32 + lane];
      best = k[i] > best ? k[i] : best;
    }
    const size_t o = ((size_t)(q0 + b) * n_tiles + tile) * kt;
    for (int r = 0; r < kt; ++r) {
      unsigned long long m = best;
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, x);
        m = other > m ? other : m;
      }
      if (lane == 0) {
        out_s[o + r] = m == 0ull ? kNegInf : key_score(m);
        out_i[o + r] = m == 0ull ? -1 : col0 + key_col(m);
      }
      if (m != 0ull && best == m) {  // this lane holds it: retire it
        best = 0ull;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          k[i] = k[i] == m ? 0ull : k[i];
          best = k[i] > best ? k[i] : best;
        }
      }
    }
  }
}

// The union's order of term id (union_prep_hashed's sort key, (id % s_n,
// id); with s_n = 1, the id itself: union_prep's order, without the
// division that the block's rank loop would pay for every pair of slots)
__device__ __forceinline__ long long union_key(int id, int s_n) {
  return s_n == 1 ? id : (long long)(id % s_n) * (1LL << 26) + id;
}

// Doc-driven lookup over a query block and a tile of TN docs (#10, #11 and,
// with UNION, #12 and #13; the header says how), in passes of tc query
// slots. Shared memory, in order: the keys (qb x TN; between passes each
// (query, doc) chain's f32 bits), the slot map (tc x qb, t-major: {term
// number or -1, weight bits}), the table (2^log_h {term id, number}), each
// warp's hits (qb * tc {doc stamp, value bits} a warp) and the count of
// distinct terms. A pass's slot map holds a query's slots [lo, lo + tc) in
// slot order with their q_val; with UNION, its distinct terms of ranks [lo,
// lo + tc) in the union's order (union_key over the layout's s_n segments)
// with their summed weight, and pads (a term that the query holds twice
// leaves one). The table holds the pass's terms only. PASSES false is the
// one-pass walk (tc = t_q), compiled apart: with the pass bookkeeping in
// it, #10 took ~40% longer at B = 64 on 32-doc tiles
// (persian_rag_tpu_torch/scripts/lex_ab.py).
template <int TN, bool UNION, bool PASSES>
__device__ __forceinline__ void lookup_body(
    const int32_t* __restrict__ q_ids, const float* __restrict__ q_vals,
    const int32_t* __restrict__ doc_ids, const float* __restrict__ doc_vals,
    float* __restrict__ out_s, int32_t* __restrict__ out_i, int n_q, int t_q,
    int n, int lrow, int s_n, int kt, int n_tiles, int qb, int log_h,
    int tc) {
  extern __shared__ unsigned long long smem_u64[];
  const int warps = blockDim.x >> 5;
  const int cells = qb * tc;
  const int n_slots = 1 << log_h;
  unsigned long long* keys = smem_u64;
  int2* qmap = reinterpret_cast<int2*>(keys + (size_t)qb * TN);
  int2* table = qmap + cells;
  int2* hits = table + n_slots;
  int* n_terms = reinterpret_cast<int*>(hits + (size_t)warps * cells);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * qb;
  const int nb = min(qb, n_q - q0);
  const int tile = blockIdx.y;
  const int col0 = tile * TN;
  const int32_t* qid_b = q_ids + (size_t)q0 * t_q;
  const float* qv_b = q_vals + (size_t)q0 * t_q;
  const int rounds = PASSES ? (t_q + tc - 1) / tc : 1;

  for (int round = 0; round < rounds; ++round) {
    const int lo = round * tc;
    const int tcur = PASSES ? min(tc, t_q - lo) : t_q;  // slots or ranks
    const bool last = !PASSES || round == rounds - 1;
    if (PASSES && round > 0) __syncthreads();  // the last pass is read
    for (int i = tid; i < n_slots; i += blockDim.x)
      table[i] = make_int2(-1, -1);
    for (int i = tid; i < warps * cells; i += blockDim.x)
      hits[i] = make_int2(-1, 0);
    if constexpr (UNION) {
      for (int i = tid; i < cells; i += blockDim.x)
        qmap[i] = make_int2(-1, 0);
    }
    if (tid == 0) *n_terms = 0;
    __syncthreads();
    // the pass's terms into the table, once each, and the slot map: a
    // query's slots [lo, lo + tcur) in order (pads -1); with UNION, a term's
    // first slot at its rank among the query's live slots, its weight the
    // query's values for it summed from +0 in slot order (a term repeated
    // below leaves a pad)
    const int span = UNION ? t_q : tcur;
    for (int i = tid; i < nb * span; i += blockDim.x) {
      const int b = i / span;
      const int t = (UNION ? 0 : lo) + i - b * span;
      const int id = qid_b[(size_t)b * t_q + t];
      float w = qv_b[(size_t)b * t_q + t];
      int place = t;
      if constexpr (UNION) {
        if (id < 0) continue;
        const int32_t* row = qid_b + (size_t)b * t_q;
        const float* vrow = qv_b + (size_t)b * t_q;
        const long long key = union_key(id, s_n);
        int rank = 0;
        bool first = true;
        w = 0.f;
        for (int t2 = 0; t2 < t_q; ++t2) {
          const int id2 = row[t2];
          rank += id2 >= 0 && union_key(id2, s_n) < key;
          if (id2 == id) {
            first = first && t2 >= t;
            w = __fadd_rn(w, vrow[t2]);
          }
        }
        if (!first || rank < lo || rank >= lo + tcur) continue;
        place = rank;
      }
      qmap[(place - lo) * qb + b] = make_int2(id, __float_as_int(w));
      if (id < 0) continue;  // a query pad
      const unsigned mask = (unsigned)n_slots - 1u;
      for (unsigned h = term_slot(id, log_h);; h = (h + 1u) & mask) {
        const int prev = atomicCAS(&table[h].x, -1, id);
        if (prev == -1 || prev == id) break;
      }
    }
    __syncthreads();
    for (int i = tid; i < n_slots; i += blockDim.x)
      if (table[i].x >= 0) table[i].y = atomicAdd(n_terms, 1);
    __syncthreads();
    for (int i = tid; i < tcur * qb; i += blockDim.x) {  // ids to numbers
      const int id = qmap[i].x;
      if (id >= 0) qmap[i].x = term_number(table, log_h, id);
    }
    __syncthreads();

    // warp w takes docs w, w + warps, ...: doc j of the warp is stamped j.
    // A step is 32 * kLookupSlots slots of a doc, kLookupSlots a lane.
    int2* my_hits = hits + (size_t)warp * cells;
    const int passes = (lrow + 32 * kLookupSlots - 1) / (32 * kLookupSlots);
    const int steps = (TN - warp + warps - 1) / warps * passes;
    int id_next[kLookupSlots];
    float v_next[kLookupSlots];
    auto fetch = [&](int step) {
      const int j = step / passes;
      const int p = step - j * passes;
      const int doc = col0 + warp + warps * j;
      const size_t base = (size_t)doc * lrow;
#pragma unroll
      for (int s = 0; s < kLookupSlots; ++s) {
        const int l = (p * kLookupSlots + s) * 32 + lane;
        const bool ok = doc < n && l < lrow;
        id_next[s] = ok ? __ldg(doc_ids + base + l) : -1;
        v_next[s] = ok ? __ldg(doc_vals + base + l) : 0.f;
      }
    };
    if (steps > 0) fetch(0);
    for (int step = 0; step < steps; ++step) {
      int id[kLookupSlots];
      float v[kLookupSlots];
#pragma unroll
      for (int s = 0; s < kLookupSlots; ++s) {
        id[s] = id_next[s];
        v[s] = v_next[s];
      }
      if (step + 1 < steps) fetch(step + 1);  // in flight during the lookups
      const int j = step / passes;
      // the slots' first probes at once (they are independent), then the
      // few that met another term walk on
      unsigned h[kLookupSlots];
      int2 e[kLookupSlots];
#pragma unroll
      for (int s = 0; s < kLookupSlots; ++s) {
        h[s] = term_slot(id[s], log_h);
        e[s] = id[s] >= 0 ? table[h[s]] : make_int2(-1, -1);  // -1: doc pad
      }
#pragma unroll
      for (int s = 0; s < kLookupSlots; ++s) {
        while (e[s].x >= 0 && e[s].x != id[s]) {
          h[s] = (h[s] + 1u) & (unsigned)(n_slots - 1);
          e[s] = table[h[s]];
        }
        if (e[s].x >= 0)
          my_hits[e[s].y] = make_int2(
              j, __float_as_int(__fadd_rn(0.f, v[s])));
      }
      if (step - j * passes != passes - 1) continue;  // more slots of the doc
      __syncwarp();  // the doc's hits are stored
      const int d = warp + warps * j;
      const bool live = col0 + d < n;
      for (int b = lane; b < nb; b += 32) {
        // the chain from the last pass (this thread stored it there)
        float acc = PASSES && round > 0
                        ? __uint_as_float((uint32_t)keys[(size_t)b * TN + d])
                        : 0.f;
        if (live) {
#pragma unroll 4
          for (int t = 0; t < tcur; ++t) {
            const int2 e = qmap[t * qb + b];
            if (e.x < 0) continue;  // query pad
            const int2 h = my_hits[e.x];
            if (h.x != j) continue;
            if constexpr (UNION) {
              acc = fmaf(__int_as_float(e.y), __int_as_float(h.y), acc);
            } else {
              acc = __fadd_rn(acc, __fmul_rn(__int_as_float(e.y),
                                             __int_as_float(h.y)));
            }
          }
        }
        keys[(size_t)b * TN + d] =
            !last ? (unsigned long long)__float_as_uint(acc)
                  : live ? make_key(acc, d) : 0ull;
      }
      __syncwarp();  // the hits are read before the next doc's land
    }
  }  // the passes
  if (kt <= kSelectMax) {
    select_top<TN>(keys, nb, q0, tile, n_tiles, col0, kt, out_s, out_i);
  } else {
    bitonic_desc(keys, TN, nb);
    write_top(keys, TN, nb, q0, tile, n_tiles, col0, kt, out_s, out_i);
  }
}

// One kernel symbol each, so that a profile tells them apart: #10 over the
// flat ELL, at the doc tile its C entry picks ...
#define PRT_LOOKUP_ARGS                                                      \
  const int32_t *__restrict__ q_ids, const float *__restrict__ q_vals,      \
      const int32_t *__restrict__ doc_ids,                                  \
      const float *__restrict__ doc_vals, float *__restrict__ out_s,        \
      int32_t *__restrict__ out_i, int n_q, int t_q, int n, int lrow,       \
      int s_n, int kt, int n_tiles, int qb, int log_h, int tc
#define PRT_LOOKUP_PASS                                                     \
  q_ids, q_vals, doc_ids, doc_vals, out_s, out_i, n_q, t_q, n, lrow, s_n,   \
      kt, n_tiles, qb, log_h, tc
template <int TN, bool PASSES>
__global__ void __launch_bounds__(kThreads)
sparse_topk_flat_kernel(PRT_LOOKUP_ARGS) {
  lookup_body<TN, false, PASSES>(PRT_LOOKUP_PASS);
}

// ... #12 over the flat ELL, at #10's tiles ...
template <int TN, bool PASSES>
__global__ void __launch_bounds__(kThreads)
sparse_topk_union_walk_kernel(PRT_LOOKUP_ARGS) {
  lookup_body<TN, true, PASSES>(PRT_LOOKUP_PASS);
}

// ... #11 over the hashed segments, at tiles of kTN docs ...
template <bool PASSES>
__global__ void __launch_bounds__(kThreads)
sparse_topk_lookup_kernel(PRT_LOOKUP_ARGS) {
  lookup_body<kTN, false, PASSES>(PRT_LOOKUP_PASS);
}

// ... and #13 over the hashed segments, at #11's launch
template <bool PASSES>
__global__ void __launch_bounds__(kThreads)
sparse_topk_union_lookup_kernel(PRT_LOOKUP_ARGS) {
  lookup_body<kTN, true, PASSES>(PRT_LOOKUP_PASS);
}
#undef PRT_LOOKUP_ARGS
#undef PRT_LOOKUP_PASS

// A per-term launch for n_q queries of t_q slots: qb queries a block, warps
// a block, a table of 2^log_h slots, tile docs a block, tc query slots a
// pass, smem bytes of shared memory.
struct LookupGeometry {
  int qb, warps, log_h, tile, tc;
  size_t smem;
};

size_t lookup_smem(int qb, int tc, int warps, int log_h, int tile) {
  const size_t cells = (size_t)qb * tc;
  return (size_t)qb * tile * sizeof(unsigned long long) + cells * 8 +
         ((size_t)8 << log_h) + (size_t)warps * cells * 8 + sizeof(int);
}

// the smallest table of at least twice a pass's (query, slot) cells, so
// that a probe ends within a few slots
int table_bits(int qb, int tc) {
  int log_h = 5;
  while (((size_t)1 << log_h) < 2 * (size_t)qb * tc) ++log_h;
  return log_h;
}

// #11: one pass when a block holds its queries' slots: the largest query
// block (at most kLookupQB, at most n_q) whose shared memory at tiles of kTN
// docs lets two blocks share an SM; else the largest that fits one block of
// kWarps warps; else of fewer warps. Past that (t_q past ~6,200), one query
// of kWarps warps a block, in the fewest passes whose slots fit.
bool lookup_geometry(int n_q, int t_q, LookupGeometry* g) {
  if (n_q <= 0 || t_q <= 0 || t_q > (1 << 20)) return false;
  const size_t budgets[2] = {kSmemTwo, kSmemMax};
  for (int warps = kWarps; warps >= 1; warps >>= 1) {
    for (const size_t budget : budgets) {
      if (budget == kSmemTwo && warps != kWarps) continue;
      for (int cap = kLookupQB; cap >= 1; cap >>= 1) {
        const int qb = cap < n_q ? cap : n_q;
        const int log_h = table_bits(qb, t_q);
        const size_t smem = lookup_smem(qb, t_q, warps, log_h, kTN);
        if (smem <= budget) {
          *g = {qb, warps, log_h, kTN, t_q, smem};
          return true;
        }
      }
    }
  }
  for (int rounds = 2;; ++rounds) {
    const int tc = (t_q + rounds - 1) / rounds;
    const int log_h = table_bits(1, tc);
    const size_t smem = lookup_smem(1, tc, kWarps, log_h, kTN);
    if (smem <= kSmemMax) {
      *g = {1, kWarps, log_h, kTN, tc, smem};
      return true;
    }
  }
}

// #10: #11's block over n docs, at the largest doc tile (kTN down to kMinTN,
// halving) whose grid holds kFillBlocks blocks; kMinTN when none does. A
// smaller tile only shrinks the keys, so #11's slots a pass fit. False past
// the grid (65,535 tiles).
bool flat_geometry(int n_q, int t_q, int n, LookupGeometry* g) {
  if (n <= 0 || !lookup_geometry(n_q, t_q, g)) return false;
  const long long q_blocks = (n_q + g->qb - 1) / g->qb;
  int tile = kTN;
  while (tile > kMinTN && q_blocks * ((n + tile - 1) / tile) < kFillBlocks)
    tile >>= 1;
  g->tile = tile;
  g->smem = lookup_smem(g->qb, g->tc, g->warps, g->log_h, tile);
  return (n + tile - 1) / tile <= 65535;
}

// The per-term kernel's launch into the tile lists (tile_s, tile_i), then
// the merge of each query's lists into its top k (res_s, res_i).
template <typename Kernel>
int launch_lookup(Kernel kernel, const LookupGeometry& g, const void* q_ids,
                  const void* q_vals, const void* doc_ids,
                  const void* doc_vals, void* tile_s, void* tile_i,
                  void* res_s, void* res_i, int n_q, int t_q, int n, int lrow,
                  int s_n, int kt, int k, void* stream) {
  const int n_tiles = (n + g.tile - 1) / g.tile;
  if (kt <= 0 || kt > g.tile || n_tiles > 65535 || k <= 0 ||
      (long long)k > (long long)n_tiles * kt) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_q + g.qb - 1) / g.qb, n_tiles);
  kernel<<<grid, 32 * g.warps, g.smem, st>>>(
      static_cast<const int32_t*>(q_ids), static_cast<const float*>(q_vals),
      static_cast<const int32_t*>(doc_ids),
      static_cast<const float*>(doc_vals), static_cast<float*>(tile_s),
      static_cast<int32_t*>(tile_i), n_q, t_q, n, lrow, s_n, kt, n_tiles,
      g.qb, g.log_h, g.tc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(tile_s, tile_i, n_q, n_tiles, kt, k, res_s, res_i, st);
}

// #10 or, with UNION, #12 over the flat ELL at flat_geometry's launch.
template <bool UNION>
int launch_flat(const void* q_ids, const void* q_vals, const void* doc_ids,
                const void* doc_vals, void* tile_s, void* tile_i, void* res_s,
                void* res_i, int n_q, int t_q, int n, int s_n, int ls, int kt,
                int k, void* stream) {
  LookupGeometry g;
  if (s_n != 1 || ls <= 0 || !flat_geometry(n_q, t_q, n, &g))
    return (int)cudaErrorInvalidValue;
#define PRT_FLAT(TN)                                                        \
  return launch_lookup(                                                     \
      g.tc < t_q                                                            \
          ? (UNION ? sparse_topk_union_walk_kernel<TN, true>                \
                   : sparse_topk_flat_kernel<TN, true>)                     \
          : (UNION ? sparse_topk_union_walk_kernel<TN, false>               \
                   : sparse_topk_flat_kernel<TN, false>),                   \
      g, q_ids, q_vals, doc_ids, doc_vals, tile_s, tile_i, res_s, res_i, n_q, \
      t_q, n, ls, 1, kt, k, stream)
  switch (g.tile) {
    case 256: PRT_FLAT(256);
    case 128: PRT_FLAT(128);
    case 64: PRT_FLAT(64);
    default: PRT_FLAT(32);
  }
#undef PRT_FLAT
}

// geo[7]: queries a block, docs a tile, threads a block, shared memory
// bytes, query blocks, table slots, query slots a pass
void report(const LookupGeometry& g, int n_q, int* geo) {
  geo[0] = g.qb;
  geo[1] = g.tile;
  geo[2] = 32 * g.warps;
  geo[3] = (int)g.smem;
  geo[4] = (n_q + g.qb - 1) / g.qb;
  geo[5] = 1 << g.log_h;
  geo[6] = g.tc;
}

}  // namespace

// q_ids (n_q, t_q) int32 (negative = pad), q_vals (n_q, t_q) f32;
// doc_ids / doc_vals (n, 1, ls) for the flat ELL, (n, s_n, ls) hashed;
// tile_s (n_q, ceil(n / tile), kt) f32 and tile_i the same shape int32 (the
// tile lists, scratch), with the tile the geometry entry reports (kTN for
// #11); res_s (n_q, k) f32 and res_i (n_q, k) int32 the merged top k,
// k <= ceil(n / tile) * kt. Each returns a cudaError_t.
extern "C" int prt_sparse_topk(const void* q_ids, const void* q_vals,
                               const void* doc_ids, const void* doc_vals,
                               void* tile_s, void* tile_i, void* res_s,
                               void* res_i, int n_q, int t_q, int n, int s_n,
                               int ls, int kt, int k, void* stream) {
  return launch_flat<false>(q_ids, q_vals, doc_ids, doc_vals, tile_s, tile_i,
                            res_s, res_i, n_q, t_q, n, s_n, ls, kt, k, stream);
}

// #12 (the union of the batch's terms) over the flat ELL: arguments, tile
// and limits as prt_sparse_topk (its geometry entry gives the launch).
extern "C" int prt_sparse_topk_union(const void* q_ids, const void* q_vals,
                                     const void* doc_ids,
                                     const void* doc_vals, void* tile_s,
                                     void* tile_i, void* res_s, void* res_i,
                                     int n_q, int t_q, int n, int s_n, int ls,
                                     int kt, int k, void* stream) {
  return launch_flat<true>(q_ids, q_vals, doc_ids, doc_vals, tile_s, tile_i,
                           res_s, res_i, n_q, t_q, n, s_n, ls, kt, k, stream);
}

// #11 (per term) or, with UNION, #13 over the hashed segments at
// lookup_geometry's launch.
template <bool UNION>
int launch_hashed(const void* q_ids, const void* q_vals, const void* doc_ids,
                  const void* doc_vals, void* tile_s, void* tile_i,
                  void* res_s, void* res_i, int n_q, int t_q, int n, int s_n,
                  int ls, int kt, int k, void* stream) {
  LookupGeometry g;
  if (n <= 0 || s_n <= 0 || ls <= 0 || (long long)s_n * ls > 2147483647LL ||
      !lookup_geometry(n_q, t_q, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool passes = g.tc < t_q;
  return launch_lookup(
      UNION ? (passes ? sparse_topk_union_lookup_kernel<true>
                      : sparse_topk_union_lookup_kernel<false>)
            : (passes ? sparse_topk_lookup_kernel<true>
                      : sparse_topk_lookup_kernel<false>),
      g, q_ids, q_vals, doc_ids, doc_vals, tile_s, tile_i, res_s, res_i, n_q,
      t_q, n, s_n * ls, s_n, kt, k, stream);
}

extern "C" int prt_sparse_topk_hashed(const void* q_ids, const void* q_vals,
                                      const void* doc_ids,
                                      const void* doc_vals, void* tile_s,
                                      void* tile_i, void* res_s, void* res_i,
                                      int n_q, int t_q, int n, int s_n,
                                      int ls, int kt, int k, void* stream) {
  return launch_hashed<false>(q_ids, q_vals, doc_ids, doc_vals, tile_s,
                              tile_i, res_s, res_i, n_q, t_q, n, s_n, ls, kt,
                              k, stream);
}

// #13 (the union of the batch's terms) over the hashed segments: arguments,
// tile and limits as prt_sparse_topk_hashed (whose geometry entry gives the
// launch).
extern "C" int prt_sparse_topk_union_hashed(
    const void* q_ids, const void* q_vals, const void* doc_ids,
    const void* doc_vals, void* tile_s, void* tile_i, void* res_s,
    void* res_i, int n_q, int t_q, int n, int s_n, int ls, int kt, int k,
    void* stream) {
  return launch_hashed<true>(q_ids, q_vals, doc_ids, doc_vals, tile_s,
                             tile_i, res_s, res_i, n_q, t_q, n, s_n, ls, kt, k,
                             stream);
}

// The launch prt_sparse_topk makes for n_q queries of t_q slots over n docs,
// into geo[7] (as report). Returns cudaErrorInvalidValue past the grid.
extern "C" int prt_sparse_topk_geometry(int n_q, int t_q, int n, int* geo) {
  LookupGeometry g;
  if (geo == nullptr || !flat_geometry(n_q, t_q, n, &g))
    return (int)cudaErrorInvalidValue;
  report(g, n_q, geo);
  return 0;
}

// The launch prt_sparse_topk_hashed makes for n_q queries of t_q slots, into
// geo[7] (as report). Returns cudaErrorInvalidValue past 2^20 slots.
extern "C" int prt_sparse_topk_hashed_geometry(int n_q, int t_q, int* geo) {
  LookupGeometry g;
  if (geo == nullptr || !lookup_geometry(n_q, t_q, &g))
    return (int)cudaErrorInvalidValue;
  report(g, n_q, geo);
  return 0;
}
