// Running top-k flat search: the regimes the two-stage path does not serve.
//
// Replaces the TPU Pallas kernels
//   persian_rag_tpu/ops/flat_topk.py::_topk_kernel             (mode "exact")
//   persian_rag_tpu/ops/flat_topk.py::_fast_topk_kernel        (mode "fast")
//   persian_rag_tpu/ops/flat_topk.py::_fast_insert_topk_kernel (mode "fasti")
//   persian_rag_tpu/ops/flat_topk.py::_fast_group_topk_kernel  (mode "fastg")
//   persian_rag_tpu/ops/flat_topk.py::_max_only_kernel         (mode "maxonly")
// reached through flat_topk_pallas, with _merge.py::merge_topk as their
// running merge. The port holds them to what they COMPUTE:
//
//   For every query, the k best corpus rows (k <= 128) by
//     s = q.c (dot), 2 q.c - ||c||^2 (l2), or scale[c] * q.c (int8 rows
//     with per-row scales), the contraction accumulated in f32; with bf16
//     compute both operands are rounded to bf16 first (products then exact).
//   exact: order (s descending, id ascending): bit-equal to a stable
//     descending sort of the kernel's own scores.
//   fast, fasti, fastg: order (ikey(s) & ~0x7FF descending, id ascending),
//     ikey the monotone f32 -> int32 map: scores truncated to their top 21
//     bits, and the returned score is the truncated one. A truncated tie
//     keeps the lower id, which is what the TPU kernel's strict '>' skips
//     and first-occurrence merges amount to. The three modes return the
//     same lists; they differ in how a tile's rows reach the running list.
//   maxonly: per query the largest s over the real rows (a floor: the
//     stream and the contraction without any top-k).
//   Scores are returned in MAXIMIZE space; the wrapper maps l2 back.
//
// The corpus is (N, d) or, with `trans`, (d, N) (the TPU's
// corpus_transposed layout). Only the staging of a chunk differs: in (d,
// N) the threads load the rows themselves (consecutive rows at one k), not
// by cp.async. The staged values and the FMA chain are the same, so both
// layouts give the same bits.
//
// Modes exact and fast (the TPU kernel walks the corpus tiles in grid order
// and carries the running top-k from one grid step to the next; its n_easy
// staging, residual proof and tile skip only cut the cost of that walk).
// Blocks on the GPU run in no order, so the walk becomes two passes over
// unique 64-bit keys (score order bits << 32 | ~id; exact mode folds -0
// into +0, so that no two keys tie and every sort below is an exact
// ranking):
//   1. running_select_kernel (flat_topk_running_select.cu, so that nvcc
//      builds its instantiations beside this file): a block streams one
//      segment of the corpus for its query block on stream_rows (the
//      register-blocked stream, below) and keeps each query's running top k
//      in shared memory, its k-th key a threshold that only the keys above
//      it pass; each segment's lists are written out.
//   2. merge_kernel: one block per (query, group of lists) sorts the
//      group's keys and keeps the top k, level by level until one list is
//      left; the last level decodes scores and ids.
// The top k of a union of lists lies in the union of their top k, so the
// result equals one sort of all N keys.
//
// Modes fasti and fastg carry the TPU kernels' mechanism: a running list
// that each tile of 256 rows updates with a few extracted candidates, and a
// residual check that falls back to a full extraction in the rare tile
// where an unextracted row could still enter. segment_topk_kernel
// (segment_topk.cuh) walks a segment's tiles in order, keeping each query's
// running list (unique 64-bit keys, as above) in shared memory, and
// merge_kernel merges the segment lists. The function is order-free, so
// the cut cannot change the result. A lane keeps its 8 packed tile keys
// per query in registers ((ikey & ~0x7FF) | reversed column, INT_MIN for a
// row past N); a rank is a warp shuffle-max and the owner's clear:
//   fasti: n_easy ranks are inserted one by one into the sorted list (one
//     shift per insertion); when the best key left beats the list's k-th
//     truncated score, ranks are extracted and inserted until one no
//     longer enters.
//   fastg: the tile is reduced to its per-slot top 2 (slot = column mod 16,
//     16 rows each: a lane's 8 keys share one slot and lanes l and l ^ 16
//     combine); n_easy ranks come from those 32 keys and merge into the
//     list by rank (binary search in the other list). When max(keys left,
//     max of the second level) beats the new list's k-th truncated score,
//     the tile's raw keys are extracted (up to k) and merged against the
//     PRE-merge list, as the TPU kernel does.
//   A rank that finds only INT_MIN ends the extraction: a row past N never
//   enters a list (the TPU kernels keyed such rows INT_MIN and decoded
//   them to NaN or 3e38 scores with duplicated ids when the last tile held
//   fewer real rows than n_easy; the port corrects that).
// maxonly (maxonly_kernel, in flat_topk_maxonly.cu so that nvcc builds it
// beside this file) keeps each query's maximum of the monotone int
// image of the scores of real rows only, with the row scales folded in
// (the TPU kernel scored pad rows 0 and ignored the scales; the port
// corrects both); a warp maximum and one atomicMax per (query, block)
// finish it, exact and order-free.
//
// What bounds them on the H100: 2 Q N d f32 FLOPs on the CUDA cores against
// N d bytes of corpus (4, 2 or 1 bytes each). At Q = 64, N = 100k, d = 384
// over int8 rows that is 4.9 GFLOP against 38 MB: far above the CUDA cores'
// f32 ridge, so the floor is the f32 FMA rate (0.073 ms at 67 TFLOP/s).
// Every mode scores on stream_rows (row_stream.cuh), the register-blocked
// stream: a block holds 64 queries (fewer where their lists or their whole
// width do not fit) k-major in shared memory; its 8 warps are 4 query
// groups x 2 row halves, and a thread keeps 16 queries x 4 rows (8 x 4 at
// 32) of accumulators, so four broadcast float4 loads of queries and one
// 16-byte load of 16 int8 K values per row feed 64 FMAs per K value, and a
// row value widened in registers (a byte permute and a subtraction) feeds
// 16 FMAs. Rows stay in their own type in shared memory, arrive in 256-row
// chunks through a cp.async ring of 64-byte row slabs (80-byte row stride:
// 8 lanes reading 8 rows hit 8 bank groups), and are rounded to bf16 under
// bf16 compute in registers. Every accumulator is one fmaf chain from 0 in
// ascending k, so maxonly's best score is exact mode's first, bit for bit,
// and the three fast modes' keys are equal, in both layouts (the (d, N)
// layout and rows of other than whole 16 bytes are staged by the threads
// instead). Only a tensor-core version would reach the bandwidth bound;
// its accumulation is not IEEE f32 in k order, so it would not keep exact
// mode's contract, nor the equality of the fast modes' keys with the plain
// versions'.
//
// fasti and fastg on the stream (segment_topk.cuh). The earlier segment
// kernel scored 16 queries a block on a 32-row chunk loop (a lane one
// staged row and 2 queries: a shared-memory load for each pair of FMAs,
// rows staged by the threads with no copy in flight), which measured 12.5%
// of the f32 floor, and streamed the corpus once per 16 queries. Here a
// stream_rows chunk of 256 rows is exactly one tile: when its chains are
// done, the threads write the tile's packed keys to a key tile in shared
// memory (QB x 256 int32, column 32 t + lane where tile_insert / tile_group
// read lane's key t), and a warp a query loads its 8 keys a lane and runs
// the mechanism above unchanged. A query whose tile maximum cannot enter
// its list skips the tile: could_enter(max, k-th) false makes every insert
// a no-op (fasti) and every merge return the list itself (fastg, whose
// query then keeps its list on its side: each query tracks which of its
// two lists is current). The query block (flat_topk.segment_geometry,
// passed in) follows Q, 32 in place of 64 where the whole width does not
// fit beside the key tile and the lists (so at d = 384 over int8 rows), and
// smaller where fastg's three lists of k keys a query do not fit (3 x 64 x
// 128 x 8 bytes is 192 KB); segments of whole tiles fill the card's
// resident blocks. The instantiations (row type x query block x copy path,
// the mode a runtime flag) are split by row type over this file and
// flat_topk_running_segment_bf16.cu / _int8.cu, so that nvcc builds them in
// parallel.

#include "bitonic.cuh"
#include "segment_topk.cuh"

namespace {

constexpr int kMergeThreads = 512;

__device__ __forceinline__ float key_score(u64 key) {
  const int ik = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
  return __int_as_float(ik < 0 ? (ik ^ 0x7FFFFFFF) : ik);
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)~(uint32_t)(key & 0xFFFFFFFFull);
}

// in: (n_q, n_lists, kk) keys. Block (g, query) sorts lists [g * group,
// (g + 1) * group) of its query in `seg` (a power of two) shared slots and
// writes the top kk: as keys to out_keys (n_q, n_groups, kk), or, on the
// last level (out_s given, one group), decoded to out_s / out_i (n_q, kk).
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const u64* __restrict__ in, u64* __restrict__ out_keys,
             float* __restrict__ out_s, int32_t* __restrict__ out_i,
             int n_lists, int kk, int group, int n_groups, int seg) {
  extern __shared__ u64 smem_u64[];
  u64* keys = smem_u64;
  const int g = blockIdx.x;
  const size_t qi = blockIdx.y;
  const int first = g * group;
  const int count = min(group, n_lists - first) * kk;
  const u64* src = in + (qi * n_lists + first) * kk;
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    keys[i] = i < count ? src[i] : 0ull;
  }
  bitonic_desc(keys, seg, 1);
  for (int r = threadIdx.x; r < kk; r += blockDim.x) {
    const u64 key = keys[r];
    if (out_s != nullptr) {
      out_s[qi * kk + r] = key == 0ull ? -3.0e38f : key_score(key);
      out_i[qi * kk + r] = key == 0ull ? -1 : key_id(key);
    } else {
      out_keys[(qi * n_groups + g) * kk + r] = key;
    }
  }
}

}  // namespace

cudaError_t segment_f32(const SegmentLaunch& l) {
  return launch_segment<float>(l);
}

// The segment kernel. mode 0 (fasti) and 1 (fastg): out (n_q, n_seg, k)
// keys of each segment's running list, n_seg = ceil(n / rows_per_seg), to
// be merged by prt_running_merge. q, c, cn, corpus_type, cn_mode,
// bf16_compute and trans as prt_running_tile_topk's
// (flat_topk_running_select.cu); qb (64, 32, 16 or 8) queries a block and
// rows_per_seg (a multiple of 256) rows a segment, flat_topk.
// segment_geometry's pick. Any d. Returns a cudaError_t;
// cudaErrorInvalidValue when the block at qb does not fit a block's shared
// memory even with one slab of queries.
extern "C" int prt_running_segment(const void* q, const void* c,
                                   const void* cn, void* out, int n_q, int n,
                                   int d, int k, int corpus_type, int cn_mode,
                                   int bf16_compute, int trans, int mode,
                                   int n_easy, int qb, int rows_per_seg,
                                   void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || mode < 0 || mode > 1 || k < 1 ||
      k > 32 * kMaxPerLane || k > n || n_easy < 1 || n_easy > kMaxEasy ||
      corpus_type < 0 || corpus_type > 2 || cn_mode < 0 || cn_mode > 2 ||
      (cn_mode != 0 && cn == nullptr) ||
      (qb != 64 && qb != 32 && qb != 16 && qb != 8) || rows_per_seg < 1 ||
      rows_per_seg % kSegTile != 0 ||
      (n + (long long)rows_per_seg - 1) / rows_per_seg > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  SegmentLaunch l = {static_cast<const float*>(q), c,
                     static_cast<const float*>(cn), cn_mode, bf16_compute,
                     trans, mode, static_cast<u64*>(out), n_q, n, d, k,
                     n_easy, qb, rows_per_seg, 0, 0,
                     static_cast<cudaStream_t>(stream)};
  l.smem = segment_smem_at(qb, d, corpus_type, k, mode, &l.wslabs);
  if (l.wslabs < 1) return (int)cudaErrorInvalidValue;
  switch (corpus_type) {
    case 0: return (int)segment_f32(l);
    case 1: return (int)segment_bf16(l);
    default: return (int)segment_int8(l);
  }
}

// Pass 2, one level. in: (n_q, n_lists, k) keys; groups of `group` lists
// are merged in `seg` shared slots (a power of two >= min(group, n_lists) *
// k, at most 16384). With out_s and out_i given (then group >= n_lists) the
// single merged list is decoded into them; else out_keys gets
// (n_q, ceil(n_lists / group), k) keys. Returns a cudaError_t.
extern "C" int prt_running_merge(const void* in, void* out_keys, void* out_s,
                                 void* out_i, int n_q, int n_lists, int k,
                                 int group, int seg, void* stream) {
  const bool last = out_s != nullptr;
  if (n_q <= 0 || n_q > 65535 || n_lists <= 0 || k < 1 || group < 1 ||
      seg < 2 || (seg & (seg - 1)) != 0 || seg > 16384 ||
      (long long)(group < n_lists ? group : n_lists) * k > seg || (last && out_i == nullptr) ||
      (last && group < n_lists) || (!last && out_keys == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_groups = (n_lists + group - 1) / group;
  const size_t smem = (size_t)seg * sizeof(u64);
  const cudaError_t err = allow_smem(merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_groups, n_q);
  merge_kernel<<<grid, kMergeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out_keys),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), n_lists, k,
      group, n_groups, seg);
  return (int)cudaGetLastError();
}
