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
// corpus_transposed layout). In (d, N), and for (n, d) rows of other than
// whole 16-byte pieces, the stream stages the rows by the threads instead
// of cp.async; the staged values and the FMA chain are the same, so both
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
//     for the int8 tier): the int8 values widen exactly to f32 in
//     registers and the same loop runs; bf16 x int8 products are exact in
//     f32 (8 + 7 significand bits), the sum is one f32 FMA chain in k
//     order, then one f32 multiply by the row's scale. No proof rests on this variant (the int8 tier
//     refines its candidates exactly); a library matmul sums in another
//     order, so a key may differ from the plain version's by one quantum.
//   * Tensor-core (wgmma / mma) accumulation is NOT used: Hopper's tensor
//     cores do not round each addition to nearest f32, so a kernel that
//     uses them must re-derive both bounds first.
//
// What bounds it on the H100: the scores are f32 FMAs on the CUDA cores,
// 2 Q N d FLOPs against 2 N d bytes of corpus (N d for int8 rows). At
// Q = 64, N = 100k, d = 384 that is 4.9 GFLOP over a 77 MB bf16 image:
// the f32 floor, 0.073 ms at 67 TFLOP/s, above the 0.023 ms of the bytes.
// (Only a tensor-core version would reach the bandwidth bound.) The
// earlier kernel gave a lane one staged row of a 32-row chunk and 2 of 16
// queries, a shared-memory load for each pair of FMAs, staged rows by the
// threads between two barriers with no copy in flight, and streamed the
// corpus once per 16 queries. Here:
//   * scoring is row_stream.cuh's stream_rows<CT, QB, ASYNC>, the stream of
//     #1, #4, #5, #6 and #9: QB queries k-major in shared memory, 256-row
//     chunks through a cp.async ring, a thread's TQ x 4 chains in
//     registers, and query windows past what a block holds, so any d. The
//     chain is the earlier kernel's (bf16(q_k) c_k added by fmaf from +0, k
//     ascending; int8 values widen to f32 exactly as they did to bf16), so
//     the keys are its keys bit for bit (flat_topk.grouped_chain_candidates
//     mirrors them);
//   * the slot reduction needs a whole tile, so a block keeps one (query
//     block, tile): blockIdx.x walks the query blocks so blocks running
//     together share a tile in L2, and the table of a tile stays in shared
//     memory (QB x min(depth, group) x C int32: 24 KB at 16 queries, tile
//     2,048, (16, 3)). A part of a tile would have to carry whole slot
//     tables (about 12 GB at the lane pick's 2,048 queries over 1M rows);
//   * when a chunk's chains are done (stream_rows' finish), a thread's
//     keys go into the table: its rows i = 0..3 lie 32 i columns apart, so
//     the rows that share a slot (all four where C divides 32, two and two
//     at C = 64) are merged in registers first; then each carry goes down its
//     slot's levels (a merge of two sorted lists, no atomics). The row
//     halves take turns (their rows can share a slot); lanes of one step
//     hit distinct slots where C >= 32, else take turns of C lanes;
//   * the tile's end is one pass per lane over the table keeping its top
//     n_easy+1 in registers, then n_easy+1 rounds of a warp maximum (the
//     tile's top n_easy+1 lies in the union of the per-lane top n_easy+1,
//     so the merge is exact);
//   * two blocks an SM where shared memory lets them: while one block's
//     row halves take turns at the table, the other streams (on the H100,
//     scripts/grouped_qb.py: two blocks of 16 queries an SM beat one of 32
//     at the lane pick, 64.2 against 70.4 ms; with two an SM, 32 beat 16
//     at Q = 512, 1.297 against 1.550). The query block
//     (flat_topk.grouped_geometry, passed in): 32 by Q, 16 where the whole
//     width does not let two blocks share an SM (the lane pick's table);
//     halved while the grid holds fewer blocks than the card has SMs;
//     halved where not one slab of queries fits.
// No (Q, N) score matrix is ever written: the output is (n_easy+1) ints
// per (query, tile). The instantiations (row type x query block x copy
// path) are split by row type over this file and
// flat_topk_candidates_grouped_int8.cu (the kernel is
// grouped_candidates.cuh), so that nvcc builds them in parallel.

#include "grouped_candidates.cuh"

namespace {

bool bad_shape(int n_q, int n, int d, int tile_n, int n_easy) {
  return n_q <= 0 || n <= 0 || d <= 0 || tile_n <= 0 || tile_n > 2048 ||
         tile_n % 32 != 0 || n_easy < 1 || n_easy + 1 > kMaxNE1 ||
         (n + tile_n - 1) / tile_n > 65535;
}

bool bad_qb(int qb) { return qb != 32 && qb != 16 && qb != 8; }

// The grouped block's shared memory at qb queries, for bf16 (scaled 0) or
// int8 (scaled 1) rows; *wslabs gets its query window's slabs (0 when not
// one slab fits).
size_t grouped_block(int d, int tile_n, int group, int depth, int scaled,
                     int qb, int* wslabs) {
  const int levels = depth < group ? depth : group;
  const int kse = slab_values(scaled ? 2 : 1);
  return grouped_smem_at(qb, d, kse, levels * (tile_n / group), wslabs);
}

}  // namespace

cudaError_t grouped_bf16(const GroupedLaunch& l) {
  return launch_grouped<__nv_bfloat16>(l);
}

// The grouped kernel's block at qb queries (32, 16 or 8) for rows of
// width d, bf16 (scaled 0) or int8 (scaled 1), into geo[2]: the K values of
// its query window (all of d's, rounded up to whole slabs, where they fit)
// and its shared memory bytes. Returns cudaErrorInvalidValue when not one
// slab of queries fits beside the ring and the key table, or on a bad
// shape.
extern "C" int prt_grouped_geometry(int d, int tile_n, int group, int depth,
                                    int scaled, int qb, int* geo) {
  if (geo == nullptr || d <= 0 || tile_n <= 0 || group < 1 ||
      tile_n % group != 0 || depth < 1 || bad_qb(qb)) {
    return (int)cudaErrorInvalidValue;
  }
  int wslabs = 0;
  const size_t smem =
      grouped_block(d, tile_n, group, depth, scaled, qb, &wslabs);
  if (wslabs < 1) return (int)cudaErrorInvalidValue;
  geo[0] = wslabs * slab_values(scaled ? 2 : 1);
  geo[1] = (int)smem;
  return 0;
}

// The grouped / lane-sliced kernel. c: bf16 rows with cn ||c||^2 (l2) or
// NULL (dot), or, with scaled, int8 rows with cn their per-row scales; (n, d)
// or, with trans, (d, n). group divides tile_n; depth >= 1; qb queries a
// block (flat_topk.grouped_geometry's pick); any d (the queries staged a
// window at a time past what fits beside the ring and the key table). out
// as above. Returns a cudaError_t.
extern "C" int prt_extract_candidates_grouped(const void* q, const void* c,
                                              const void* cn, void* out,
                                              int n_q, int n, int d,
                                              int tile_n, int n_easy,
                                              int group, int depth,
                                              int scaled, int trans, int qb,
                                              void* stream) {
  if (bad_shape(n_q, n, d, tile_n, n_easy) || group < 1 ||
      tile_n % group != 0 || depth < 1 || bad_qb(qb) ||
      (scaled && cn == nullptr) ||
      (n_q + (long long)qb - 1) / qb > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  GroupedLaunch l = {static_cast<const float*>(q), c,
                     static_cast<const float*>(cn),
                     scaled ? 2 : (cn != nullptr ? 1 : 0), trans,
                     static_cast<int32_t*>(out), n_q, n, d, tile_n, n_easy,
                     group, depth, qb, 0, 0,
                     static_cast<cudaStream_t>(stream)};
  l.smem = grouped_block(d, tile_n, group, depth, scaled, qb, &l.wslabs);
  if (l.wslabs < 1) return (int)cudaErrorInvalidValue;  // the key table
  return (int)(scaled ? grouped_int8(l) : grouped_bf16(l));
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
