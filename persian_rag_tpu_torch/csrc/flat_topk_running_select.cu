// Running top-k, modes exact and fast (#5, #6): a register-blocked stream
// with a threshold-filtered running list.
//
// Replaces the TPU Pallas kernels
//   persian_rag_tpu/ops/flat_topk.py::_topk_kernel       (mode "exact")
//   persian_rag_tpu/ops/flat_topk.py::_fast_topk_kernel  (mode "fast")
// reached through flat_topk_pallas. What they compute is in the header of
// flat_topk_running.cu (the family's file): for every query the k <= 128
// best rows by unique 64-bit keys (score order bits << 32 | ~id; exact mode
// folds -0 into +0, fast mode masks the low 11 bits of the score's int
// key), each score finish_score of ONE fmaf chain from +0 in ascending k.
//
// What bounds it on the H100: 2 Q N d f32 FMAs on the CUDA cores against
// N d bytes of rows (4.9 GFLOP against 38 MB at Q = 64, N = 100k, d = 384
// over int8 rows: the f32 floor, 0.073 ms at 67 TFLOP/s). The earlier
// kernel scored 16 queries a block on a 32-row chunk loop (a lane one
// staged row, a shared-memory load an FMA pair, no copy in flight) and
// sorted every 256-row tile's 16 x 256 keys bitonically in shared memory,
// writing k keys a (query, tile). Here:
//   * scoring is row_stream.cuh's stream_rows<CT, QB, ASYNC>, the stream of
//     #9, #1 and #4: QB queries k-major in shared memory, 256-row chunks
//     through a cp.async ring, a thread's TQ x 4 chains in registers, and
//     query windows past what a block holds, so any d; the chain is the
//     earlier loop's, so the keys are the earlier kernel's bit for bit;
//   * a block streams one contiguous segment of the corpus for its query
//     block; the segments fill the card's resident blocks
//     (flat_topk.running_geometry), and merge_kernel (flat_topk_running.cu)
//     merges the segments' lists: the top k of a union lies in the union of
//     the top k's, so the result is one sort of all N keys, whatever the
//     segmentation;
//   * selection is a running list a query in shared memory whose k-th key
//     is a threshold (the idea of FAISS's WarpSelect / BlockSelect: Johnson,
//     Douze, Jegou, "Billion-scale similarity search with GPUs", 2017).
//     When a chunk's chains are done, each thread compares its keys with
//     their queries' thresholds; only keys above one are queued (a slot by
//     a warp ballot's prefix, each row half in its own share of the
//     queue), and a warp a query merges its queue into the sorted list by
//     rank (each key's place is its rank in its own list plus the keys
//     above it in the other), which raises the threshold. A queue holds k
//     rounded up to 32 keys; what does not fit waits for the next round,
//     and a round repeats until no thread holds a key that still enters.
//     The loops over a thread's 64 keys are unrolled from registers: over
//     a local-memory copy the same work took ~2.8x the cycles a chunk on
//     the H100. The compare is on the whole key, so a
//     row that ties the k-th score with a lower id enters. A query whose
//     list is not yet full first takes a bound from the chunk itself (k <=
//     32: the k-th largest high word of a warp's lane maxima), so a
//     segment's first chunk does not queue all its rows.
// Shared memory: the query window, the ring, then QB lists of k keys, QB
// queues, a warp's sorted queue, the QB thresholds and the row halves'
// queue counts. The instantiations are split by row type over this file
// and flat_topk_running_select_bf16.cu / _int8.cu (the kernel is
// running_select.cuh), so that nvcc builds them in parallel. 64
// queries a block where their whole width fits beside the rest, else 32
// (flat_topk.running_geometry picks the block by Q and k). No tensor cores:
// their accumulation is not IEEE f32 in k order.

#include "running_select.cuh"

namespace {

// The block's shared memory past the query window and the ring.
size_t select_bytes(int qb, int kk, int qcap) {
  return ((size_t)qb * kk + (size_t)qb * qcap + (size_t)kWarps * qcap +
          (size_t)qb) * sizeof(u64) + (size_t)2 * qb * sizeof(int);
}

// A block's shared memory at QB queries: the query window (wslabs slabs),
// the ring and the selection's lists, queues, thresholds and counts; 0
// (and *wslabs 0) when not one slab of queries fits beside the rest.
template <int QB>
size_t running_smem(int d, int corpus_type, int kk, int qcap, int* wslabs) {
  typedef StreamShape<QB> S;
  const int kse = slab_values(corpus_type);
  const size_t slab = (size_t)kse * S::QS * sizeof(float);
  const size_t rest =
      (size_t)S::STAGES * S::STAGE + select_bytes(QB, kk, qcap);
  *wslabs = 0;
  if (rest + slab > kMaxSmem) return 0;
  *wslabs = window_slabs((d + kse - 1) / kse, slab, rest);
  return *wslabs * slab + rest;
}

size_t running_smem_at(int qb, int d, int corpus_type, int kk, int qcap,
                       int* wslabs) {
  switch (qb) {
    case 64: return running_smem<64>(d, corpus_type, kk, qcap, wslabs);
    case 32: return running_smem<32>(d, corpus_type, kk, qcap, wslabs);
    case 16: return running_smem<16>(d, corpus_type, kk, qcap, wslabs);
    default: return running_smem<8>(d, corpus_type, kk, qcap, wslabs);
  }
}

}  // namespace

cudaError_t running_select_f32(const RunningSelectLaunch& l) {
  return launch_select<float>(l);
}

// Modes exact (fast 0) and fast (fast 1). q: (n_q, d) f32; c: (n, d) rows
// (or, with trans, (d, n)) of corpus_type 0 f32, 1 bf16, 2 int8; cn: (n,)
// f32 per cn_mode (0: unused, 1: ||c||^2, 2: row scales); qb (64, 32, 16 or
// 8) queries a block, qcap keys a query's queue (a multiple of 32, k <=
// qcap <= 128) and rows_per_seg rows a segment (flat_topk.
// running_geometry's pick); out: (n_q, ceil(n / rows_per_seg), k) keys of
// each segment's top k, descending, 0 = no row, to be merged by
// prt_running_merge. Any d. Returns a cudaError_t; cudaErrorInvalidValue
// when the block at qb does not fit a block's shared memory even with one
// slab of queries.
extern "C" int prt_running_tile_topk(const void* q, const void* c,
                                     const void* cn, void* out, int n_q, int n,
                                     int d, int k, int corpus_type,
                                     int cn_mode, int bf16_compute, int fast,
                                     int trans, int qb, int qcap,
                                     int rows_per_seg, void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k < 1 || k > kMaxK || k > n ||
      corpus_type < 0 || corpus_type > 2 || cn_mode < 0 || cn_mode > 2 ||
      (cn_mode != 0 && cn == nullptr) ||
      (qb != 64 && qb != 32 && qb != 16 && qb != 8) || qcap < k ||
      qcap > kMaxK || qcap % 32 != 0 || rows_per_seg < 1 ||
      (n + (long long)rows_per_seg - 1) / rows_per_seg > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  RunningSelectLaunch l = {static_cast<const float*>(q), c,
                           static_cast<const float*>(cn), cn_mode,
                           bf16_compute, fast, trans,
                           static_cast<unsigned long long*>(out), n_q, n, d,
                           k, qb, qcap, rows_per_seg, 0, 0,
                           static_cast<cudaStream_t>(stream)};
  l.smem = running_smem_at(qb, d, corpus_type, k, qcap, &l.wslabs);
  if (l.wslabs < 1) return (int)cudaErrorInvalidValue;
  switch (corpus_type) {
    case 0: return (int)running_select_f32(l);
    case 1: return (int)running_select_bf16(l);
    default: return (int)running_select_int8(l);
  }
}
