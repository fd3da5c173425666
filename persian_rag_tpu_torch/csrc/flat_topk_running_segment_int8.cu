// The int8-row instantiations of the fasti / fastg segment kernel (#7,
// #8; segment_topk.cuh), in their own source so that nvcc builds them
// beside the others. flat_topk_running.cu holds the C entry.

#include "segment_topk.cuh"

cudaError_t segment_int8(const SegmentLaunch& l) {
  return launch_segment<int8_t>(l);
}
