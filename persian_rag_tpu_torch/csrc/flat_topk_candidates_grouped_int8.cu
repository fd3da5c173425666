// The int8-row instantiations of the grouped / lane-sliced stage 1 (#3;
// grouped_candidates.cuh), in their own source so that nvcc builds them
// beside the bf16 ones. flat_topk_candidates.cu holds the C entry and says
// what the kernel computes.

#include "grouped_candidates.cuh"

cudaError_t grouped_int8(const GroupedLaunch& l) {
  return launch_grouped<int8_t>(l);
}
