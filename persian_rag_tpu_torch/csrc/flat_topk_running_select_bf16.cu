// The bf16-row instantiations of the exact / fast select kernel (#5,
// #6; running_select.cuh), in their own source so that nvcc builds them
// beside the others. flat_topk_running_select.cu holds the C entry.

#include "running_select.cuh"

cudaError_t running_select_bf16(const RunningSelectLaunch& l) {
  return launch_select<__nv_bfloat16>(l);
}
