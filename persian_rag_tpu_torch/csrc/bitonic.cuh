// Block-wide bitonic sort of unique 64-bit keys in shared memory, shared by
// the top-k kernels (sparse_topk.cu, flat_topk_running.cu). Keys are unique
// (score order bits << 32 | ~id), so the sorted order is an exact,
// tie-ordered ranking: score descending, lower id first.
#pragma once

// Sort nseg contiguous segments of n (a power of two) keys descending.
__device__ inline void bitonic_desc(unsigned long long* keys, int n, int nseg) {
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < nseg * half; p += blockDim.x) {
        const int seg = p / half;
        const int q = p - seg * half;
        const int i = 2 * q - (q & (stride - 1));
        unsigned long long* base = keys + (size_t)seg * n;
        const unsigned long long a = base[i];
        const unsigned long long b = base[i + stride];
        const bool desc = (i & size) == 0;
        if (desc ? (a < b) : (a > b)) {
          base[i] = b;
          base[i + stride] = a;
        }
      }
    }
  }
  __syncthreads();
}
