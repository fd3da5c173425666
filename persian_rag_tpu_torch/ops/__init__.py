"""Search operators and their hand-written CUDA kernels."""
