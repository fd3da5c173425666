"""persian_rag_tpu_torch — the PyTorch + CUDA port of persian_rag_tpu.

The port serves the same dense exact retrieval as the JAX package, on an
NVIDIA H100: PyTorch for the plain tensor code and hand-written CUDA
kernels (``csrc/``) where the JAX package used Pallas kernels. It imports
torch and numpy only, never JAX or the JAX package, so it runs on a
machine that has neither installed.
"""

__version__ = "0.1.0"
