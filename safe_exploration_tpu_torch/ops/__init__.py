"""L1 math: control linear algebra and the hand-written CUDA kernels."""
