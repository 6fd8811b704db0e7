"""Tensor ops (resize) and the hand-written CUDA kernels (``ops.kernels``)."""
