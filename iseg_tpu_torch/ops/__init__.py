"""Tensor ops (resize, deformable sampling) and the hand-written CUDA kernels
(``ops.kernels``)."""
