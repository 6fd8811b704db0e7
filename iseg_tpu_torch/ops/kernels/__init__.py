"""Wrappers of the CUDA kernels in ``iseg_tpu_torch/csrc``: each takes its
plain PyTorch version for CPU tensors and launches its kernel for CUDA
tensors (or raises)."""
