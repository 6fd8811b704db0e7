"""PyTorch + CUDA port of ``iseg_tpu`` for NVIDIA Hopper (H100).

Subpackages mirror ``iseg_tpu``: ``core``, ``nn``, ``nn.heads``,
``backbones``, ``losses``, ``metrics``, ``ops``, ``nlp`` (the Gemma causal
LM: cached generation, samplers, tokenizer). The package imports torch and
numpy only, never jax or the JAX package. ``csrc/`` holds the hand-written CUDA
kernels, built on first use into ``_build/``.
"""
