"""Gemma causal LM: backbone (RoPE + GQA attention, GeGLU FFN, RMSNorm) with
KV-cache generation, the samplers, and the SentencePiece tokenizer; tensor
and sequence parallelism (``model.GemmaParallel``), the tensor-parallel
layout (:mod:`.layout`) and the pipeline-parallel loss (:mod:`.pipeline`).

Counterpart of ``iseg_tpu/nlp/gemma``. int8 serving, weight-only and W8A8,
loads a quantized tree into the model (``ops.quant.quantize_tree`` or
``quantize_dense_tree`` of ``convert.flax_tree(lm)["params"]``, then
``convert.load_flax``); :mod:`.quant` is the JAX package's alias of the
weight-only quantizer.
"""

from iseg_tpu_torch.nlp.gemma.causal_lm import GemmaCausalLM
from iseg_tpu_torch.nlp.gemma.config import GEMMA_PRESETS, GemmaConfig, get_preset
from iseg_tpu_torch.nlp.gemma.layout import get_layout_map, shard_gemma_params
from iseg_tpu_torch.nlp.gemma.model import GemmaBackbone, GemmaParallel
from iseg_tpu_torch.nlp.gemma.samplers import (
    BeamSampler,
    ContrastiveSampler,
    GreedySampler,
    RandomSampler,
    Sampler,
    TopKSampler,
    TopPSampler,
    get_sampler,
)

__all__ = [
    "GemmaConfig",
    "GEMMA_PRESETS",
    "get_preset",
    "GemmaBackbone",
    "GemmaCausalLM",
    "GemmaParallel",
    "get_layout_map",
    "shard_gemma_params",
    "Sampler",
    "GreedySampler",
    "RandomSampler",
    "TopKSampler",
    "TopPSampler",
    "BeamSampler",
    "ContrastiveSampler",
    "get_sampler",
]
