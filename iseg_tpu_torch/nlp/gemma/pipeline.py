"""Pipeline-parallel Gemma training (counterpart of
``iseg_tpu/nlp/gemma/pipeline.py``).

The decoder stack is staged over a ``stage`` mesh axis with
:func:`iseg_tpu_torch.parallel.pipeline.pipeline_spmd`:

* the ``num_layers`` decoder blocks' weights are stacked into one tree with
  a leading layer axis, reshaped ``[stages, layers/stage]``
  (:func:`to_pipeline_params`); each rank holds its stage's slice and runs
  its layers in order;
* the embedding, the final norm and the tied readout are replicated
  (computed alike on every rank, outside the pipeline);
* only the ``[B, T]`` positions ride the pipeline, as per-microbatch
  constants (indexed locally, never sent); each stage builds the ``[mb, 1,
  T, T]`` causal mask and the rotary tables for its microbatch;
* one ``loss.backward()`` on every rank is the pipeline-parallel train
  step's backward: each stage's gradients land on its rank.

The trees are the flax layout (``convert.to_flax`` of a ``GemmaCausalLM``,
or the JAX package's), with torch (or numpy) leaves; the layers, the
embedding, the final norm and the readout run through
``torch.func.functional_call`` of the backbone's own modules on the meta
device, fed by ``convert.module_params_from_flax``'s views, so the
gradients land on the flax-layout leaves themselves.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import tree_leaves, tree_map

from iseg_tpu_torch.nlp.gemma.causal_lm import masked_nll_sums
from iseg_tpu_torch.nlp.gemma.config import GemmaConfig
from iseg_tpu_torch.nlp.gemma.model import GemmaDecoderBlock, causal_mask, rope_tables
from iseg_tpu_torch.nn.norm import RMSNorm
from iseg_tpu_torch.ops.quant import QuantEmbed
from iseg_tpu_torch.parallel.pipeline import pipeline_spmd

__all__ = ["to_pipeline_params", "from_pipeline_params", "stage_slice", "make_pp_loss_fn"]


def _stack(xs):
    return np.stack(xs) if isinstance(xs[0], np.ndarray) else torch.stack(xs)


def to_pipeline_params(params: dict, num_stages: int) -> tuple[dict, dict]:
    """Split a backbone's flax params into ``(staged, shared)``: ``staged``
    leaves ``[num_stages, layers_per_stage, ...]`` (the ``layer_i`` trees
    stacked), ``shared`` the embedding and the final norm."""
    layer_keys = sorted((k for k in params if k.startswith("layer_")),
                        key=lambda k: int(k.split("_")[1]))
    n_layers = len(layer_keys)
    if n_layers % num_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {num_stages} stages")
    lps = n_layers // num_stages

    def stack(*xs):
        return _stack(list(xs)).reshape(num_stages, lps, *xs[0].shape)

    staged = tree_map(stack, *[params[k] for k in layer_keys])
    shared = {k: v for k, v in params.items() if not k.startswith("layer_")}
    return staged, shared


def from_pipeline_params(staged: dict, shared: dict) -> dict:
    """Inverse of :func:`to_pipeline_params`."""
    s, lps = tree_leaves(staged)[0].shape[:2]
    flat = tree_map(lambda x: x.reshape(s * lps, *x.shape[2:]), staged)
    params = dict(shared)
    for i in range(s * lps):
        params[f"layer_{i}"] = tree_map(lambda x, i=i: x[i], flat)
    return params


def stage_slice(staged: dict, stage: int) -> dict:
    """Stage ``stage``'s layers of a staged tree: leaves ``[layers_per_stage,
    ...]``, what that stage's rank passes to the loss."""
    return tree_map(lambda x: x[stage], staged)


class _SharedEnds(nn.Module):
    """The replicated modules around the pipeline, under the shared tree's
    names: the embedding (lookup and tied readout) and the final norm."""

    def __init__(self, config: GemmaConfig, dtype, param_dtype):
        super().__init__()
        self.token_embedding = QuantEmbed(config.vocab_size, config.hidden_dim, dtype=dtype,
                                          param_dtype=param_dtype, device="meta")
        self.final_normalization = RMSNorm(config.hidden_dim,
                                           epsilon=config.layer_norm_epsilon,
                                           param_dtype=param_dtype, device="meta")

    def forward(self, x: torch.Tensor, readout: bool = False) -> torch.Tensor:
        """Token ids -> rows of the table, or (``readout``) hidden states ->
        fp32 logits through the final norm and the tied readout."""
        if not readout:
            return self.token_embedding(x)
        return self.token_embedding.attend(self.final_normalization(x).float())


def make_pp_loss_fn(config: GemmaConfig, mesh, stage_axis: str = "stage",
                    num_microbatches: int = 4, batch_axis: Optional[str] = None,
                    dtype=None, param_dtype=torch.float32, remat: bool = False):
    """Next-token LM loss with the decoder stack pipelined over
    ``stage_axis`` of ``mesh``.

    Returns ``loss_fn(stage_params, shared, token_ids, weights)``:
    ``stage_params`` is this rank's stage (:func:`stage_slice`), ``shared``
    the replicated leaves, ``token_ids`` / ``weights`` ``[B, T]`` the global
    batch on every rank. ``weights`` masks padding; the targets are
    ``token_ids`` shifted left. The loss is the same on every rank;
    ``backward()`` on every rank gives each rank its stage's gradients and
    the shared leaves' whole gradients. With ``batch_axis`` the stage
    gradients are summed over the data shards inside the backward.

    ``remat``: recompute each layer in the backward (``torch.utils.checkpoint``)
    so a stage keeps only its layers' inputs of every tick, not their
    activations; the same arithmetic.
    """
    from iseg_tpu_torch.convert import module_params_from_flax

    block = GemmaDecoderBlock(config, dtype=dtype, param_dtype=param_dtype, device="meta")
    ends = _SharedEnds(config, dtype, param_dtype)

    def stage_fn(p_stage, hidden, positions):
        # the mask and rotary tables of this microbatch, built here: no
        # [M, mb, 1, T, T] stack rides the replicated constants
        mask = causal_mask(positions.shape[1], positions)
        rope = rope_tables(positions, config.head_dim, config.rope_max_wavelength)
        for i in range(tree_leaves(p_stage)[0].shape[0]):
            layer = tree_map(lambda a, i=i: a[i], p_stage)
            if remat and torch.is_grad_enabled():
                hidden = checkpoint(run_layer, layer, hidden, rope, mask, use_reentrant=False)
            else:
                hidden = run_layer(layer, hidden, rope, mask)
        return hidden

    def run_layer(layer, hidden, rope, mask):
        params = module_params_from_flax(block, layer)
        return functional_call(block, params, (hidden, rope), {"mask": mask})[0]

    pp = pipeline_spmd(stage_fn, mesh, stage_axis, num_microbatches, batch_axis=batch_axis)

    def loss_fn(stage_params, shared, token_ids, weights):
        b, t = token_ids.shape
        positions = torch.arange(t, device=token_ids.device)[None].expand(b, t)
        ends_params = module_params_from_flax(ends, shared)
        x = functional_call(ends, ends_params, (token_ids,))
        x = x * float(torch.tensor(config.hidden_dim ** 0.5).to(x.dtype))
        x = pp(stage_params, x, const=positions)
        logits = functional_call(ends, ends_params, (x,), {"readout": True})
        total, count = masked_nll_sums(logits[:, :-1], token_ids[:, 1:], weights[:, 1:])
        return total / torch.clamp(count, min=1.0)

    return loss_fn
