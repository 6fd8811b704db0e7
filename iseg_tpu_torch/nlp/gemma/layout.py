"""Tensor-parallel layout of Gemma's weights (counterpart of
``iseg_tpu/nlp/gemma/layout.py``).

The JAX package places each leaf with a ``PartitionSpec`` chosen by the first
rule whose path regex matches (``LAYOUT_RULES``) and lets GSPMD shard the
computation to match. The port builds each rank's tensor-parallel modules at
their local shapes (``model.GemmaParallel``) and fills them with this rank's
slice of the full weights, cut by the same rules: :func:`shard_gemma_params`.

A spec here is a tuple of axis names or None, one per leading dimension of
the leaf (the JAX ``PartitionSpec`` entries). As in the JAX ``spec_for``, a
rule applies only where the spec is no longer than the leaf's rank, and a
leaf no rule matches is replicated (``()``): the int8 scales stay whole.
"""

from __future__ import annotations

import re
import zlib
from typing import Any

import numpy as np
import torch

from iseg_tpu_torch.parallel.mesh import MODEL_AXIS, axis_rank, axis_size

__all__ = ["LAYOUT_RULES", "get_layout_map", "layout_spec", "shard_gemma_leaf",
           "shard_gemma_params", "init_seeded_shard"]

# (path regex, spec): first match wins, as in the JAX package
LAYOUT_RULES: tuple[tuple[str, tuple], ...] = (
    (r"token_embedding/embedding", (MODEL_AXIS, None)),
    (r"attention/(query|key|value)/kernel", (None, MODEL_AXIS, None)),
    (r"attention/attention_output/kernel", (MODEL_AXIS, None, None)),
    (r"gating_ffw(_2)?/kernel", (None, MODEL_AXIS)),
    (r"ffw_linear/kernel", (MODEL_AXIS, None)),
)


def layout_spec(path: str, ndim: int) -> tuple:
    """The spec of the flax leaf at ``path`` (``"a/b/c"``) of rank ``ndim``,
    padded with None to ``ndim`` entries; ``()`` when replicated."""
    for pattern, spec in LAYOUT_RULES:
        if re.search(pattern, path) and len(spec) <= ndim:
            return (*spec, *([None] * (ndim - len(spec))))
    return ()


def _walk(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def get_layout_map(params: dict) -> dict:
    """The spec tree matching a flax ``params`` tree."""
    return _walk(params, lambda path, leaf: layout_spec(path, np.ndim(leaf)))


def shard_gemma_leaf(path: str, value: Any, mesh, axis: str = MODEL_AXIS) -> Any:
    """This rank's block of the full flax leaf ``value`` at ``path``: the
    dimension the layout puts on ``axis`` cut into ``mesh``'s axis size and
    indexed by this rank's coordinate (a view; numpy or torch). Raises where
    the dimension does not divide, as ``jax.device_put`` does."""
    spec = layout_spec(path, np.ndim(value))
    n = axis_size(mesh, axis)
    for dim, name in enumerate(spec):
        if name != axis or n == 1:
            continue
        size = value.shape[dim]
        if size % n:
            raise ValueError(f"{path}: dimension {dim} of shape {tuple(value.shape)} should be "
                             f"divisible by {n}, the {axis!r} axis size of the layout")
        per = size // n
        r = axis_rank(mesh, axis)
        index = [slice(None)] * np.ndim(value)
        index[dim] = slice(r * per, (r + 1) * per)
        value = value[tuple(index)]
    return value


def shard_gemma_params(params, mesh, axis: str = MODEL_AXIS) -> dict:
    """This rank's shard of full Gemma weights by :data:`LAYOUT_RULES`:
    ``params`` is a flax params tree (numpy from ``convert.to_flax`` or the
    JAX package, or torch tensors) or a full ``GemmaCausalLM`` /
    ``GemmaBackbone`` (its tensors, in the flax layout, without a copy). The
    result loads into the tensor-parallel model with ``convert.load_flax``."""
    if isinstance(params, torch.nn.Module):
        from iseg_tpu_torch.convert import _leaves, unflatten

        params = unflatten({path: to_flax(t.detach()) for col, path, t, to_flax, _
                            in _leaves(params) if col == "params"})
    return _walk(params, lambda path, leaf: shard_gemma_leaf(path, leaf, mesh, axis))


def leaf_seed(seed: int, name: str) -> int:
    """The generator seed of the weights at module path ``name``: the same on
    every rank and at every model parallelism."""
    return zlib.crc32(f"{seed}/{name}".encode())


@torch.no_grad()
def init_seeded_shard(lm, seed: int):
    """Fill a (tensor-parallel or whole) ``GemmaCausalLM`` with this rank's
    shard of random full weights: each weight-holding module of the full
    model is made on ``lm``'s device alone, drawn the way flax draws it
    (``nn.initializers``) from a generator seeded by ``(seed, its path)``,
    cut by :func:`shard_gemma_leaf` and copied in, one at a time. Every model
    parallelism gets the same full weights, so a tensor-parallel run and a
    world-size-1 run of the same seed compute the same function."""
    from iseg_tpu_torch.convert import _leaves
    from iseg_tpu_torch.nlp.gemma.causal_lm import GemmaCausalLM
    from iseg_tpu_torch.nn.initializers import initialize

    device = lm.device
    param_dtype = lm.backbone.token_embedding.embedding.dtype
    full = GemmaCausalLM(lm.config, dtype=lm.dtype, param_dtype=param_dtype, device="meta")
    mine = {path: (t, from_flax) for _, path, t, _, from_flax in _leaves(lm)}
    mesh = lm.parallel.mesh if lm.parallel.mp > 1 else None
    axis = lm.parallel.model_axis or MODEL_AXIS
    for name, m in full.backbone.named_modules():
        if not any(True for _ in m.parameters(recurse=False)):
            continue
        m.to_empty(device=device)
        gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
        initialize(m, gen)
        prefix = name.replace(".", "/") + "/"
        for _, path, t, to_flax, _ in _leaves(m):
            target, from_flax = mine.pop(prefix + path)
            target.copy_(from_flax(shard_gemma_leaf(prefix + path, to_flax(t), mesh, axis)))
        m.to_empty(device="meta")
    if mine:
        raise KeyError(f"leaves of the model not filled: {sorted(mine)}")
    return lm
