"""Weight bridge between flax variable trees and the port's modules.

A flax model's ``{"params": ..., "batch_stats": ...}`` tree (nested dicts of
arrays) maps onto the port's module of the same architecture by path: the
port's module names mirror the flax tree (``backbone/stem0/conv``,
``head/image_pool/conv/conv``, ``logits_conv``), and each leaf module
translates its own leaves:

====================  ===============================  ==========================
module                flax leaf (layout)               torch tensor (layout)
====================  ===============================  ==========================
``nn.Conv2d``         params ``kernel`` (HWIO;         ``weight`` (OIHW;
                      depthwise ``[kh,kw,1,C*m]``)     depthwise ``[C*m,1,kh,kw]``)
                      params ``bias``                  ``bias``
``nn.Linear``         params ``kernel`` ``[in,out]``   ``weight`` ``[out,in]``
                      params ``bias``                  ``bias``
``BatchNorm``         params ``scale``, ``bias``       ``weight``, ``bias``
                      batch_stats ``mean``, ``var``    ``running_mean``, ``running_var``
``nn.LayerNorm``      params ``scale``, ``bias``       ``weight``, ``bias``
``GroupNorm``,        params ``scale``, ``bias``       ``weight``, ``bias`` (over
``ChannelLayerNorm``, (``ChannelRMSNorm``: ``scale``   dim 1 of NCHW)
``ChannelRMSNorm``    alone)
``ConvNeXtBlock``     params ``gamma`` ``[dim]``       the parameter of that name
                      (layer scale; absent in V2)
``GlobalResponseNorm`` params ``gamma``, ``beta``      the parameters of those names
                      ``[C]``
``MOATAttention``     params ``rel_pos_embed``         the parameter of that name
                      ``[heads, 2p-1, 2p-1]`` (with
                      ``use_pos_emb``)
``WindowAttention``   params ``relative_position_      the parameter of that name
                      bias_table`` ``[(2ws-1)^2, H]``  (its index buffer is static)
``InternImageBlock``  params ``gamma1``, ``gamma2``    the parameters of those names
                      ``[dim]`` (layer scale; absent   (bare parameters of the block)
                      when ``layer_scale`` is None)
``DCNv2``             params ``kernel``                the parameters of those names
                      ``[K*K*C, filters]``, ``bias``
``Eva``, ViT          params ``pos_embed``             the parameters of those names
                      ``[1, prefix + grid², C]``,      (bare parameters of the
                      ``cls_token`` ``[1, 1, C]``      backbone; the SAM ViTs have
                                                       no class token)
``SelfAttention2D``   params ``gamma`` ``[]``          the parameter of that name
``QuantDense``        params ``kernel``                ``weight`` ``[prod(features),
                      ``(*contract, *features)``       prod(contract)]`` (reshape +
                                                       transpose)
                      params ``kernel_scale``          buffer ``kernel_scale`` (ones)
                      ``features``
``QuantEmbed``        params ``embedding`` ``[V, D]``  ``embedding``
                      params ``embedding_scale``       buffer ``embedding_scale``
                      ``[V]``                          (ones)
``RMSNorm`` (Gemma)   params ``scale``                 ``scale``
``MoEFeedForward``    params ``router`` ``[D, E]``,    the parameters of those names
                      ``w1`` ``[E, D, F]``, ``w2``     (an expert-parallel layer
                      ``[E, F, D]``                    holds its experts' rows:
                                                       ``moe.shard_experts``)
====================  ===============================  ==========================

An ``nn.Linear`` maps the same whichever axis it mixes: MLP-Mixer's
token-mixing ``token_fc1``/``token_fc2`` are ``nn.Linear`` over the
patch axis, their flax kernels ``[tokens, hidden]`` and ``[hidden, tokens]``.

A ``GemmaCausalLM`` converts as its backbone (the flax tree of the JAX
``GemmaCausalLM.init`` is the backbone's: ``token_embedding``, ``layer_i``,
``final_normalization``). The ``*_scale`` leaves carry the int8 scales of
the JAX package's quantized serving; the float path keeps them at one and
does not apply them, and an int8 leaf raises (ROADMAP queue 1 item 26).

:func:`load_flax` consumes every leaf on both sides or raises, so a
renamed or missing layer cannot pass silently. The same paths key the
optimizer (:func:`param_tree`), which is how the weight-decay mask makes
the JAX package's decisions.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from iseg_tpu_torch.backbones.convnext import ConvNeXtBlock
from iseg_tpu_torch.backbones.eva import Eva
from iseg_tpu_torch.backbones.intern_image import InternImageBlock
from iseg_tpu_torch.backbones.moat import MOATAttention
from iseg_tpu_torch.backbones.swin import WindowAttention
from iseg_tpu_torch.backbones.vit import VisionTransformer
from iseg_tpu_torch.nlp.gemma.causal_lm import GemmaCausalLM
from iseg_tpu_torch.nn.attention import SelfAttention2D
from iseg_tpu_torch.nn.blocks import GlobalResponseNorm
from iseg_tpu_torch.nn.dcn import DCNv2
from iseg_tpu_torch.nn.moe import MoEFeedForward
from iseg_tpu_torch.nn.norm import BatchNorm, ChannelLayerNorm, ChannelRMSNorm, GroupNorm, RMSNorm
from iseg_tpu_torch.ops.quant import QuantDense, QuantEmbed

_Leaf = tuple[str, str, torch.Tensor, Callable, Callable]


def _oihw_to_hwio(t):
    return t.permute(2, 3, 1, 0)


def _hwio_to_oihw(t):
    return t.permute(3, 2, 0, 1)


def _transpose(t):
    return t.t()


def _same(t):
    return t


def _dense_general(m: QuantDense) -> tuple[Callable, Callable]:
    """(to_flax, from_flax) between ``weight [N, K]`` and the flax kernel
    ``(*contract, *features)``; from_flax gives None for another shape."""
    shape = (*m.contract, *m.features)

    def to_flax(t):
        return t.t().reshape(shape)

    def from_flax(t):
        if tuple(t.shape) != shape:
            return None
        return t.reshape(m.weight.shape[1], m.weight.shape[0]).t()

    from_flax.flax_ndim = len(shape)
    return to_flax, from_flax


def _leaves(model: nn.Module) -> Iterator[_Leaf]:
    """(collection, flax path, tensor, to_flax, from_flax) for every leaf."""
    if isinstance(model, GemmaCausalLM):
        model = model.backbone
    for name, m in model.named_modules():
        prefix = name.replace(".", "/")
        prefix = prefix + "/" if prefix else ""
        if isinstance(m, nn.Conv2d):
            yield "params", prefix + "kernel", m.weight, _oihw_to_hwio, _hwio_to_oihw
            if m.bias is not None:
                yield "params", prefix + "bias", m.bias, _same, _same
        elif isinstance(m, nn.Linear):
            yield "params", prefix + "kernel", m.weight, _transpose, _transpose
            if m.bias is not None:
                yield "params", prefix + "bias", m.bias, _same, _same
        elif isinstance(m, BatchNorm):
            yield "params", prefix + "scale", m.weight, _same, _same
            yield "params", prefix + "bias", m.bias, _same, _same
            yield "batch_stats", prefix + "mean", m.running_mean, _same, _same
            yield "batch_stats", prefix + "var", m.running_var, _same, _same
        elif isinstance(m, (nn.LayerNorm, GroupNorm, ChannelLayerNorm, ChannelRMSNorm)):
            yield "params", prefix + "scale", m.weight, _same, _same
            if m.bias is not None:
                yield "params", prefix + "bias", m.bias, _same, _same
        elif isinstance(m, WindowAttention):
            yield ("params", prefix + "relative_position_bias_table",
                   m.relative_position_bias_table, _same, _same)
        elif isinstance(m, (InternImageBlock, DCNv2, VisionTransformer, Eva, SelfAttention2D,
                            ConvNeXtBlock, GlobalResponseNorm, MOATAttention, MoEFeedForward)):
            # bare parameters of the module itself, named as in the flax tree
            for leaf, param in m.named_parameters(recurse=False):
                yield "params", prefix + leaf, param, _same, _same
        elif isinstance(m, QuantDense):
            yield ("params", prefix + "kernel", m.weight, *_dense_general(m))
            yield "params", prefix + "kernel_scale", m.kernel_scale, _same, _same
            if m.bias is not None:
                yield "params", prefix + "bias", m.bias, _same, _same
        elif isinstance(m, QuantEmbed):
            yield "params", prefix + "embedding", m.embedding, _same, _same
            yield "params", prefix + "embedding_scale", m.embedding_scale, _same, _same
        elif isinstance(m, RMSNorm):
            yield "params", prefix + "scale", m.scale, _same, _same
        elif (any(True for _ in m.parameters(recurse=False))
              or any(True for _ in m.buffers(recurse=False))):
            raise TypeError(f"no flax mapping for {name or 'the root'} ({type(m).__name__})")


def param_tree(model: nn.Module) -> dict[str, torch.Tensor]:
    """Flat {flax path: parameter} of the model, in module order (the
    buffers that ride in the flax ``params`` collection are left out)."""
    return {path: t for col, path, t, _, _ in _leaves(model)
            if col == "params" and isinstance(t, nn.Parameter)}


def batch_stats_tree(model: nn.Module) -> dict[str, torch.Tensor]:
    """Flat {flax path: BN running statistic} of the model."""
    return {path: t for col, path, t, _, _ in _leaves(model) if col == "batch_stats"}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
    """{"a/b/c": leaf} -> nested dict."""
    out: dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def module_params_from_flax(model: nn.Module, params: Mapping[str, Any]) -> dict[str, Any]:
    """``{parameter name: tensor}`` of ``model`` from a flax ``params`` tree
    of torch tensors, by :func:`load_flax`'s rules but without a copy: the
    reshapes and transposes are views, so the result feeds
    ``torch.func.functional_call`` and gradients land on the flax-layout
    leaves (the pipeline's staged trees)."""
    flat = flatten(params)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for col, path, tensor, _, from_flax in _leaves(model):
        if col != "params" or id(tensor) not in names:
            continue
        if path not in flat:
            raise KeyError(f"flax tree has no params leaf {path!r}")
        value = from_flax(flat[path])
        if value is None or tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"params/{path}: flax shape {tuple(flat[path].shape)} does not map "
                             f"to the module's {tuple(tensor.shape)}")
        out[names[id(tensor)]] = value
    return out


@torch.no_grad()
def load_flax(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` in place from a flax ``{"params", "batch_stats"}`` tree
    of numpy (or array-like) leaves, or torch tensors (copied from where they
    are: a card's leaves never pass through the host). Raises on a missing
    or unconsumed leaf and on a shape mismatch."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    pending = {col: flatten(variables.get(col, {})) for col in ("params", "batch_stats")}
    for col, path, tensor, _, from_flax in _leaves(model):
        if path not in pending[col]:
            raise KeyError(f"flax tree has no {col} leaf {path!r}")
        raw = pending[col].pop(path)
        if not isinstance(raw, torch.Tensor):
            raw = np.asarray(raw)
        if raw.dtype in (np.int8, torch.int8):
            raise NotImplementedError(
                f"{col}/{path} is int8: the int8 serving paths are not in the port yet "
                "(ROADMAP queue 1 item 26)")
        flax_ndim = getattr(from_flax, "flax_ndim", tensor.ndim)
        raw = raw if isinstance(raw, torch.Tensor) else torch.tensor(raw)
        value = from_flax(raw) if raw.ndim == flax_ndim else None
        if value is None or tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{col}/{path}: flax shape {raw.shape} does not map to "
                             f"the module's {tuple(tensor.shape)}")
        tensor.copy_(value)
    left = [f"{col}/{p}" for col, rest in pending.items() for p in rest]
    if left:
        raise KeyError(f"flax leaves not consumed by the module: {left}")
    return model


@torch.no_grad()
def to_flax(model: nn.Module) -> dict[str, dict[str, Any]]:
    """The model's weights as a flax ``{"params", "batch_stats"}`` tree of
    float32 numpy arrays."""
    flat: dict[str, dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for col, path, tensor, to_flax_fn, _ in _leaves(model):
        flat[col][path] = to_flax_fn(tensor.detach().float().cpu()).contiguous().numpy()
    return {col: unflatten(leaves) for col, leaves in flat.items()}
