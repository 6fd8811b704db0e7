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
the JAX package's quantized serving (:mod:`iseg_tpu_torch.ops.quant`); the
float path keeps them at one and does not apply them. int8 leaves load into
``QuantDense`` and ``QuantEmbed`` as int8 (the module's weight is replaced):

* W8A8 (``quantize_dense_tree``): an int8 ``kernel`` or ``embedding``
  array, with its real ``kernel_scale`` (shape ``features``, per output
  channel: ``(H, Dh)`` for a ``QuantDense((H, Dh))``) or ``embedding_scale``
  (``[V]``, per row) beside it;
* weight-only (``quantize_tree``): a ``QTensor`` ``(q, scale)`` leaf, its
  scale over the last flax axis: ``Dh`` alone for that ``(D, H, Dh)``
  kernel, ``D`` (per column) for the ``[V, D]`` table; kept as the
  module's ``weight_scale`` buffer in that shape.

A ``QTensor`` anywhere else (a conv kernel, a ``kernel_scale`` of 4096
values or more) is dequantized into the float tensor, as the JAX package's
``dequantize_tree`` would give it to the model. :func:`flax_tree` and
:func:`to_flax` give the int8 leaves back in the same forms.

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
from iseg_tpu_torch.ops.quant import QTensor, QuantDense, QuantEmbed, dequantize

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


def _int8_slots(model: nn.Module) -> dict[str, nn.Module]:
    """{flax path of a ``kernel`` / ``embedding``: the ``QuantDense`` /
    ``QuantEmbed`` that can hold it as int8}."""
    if isinstance(model, GemmaCausalLM):
        model = model.backbone
    out = {}
    for name, m in model.named_modules():
        prefix = name.replace(".", "/")
        prefix = prefix + "/" if prefix else ""
        if isinstance(m, QuantDense):
            out[prefix + "kernel"] = m
        elif isinstance(m, QuantEmbed):
            out[prefix + "embedding"] = m
    return out


def _is_qtensor(leaf) -> bool:
    """A ``QTensor`` of either package (numpy, JAX or torch parts)."""
    return isinstance(leaf, tuple) and hasattr(leaf, "q") and hasattr(leaf, "scale")


def _torch_leaf(raw) -> torch.Tensor:
    if isinstance(raw, torch.Tensor):
        return raw
    raw = np.asarray(raw)
    if raw.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 (JAX's): exact through fp32
        return torch.tensor(raw.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(raw)


@torch.no_grad()
def load_flax(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` in place from a flax ``{"params", "batch_stats"}`` tree
    of numpy (or array-like) leaves, or torch tensors (copied from where they
    are: a card's leaves never pass through the host). int8 leaves load as
    the module note says. Raises on a missing or unconsumed leaf and on a
    shape mismatch."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    pending = {col: flatten(variables.get(col, {})) for col in ("params", "batch_stats")}
    slots = _int8_slots(model)
    dequant_dtype = getattr(model, "dtype", None) or torch.bfloat16
    for col, path, tensor, _, from_flax in _leaves(model):
        if path not in pending[col]:
            raise KeyError(f"flax tree has no {col} leaf {path!r}")
        raw = pending[col].pop(path)
        scale = None
        if _is_qtensor(raw):
            raw, scale = _torch_leaf(raw.q), _torch_leaf(raw.scale)
        raw = _torch_leaf(raw)
        int8 = raw.dtype == torch.int8
        flax_ndim = getattr(from_flax, "flax_ndim", tensor.ndim)
        value = from_flax(raw) if raw.ndim == flax_ndim else None
        if value is None or tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{col}/{path}: flax shape {tuple(raw.shape)} does not map to "
                             f"the module's {tuple(tensor.shape)}")
        if int8 and path in slots and col == "params":
            # weight-only with a scale over the last flax axis, else W8A8
            # (its scale is the sibling *_scale leaf, loaded on its own)
            slots[path].set_int8(value, weight_scale=scale)
            continue
        if scale is not None:
            value = from_flax(dequantize(raw, scale, dequant_dtype))
        elif int8:
            raise TypeError(f"{col}/{path} is int8, and only a QuantDense kernel or a "
                            "QuantEmbed table holds int8")
        tensor.copy_(value)
    left = [f"{col}/{p}" for col, rest in pending.items() for p in rest]
    if left:
        raise KeyError(f"flax leaves not consumed by the module: {left}")
    return model


@torch.no_grad()
def flax_tree(model: nn.Module) -> dict[str, dict[str, Any]]:
    """The model's weights as a flax ``{"params", "batch_stats"}`` tree of
    torch tensors where they are, in their own dtypes (views where the
    layout change is one): the trees :mod:`iseg_tpu_torch.ops.quant`
    quantizes. int8 leaves come back as :func:`load_flax` takes them."""
    slots = _int8_slots(model)
    flat: dict[str, dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for col, path, tensor, to_flax_fn, _ in _leaves(model):
        value = to_flax_fn(tensor.detach())
        owner = slots.get(path)
        if value.dtype == torch.int8 and owner is not None and owner.weight_scale is not None:
            value = QTensor(value, owner.weight_scale)
        flat[col][path] = value
    return {col: unflatten(leaves) for col, leaves in flat.items()}


def to_flax(model: nn.Module) -> dict[str, dict[str, Any]]:
    """The model's weights as a flax ``{"params", "batch_stats"}`` tree of
    float32 numpy arrays (int8 leaves stay int8, weight-only ones a
    ``QTensor`` of int8 and float32 numpy arrays)."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.cpu() if t.dtype == torch.int8 else t.float().cpu()
        return t.contiguous().numpy()

    def leaf(v):
        return QTensor(host(v.q), host(v.scale)) if isinstance(v, QTensor) else host(v)

    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else leaf(node)

    return walk(flax_tree(model))
