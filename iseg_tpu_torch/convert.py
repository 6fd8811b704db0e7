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
====================  ===============================  ==========================

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

from iseg_tpu_torch.nn.norm import BatchNorm

_Leaf = tuple[str, str, torch.Tensor, Callable, Callable]


def _oihw_to_hwio(t):
    return t.permute(2, 3, 1, 0)


def _hwio_to_oihw(t):
    return t.permute(3, 2, 0, 1)


def _transpose(t):
    return t.t()


def _same(t):
    return t


def _leaves(model: nn.Module) -> Iterator[_Leaf]:
    """(collection, flax path, tensor, to_flax, from_flax) for every leaf."""
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
        elif (any(True for _ in m.parameters(recurse=False))
              or any(True for _ in m.buffers(recurse=False))):
            raise TypeError(f"no flax mapping for {name or 'the root'} ({type(m).__name__})")


def param_tree(model: nn.Module) -> dict[str, torch.Tensor]:
    """Flat {flax path: parameter} of the model, in module order."""
    return {path: t for col, path, t, _, _ in _leaves(model) if col == "params"}


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


@torch.no_grad()
def load_flax(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` in place from a flax ``{"params", "batch_stats"}`` tree
    of numpy (or array-like) leaves. Raises on a missing or unconsumed leaf
    and on a shape mismatch."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    pending = {col: flatten(variables.get(col, {})) for col in ("params", "batch_stats")}
    for col, path, tensor, _, from_flax in _leaves(model):
        if path not in pending[col]:
            raise KeyError(f"flax tree has no {col} leaf {path!r}")
        raw = np.asarray(pending[col].pop(path))
        value = from_flax(torch.tensor(raw)) if raw.ndim == tensor.ndim else None
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
