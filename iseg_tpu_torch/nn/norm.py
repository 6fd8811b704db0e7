"""Normalization layers + factory (counterpart of ``iseg_tpu/nn/norm.py``).

:class:`BatchNorm` is written here rather than taken from ``torch.nn``,
because it must behave like flax's ``nn.BatchNorm`` with Keras defaults:

* momentum is the Keras one: ``running = m * running + (1 - m) * batch``
  with m = 0.99 by default;
* the running variance is updated with the BIASED batch variance;
* a batch with one value per channel (the image-pool branch at N=1) is
  allowed in training;
* the moments are computed in fp32 whatever the compute dtype (under bf16
  autocast), and the output returns in the input's dtype.

On one card BatchNorm and SyncBatchNorm are the same layer.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn

_DEFAULT_NORM = "sync_batch_norm"
_BN_MOMENTUM_OVERRIDE: float | None = None
_BN_EPSILON_OVERRIDE: float | None = None

_BN_KINDS = ("batch_norm", "bn", "sync_batch_norm", "syncbn", "sync_bn")


def set_default_norm(kind: str) -> None:
    global _DEFAULT_NORM
    _DEFAULT_NORM = kind


def set_bn_momentum(momentum: float | None) -> None:
    """Global BN momentum override, read when a layer is constructed."""
    global _BN_MOMENTUM_OVERRIDE
    _BN_MOMENTUM_OVERRIDE = momentum


def set_bn_epsilon(epsilon: float | None) -> None:
    """Global BN epsilon override, read when a layer is constructed."""
    global _BN_EPSILON_OVERRIDE
    _BN_EPSILON_OVERRIDE = epsilon


def resolve_bn_momentum(default: float) -> float:
    return _BN_MOMENTUM_OVERRIDE if _BN_MOMENTUM_OVERRIDE is not None else default


def resolve_bn_epsilon(default: float) -> float:
    return _BN_EPSILON_OVERRIDE if _BN_EPSILON_OVERRIDE is not None else default


class BatchNorm(nn.Module):
    """Batch norm over every dim but dim 1 (channels), flax/Keras semantics.

    Parameters ``weight``/``bias`` are flax's ``scale``/``bias``; buffers
    ``running_mean``/``running_var`` are flax's ``batch_stats``
    ``mean``/``var``. Training mode (``module.training``) normalizes with
    the batch moments and updates the running ones.
    """

    def __init__(self, num_features: int, momentum: float = 0.99, epsilon: float = 1e-3):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            # one fused two-pass reduction; flax's E[x^2] - E[x]^2 gives the
            # same moments up to rounding (and no better parity in the tests)
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_features}, momentum={self.momentum}, epsilon={self.epsilon}"


class SyncBatchNorm(BatchNorm):
    """Cross-replica BN; on one card it is :class:`BatchNorm`."""


def normalization(kind: str | None = None, **kwargs) -> Callable[..., nn.Module]:
    """Factory returning a norm-module constructor taking ``num_features``.

    ``kind`` in {"batch_norm", "sync_batch_norm"} (and their short names);
    None uses the global default (SyncBN). Group/layer/RMS norm raise until
    they are ported.
    """
    if kind is None:
        kind = _DEFAULT_NORM
    if kind in ("batch_norm", "bn"):
        return functools.partial(BatchNorm, **kwargs)
    if kind in ("sync_batch_norm", "syncbn", "sync_bn"):
        return functools.partial(SyncBatchNorm, **kwargs)
    if kind in ("group_norm", "gn", "layer_norm", "ln", "rms_norm", "rmsn"):
        raise NotImplementedError(f"normalization {kind!r} is not ported to iseg_tpu_torch yet")
    raise ValueError(f"unknown normalization kind: {kind!r}")


def is_batch_norm(kind: str | None) -> bool:
    return (kind if kind is not None else _DEFAULT_NORM) in _BN_KINDS
