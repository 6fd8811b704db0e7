"""Normalization layers + factory (counterpart of ``iseg_tpu/nn/norm.py``).

:class:`BatchNorm` is written here rather than taken from ``torch.nn``,
because it must behave like flax's ``nn.BatchNorm`` with Keras defaults:

* momentum is the Keras one: ``running = m * running + (1 - m) * batch``
  with m = 0.99 by default;
* the running variance is updated with the BIASED batch variance;
* a batch with one value per channel (the image-pool branch at N=1) is
  allowed in training;
* the moments are computed in fp32 or wider (float64 stays float64, as
  flax promotes with fp32), whatever the compute dtype (under bf16
  autocast), and the output returns in the input's dtype.

:class:`SyncBatchNorm` takes its moments over the GLOBAL batch when a
data-parallel group is active (``parallel.collectives.data_parallel``,
entered by ``make_train_step(..., mesh=)``), as flax's BatchNorm does
over a GSPMD-sharded batch: the per-channel sum, sum of squares and count
are all-reduced in ``promote_types(dtype, float32)``, the batch is
normalized with the global biased variance E[x^2] - E[x]^2, and the
running stats take that mean and variance. Its backward all-reduces the
gradients of the two sums. With no group, or one rank, it is
:class:`BatchNorm` bit for bit. :class:`BatchNorm` itself stays per rank
(the reference's unsynchronized BN under MirroredStrategy).

The factory's other kinds normalize over the channels (dim 1) of an NCHW
tensor, as flax's layers do over the last axis of an NHWC one:
:class:`GroupNorm` (32 groups, epsilon 1e-5), :class:`ChannelLayerNorm`
(epsilon 1e-6) and :class:`ChannelRMSNorm` (flax's ``nn.RMSNorm``, epsilon
1e-6). Like flax they take the moments in ``promote_types(x.dtype,
float32)`` by E[x^2] - E[x]^2 clamped at 0, and return the input's dtype.

:class:`RMSNorm` is Gemma's (``iseg_tpu/nlp/gemma/model.py``), with its
``(1 + scale)`` convention; the factory hands out :class:`ChannelRMSNorm`.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn

from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.parallel.collectives import active_group, world_size

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
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return self._normalize(x, xf, self.running_mean, self.running_var)
        dims = [0] + list(range(2, x.ndim))
        # one fused two-pass reduction; flax's E[x^2] - E[x]^2 gives the
        # same moments up to rounding (and no better parity in the tests)
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        return self._normalize(x, xf, mean, var, update=True)

    def _normalize(self, x, xf, mean, var, update: bool = False) -> torch.Tensor:
        """``xf`` normalized by ``mean``/``var`` ([C]), returned in ``x``'s
        dtype; ``update`` moves the running stats toward them first."""
        if update:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_features}, momentum={self.momentum}, epsilon={self.epsilon}"


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of the active group; its backward is the same
    sum of the incoming gradient (every rank's loss reads the global
    sums)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class SyncBatchNorm(BatchNorm):
    """Cross-replica BN (reference ``layers/syncbn.py:20``): global
    moments over the active data-parallel group (see the module note);
    :class:`BatchNorm` without one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = active_group()
        if not self.training or world_size(group) == 1:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.ndim))
        count = torch.full((1,), float(x.numel() // x.shape[1]), dtype=xf.dtype,
                           device=x.device)
        # [sum, sum of squares, count] of this rank's values, summed over ranks
        sums = _AllReduceSum.apply(
            torch.cat([xf.sum(dim=dims), xf.square().sum(dim=dims), count]), group)
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean.square(), min=0.0)
        return self._normalize(x, xf, mean, var, update=True)


class RMSNorm(nn.Module):
    """RMS normalization in fp32 with Gemma's ``(1 + scale)`` convention.
    The scale is allocated on ``device`` (the card unless the caller names
    the CPU)."""

    def __init__(self, dim: int, epsilon: float = 1e-6, param_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.zeros((dim,), dtype=param_dtype,
                                              device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.epsilon)
        return (xf * (1.0 + self.scale.float())).to(x.dtype)


def _fast_moments(xf: torch.Tensor, dims, use_mean: bool = True):
    """flax's ``_compute_stats``: (mean, E[x^2] - mean^2 clamped at 0) over
    ``dims`` (mean 0 and E[x^2] without ``use_mean``), kept dims."""
    mean2 = xf.square().mean(dim=dims, keepdim=True)
    if not use_mean:
        return torch.zeros_like(mean2), mean2
    mean = xf.mean(dim=dims, keepdim=True)
    return mean, torch.clamp(mean2 - mean.square(), min=0.0)


class _ChannelNorm(nn.Module):
    """Scale (and bias) over dim 1; flax's ``scale`` and ``bias``."""

    def __init__(self, num_features: int, epsilon: float, use_bias: bool = True):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None

    def _normalize(self, x, xf, mean, var):
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = torch.rsqrt(var + self.epsilon) * self.weight.view(shape)
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_features}, epsilon={self.epsilon}"


class GroupNorm(_ChannelNorm):
    """flax's ``nn.GroupNorm``: ``num_groups`` groups of consecutive
    channels, moments over each group's channels and every spatial dim."""

    def __init__(self, num_features: int, num_groups: int = 32, epsilon: float = 1e-5):
        if num_groups <= 0 or num_features % num_groups:
            raise ValueError(f"number of groups ({num_groups}) does not divide the number "
                             f"of channels ({num_features})")
        super().__init__(num_features, epsilon)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = _fast_moments(xf.reshape(x.shape[0], self.num_groups, -1), [2])
        # each group's moments repeated over its channels: [N, C, 1, ...]
        size = x.shape[1] // self.num_groups
        shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
        mean = mean.repeat_interleave(size, dim=1).view(shape)
        var = var.repeat_interleave(size, dim=1).view(shape)
        return self._normalize(x, xf, mean, var)


class ChannelLayerNorm(_ChannelNorm):
    """flax's ``nn.LayerNorm`` over the channels of an NCHW tensor."""

    def __init__(self, num_features: int, epsilon: float = 1e-6):
        super().__init__(num_features, epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = _fast_moments(xf, [1])
        return self._normalize(x, xf, mean, var)


class ChannelRMSNorm(_ChannelNorm):
    """flax's ``nn.RMSNorm`` over the channels of an NCHW tensor: ``x /
    sqrt(E[x^2] + eps) * scale``, no bias."""

    def __init__(self, num_features: int, epsilon: float = 1e-6):
        super().__init__(num_features, epsilon, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = _fast_moments(xf, [1], use_mean=False)
        return self._normalize(x, xf, mean, var)


def normalization(kind: str | None = None, **kwargs) -> Callable[..., nn.Module]:
    """Factory returning a norm-module constructor taking ``num_features``.

    ``kind`` in {"batch_norm", "sync_batch_norm", "group_norm",
    "layer_norm", "rms_norm"} (and their short names); None uses the global
    default (SyncBN).
    """
    if kind is None:
        kind = _DEFAULT_NORM
    if kind in ("batch_norm", "bn"):
        return functools.partial(BatchNorm, **kwargs)
    if kind in ("sync_batch_norm", "syncbn", "sync_bn"):
        return functools.partial(SyncBatchNorm, **kwargs)
    if kind in ("group_norm", "gn"):
        return functools.partial(GroupNorm, **kwargs)
    if kind in ("layer_norm", "ln"):
        return functools.partial(ChannelLayerNorm, **kwargs)
    if kind in ("rms_norm", "rmsn"):
        return functools.partial(ChannelRMSNorm, **kwargs)
    raise ValueError(f"unknown normalization kind: {kind!r}")


def is_batch_norm(kind: str | None) -> bool:
    return (kind if kind is not None else _DEFAULT_NORM) in _BN_KINDS
