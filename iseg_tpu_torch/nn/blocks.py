"""Reusable blocks (counterpart of ``iseg_tpu/nn/blocks.py``): dropout,
drop-path, squeeze-excite, image-level pooling, head-end block, a dense
layer, ConvNeXt-V2's global response norm, gradient scaling and adaptive
pooling. NCHW in and out, but for :class:`DenseExt` and
:class:`GlobalResponseNorm`, which work over the last axis (NHWC) as the
token MLPs they sit in do."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from iseg_tpu_torch.nn.conv import Activation, Conv2d, ConvNormAct, _resolve_act
from iseg_tpu_torch.ops.resize import resize_nchw
from iseg_tpu_torch.parallel.collectives import global_rows


class Dropout(nn.Module):
    """Inverted dropout drawn from an explicit generator (flax's
    ``nn.Dropout``: keep with probability 1 - rate, scale by 1/keep).

    ``generator`` must live on the input's device; None draws from torch's
    default generator. :func:`set_dropout_generator` sets it on a tree.
    Under data parallelism a rank's mask is its rows of the global batch's
    (``parallel.collectives.global_rows``).
    """

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        rows, mine = global_rows(x.shape[0])
        u = torch.rand((rows,) + tuple(x.shape[1:]), generator=self.generator,
                       device=x.device)[mine]
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Per-sample stochastic depth: in training each sample of the batch
    (dim 0) is kept with probability 1 - rate and scaled by 1/keep, or
    zeroed whole. Identity in eval or at rate 0. The keep mask is drawn
    from ``generator`` like :class:`Dropout`'s."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        rows, mine = global_rows(x.shape[0])
        u = torch.rand((rows,) + (1,) * (x.ndim - 1), generator=self.generator,
                       device=x.device)[mine]
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Set the generator of every :class:`Dropout` and :class:`DropPath`."""
    for m in module.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.generator = generator


class ImageLevelBlock(nn.Module):
    """Global-pool branch: pool -> 1x1 ConvNormAct -> broadcast back to the
    input resolution."""

    def __init__(self, in_channels: int, filters: int,
                 norm: Optional[str] = "sync_batch_norm", act: str = "relu"):
        super().__init__()
        self.conv = ConvNormAct(in_channels, filters, kernel_size=1, norm=norm, act=act)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.conv(x.mean(dim=(2, 3), keepdim=True))
        return pooled.expand(-1, -1, x.shape[2], x.shape[3])


class CommonEndBlock(nn.Module):
    """Head-end block: 3x3 ConvNormAct transform + dropout."""

    def __init__(self, in_channels: int, filters: int, dropout_rate: float = 0.1,
                 norm: Optional[str] = "sync_batch_norm", act: str = "relu"):
        super().__init__()
        self.conv = ConvNormAct(in_channels, filters, kernel_size=3, norm=norm, act=act)
        self.dropout = Dropout(dropout_rate)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.conv(x))


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation: global mean -> 1x1 conv ``reduce`` (bias) ->
    ``inner_act`` -> 1x1 conv ``expand`` back to the input's width (bias)
    -> ``gate_act`` -> scale the input."""

    def __init__(self, in_channels: int, reduction_filters: int, gate_act: Activation = "sigmoid",
                 inner_act: Activation = "silu"):
        super().__init__()
        self.reduce = Conv2d(in_channels, reduction_filters, 1, bias=True)
        self.expand = Conv2d(reduction_filters, in_channels, 1, bias=True)
        self.inner_act = _resolve_act(inner_act)
        self.gate_act = _resolve_act(gate_act)
        self.out_channels = in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.reduce(x.mean(dim=(2, 3), keepdim=True))
        if self.inner_act is not None:
            s = self.inner_act(s)
        s = self.expand(s)
        if self.gate_act is not None:
            s = self.gate_act(s)
        return x * s


class DenseExt(nn.Module):
    """A dense layer over the last axis (flax's ``DenseExt`` wraps one
    ``nn.Dense``, auto-named ``Dense_0``)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=use_bias)
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-V2's GRN on an NHWC tensor, in ``promote_types(dtype,
    float32)``: ``gamma * (x * nx) + beta + x`` with ``gx`` the L2 norm of
    each channel over the map (plus 1e-12 inside the root) and ``nx = gx /
    (mean_c gx + epsilon)``; ``gamma`` and ``beta`` start at zero."""

    def __init__(self, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        gx = torch.sqrt(xf.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + self.epsilon)
        return (self.gamma * (xf * nx) + self.beta + xf).to(x.dtype)


class _ScaleGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grads(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward; the backward multiplies the gradient by ``scale``."""
    return _ScaleGrads.apply(x, scale)


def adaptive_average_pooling_2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """Average-pool an NCHW map to ``output_size`` (int or (h, w)): the mean
    of each cell where the sizes divide evenly, else the half-pixel bilinear
    resize (the JAX package's rule)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return resize_nchw(x, (oh, ow))
