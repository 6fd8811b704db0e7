"""Foundational conv blocks (counterpart of ``iseg_tpu/nn/conv.py``):
``ConvNormAct``, ``SepConvNormAct``, ``NormConvAct``.

Modules of the port take and return NCHW tensors (channels_last memory
recommended: it is NHWC in memory, so the model's NHWC boundary costs only
views). Padding follows flax's string padding: ``"SAME"`` is TensorFlow's
rule, which pads a stride-2 conv asymmetrically, the extra row and column
at the bottom and right; ``"VALID"`` pads nothing.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.nn.norm import (
    is_batch_norm,
    normalization,
    resolve_bn_epsilon,
    resolve_bn_momentum,
)

Activation = Union[str, Callable, None]


def _relu6(x):
    return torch.clamp(F.relu(x), max=6.0)


def _gelu_exact(x):
    # keras/tf gelu is the exact erf form (flax defaults to the tanh one)
    return F.gelu(x, approximate="none")


_ACTIVATIONS = {
    "relu": F.relu,
    "relu6": _relu6,
    "gelu": _gelu_exact,
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "hard_swish": F.hardswish,
    "hard_sigmoid": F.hardsigmoid,
    "linear": None,
    "none": None,
}


def _resolve_act(act: Activation) -> Optional[Callable]:
    if act is None or callable(act):
        return act
    if act not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {act!r}")
    return _ACTIVATIONS[act]


def _pair(v) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(v)  # type: ignore[return-value]


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """TensorFlow "SAME" padding (before, after) of one spatial dim."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel, stride, dilation=1, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` by the "SAME" rule (for convs and pools)."""
    (kh, kw), (sh, sw), (dh, dw) = _pair(kernel), _pair(stride), _pair(dilation)
    top, bottom = same_padding(x.shape[2], kh, sh, dh)
    left, right = same_padding(x.shape[3], kw, sw, dw)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's string padding ("SAME" or "VALID").
    A symmetric "SAME" pad goes to the conv itself; an asymmetric one is an
    explicit ``F.pad`` first."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 dilation=1, groups: int = 1, bias: bool = True, padding: str = "SAME"):
        super().__init__(in_channels, out_channels, _pair(kernel_size), stride=_pair(stride),
                         padding=0, dilation=_pair(dilation), groups=groups, bias=bias)
        if padding.upper() not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.same = padding.upper() == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.same:
            return super().forward(x)
        pads = [same_padding(x.shape[2 + d], self.kernel_size[d], self.stride[d],
                             self.dilation[d]) for d in range(2)]
        if all(a == b for a, b in pads):
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (pads[0][0], pads[1][0]), self.dilation, self.groups)
        x = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def _bn_kwargs(norm: str, bn_momentum: float = 0.99, bn_epsilon: float = 1e-3) -> dict:
    """BN constructor kwargs honoring the global set_bn_momentum/
    set_bn_epsilon overrides."""
    if is_batch_norm(norm):
        return dict(momentum=resolve_bn_momentum(bn_momentum),
                    epsilon=resolve_bn_epsilon(bn_epsilon))
    return {}


class ConvNormAct(nn.Module):
    """conv -> norm -> activation."""

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel_size: Union[int, Sequence[int]] = 3,
        strides: Union[int, Sequence[int]] = 1,
        dilation: Union[int, Sequence[int]] = 1,
        groups: int = 1,
        padding: str = "SAME",
        norm: Optional[str] = "sync_batch_norm",
        act: Activation = "relu",
        use_bias: Optional[bool] = None,  # default: bias only when no norm
        bn_momentum: float = 0.99,
        bn_epsilon: float = 1e-3,
        name_conv: str = "conv",
    ):
        super().__init__()
        use_bias = use_bias if use_bias is not None else norm is None
        self.name_conv = name_conv
        self.add_module(name_conv, Conv2d(in_channels, filters, kernel_size, strides,
                                          dilation, groups, use_bias, padding))
        self.norm = (normalization(norm, **_bn_kwargs(norm, bn_momentum, bn_epsilon))(filters)
                     if norm is not None else None)
        self.act = _resolve_act(act)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._modules[self.name_conv](x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class NormConvAct(nn.Module):
    """norm -> conv -> activation."""

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel_size: Union[int, Sequence[int]] = 3,
        strides: Union[int, Sequence[int]] = 1,
        dilation: Union[int, Sequence[int]] = 1,
        padding: str = "SAME",
        norm: Optional[str] = "sync_batch_norm",
        act: Activation = "relu",
        use_bias: bool = True,
    ):
        super().__init__()
        self.norm = (normalization(norm, **_bn_kwargs(norm))(in_channels)
                     if norm is not None else None)
        self.conv = Conv2d(in_channels, filters, kernel_size, strides, dilation, 1,
                           use_bias, padding)
        self.act = _resolve_act(act)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        x = self.conv(x)
        if self.act is not None:
            x = self.act(x)
        return x


class SepConvNormAct(nn.Module):
    """Depthwise-separable conv -> norm -> act. ``pre_act`` is the
    pre-activation form: act BEFORE the depthwise conv, none after."""

    def __init__(
        self,
        in_channels: int,
        filters: int,
        kernel_size: Union[int, Sequence[int]] = 3,
        strides: Union[int, Sequence[int]] = 1,
        dilation: Union[int, Sequence[int]] = 1,
        padding: str = "SAME",
        norm: Optional[str] = "sync_batch_norm",
        act: Activation = "relu",
        depth_multiplier: int = 1,
        norm_between: bool = True,  # norm+act between depthwise and pointwise
        pre_act: bool = False,
    ):
        super().__init__()
        mid = in_channels * depth_multiplier
        self.act = _resolve_act(act)
        self.pre_act = pre_act
        self.depthwise = Conv2d(in_channels, mid, kernel_size, strides, dilation,
                                groups=in_channels, bias=False, padding=padding)
        self.depthwise_norm = (normalization(norm, **_bn_kwargs(norm))(mid)
                               if norm_between and norm is not None else None)
        self.pointwise = ConvNormAct(mid, filters, kernel_size=1, norm=norm,
                                     act=None if pre_act else act)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_act and self.act is not None:
            x = self.act(x)
        x = self.depthwise(x)
        if self.depthwise_norm is not None:
            x = self.depthwise_norm(x)
            if self.act is not None and not self.pre_act:
                x = self.act(x)
        return self.pointwise(x)
