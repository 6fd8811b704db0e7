"""MobileNetV2 backbone (counterpart of ``iseg_tpu/backbones/mobilenetv2.py``).

The atrous rewrite is decided at construction from ``output_stride``: once
the cumulative stride reaches it, later stage strides become 1 and the
dilation multiplies up instead. NCHW in, a list of NCHW endpoints out. The
module names are the flax tree's (``stem``, ``block_{i}`` with ``expand``,
``depthwise``, ``project``, and ``top_conv``), so ``convert`` maps the
weights by path. Every BN takes the conv factory's epsilon, 1e-3.
"""

from __future__ import annotations

import torch
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.conv import ConvNormAct

# (expansion t, channels c, repeats n, stride s): the MobileNetV2 paper's
# table 2 stages
_MBV2_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """1x1 expand (ReLU6; absent at expansion 1) -> 3x3 depthwise (ReLU6)
    -> 1x1 project (linear), with the identity added when the block keeps
    stride 1 and width."""

    def __init__(self, in_channels: int, filters: int, stride: int, expansion: int,
                 dilation: int = 1, norm: str = "sync_batch_norm"):
        super().__init__()
        hidden = in_channels * expansion
        self.expand = (ConvNormAct(in_channels, hidden, kernel_size=1, norm=norm, act="relu6")
                       if expansion != 1 else None)
        self.depthwise = ConvNormAct(hidden, hidden, kernel_size=3, strides=stride,
                                     dilation=dilation, groups=hidden, norm=norm, act="relu6")
        self.project = ConvNormAct(hidden, filters, kernel_size=1, norm=norm, act=None)
        self.residual = stride == 1 and in_channels == filters
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand(x) if self.expand is not None else x
        h = self.project(self.depthwise(h))
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """Input-size-free MobileNetV2 returning endpoints at each stride
    boundary (os 2/4/8/16 taps, then the last feature). An endpoint is
    tapped before each stride-2 block, dilated or not.
    ``endpoint_channels`` lists the endpoints' widths, ``endpoint_strides``
    their output strides and ``out_channels`` the last one's width."""

    def __init__(self, output_stride: int = 32, width_multiplier: float = 1.0,
                 return_endpoints: bool = True, include_top_conv: bool = True,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        self.return_endpoints = return_endpoints
        ch = _make_divisible(32 * width_multiplier)
        self.stem = ConvNormAct(3, ch, kernel_size=3, strides=2, norm=norm, act="relu6")
        self.endpoint_channels = []
        self.endpoint_strides = []
        self.taps = []  # block indices an endpoint is tapped before
        current_stride, dilation, block_idx = 2, 1, 0
        for t, c, n, s in _MBV2_STAGES:
            out_ch = _make_divisible(c * width_multiplier)
            for i in range(n):
                stride = s if i == 0 else 1
                if stride > 1:
                    self.taps.append(block_idx)
                    self.endpoint_channels.append(ch)
                    self.endpoint_strides.append(current_stride)
                    if current_stride >= output_stride:
                        dilation *= stride
                        stride = 1
                    else:
                        current_stride *= 2
                self.add_module(f"block_{block_idx}", InvertedResidual(
                    ch, out_ch, stride, t, dilation=dilation, norm=norm))
                ch = out_ch
                block_idx += 1
        self.num_blocks = block_idx
        self.top_conv = None
        if include_top_conv:
            top = _make_divisible(1280 * max(1.0, width_multiplier))
            self.top_conv = ConvNormAct(ch, top, kernel_size=1, norm=norm, act="relu6")
            ch = top
        self.endpoint_channels.append(ch)
        self.endpoint_strides.append(current_stride)
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        endpoints = []
        for i in range(self.num_blocks):
            if i in self.taps:
                endpoints.append(x)
            x = self._modules[f"block_{i}"](x)
        if self.top_conv is not None:
            x = self.top_conv(x)
        endpoints.append(x)
        return endpoints if self.return_endpoints else x


@register_backbone("mobilenetv2")
def mobilenetv2(output_stride: int = 32, return_endpoints: bool = True,
                width_multiplier: float = 1.0, **kwargs) -> MobileNetV2:
    return MobileNetV2(output_stride=output_stride, return_endpoints=return_endpoints,
                       width_multiplier=width_multiplier, **kwargs)
