"""EfficientNet B0-B7 and L2 backbones (counterpart of
``iseg_tpu/backbones/efficientnet.py``).

MBConv blocks (1x1 expand, depthwise k x k, squeeze-excite, 1x1 project;
SiLU; BN epsilon 1e-3) over B0's seven stages, the widths rounded by
:func:`round_filters` (to a multiple of 8, at least 90% of the scaled
width) and the repeats by :func:`round_repeats` (ceil). The squeeze-excite
width comes from the block's INPUT width, not the expanded one; the
drop-path rate grows linearly, ``drop_connect_rate * block / blocks``. A
strided depthwise conv pads by TensorFlow's "SAME" rule (the extra row and
column at the bottom and right). Once the stride reaches ``output_stride``
a stage's stride becomes dilation, from that stage's first block on.

NCHW in; the endpoints are the input of every stage that strides (os2,
os4, ...), then the last feature (after the 1x1 ``top_conv`` when
``include_top_conv``). The module names are the flax tree's (``stem``,
``block_{stage}_{i}`` with ``expand``, ``depthwise``, ``se``, ``project``,
and ``top_conv``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.blocks import DropPath, SqueezeExcite
from iseg_tpu_torch.nn.conv import ConvNormAct

_BN_EPS = 1e-3

# (kernel, repeats, in_filters, out_filters, expand_ratio, stride, se_ratio)
_B0_STAGES = (
    (3, 1, 32, 16, 1, 1, 0.25),
    (3, 2, 16, 24, 6, 2, 0.25),
    (5, 2, 24, 40, 6, 2, 0.25),
    (3, 3, 40, 80, 6, 2, 0.25),
    (5, 3, 80, 112, 6, 1, 0.25),
    (5, 4, 112, 192, 6, 2, 0.25),
    (3, 1, 192, 320, 6, 1, 0.25),
)

# name: (width_coefficient, depth_coefficient, dropout)
_VARIANTS = {
    "efficientnetb0": (1.0, 1.0, 0.2),
    "efficientnetb1": (1.0, 1.1, 0.2),
    "efficientnetb2": (1.1, 1.2, 0.3),
    "efficientnetb3": (1.2, 1.4, 0.3),
    "efficientnetb4": (1.4, 1.8, 0.4),
    "efficientnetb5": (1.6, 2.2, 0.4),
    "efficientnetb6": (1.8, 2.6, 0.5),
    "efficientnetb7": (2.0, 3.1, 0.5),
    "efficientnetl2": (4.3, 5.3, 0.5),
}


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


class MBConv(nn.Module):
    def __init__(self, in_channels: int, out_filters: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, expand_ratio: int = 6,
                 se_ratio: float = 0.25, drop_rate: float = 0.0,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        common = dict(norm=norm, bn_epsilon=_BN_EPS)
        hidden = in_channels * expand_ratio
        self.expand = (ConvNormAct(in_channels, hidden, 1, act="silu", **common)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvNormAct(hidden, hidden, kernel_size, strides=stride,
                                     dilation=dilation, groups=hidden, act="silu", **common)
        self.se = (SqueezeExcite(hidden, max(1, int(in_channels * se_ratio)), inner_act="silu")
                   if se_ratio else None)
        self.project = ConvNormAct(hidden, out_filters, 1, act=None, **common)
        self.residual = stride == 1 and in_channels == out_filters
        self.drop_path = DropPath(drop_rate) if self.residual else None
        self.out_channels = out_filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand(x) if self.expand is not None else x
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        return self.drop_path(h) + x if self.residual else h


class EfficientNet(nn.Module):
    def __init__(self, width_coefficient: float = 1.0, depth_coefficient: float = 1.0,
                 output_stride: int = 32, drop_connect_rate: float = 0.2,
                 return_endpoints: bool = True, include_top_conv: bool = True,
                 norm: str = "sync_batch_norm", in_channels: int = 3):
        super().__init__()
        self.return_endpoints = return_endpoints
        common = dict(norm=norm, bn_epsilon=_BN_EPS)
        ch = round_filters(32, width_coefficient)
        self.stem = ConvNormAct(in_channels, ch, 3, strides=2, act="silu", **common)
        current_stride, dilation = 2, 1
        total_blocks = sum(round_repeats(r, depth_coefficient) for (_, r, *_rest) in _B0_STAGES)
        block_idx = 0
        self.endpoint_channels, self.endpoint_strides = [], []
        self._blocks: list[str] = []
        self._tapped: set[str] = set()  # the blocks whose input is an endpoint
        for stage_idx, (k, r, _fin, fout, e, s, se) in enumerate(_B0_STAGES):
            out_f = round_filters(fout, width_coefficient)
            for i in range(round_repeats(r, depth_coefficient)):
                name = f"block_{stage_idx}_{i}"
                stride = s if i == 0 else 1
                if stride > 1:
                    self._tapped.add(name)
                    self.endpoint_channels.append(ch)
                    self.endpoint_strides.append(current_stride)
                    if current_stride >= output_stride:
                        dilation *= stride
                        stride = 1
                    else:
                        current_stride *= 2
                self.add_module(name, MBConv(
                    ch, out_f, k, stride=stride, dilation=dilation, expand_ratio=e, se_ratio=se,
                    drop_rate=drop_connect_rate * block_idx / total_blocks, norm=norm))
                self._blocks.append(name)
                ch = out_f
                block_idx += 1
        self.top_conv = None
        if include_top_conv:
            top = round_filters(1280, width_coefficient)
            self.top_conv = ConvNormAct(ch, top, 1, act="silu", **common)
            ch = top
        self.endpoint_channels.append(ch)
        self.endpoint_strides.append(current_stride)
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        endpoints = []
        x = self.stem(x)
        for name in self._blocks:
            if name in self._tapped:
                endpoints.append(x)
            x = self._modules[name](x)
        if self.top_conv is not None:
            x = self.top_conv(x)
        endpoints.append(x)
        return endpoints if self.return_endpoints else x


def _make_ctor(name, width, depth):
    def ctor(output_stride=32, return_endpoints=True, **kwargs):
        return EfficientNet(width_coefficient=width, depth_coefficient=depth,
                            output_stride=output_stride, return_endpoints=return_endpoints,
                            **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_w, _d, _do) in _VARIANTS.items():
    register_backbone(_name, _make_ctor(_name, _w, _d))
