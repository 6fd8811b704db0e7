"""Xception-65, DeepLab's variant (counterpart of ``iseg_tpu/backbones/xception.py``).

Entry flow (two stem convs, three downsampling blocks), 16 middle blocks
and the exit block with three separable convs; every conv of a block is a
pre-activation separable conv (ReLU, depthwise 3x3, BN, pointwise 1x1, BN).
The atrous rewrite is decided at construction: a block de-strided because
the stride reached ``output_stride`` keeps the current rate, and the rate
doubles for the blocks after it. NCHW in; the endpoints are the first stem
conv's output (os2) and the input of every block that stays strided, then
the last feature. The module names are the flax tree's (``stem0``,
``stem1``, ``entry_block{1,2,3}``, ``middle_block{i}``, ``exit_block`` with
``sepconv{i}`` and ``shortcut``, ``exit_sepconv{i}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.conv import ConvNormAct, SepConvNormAct


class XceptionBlock(nn.Module):
    """Three pre-activation separable convs (the last one strided) and a
    1x1 conv + BN shortcut (``"conv"``), the identity (``"sum"``) or none."""

    def __init__(self, in_channels: int, filters: Sequence[int], stride: int = 1,
                 dilation: int = 1, skip_type: str = "conv", norm: str = "sync_batch_norm"):
        super().__init__()
        self.skip_type = skip_type
        ch = in_channels
        for i, f in enumerate(filters):
            self.add_module(f"sepconv{i}", SepConvNormAct(
                ch, f, 3, strides=stride if i == len(filters) - 1 else 1, dilation=dilation,
                norm=norm, pre_act=True))
            ch = f
        self.num_convs = len(filters)
        self.shortcut = (ConvNormAct(in_channels, filters[-1], 1, strides=stride, norm=norm,
                                     act=None) if skip_type == "conv" else None)
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.num_convs):
            h = self._modules[f"sepconv{i}"](h)
        if self.skip_type == "conv":
            return h + self.shortcut(x)
        if self.skip_type == "sum":
            return h + x
        return h


class Xception(nn.Module):
    def __init__(self, middle_blocks: int = 16, output_stride: int = 32,
                 return_endpoints: bool = True, norm: str = "sync_batch_norm",
                 in_channels: int = 3):
        super().__init__()
        self.return_endpoints = return_endpoints
        self.middle_blocks = middle_blocks
        self.stem0 = ConvNormAct(in_channels, 32, 3, strides=2, norm=norm)
        self.stem1 = ConvNormAct(32, 64, 3, norm=norm)
        self.endpoint_channels, self.endpoint_strides = [32], [2]
        self._tapped: list[str] = []  # the blocks whose input is an endpoint
        current_stride, dilation = 2, 1
        ch = 64

        def next_block():
            nonlocal current_stride, dilation
            if current_stride >= output_stride:
                rate, stride = dilation, 1
                dilation *= 2
            else:
                rate, stride = dilation, 2
                current_stride *= 2
            return rate, stride

        for filters, name in (((128, 128, 128), "entry_block1"),
                              ((256, 256, 256), "entry_block2"),
                              ((728, 728, 728), "entry_block3")):
            rate, stride = next_block()
            if stride == 2:
                self._tapped.append(name)
                self.endpoint_channels.append(ch)
                self.endpoint_strides.append(current_stride // 2)
            self.add_module(name, XceptionBlock(ch, filters, stride, rate, norm=norm))
            ch = filters[-1]
        for i in range(middle_blocks):
            self.add_module(f"middle_block{i}", XceptionBlock(
                ch, (728, 728, 728), 1, dilation, skip_type="sum", norm=norm))
        rate, stride = next_block()
        if stride == 2:
            self._tapped.append("exit_block")
            self.endpoint_channels.append(ch)
            self.endpoint_strides.append(current_stride // 2)
        self.exit_block = XceptionBlock(ch, (728, 1024, 1024), stride, rate, norm=norm)
        ch = 1024
        for i, f in enumerate((1536, 1536, 2048)):
            self.add_module(f"exit_sepconv{i}", SepConvNormAct(ch, f, 3, dilation=dilation,
                                                               norm=norm))
            ch = f
        self.endpoint_channels.append(ch)
        self.endpoint_strides.append(current_stride)
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        x = self.stem0(x)
        endpoints = [x]
        x = self.stem1(x)
        names = (["entry_block1", "entry_block2", "entry_block3"]
                 + [f"middle_block{i}" for i in range(self.middle_blocks)]
                 + ["exit_block", "exit_sepconv0", "exit_sepconv1", "exit_sepconv2"])
        for name in names:
            if name in self._tapped:
                endpoints.append(x)
            x = self._modules[name](x)
        endpoints.append(x)
        return endpoints if self.return_endpoints else x


@register_backbone("xception65")
def xception65(output_stride: int = 32, return_endpoints: bool = True, **kwargs):
    return Xception(middle_blocks=16, output_stride=output_stride,
                    return_endpoints=return_endpoints, **kwargs)
