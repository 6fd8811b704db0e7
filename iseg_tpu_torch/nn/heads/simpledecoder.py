"""DeepLabV3+-style low-level-skip decoder (counterpart of
``iseg_tpu/nn/heads/simpledecoder.py``). NCHW in and out."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from iseg_tpu_torch.nn.conv import ConvNormAct
from iseg_tpu_torch.ops.resize import resize_nchw


class SimpleDecoder(nn.Module):
    """Project a low-level endpoint, upsample the high-level feature to it
    (half-pixel bilinear, by interpolation matrices), concat ``[high, low]``, refine with two 3x3
    convs. ``in_channels`` are the backbone's endpoint widths
    (``backbone.endpoint_channels``); ``out_channels`` is ``filters``."""

    def __init__(self, in_channels: Sequence[int], filters: int = 256,
                 low_level_filters: int = 48, low_level_index: int = 1,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        in_channels = list(in_channels)
        self.low_level_index = min(low_level_index, len(in_channels) - 1)
        self.low_level_project = ConvNormAct(in_channels[self.low_level_index],
                                             low_level_filters, kernel_size=1, norm=norm)
        self.fuse0 = ConvNormAct(in_channels[-1] + low_level_filters, filters, kernel_size=3,
                                 norm=norm)
        self.fuse1 = ConvNormAct(filters, filters, kernel_size=3, norm=norm)
        self.out_channels = filters

    def forward(self, endpoints) -> torch.Tensor:
        if not isinstance(endpoints, (list, tuple)):
            endpoints = [endpoints]
        high = endpoints[-1]
        low = self.low_level_project(endpoints[min(self.low_level_index, len(endpoints) - 1)])
        if tuple(high.shape[2:]) != tuple(low.shape[2:]):
            high = resize_nchw(high, tuple(low.shape[2:]))
        x = torch.cat([high, low.to(high.dtype)], dim=1)
        if high.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous(memory_format=torch.channels_last)
        return self.fuse1(self.fuse0(x))
