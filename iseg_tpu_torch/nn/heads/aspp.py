"""Atrous Spatial Pyramid Pooling (counterpart of
``iseg_tpu/nn/heads/aspp.py``): image-pool branch + 1x1 + atrous 3x3
branches -> concat -> 1x1 project -> dropout. NCHW in and out."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from iseg_tpu_torch.nn.blocks import Dropout, ImageLevelBlock
from iseg_tpu_torch.nn.conv import ConvNormAct, SepConvNormAct


class ASPP(nn.Module):
    """``in_channels`` is the backbone's last endpoint width
    (``backbone.out_channels``); the other fields are the JAX module's.
    ``use_projection=False`` returns the raw branch concat, like the
    reference's ASPP."""

    def __init__(
        self,
        in_channels: int,
        filters: int = 256,
        atrous_rates: Sequence[int] = (6, 12, 18),
        use_separable_conv: bool = False,
        dropout_rate: float = 0.1,
        use_image_level: bool = True,
        use_projection: bool = True,
        norm: str = "sync_batch_norm",
    ):
        super().__init__()
        self.image_pool = (ImageLevelBlock(in_channels, filters, norm=norm)
                           if use_image_level else None)
        self.conv1x1 = ConvNormAct(in_channels, filters, kernel_size=1, norm=norm)
        conv_cls = SepConvNormAct if use_separable_conv else ConvNormAct
        self.num_atrous = len(atrous_rates)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"atrous{i}", conv_cls(in_channels, filters, kernel_size=3,
                                                   dilation=rate, norm=norm))
        width = filters * (len(atrous_rates) + 1 + int(use_image_level))
        self.project = (ConvNormAct(width, filters, kernel_size=1, norm=norm)
                        if use_projection else None)
        self.dropout = Dropout(dropout_rate)
        self.out_channels = filters if use_projection else width

    def forward(self, endpoints) -> torch.Tensor:
        x = endpoints[-1] if isinstance(endpoints, (list, tuple)) else endpoints
        branches = []
        if self.image_pool is not None:
            branches.append(self.image_pool(x))
        branches.append(self.conv1x1(x))
        for i in range(self.num_atrous):
            branches.append(self._modules[f"atrous{i}"](x))
        dtype = branches[-1].dtype
        y = torch.cat([b.to(dtype) for b in branches], dim=1)
        if y.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            y = y.contiguous(memory_format=torch.channels_last)
        if self.project is not None:
            y = self.project(y)
        return self.dropout(y)


# reference class name alias
AtrousSpatialPyramidPooling = ASPP
