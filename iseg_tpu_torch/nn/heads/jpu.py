"""Joint Pyramid Upsampling, FastFCN (counterpart of
``iseg_tpu/nn/heads/jpu.py``). NCHW in and out.

The three coarsest distinct-resolution endpoints (for HRNet the os8, os16
and os32 branches) each pass a 3x3 ConvNormAct to ``filters`` channels, are
resized to the finest of them (half-pixel bilinear, by interpolation
matrices: ``ops/resize.py`` ``resize_nchw``) and concatenated; then
four parallel branches, dilation 1/2/4/8, of a depthwise 3x3 conv WITH bias
and no activation -> BN -> 1x1 ConvNormAct(``filters``). The four branch
outputs concatenate into the ``4 * filters``-channel head feature.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from iseg_tpu_torch.nn.conv import Conv2d, ConvNormAct, _bn_kwargs
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints
from iseg_tpu_torch.nn.norm import normalization
from iseg_tpu_torch.ops.resize import resize_nchw


class JointPyramidUpsampling(nn.Module):
    """``in_channels`` are the widths of the three levels it will be fed,
    fine -> coarse (``select_pyramid_levels(backbone.endpoint_channels,
    backbone.endpoint_strides, 3)``); ``out_channels`` is ``4 * filters``
    (``len(dilation_rates) * filters``)."""

    def __init__(self, in_channels: Sequence[int], filters: int = 512,
                 dilation_rates: Sequence[int] = (1, 2, 4, 8), norm: str = "sync_batch_norm"):
        super().__init__()
        in_channels = list(in_channels)
        if len(in_channels) != 3:
            raise ValueError(f"JPU takes three pyramid levels, got widths {in_channels}")
        self.dilation_rates = tuple(dilation_rates)
        for i, ch in enumerate(in_channels):
            self.add_module(f"endpoint_conv{i}", ConvNormAct(ch, filters, 3, act="relu",
                                                             norm=norm))
        width = len(in_channels) * filters
        for rate in self.dilation_rates:
            self.add_module(f"dw_conv{rate}", Conv2d(width, width, 3, dilation=rate,
                                                     groups=width, bias=True))
            self.add_module(f"dw_norm{rate}", normalization(norm, **_bn_kwargs(norm))(width))
            self.add_module(f"pw_conv{rate}", ConvNormAct(width, filters, 1, act="relu",
                                                          norm=norm))
        self.out_channels = len(self.dilation_rates) * filters

    def forward(self, endpoints) -> torch.Tensor:
        feats = select_pyramid_endpoints(endpoints, 3)
        convs = [self._modules[f"endpoint_conv{i}"](f) for i, f in enumerate(feats)]
        target = tuple(convs[0].shape[2:])
        convs = [resize_nchw(c, target) for c in convs]
        x = torch.cat([c.to(convs[0].dtype) for c in convs], dim=1)
        branches = []
        for rate in self.dilation_rates:
            h = self._modules[f"dw_norm{rate}"](self._modules[f"dw_conv{rate}"](x))
            branches.append(self._modules[f"pw_conv{rate}"](h))
        return torch.cat(branches, dim=1)


JPU = JointPyramidUpsampling
