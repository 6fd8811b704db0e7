"""FaPN, the feature-aligned pyramid network head (counterpart of
``iseg_tpu/nn/heads/fapn.py``). NCHW in and out.

- :class:`FeatureSelectionModule`: a bias-free squeeze-excite gate (ratio
  1, ReLU, sigmoid) -> ``x * gate + x`` -> bias-free 1x1 projection.
- :class:`FeatureAlignment`: the coarse map is resized to the fine map's
  size (half-pixel bilinear, by interpolation matrices:
  ``ops/resize.py`` ``resize_nchw``, whose backward sums in a fixed
  order); ``feats_arm = FSM(fine)``; a bias-free 1x1 conv over
  ``concat([feats_arm, 2 * feats_up])`` gives the offset features, from
  which the port's ``DCNv2`` (custom-offset mode, ``offset_in_channels``)
  takes its offsets and deforms the UPSAMPLED COARSE map; the output is
  ``relu(aligned) + feats_arm``.
- :class:`FeatureAlignedPyramidNet` (:data:`FAPN`): the coarsest endpoint
  enters raw (or through the 1x1 dense ``coarse_warp_conv`` to ``filters``
  with ``warp_coarse_feature``); each finer level aligns against the
  running map. It returns the finest map (or every level, fine -> coarse,
  with ``return_all_levels``).

``in_channels`` are the widths of the ``num_levels`` pyramid levels it will
be fed, fine -> coarse: ``select_pyramid_levels(backbone.endpoint_channels,
backbone.endpoint_strides, 4)``, the rule by which the forward picks them.
The DCNv2 works on NHWC views of the channels_last maps.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.nn.dcn import DCNv2
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints
from iseg_tpu_torch.ops.resize import resize_nchw


class FeatureSelectionModule(nn.Module):
    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.down_conv = Conv2d(in_channels, in_channels, 1, bias=False)
        self.expand_conv = Conv2d(in_channels, in_channels, 1, bias=False)
        self.conv = Conv2d(in_channels, filters, 1, bias=False)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.expand_conv(F.relu(self.down_conv(x.mean(dim=(2, 3), keepdim=True))))
        gate = torch.sigmoid(s).to(x.dtype)
        return self.conv(x * gate + x)


class FeatureAlignment(nn.Module):
    """``forward(fine, coarse)``: ``fine_channels`` and ``coarse_channels``
    are the two maps' widths."""

    def __init__(self, fine_channels: int, coarse_channels: int, filters: int):
        super().__init__()
        self.lateral_conv = FeatureSelectionModule(fine_channels, filters)
        self.offset_conv = Conv2d(filters + coarse_channels, filters, 1, bias=False)
        self.depack_l2 = DCNv2(coarse_channels, filters, kernel_size=3, use_bias=True,
                               offset_in_channels=filters)
        self.out_channels = filters

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        feats_up = resize_nchw(coarse, tuple(fine.shape[2:]))
        feats_arm = self.lateral_conv(fine)
        feats_up = feats_up.to(feats_arm.dtype)
        offset = self.offset_conv(torch.cat([feats_arm, feats_up * 2], dim=1))
        aligned = self.depack_l2(feats_up.permute(0, 2, 3, 1),
                                 offset_input=offset.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return F.relu(aligned) + feats_arm


class FeatureAlignedPyramidNet(nn.Module):
    def __init__(self, in_channels: Sequence[int], filters: int = 128,
                 warp_coarse_feature: bool = False, return_all_levels: bool = False):
        super().__init__()
        in_channels = list(in_channels)
        self.num_levels = len(in_channels)
        self.return_all_levels = return_all_levels
        ch = in_channels[-1]
        self.coarse_warp_conv = nn.Linear(ch, filters) if warp_coarse_feature else None
        if warp_coarse_feature:
            ch = filters
        widths = [ch]
        for i in range(self.num_levels - 2, -1, -1):
            self.add_module(f"align{i}", FeatureAlignment(in_channels[i], ch, filters))
            ch = filters
            widths.append(ch)
        widths.reverse()
        self.out_channels = widths if return_all_levels else widths[0]

    def forward(self, endpoints):
        feats = select_pyramid_endpoints(endpoints, self.num_levels)
        x = feats[-1]
        if self.coarse_warp_conv is not None:
            x = self.coarse_warp_conv(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        outs = [x]
        for i in range(len(feats) - 2, -1, -1):
            x = self._modules[f"align{i}"](feats[i], x)
            outs.append(x)
        outs.reverse()
        return outs if self.return_all_levels else outs[0]


FAPN = FeatureAlignedPyramidNet
