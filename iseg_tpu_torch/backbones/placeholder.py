"""Identity backbone for head-only models (counterpart of
``iseg_tpu/backbones/placeholder.py``): the input is the one endpoint, of
``in_channels`` channels at stride 1."""

from __future__ import annotations

import torch
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone


class PlaceHolder(nn.Module):
    def __init__(self, return_endpoints: bool = True, in_channels: int = 3):
        super().__init__()
        self.return_endpoints = return_endpoints
        self.endpoint_channels, self.endpoint_strides = [in_channels], [1]
        self.out_channels = in_channels

    def forward(self, x: torch.Tensor):
        return [x] if self.return_endpoints else x


@register_backbone("placeholder")
def placeholder(output_stride: int = 1, return_endpoints: bool = True, **kwargs):
    del output_stride
    return PlaceHolder(return_endpoints=return_endpoints, **kwargs)
