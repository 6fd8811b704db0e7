"""ConvNeXt V1 and V2 backbones (counterpart of ``iseg_tpu/backbones/convnext.py``).

A 4x4/4 patchify stem with a LayerNorm, then four stages of blocks:
depthwise 7x7 -> LayerNorm -> Linear(4C) -> exact GELU -> [GRN, V2] ->
Linear(C) -> [layer scale, V1] -> drop path -> residual add; between stages
a LayerNorm and a 2x2/2 downsample conv. Once the stride reaches
``output_stride`` the downsample becomes a 2x2/1 ``SAME`` conv (padded 0
at the top and left, 1 at the bottom and right) and the blocks after it
dilate by 2 more.

NCHW in; the endpoints are ``[None, os4, os8, os16, last]`` like the JAX
module's (the ``None`` stands for the os2 feature ConvNeXt has not):
``endpoint_channels`` and ``endpoint_strides`` are None there, so
``select_pyramid_levels`` skips it as the forward's selection does. The
stem's and the downsamples' LayerNorms are the norm factory's
``ChannelLayerNorm`` (over dim 1). Inside a block the MLP works on the
NHWC view of the depthwise conv's output (no copy for a channels_last
tensor), with ``nn.LayerNorm`` and ``nn.Linear`` over the last axis, and
returns to NCHW by another view. The module names
are the flax tree's (``stem_conv``, ``stem_norm``, ``downsample_norm{s}``,
``downsample_conv{s}``, ``stage{s}_block{i}`` with ``dwconv``, ``norm``,
``pwconv1``, ``grn``, ``pwconv2`` and the layer-scale ``gamma``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.blocks import DropPath, GlobalResponseNorm
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.nn.norm import ChannelLayerNorm


class ConvNeXtBlock(nn.Module):
    """One block; ``gamma`` (the layer scale, V1) is a parameter of the
    block itself, as in the flax tree."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: Optional[float] = 1e-6, use_grn: bool = False,
                 dilation: int = 1):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2d(dim, dim, 7, dilation=dilation, groups=dim, bias=True)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GlobalResponseNorm(4 * dim) if use_grn else None
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init))
                      if layer_scale_init is not None else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC view
        h = F.gelu(self.pwconv1(self.norm(h)), approximate="none")
        if self.grn is not None:
            h = self.grn(h)
        h = self.pwconv2(h)
        if self.gamma is not None:
            h = h * self.gamma
        return x + self.drop_path(h.permute(0, 3, 1, 2))


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), drop_path_rate: float = 0.0,
                 layer_scale_init: Optional[float] = 1e-6, use_grn: bool = False,
                 output_stride: int = 32, return_endpoints: bool = True, in_channels: int = 3):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.return_endpoints = return_endpoints
        self.stem_conv = Conv2d(in_channels, dims[0], 4, stride=4, bias=True)
        self.stem_norm = ChannelLayerNorm(dims[0], epsilon=1e-6)
        total_blocks = sum(depths)
        block_idx = 0
        current_stride, dilation = 4, 1
        self.endpoint_channels: list = [None]
        self.endpoint_strides: list = [None]
        for stage_idx, (depth, dim) in enumerate(zip(depths, dims)):
            if stage_idx > 0:
                self.endpoint_channels.append(dims[stage_idx - 1])
                self.endpoint_strides.append(current_stride)
                self.add_module(f"downsample_norm{stage_idx}",
                                ChannelLayerNorm(dims[stage_idx - 1], epsilon=1e-6))
                if current_stride >= output_stride:
                    dilation *= 2
                    stride = 1
                else:
                    current_stride *= 2
                    stride = 2
                self.add_module(f"downsample_conv{stage_idx}",
                                Conv2d(dims[stage_idx - 1], dim, 2, stride=stride, bias=True))
            for i in range(depth):
                self.add_module(f"stage{stage_idx}_block{i}", ConvNeXtBlock(
                    dim, drop_path=drop_path_rate * block_idx / max(1, total_blocks - 1),
                    layer_scale_init=layer_scale_init, use_grn=use_grn, dilation=dilation))
                block_idx += 1
        self.endpoint_channels.append(dims[-1])
        self.endpoint_strides.append(current_stride)
        self.out_channels = dims[-1]

    def forward(self, x: torch.Tensor):
        endpoints: list = [None]
        x = self.stem_norm(self.stem_conv(x))
        for stage_idx, depth in enumerate(self.depths):
            if stage_idx > 0:
                endpoints.append(x)
                x = self._modules[f"downsample_norm{stage_idx}"](x)
                x = self._modules[f"downsample_conv{stage_idx}"](x)
            for i in range(depth):
                x = self._modules[f"stage{stage_idx}_block{i}"](x)
        endpoints.append(x)
        return endpoints if self.return_endpoints else x


# name: (depths, dims)
_V1 = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}
_V2 = {
    "convnext_v2_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnext_v2_nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "convnext_v2_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_v2_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_v2_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_v2_huge": ((3, 3, 27, 3), (352, 704, 1408, 2816)),
}


def _make_ctor(name, depths, dims, v2):
    def ctor(output_stride=32, return_endpoints=True, **kwargs):
        return ConvNeXt(depths=depths, dims=dims, layer_scale_init=None if v2 else 1e-6,
                        use_grn=v2, output_stride=output_stride,
                        return_endpoints=return_endpoints, **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_depths, _dims) in _V1.items():
    register_backbone(_name, _make_ctor(_name, _depths, _dims, v2=False))
for _name, (_depths, _dims) in _V2.items():
    register_backbone(_name, _make_ctor(_name, _depths, _dims, v2=True))
