"""Feature Pyramid Network + Semantic-FPN blocks (counterpart of
``iseg_tpu/nn/heads/fpn.py``). NCHW in and out.

- :class:`FeaturePyramidNetwork`: a 1x1 ConvNormAct skip per non-coarsest
  level, top-down bilinear resize + add; the COARSEST level passes through
  raw. Returns the fine->coarse list.
- :class:`SemanticPyramidNetworkBlockV1`: per level a cell of two 3x3
  ConvNormActs, resize to the finest, concat, 3x3 merge conv of
  ``num_levels * filters`` channels.
- :class:`SemanticPyramidNetworkBlockV2`: level ``i`` gets ``max(1, i)``
  3x3 convs, each followed (for i > 0) by a resize one pyramid step finer;
  the per-level results sum and pass a 1x1 end conv.
- :class:`SemanticFPN`: the composed head (FPN -> block -> one finest-level
  map) that ``SegManaged`` consumes.

A torch module fixes its input widths when it is built, so every class
takes ``in_channels``: the widths of the pyramid levels it will be given,
fine -> coarse: ``select_pyramid_levels(backbone.endpoint_channels,
backbone.endpoint_strides, 4)`` (``nn/heads/common.py``), the rule by which
the forward picks them.
Sizes come from the inputs at run time, never from a factor of 2.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from iseg_tpu_torch.nn.conv import ConvNormAct
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints
from iseg_tpu_torch.ops.numerics import replace_non_finite
from iseg_tpu_torch.ops.resize import resize_nchw


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of an NCHW map (no antialias), by
    interpolation matrices: a backward in a fixed order."""
    return resize_nchw(x, hw)


class FeaturePyramidNetwork(nn.Module):
    """endpoints (fine->coarse) -> pyramid list (fine->coarse): the coarsest
    endpoint is returned RAW (its own width); each finer level is
    ``resize(x) + ConvNormAct_1x1(skip)`` with ``filters`` channels."""

    def __init__(self, in_channels: Sequence[int], filters: int = 256,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, ch in enumerate(in_channels[:-1]):
            self.add_module(f"skip_conv{i}", ConvNormAct(ch, filters, kernel_size=1,
                                                         norm=norm, act="relu"))
        self.out_channels = [filters] * (self.num_levels - 1) + [in_channels[-1]]

    def forward(self, endpoints) -> list[torch.Tensor]:
        feats = select_pyramid_endpoints(endpoints, self.num_levels)
        x = feats[-1]
        outs = [x]
        for i in range(len(feats) - 2, -1, -1):
            skip = self._modules[f"skip_conv{i}"](replace_non_finite(feats[i]))
            x = _resize(x, skip.shape[2:]).to(skip.dtype) + skip
            outs.append(x)
        outs.reverse()
        return outs


class SemanticPyramidNetworkBlockV1(nn.Module):
    """Two-conv cell per level, resize all to the finest, concat, 3x3 merge."""

    def __init__(self, in_channels: Sequence[int], filters: int = 128,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, ch in enumerate(in_channels):
            self.add_module(f"cell{i}_conv0", ConvNormAct(ch, filters, 3, norm=norm))
            self.add_module(f"cell{i}_conv1", ConvNormAct(filters, filters, 3, norm=norm))
        self.out_channels = self.num_levels * filters
        self.merge_conv = ConvNormAct(self.out_channels, self.out_channels, 3, norm=norm)

    def forward(self, feature_list) -> torch.Tensor:
        ys = [self._modules[f"cell{i}_conv1"](self._modules[f"cell{i}_conv0"](f))
              for i, f in enumerate(feature_list)]
        ys = [ys[0]] + [_resize(h, ys[0].shape[2:]).to(ys[0].dtype) for h in ys[1:]]
        return self.merge_conv(torch.cat(ys, dim=1))


class SemanticPyramidNetworkBlockV2(nn.Module):
    """Level ``i`` runs ``max(1, i)`` 3x3 convs; after conv ``j`` (i > 0
    only) the map resizes to the size of level ``i-j-1``, a walk down to
    the finest level. The per-level results sum; a 1x1 end conv finishes."""

    def __init__(self, in_channels: Sequence[int], filters: int = 128,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, ch in enumerate(in_channels):
            for j in range(max(1, i)):
                self.add_module(f"s{i}_conv{j}", ConvNormAct(ch if j == 0 else filters,
                                                             filters, 3, norm=norm))
        self.end_conv = ConvNormAct(filters, filters, 1, norm=norm)
        self.out_channels = filters

    def forward(self, feature_list) -> torch.Tensor:
        sizes = [tuple(f.shape[2:]) for f in feature_list]
        y = None
        for i, x in enumerate(feature_list):
            for j in range(max(1, i)):
                x = self._modules[f"s{i}_conv{j}"](x)
                if i > 0:
                    x = _resize(x, sizes[i - j - 1])
            y = x if y is None else y + x.to(y.dtype)
        return self.end_conv(y)


class SemanticFPN(nn.Module):
    """FPN then a semantic block (``version`` 1 or 2), returning one
    finest-level map. The FPN passes the coarsest endpoint through raw, so
    an endpoint that is not ``filters`` wide is projected first
    (``coarse_project``, a 1x1 ConvNormAct without activation)."""

    def __init__(self, in_channels: Sequence[int], filters: int = 256, fuse_filters: int = 128,
                 version: int = 2, norm: str = "sync_batch_norm"):
        super().__init__()
        in_channels = list(in_channels)
        self.num_levels = len(in_channels)
        self.coarse_project = None
        if in_channels[-1] != filters:
            self.coarse_project = ConvNormAct(in_channels[-1], filters, kernel_size=1,
                                              norm=norm, act=None)
            in_channels[-1] = filters
        self.fpn = FeaturePyramidNetwork(in_channels, filters=filters, norm=norm)
        block_cls = (SemanticPyramidNetworkBlockV1 if version == 1
                     else SemanticPyramidNetworkBlockV2)
        self.semantic_block = block_cls(self.fpn.out_channels, filters=fuse_filters, norm=norm)
        self.out_channels = self.semantic_block.out_channels

    def forward(self, endpoints) -> torch.Tensor:
        feats = list(select_pyramid_endpoints(endpoints, self.num_levels))
        if self.coarse_project is not None:
            feats[-1] = self.coarse_project(feats[-1])
        return self.semantic_block(self.fpn(feats))
