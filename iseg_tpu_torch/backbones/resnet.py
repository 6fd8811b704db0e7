"""Modern ResNet family (counterpart of ``iseg_tpu/backbones/resnet.py``).

Deep stem + slim stacks + multi-grid, with the output-stride dilation
decided at construction. NCHW in, a list of NCHW endpoints out. Pools
use flax's "SAME" rule: the max-pool pads with -inf, the slim-stack
identity avg-pool pads with zeros that it counts (an odd size divides the
edge windows by the full window).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.conv import ConvNormAct, pad_same

_BN_EPS = 1.001e-5


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(pad_same(x, window, stride, value=float("-inf")), window, stride)


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.avg_pool2d(pad_same(x, window, stride), window, stride)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1, dilation: int = 1,
                 conv_shortcut: Optional[bool] = None, bn_epsilon: float = _BN_EPS,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        common = dict(norm=norm, bn_epsilon=bn_epsilon)
        self.conv1 = ConvNormAct(in_channels, filters, 3, strides=stride, dilation=dilation,
                                 act="relu", **common)
        self.conv2 = ConvNormAct(filters, filters, 3, dilation=dilation, act=None, **common)
        if conv_shortcut is None:
            conv_shortcut = stride != 1 or in_channels != filters
        self.shortcut = (ConvNormAct(in_channels, filters, 1, strides=stride, act=None, **common)
                         if conv_shortcut else None)
        self.stride = stride
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        if self.shortcut is not None:
            x = self.shortcut(x)
        elif self.stride != 1:
            x = avg_pool_same(x, self.stride, self.stride)
        return F.relu(h + x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4) bottleneck. ``conv_shortcut`` None
    = a conv projection when the stride or width changes; slim stride
    blocks pass False and downsample the identity with an avg-pool."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1, dilation: int = 1,
                 conv_shortcut: Optional[bool] = None, bn_epsilon: float = _BN_EPS,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        out_ch = filters * 4
        common = dict(norm=norm, bn_epsilon=bn_epsilon)
        if conv_shortcut is None:
            conv_shortcut = stride != 1 or in_channels != out_ch
        self.conv1 = ConvNormAct(in_channels, filters, 1, act="relu", **common)
        self.conv2 = ConvNormAct(filters, filters, 3, strides=stride, dilation=dilation,
                                 act="relu", **common)
        self.conv3 = ConvNormAct(filters, out_ch, 1, act=None, **common)
        self.shortcut = (ConvNormAct(in_channels, out_ch, 1, strides=stride, act=None, **common)
                         if conv_shortcut else None)
        self.stride = stride
        self.out_channels = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv3(self.conv2(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        elif self.stride != 1:
            x = avg_pool_same(x, self.stride, self.stride)
        return F.relu(h + x)


class ResNet(nn.Module):
    """Input-size-free ResNet returning endpoints at os 2/4/8/16/32 (or
    dilated). Submodule names are the flax ones (``stem0``,
    ``stage2_block1``, ...). ``endpoint_channels`` lists the endpoints'
    widths, ``endpoint_strides`` their output strides and ``out_channels``
    the last one's width."""

    def __init__(
        self,
        depths: Sequence[int] = (3, 4, 6, 3),
        use_bottleneck: bool = True,
        output_stride: int = 32,
        multi_grid: Optional[Sequence[int]] = None,  # e.g. (1, 2, 4)
        deep_stem: bool = False,  # 7x7 -> 3x 3x3
        slim_stack: bool = False,  # stride on each stage's LAST block
        stem_filters: int = 64,
        stem_depth_multiplier: float = 1.0,
        return_endpoints: bool = True,
        norm: str = "sync_batch_norm",
        in_channels: int = 3,
    ):
        super().__init__()
        self.return_endpoints = return_endpoints
        common = dict(norm=norm, bn_epsilon=_BN_EPS)
        if deep_stem:
            m = stem_depth_multiplier
            self.stem0 = ConvNormAct(in_channels, int(64 * m), 3, strides=2, **common)
            self.stem1 = ConvNormAct(int(64 * m), int(64 * m), 3, **common)
            self.stem2 = ConvNormAct(int(64 * m), int(128 * m), 3, **common)
            self._stem = ("stem0", "stem1", "stem2")
            ch = int(128 * m)
        else:
            self.stem = ConvNormAct(in_channels, stem_filters, 7, strides=2, **common)
            self._stem = ("stem",)
            ch = stem_filters
        self.endpoint_channels = [ch]
        self.endpoint_strides = [2]
        x_stride = 4  # after the stem's max-pool

        block_cls = BottleneckBlock if use_bottleneck else BasicBlock
        # (name, tap an endpoint before this block)
        self._plan: list[tuple[str, bool]] = []
        current_stride, dilation = 4, 1
        stage_filters = (64, 128, 256, 512)
        num_stages = len(depths)
        for stage_idx, (depth, filters) in enumerate(zip(depths, stage_filters)):
            is_last_stage = stage_idx == num_stages - 1
            grid = list(multi_grid) if (is_last_stage and multi_grid) else [1] * depth
            stage_stride = 1 if stage_idx == 0 else 2
            tap_first = False
            if not slim_stack and stage_idx > 0:
                # endpoint taps stay fixed whether or not the stage is dilated
                tap_first = True
                if current_stride >= output_stride:
                    dilation *= stage_stride
                    stage_stride = 1
                else:
                    current_stride *= 2
            for i in range(depth):
                tap = tap_first and i == 0
                if slim_stack:
                    # stride-last stacks: block n of each non-final stage
                    # downsamples; endpoints tap pre-stride features
                    stride = 1
                    if i == depth - 1 and not is_last_stage:
                        tap = True
                        if current_stride >= output_stride:
                            dilation *= 2  # the de-strided block runs at the doubled rate
                        else:
                            stride = 2
                            current_stride *= 2
                    shortcut = i == 0
                else:
                    stride = stage_stride if i == 0 else 1
                    shortcut = None
                if tap:
                    self.endpoint_channels.append(ch)
                    self.endpoint_strides.append(x_stride)
                x_stride *= stride
                name = f"stage{stage_idx}_block{i}"
                block = block_cls(ch, filters, stride=stride,
                                  dilation=dilation * grid[i % len(grid)],
                                  conv_shortcut=shortcut, norm=norm)
                self.add_module(name, block)
                self._plan.append((name, tap))
                ch = block.out_channels
        self.endpoint_channels.append(ch)
        self.endpoint_strides.append(x_stride)
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        for name in self._stem:
            x = self._modules[name](x)
        endpoints = [x]
        x = max_pool_same(x, 3, 2)
        for name, tap in self._plan:
            if tap:
                endpoints.append(x)
            x = self._modules[name](x)
        endpoints.append(x)
        return endpoints if self.return_endpoints else x


_CONFIGS = {
    # name: (depths, bottleneck, stem_multiplier); all deep-stem + slim by
    # default, like the reference's published weights
    "resnet9": ((1, 1, 1, 1), False, 0.5),
    "resnet10": ((1, 1, 1, 1), False, 0.5),
    "resnet18": ((2, 2, 2, 2), False, 1.0),
    "resnet50": ((3, 4, 6, 3), True, 1.0),
    "resnet52": ((3, 4, 6, 3), True, 1.0),
    "resnet101": ((3, 4, 23, 3), True, 1.0),
    "resnet103": ((3, 4, 23, 3), True, 1.0),
    "resnet152": ((3, 8, 36, 3), True, 1.0),
}


def _make_ctor(name, depths, bottleneck, stem_mult):
    def ctor(output_stride=32, return_endpoints=True, multi_grid=(1, 2, 4),
             deep_stem=True, slim_stack=True, **kwargs):
        # multi-grid applies unconditionally to the last stage
        return ResNet(depths=depths, use_bottleneck=bottleneck, deep_stem=deep_stem,
                      slim_stack=slim_stack, stem_depth_multiplier=stem_mult,
                      output_stride=output_stride, multi_grid=multi_grid,
                      return_endpoints=return_endpoints, **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_depths, _bneck, _mult) in _CONFIGS.items():
    register_backbone(_name, _make_ctor(_name, _depths, _bneck, _mult))
