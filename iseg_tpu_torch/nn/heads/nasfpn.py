"""NAS-FPN head (counterpart of ``iseg_tpu/nn/heads/nasfpn.py``). NCHW in
and out.

The discovered 7-node merging cell (Ghiasi et al., CVPR 2019) over pyramid
levels P3-P7, repeated ``num_repeats`` times:

- the three coarsest distinct-resolution endpoints are P3-P5, each through
  a 1x1 conv (with bias) + BN where its width is not ``filters``; P6 and P7
  are 2x2/2 max pools of the level before (``"SAME"``, padded with -inf);
- a node resamples its two inputs to its level (max pool of ``2^d`` down,
  ``2^d`` nearest repeat up) and combines them by a sum, or with
  ``use_sum_for_combination=False`` by the cell's global attention where
  the spec says so (``feat0 + feat1 * sigmoid(global max of feat0)``,
  the input of the coarser-or-equal original level gating);
- an output node also adds every same-level node that no node has read
  yet; every node is ReLU -> 3x3 conv (bias) -> BN;
- the new pyramid is the last five nodes by level.

It returns P3 (or ``{level: map}`` with ``return_all_levels``).
``in_channels`` are the widths of the three levels it will be fed, fine ->
coarse: ``select_pyramid_levels(backbone.endpoint_channels,
backbone.endpoint_strides, 3)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.nn.conv import ConvNormAct, pad_same
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints

# (output_level, combine_op, (input_node_a, input_node_b), is_output);
# nodes 0..4 are the input pyramid P3..P7, new nodes append after
NASFPN_BLOCK_SPECS = (
    (4, "attention", (1, 3), False),
    (4, "sum", (1, 5), False),
    (3, "sum", (0, 6), True),
    (4, "sum", (6, 7), True),
    (5, "attention", (7, 8), True),
    (7, "attention", (6, 9), True),
    (6, "attention", (9, 10), True),
)

_MIN_LEVEL = 3
_MAX_LEVEL = 7


def max_pool_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """``size`` x ``size`` max pool of stride ``size``, "SAME" padded with -inf."""
    return F.max_pool2d(pad_same(x, size, size, value=float("-inf")), size, size)


def _resample_by_level(x: torch.Tensor, in_level: int, target_level: int) -> torch.Tensor:
    if in_level < target_level:
        return max_pool_same(x, 2 ** (target_level - in_level))
    if in_level > target_level:
        s = 2 ** (in_level - target_level)
        return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
    return x


def _global_attention(feat0: torch.Tensor, feat1: torch.Tensor) -> torch.Tensor:
    m = feat0.amax(dim=(2, 3), keepdim=True)
    return feat0 + feat1.to(feat0.dtype) * torch.sigmoid(m)


class NASFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], filters: int = 256, num_repeats: int = 5,
                 block_specs: Sequence = NASFPN_BLOCK_SPECS,
                 use_sum_for_combination: bool = True, norm: str = "sync_batch_norm",
                 return_all_levels: bool = False):
        super().__init__()
        in_channels = list(in_channels)
        if len(in_channels) != 3:
            raise ValueError(f"NASFPN takes three pyramid levels, got widths {in_channels}")
        self.num_repeats = num_repeats
        self.block_specs = tuple(block_specs)
        self.use_sum_for_combination = use_sum_for_combination
        self.return_all_levels = return_all_levels
        self._resample = []
        for i, ch in enumerate(in_channels):
            name = f"resample_l{_MIN_LEVEL + i}"
            if ch != filters:
                self.add_module(name, ConvNormAct(ch, filters, 1, act=None, use_bias=True,
                                                  norm=norm))
            self._resample.append(name if ch != filters else None)
        for rep in range(num_repeats):
            for i in range(len(self.block_specs)):
                self.add_module(f"cell{rep}_sub{i}", ConvNormAct(
                    filters, filters, 3, act=None, use_bias=True, norm=norm))
        levels = _MAX_LEVEL - _MIN_LEVEL + 1
        self.out_channels = [filters] * levels if return_all_levels else filters

    def forward(self, endpoints):
        feats_in = select_pyramid_endpoints(endpoints, 3)
        pyramid = [self._modules[name](f) if name is not None else f
                   for name, f in zip(self._resample, feats_in)]
        while len(pyramid) < _MAX_LEVEL - _MIN_LEVEL + 1:
            pyramid.append(max_pool_same(pyramid[-1], 2))

        num_levels = _MAX_LEVEL - _MIN_LEVEL + 1
        for rep in range(self.num_repeats):
            feats = list(pyramid)
            feat_levels = list(range(_MIN_LEVEL, _MAX_LEVEL + 1))
            n_out_conn = [0] * len(feats)
            for i, (lvl, combine, (i0, i1), is_out) in enumerate(self.block_specs):
                node0 = _resample_by_level(feats[i0], feat_levels[i0], lvl)
                node1 = _resample_by_level(feats[i1], feat_levels[i1], lvl)
                n_out_conn[i0] += 1
                n_out_conn[i1] += 1
                if self.use_sum_for_combination or combine == "sum":
                    new_node = node0 + node1.to(node0.dtype)
                elif combine == "attention":
                    if feat_levels[i0] >= feat_levels[i1]:
                        new_node = _global_attention(node0, node1)
                    else:
                        new_node = _global_attention(node1, node0)
                else:
                    raise ValueError(f"unknown combine_fn {combine!r}")
                if is_out:
                    for j in range(len(feats)):
                        if n_out_conn[j] == 0 and feat_levels[j] == lvl:
                            n_out_conn[j] += 1
                            new_node = new_node + _resample_by_level(
                                feats[j], feat_levels[j], lvl).to(new_node.dtype)
                new_node = self._modules[f"cell{rep}_sub{i}"](F.relu(new_node))
                feats.append(new_node)
                feat_levels.append(lvl)
                n_out_conn.append(0)
            by_level = {feat_levels[j]: feats[j]
                        for j in range(len(feats) - num_levels, len(feats))}
            pyramid = [by_level[lvl] for lvl in range(_MIN_LEVEL, _MAX_LEVEL + 1)]

        if self.return_all_levels:
            return {lvl: f for lvl, f in zip(range(_MIN_LEVEL, _MAX_LEVEL + 1), pyramid)}
        return pyramid[0]
