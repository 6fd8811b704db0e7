"""HRNet backbone, W32 / W48 (counterpart of ``iseg_tpu/backbones/hrnet.py``).

A stem to os4, a bottleneck first stage, then three multi-resolution stages
(2/3/4 parallel branches at os4..os32) with full cross-resolution fusion
after every module. The endpoints are the four branch outputs (fine ->
coarse) and the os4 concat of all of them upsampled (HRNetV2), in that
order: ``[b0 os4, b1 os8, b2 os16, b3 os32, concat os4]``.

NCHW in, a list of NCHW endpoints out. Module names are the flax tree's
(``stem0``, ``stage1_block0``, ``transition1_1``,
``stage3_module2/branch1_block3``, ``stage4_module0/fuse/down0_2_1``,
``.../fuse/up3_1``), so ``convert`` maps the weights by path. The JAX
package runs thin branches through an exactly equivalent W-folded block
(``w_fold``, ``iseg_tpu/nn/wfold.py``) whose parameters keep the plain
block's names and shapes; the port runs the plain block, and the same
weights load from either JAX model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.backbones.resnet import BasicBlock, BottleneckBlock
from iseg_tpu_torch.nn.conv import ConvNormAct
from iseg_tpu_torch.ops.resize import resize_nchw

# the HRNet blocks' BN epsilon; the ConvNormAct layers keep their default
_BLOCK_BN_EPS = 1e-3


class FuseLayer(nn.Module):
    """Full cross-resolution fusion: output branch ``i`` sums every input
    branch brought to its resolution, then a ReLU.

    As in the reference (and unlike the original HRNet), branch ``i`` is
    REPLACED by its fused output before branch ``i + 1`` is computed, so a
    coarser output consumes the already-fused finer branches. Down paths
    (j < i): strided 3x3 ConvNormActs, the inner ones keeping the source
    width with a ReLU, the last projecting without one. Up paths (j > i): a
    1x1 ConvNormAct without activation, then bilinear with
    ``align_corners=True`` (by interpolation matrices, as the JAX package
    resizes: ``ops/resize.py`` ``resize_nchw``)."""

    def __init__(self, channels: Sequence[int], norm: str = "sync_batch_norm"):
        super().__init__()
        self.channels = list(channels)
        for i, out_ch in enumerate(self.channels):
            for j, ch in enumerate(self.channels):
                if j < i:
                    for k in range(i - j):
                        last = k == i - j - 1
                        self.add_module(f"down{j}_{i}_{k}", ConvNormAct(
                            ch, out_ch if last else ch, 3, strides=2,
                            act=None if last else "relu", norm=norm))
                elif j > i:
                    self.add_module(f"up{j}_{i}", ConvNormAct(ch, out_ch, 1, act=None,
                                                              norm=norm))

    def forward(self, branches: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        branches = list(branches)
        for i in range(len(self.channels)):
            acc = None
            for j, b in enumerate(branches):
                if j == i:
                    h = b
                elif j < i:
                    h = b
                    for k in range(i - j):
                        h = self._modules[f"down{j}_{i}_{k}"](h)
                else:
                    h = resize_nchw(self._modules[f"up{j}_{i}"](b), branches[i].shape[2:],
                                    align_corners=True)
                acc = h if acc is None else acc + h.to(acc.dtype)
            branches[i] = F.relu(acc)
        return branches


class HRModule(nn.Module):
    """``len(channels)`` parallel stacks of ``num_blocks`` basic blocks,
    then a :class:`FuseLayer`."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 norm: str = "sync_batch_norm"):
        super().__init__()
        self.channels = list(channels)
        self.num_blocks = num_blocks
        for i, ch in enumerate(self.channels):
            for k in range(num_blocks):
                self.add_module(f"branch{i}_block{k}", BasicBlock(
                    ch, ch, bn_epsilon=_BLOCK_BN_EPS, norm=norm))
        self.fuse = FuseLayer(self.channels, norm=norm)

    def forward(self, branches: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for i, h in enumerate(branches):
            for k in range(self.num_blocks):
                h = self._modules[f"branch{i}_block{k}"](h)
            outs.append(h)
        return self.fuse(outs)


class HRNet(nn.Module):
    """Input-size-free HRNet. ``endpoint_channels`` lists the endpoints'
    widths (``[w, 2w, 4w, 8w, 15w]``), ``endpoint_strides`` their output
    strides (``[4, 8, 16, 32, 4]``) and ``out_channels`` the last one's (the
    concat, also what ``return_endpoints=False`` returns)."""

    def __init__(self, width: int = 48, stage_modules: Sequence[int] = (1, 1, 4, 3),
                 return_endpoints: bool = True, norm: str = "sync_batch_norm",
                 in_channels: int = 3):
        super().__init__()
        self.return_endpoints = return_endpoints
        w = width
        channels = [w, 2 * w, 4 * w, 8 * w]
        self.stem0 = ConvNormAct(in_channels, 64, 3, strides=2, norm=norm)
        self.stem1 = ConvNormAct(64, 64, 3, strides=2, norm=norm)
        ch = 64
        for k in range(4):
            block = BottleneckBlock(ch, 64, bn_epsilon=_BLOCK_BN_EPS, norm=norm)
            self.add_module(f"stage1_block{k}", block)
            ch = block.out_channels
        self.transition1_0 = ConvNormAct(ch, channels[0], 3, norm=norm)
        self.transition1_1 = ConvNormAct(ch, channels[1], 3, strides=2, norm=norm)
        # (module names of each stage, the transition after it or None)
        self._plan: list[tuple[list[str], str | None]] = []
        n_branches = 2
        for stage_idx, n_modules in enumerate(stage_modules[1:], start=2):
            names = []
            for m in range(n_modules):
                name = f"stage{stage_idx}_module{m}"
                self.add_module(name, HRModule(channels[:n_branches], norm=norm))
                names.append(name)
            transition = None
            if stage_idx < len(stage_modules):
                transition = f"transition{stage_idx}_{n_branches}"
                self.add_module(transition, ConvNormAct(
                    channels[n_branches - 1], channels[n_branches], 3, strides=2, norm=norm))
                n_branches += 1
            self._plan.append((names, transition))
        branch_channels = channels[:n_branches]
        self.endpoint_channels = branch_channels + [sum(branch_channels)]
        self.endpoint_strides = [4 * 2 ** i for i in range(n_branches)] + [4]
        self.out_channels = self.endpoint_channels[-1]

    def forward(self, x: torch.Tensor):
        x = self.stem1(self.stem0(x))
        for k in range(4):
            x = self._modules[f"stage1_block{k}"](x)
        branches = [self.transition1_0(x), self.transition1_1(x)]
        for names, transition in self._plan:
            for name in names:
                branches = self._modules[name](branches)
            if transition is not None:
                branches = branches + [self._modules[transition](branches[-1])]
        # HRNetV2 head: every branch to os4 (align_corners=True), concatenated
        target = branches[0].shape[2:]
        ups = [branches[0]] + [resize_nchw(b, target, align_corners=True).to(branches[0].dtype)
                               for b in branches[1:]]
        y = torch.cat(ups, dim=1)
        if self.return_endpoints:
            return list(branches) + [y]
        return y


@register_backbone("hrnet_w32")
def hrnet_w32(output_stride: int = 4, return_endpoints: bool = True, **kwargs) -> HRNet:
    del output_stride  # HRNet keeps os4 natively; no atrous rewrite
    return HRNet(width=32, return_endpoints=return_endpoints, **kwargs)


@register_backbone("hrnet_w48")
def hrnet_w48(output_stride: int = 4, return_endpoints: bool = True, **kwargs) -> HRNet:
    del output_stride
    return HRNet(width=48, return_endpoints=return_endpoints, **kwargs)
