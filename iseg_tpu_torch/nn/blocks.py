"""Reusable blocks (counterpart of ``iseg_tpu/nn/blocks.py``): dropout,
image-level pooling, head-end block. NCHW in and out."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from iseg_tpu_torch.nn.conv import ConvNormAct


class Dropout(nn.Module):
    """Inverted dropout drawn from an explicit generator (flax's
    ``nn.Dropout``: keep with probability 1 - rate, scale by 1/keep).

    ``generator`` must live on the input's device; None draws from torch's
    default generator. :func:`set_dropout_generator` sets it on a tree.
    """

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class ImageLevelBlock(nn.Module):
    """Global-pool branch: pool -> 1x1 ConvNormAct -> broadcast back to the
    input resolution."""

    def __init__(self, in_channels: int, filters: int,
                 norm: Optional[str] = "sync_batch_norm", act: str = "relu"):
        super().__init__()
        self.conv = ConvNormAct(in_channels, filters, kernel_size=1, norm=norm, act=act)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.conv(x.mean(dim=(2, 3), keepdim=True))
        return pooled.expand(-1, -1, x.shape[2], x.shape[3])


class CommonEndBlock(nn.Module):
    """Head-end block: 3x3 ConvNormAct transform + dropout."""

    def __init__(self, in_channels: int, filters: int, dropout_rate: float = 0.1,
                 norm: Optional[str] = "sync_batch_norm", act: str = "relu"):
        super().__init__()
        self.conv = ConvNormAct(in_channels, filters, kernel_size=3, norm=norm, act=act)
        self.dropout = Dropout(dropout_rate)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.conv(x))
