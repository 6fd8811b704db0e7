"""MLP-Mixer backbones, B/16 and L/16 (counterpart of
``iseg_tpu/backbones/mlp_mixer.py``).

A patch embedding (``patch_size`` conv, stride ``patch_size``), then mixer
blocks: LayerNorm (epsilon 1e-3) -> token-mixing MLP over the patches ->
residual; LayerNorm -> channel-mixing MLP -> residual (exact GELU); a final
LayerNorm. The token-mixing MLP's output width is the number of patches,
so the input size is fixed when the module is built: ``input_size`` (H,
W), 224 x 224 by default, the published models' resolution. The JAX module
takes the size from its first call; another size raises here, as a
weight of the wrong shape would there. NCHW in; one endpoint, the NCHW
map of the final tokens at stride ``patch_size``. The module names are the
flax tree's (``patch_embed``, ``block{i}`` with ``norm1``, ``token_fc1``,
``token_fc2``, ``norm2``, ``channel_fc1``, ``channel_fc2``, and ``norm``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.conv import Conv2d


class MixerBlock(nn.Module):
    """``[B, N, C]`` tokens in and out."""

    def __init__(self, num_tokens: int, dim: int, tokens_dim: int, channels_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-3)
        self.token_fc1 = nn.Linear(num_tokens, tokens_dim)
        self.token_fc2 = nn.Linear(tokens_dim, num_tokens)
        self.norm2 = nn.LayerNorm(dim, eps=1e-3)
        self.channel_fc1 = nn.Linear(dim, channels_dim)
        self.channel_fc2 = nn.Linear(channels_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x).transpose(1, 2)
        h = self.token_fc2(F.gelu(self.token_fc1(h), approximate="none"))
        x = x + h.transpose(1, 2)
        h = self.channel_fc2(F.gelu(self.channel_fc1(self.norm2(x)), approximate="none"))
        return x + h


class MLPMixer(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 tokens_mlp_dim: int = 384, channels_mlp_dim: int = 3072,
                 input_size: int | Sequence[int] = 224, return_endpoints: bool = True,
                 in_channels: int = 3):
        super().__init__()
        h, w = (input_size, input_size) if isinstance(input_size, int) else tuple(input_size)
        if h % patch_size or w % patch_size:
            raise ValueError(f"input {h}x{w} must be a multiple of patch_size {patch_size}")
        self.input_size, self.patch_size, self.dim = (h, w), patch_size, dim
        self.return_endpoints = return_endpoints
        num_tokens = (h // patch_size) * (w // patch_size)
        self.patch_embed = Conv2d(in_channels, dim, patch_size, stride=patch_size, bias=True)
        for i in range(depth):
            self.add_module(f"block{i}", MixerBlock(num_tokens, dim, tokens_mlp_dim,
                                                    channels_mlp_dim))
        self.depth = depth
        self.norm = nn.LayerNorm(dim, eps=1e-3)
        self.endpoint_channels, self.endpoint_strides = [dim], [patch_size]
        self.out_channels = dim

    def forward(self, x: torch.Tensor):
        n, _, h, w = x.shape
        if (h, w) != self.input_size:
            raise ValueError(f"this MLP-Mixer was built for {self.input_size[0]}x"
                             f"{self.input_size[1]} inputs (its token-mixing weights fix the "
                             f"patch count); got {h}x{w}: build it with input_size=({h}, {w})")
        gh, gw = h // self.patch_size, w // self.patch_size
        x = self.patch_embed(x).permute(0, 2, 3, 1).reshape(n, gh * gw, self.dim)
        for i in range(self.depth):
            x = self._modules[f"block{i}"](x)
        spatial = self.norm(x).reshape(n, gh, gw, self.dim).permute(0, 3, 1, 2)
        return [spatial] if self.return_endpoints else spatial


@register_backbone("mlp_mixer_b16")
def mlp_mixer_b16(output_stride: int = 16, return_endpoints: bool = True, **kwargs):
    del output_stride
    return MLPMixer(dim=768, depth=12, tokens_mlp_dim=384, channels_mlp_dim=3072,
                    return_endpoints=return_endpoints, **kwargs)


@register_backbone("mlp_mixer_l16")
def mlp_mixer_l16(output_stride: int = 16, return_endpoints: bool = True, **kwargs):
    del output_stride
    return MLPMixer(dim=1024, depth=24, tokens_mlp_dim=512, channels_mlp_dim=4096,
                    return_endpoints=return_endpoints, **kwargs)
