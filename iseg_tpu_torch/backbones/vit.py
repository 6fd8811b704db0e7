"""Vision Transformer backbone (counterpart of ``iseg_tpu/backbones/vit.py``):
patch embedding, class token, a learned absolute positional embedding
resampled to the input's grid on every forward (bicubic, as
``jax.image.resize``: :func:`iseg_tpu_torch.ops.resize.resample_abs_pos_embed`),
pre-LN transformer blocks, and no final norm unless ``use_final_norm``.

The module tree mirrors the flax one (``patch_embed``, ``pos_embed``,
``cls_token``, ``block{i}/{norm1, qkv, proj, norm2, mlp_fc1, mlp_fc2}``,
``norm``), so :mod:`iseg_tpu_torch.convert` maps weights by path. NCHW
image in; one NCHW endpoint out, the token map at output stride
``patch_size`` (a channels_last view of the tokens). Global attention is
:func:`iseg_tpu_torch.nn.attention.dot_product_attention` (SDPA on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.attention import dot_product_attention
from iseg_tpu_torch.nn.blocks import DropPath
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.ops.resize import resample_abs_pos_embed


def check_patch_multiple(h: int, w: int, patch_size: int) -> tuple[int, int]:
    """The token grid of an ``h`` x ``w`` input; raises unless both are
    multiples of ``patch_size``."""
    if h % patch_size or w % patch_size:
        raise ValueError(f"input {h}x{w} must be a multiple of patch_size {patch_size} "
                         "(pad or bucket the input first)")
    return h // patch_size, w // patch_size


class TransformerBlock(nn.Module):
    """Pre-LN block on ``[B, N, C]`` tokens: LayerNorm (eps 1e-6) -> one
    ``qkv`` projection split into q, k, v -> global MHSA -> ``proj``; then
    LayerNorm -> MLP with exact GELU; each branch through drop-path."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.dp1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(self.norm1(x)).view(b, n, 3, self.num_heads,
                                                c // self.num_heads).unbind(2)
        x = x + self.dp1(self.proj(dot_product_attention(q, k, v).reshape(b, n, c)))
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + self.dp2(h)


class VisionTransformer(nn.Module):
    """``pretrain_grid`` is the token grid the positional embedding was
    trained at (its side); ``endpoint_channels``, ``endpoint_strides`` and
    ``out_channels`` describe the one endpoint."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 use_class_token: bool = True, pretrain_grid: int = 14,
                 use_final_norm: bool = False, return_endpoints: bool = True):
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.pretrain_grid = pretrain_grid
        self.return_endpoints = return_endpoints
        self.num_prefix_tokens = 1 if use_class_token else 0
        self.patch_embed = Conv2d(3, dim, patch_size, stride=patch_size, padding="VALID")
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pretrain_grid * pretrain_grid + self.num_prefix_tokens, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim)) if use_class_token else None
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, num_heads, mlp_ratio, drop_path=drop_path_rate * i / max(1, depth - 1)))
        self.norm = nn.LayerNorm(dim, eps=1e-6) if use_final_norm else None
        self.out_channels = dim
        self.endpoint_channels = [dim]
        self.endpoint_strides = [patch_size]

    def forward(self, x: torch.Tensor):
        n = x.shape[0]
        gh, gw = check_patch_multiple(x.shape[2], x.shape[3], self.patch_size)
        x = self.patch_embed(x).permute(0, 2, 3, 1).reshape(n, gh * gw, self.dim)
        pos = resample_abs_pos_embed(self.pos_embed, (gh, gw),
                                     (self.pretrain_grid, self.pretrain_grid),
                                     num_prefix_tokens=self.num_prefix_tokens)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.expand(n, 1, self.dim), x], dim=1)
        x = x + pos.to(x.dtype)
        for i in range(self.depth):
            x = self._modules[f"block{i}"](x)
        if self.norm is not None:
            x = self.norm(x)
        spatial = x[:, self.num_prefix_tokens:].reshape(n, gh, gw, self.dim).permute(0, 3, 1, 2)
        return [spatial] if self.return_endpoints else spatial


_VARIANTS = {
    # name: (patch, dim, depth, heads, pretrain_grid); the SAM variants have no
    # class token and a pretrain grid of 64 (1024 / 16)
    "vit_small_patch16": (16, 384, 12, 6, 24),
    "vit_base_patch16": (16, 768, 12, 12, 24),
    "vit_large_patch16": (16, 1024, 24, 16, 24),
    "vit_base_patch16_sam": (16, 768, 12, 12, 64),
    "vit_large_patch16_sam": (16, 1024, 24, 16, 64),
}


def _make_ctor(name, patch, dim, depth, heads, grid):
    def ctor(output_stride=16, return_endpoints=True, **kwargs):
        del output_stride  # the output stride is the patch size
        return VisionTransformer(patch_size=patch, dim=dim, depth=depth, num_heads=heads,
                                 pretrain_grid=grid, use_class_token="sam" not in name,
                                 return_endpoints=return_endpoints, **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_p, _dim, _depth, _heads, _grid) in _VARIANTS.items():
    register_backbone(_name, _make_ctor(_name, _p, _dim, _depth, _heads, _grid))
