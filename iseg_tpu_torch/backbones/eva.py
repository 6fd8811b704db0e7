"""EVA02 backbone (counterpart of ``iseg_tpu/backbones/eva.py``): a ViT with
axial 2-D rotary embeddings on q and k, q and v biases without a k bias, a
SwiGLU MLP (with a sub-LayerNorm when ``scale_mlp``), optional train-time
patch dropout and positional dropout, and no final norm.

The module tree mirrors the flax one (``patch_embed``, ``pos_embed``,
``cls_token``, ``block{i}/{norm1, q_proj, k_proj, v_proj, proj, norm2,
mlp/{fc1_g, fc1_x, norm, fc2}}``), so :mod:`iseg_tpu_torch.convert` maps
weights by path. NCHW image in; the endpoints are ``[class token [B, 1, C],
patch embedding, one spatial map per block]``, the maps NCHW at output
stride ``patch_size`` (``endpoint_strides`` gives None for the class token).
Dropout draws (positional and patch dropout) come from the generator that
:func:`iseg_tpu_torch.nn.blocks.set_dropout_generator` sets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.backbones.vit import check_patch_multiple
from iseg_tpu_torch.nn.attention import dot_product_attention
from iseg_tpu_torch.nn.blocks import Dropout, DropPath
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.ops.resize import resample_abs_pos_embed
from iseg_tpu_torch.parallel.collectives import global_rows


def build_rope_2d(gh: int, gw: int, head_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Axial 2-D rotary angles, "cat" layout: base 100 over ``head_dim // 4``
    frequencies, half the rotary dims carry the row, half the column,
    duplicated for rotate-half. Returns float32 (sin, cos), each
    ``[gh*gw, head_dim]``."""
    quarter = head_dim // 4
    inv = 1.0 / (100.0 ** (np.arange(quarter) / quarter))
    ang_h = np.outer(np.arange(gh), inv)
    ang_w = np.outer(np.arange(gw), inv)
    ah = np.repeat(ang_h[:, None, :], gw, axis=1)
    aw = np.repeat(ang_w[None, :, :], gh, axis=0)
    ang = np.concatenate([ah, aw], axis=-1).reshape(gh * gw, head_dim // 2)
    ang = np.concatenate([ang, ang], axis=-1)
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, N, H, D] by tables ``[N, D]`` shared by the batch or
    ``[B, N, D]`` per element (the patch-dropout path), cast to x's type."""
    if sin.ndim == 2:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    return x * cos.to(x.dtype) + _rotate_half(x) * sin.to(x.dtype)


class SwiGLU(nn.Module):
    """``fc2(norm(silu(fc1_g(x)) * fc1_x(x)))``; ``norm`` (LayerNorm, eps
    1e-6) only with ``use_norm``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, use_norm: bool = True):
        super().__init__()
        self.fc1_g = nn.Linear(in_dim, hidden_dim)
        self.fc1_x = nn.Linear(in_dim, hidden_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-6) if use_norm else None
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        if self.norm is not None:
            h = self.norm(h)
        return self.fc2(h)


class PatchDropout(Dropout):
    """Train-time token dropout that keeps the ``num_prefix_tokens`` prefix
    tokens and ``max(1, int(L * (1 - rate)))`` of the ``L`` others, chosen
    at random per batch element and kept in their order. The draw comes
    from ``generator``, as :class:`Dropout`'s."""

    def __init__(self, rate: float = 0.0, num_prefix_tokens: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(rate, generator)
        self.num_prefix_tokens = num_prefix_tokens

    def keep_indices(self, batch: int, num_tokens: int, device) -> torch.Tensor:
        """Sorted ``[batch, num_keep]`` indices of the kept tokens among
        ``num_tokens`` (prefix excluded)."""
        num_keep = max(1, int(num_tokens * (1.0 - self.rate)))
        rows, mine = global_rows(batch)
        noise = torch.rand((rows, num_tokens), generator=self.generator, device=device)[mine]
        return torch.sort(torch.argsort(noise, dim=-1)[:, :num_keep], dim=-1).values

    def forward(self, x: torch.Tensor):
        """``x`` [B, L+p, C] -> (kept tokens [B, num_keep+p, C], the kept
        indices, or None when inactive)."""
        if not self.training or self.rate <= 0.0:
            return x, None
        p = self.num_prefix_tokens
        keep_idx = self.keep_indices(x.shape[0], x.shape[1] - p, x.device)
        return keep_tokens(x, keep_idx, p), keep_idx


def keep_tokens(x: torch.Tensor, keep_idx: torch.Tensor, num_prefix_tokens: int) -> torch.Tensor:
    """The prefix tokens of ``x`` [B, L+p, C] and its tokens at ``keep_idx``
    [B, k] (counted after the prefix)."""
    p = num_prefix_tokens
    kept = torch.gather(x[:, p:], 1, keep_idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :p], kept], dim=1)


class EvaBlock(nn.Module):
    """Pre-LN block: q/v biases and no k bias, RoPE on q and k (the tables
    carry identity rows for the prefix token), global attention, then the
    SwiGLU MLP of hidden width ``int(dim * mlp_ratio)``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4 * 2 / 3,
                 scale_mlp: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.dp1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = SwiGLU(dim, int(dim * mlp_ratio), dim, use_norm=scale_mlp)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        shape = (b, n, self.num_heads, c // self.num_heads)
        h = self.norm1(x)
        q = apply_rope(self.q_proj(h).view(shape), sin, cos)
        k = apply_rope(self.k_proj(h).view(shape), sin, cos)
        v = self.v_proj(h).view(shape)
        x = x + self.dp1(self.proj(dot_product_attention(q, k, v).reshape(b, n, c)))
        return x + self.dp2(self.mlp(self.norm2(x)))


class Eva(nn.Module):
    """``pretrain_grid`` is the side of the positional embedding's grid.
    ``layer_name_pattern`` names the blocks for
    :func:`iseg_tpu_torch.core.optimizer.layerwise_decay_multipliers`."""

    layer_name_pattern = r"block(\d+)"

    def __init__(self, patch_size: int = 14, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, drop_path_rate: float = 0.0,
                 patch_dropout_rate: float = 0.0, pos_dropout_rate: float = 0.0,
                 scale_mlp: bool = True, pretrain_grid: int = 16,
                 return_endpoints: bool = True):
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.num_heads, self.pretrain_grid = num_heads, pretrain_grid
        self.return_endpoints = return_endpoints
        self.patch_embed = Conv2d(3, dim, patch_size, stride=patch_size, padding="VALID")
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid * pretrain_grid + 1, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_dropout = Dropout(pos_dropout_rate)
        self.patch_dropout = PatchDropout(patch_dropout_rate, num_prefix_tokens=1)
        for i in range(depth):
            self.add_module(f"block{i}", EvaBlock(
                dim, num_heads, scale_mlp=scale_mlp,
                drop_path=drop_path_rate * i / max(1, depth - 1)))
        self.out_channels = dim
        self.endpoint_channels = [dim] * (depth + 2)
        self.endpoint_strides = [None] + [patch_size] * (depth + 1)
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def rope_tables(self, gh: int, gw: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """float32 (sin, cos) ``[gh*gw, head_dim]`` on ``device``, made once
        per grid and device."""
        key = (gh, gw, torch.device(device))
        if key not in self._rope:
            sin, cos = build_rope_2d(gh, gw, self.dim // self.num_heads)
            self._rope[key] = (torch.tensor(sin, device=device), torch.tensor(cos, device=device))
        return self._rope[key]

    def forward(self, x: torch.Tensor):
        n = x.shape[0]
        gh, gw = check_patch_multiple(x.shape[2], x.shape[3], self.patch_size)
        patch_embedding = self.patch_embed(x)
        x = patch_embedding.permute(0, 2, 3, 1).reshape(n, gh * gw, self.dim)
        pos = resample_abs_pos_embed(self.pos_embed, (gh, gw),
                                     (self.pretrain_grid, self.pretrain_grid))
        x = torch.cat([self.cls_token.expand(n, 1, self.dim), x], dim=1)
        x = self.pos_dropout(x + pos.to(x.dtype))

        sin, cos = self.rope_tables(gh, gw, x.device)
        x, keep_idx = self.patch_dropout(x)
        if keep_idx is not None:  # each element's tables at its kept positions
            sin, cos = sin[keep_idx], cos[keep_idx]
        # identity rows (sin 0, cos 1) for the class token: every token
        # rotates in one op
        lead = sin.shape[:-2] + (1, sin.shape[-1])
        sin = torch.cat([sin.new_zeros(lead), sin], dim=-2)
        cos = torch.cat([cos.new_ones(lead), cos], dim=-2)

        def to_spatial(tokens: torch.Tensor) -> torch.Tensor:
            """[B, kept, C] spatial tokens -> NCHW map, zeros where dropped."""
            if keep_idx is not None:
                idx = keep_idx[..., None].expand(-1, -1, self.dim)
                tokens = tokens.new_zeros(n, gh * gw, self.dim).scatter(1, idx, tokens)
            return tokens.reshape(n, gh, gw, self.dim).permute(0, 3, 1, 2)

        endpoints = []
        for i in range(self.depth):
            x = self._modules[f"block{i}"](x, sin, cos)
            if self.return_endpoints:
                endpoints.append(to_spatial(x[:, 1:]))
        if self.return_endpoints:
            return [x[:, :1], patch_embedding] + endpoints
        return to_spatial(x[:, 1:])


_VARIANTS = {
    # name: (patch, dim, depth, heads, pretrain_grid, scale_mlp); scale_mlp
    # False is the fused-fc1 GluMlp without its sub-LayerNorm (tiny, small)
    "eva02_tiny": (14, 192, 12, 3, 24, False),
    "eva02_small": (14, 384, 12, 6, 24, False),
    "eva02_base": (14, 768, 12, 12, 16, True),
    "eva02_large": (14, 1024, 24, 16, 16, True),
    "eva02_tiny_patch14_336": (14, 192, 12, 3, 24, False),
    "eva02_large_patch14_224": (14, 1024, 24, 16, 16, True),
    "eva02_large_patch16_224": (16, 1024, 24, 16, 14, True),
    "eva02_large_patch16_512_coco": (16, 1024, 24, 16, 32, True),
    "eva02_large_patch16_512_mv": (16, 1024, 24, 16, 32, True),
}


def _make_ctor(name, patch, dim, depth, heads, grid, scale_mlp):
    def ctor(output_stride=16, return_endpoints=True, **kwargs):
        del output_stride  # the output stride is the patch size
        return Eva(patch_size=patch, dim=dim, depth=depth, num_heads=heads,
                   pretrain_grid=grid, scale_mlp=scale_mlp,
                   return_endpoints=return_endpoints, **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_p, _dim, _depth, _heads, _grid, _sm) in _VARIANTS.items():
    register_backbone(_name, _make_ctor(_name, _p, _dim, _depth, _heads, _grid, _sm))
