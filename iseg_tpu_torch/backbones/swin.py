"""Swin Transformer backbone (counterpart of ``iseg_tpu/backbones/swin.py``).

The module tree mirrors the flax one (``patch_embed``, ``patch_norm``,
``stage{s}_block{i}/attn/qkv``, ``.../attn/proj``, ``norm1``, ``norm2``,
``mlp_fc1``, ``mlp_fc2``, ``merge{s}/norm``, ``merge{s}/reduction``), so
:mod:`iseg_tpu_torch.convert` maps weights by path.

The backbone takes an NCHW image and returns NCHW endpoints like the other
backbones of the port; between the patch embedding and the endpoints the
tokens are NHWC, as in the JAX module, so the endpoints are channels_last
views. The window attention of every block is
:func:`iseg_tpu_torch.ops.kernels.window_attention.window_attention`: the
hand-written CUDA kernels on the card, the plain version on the CPU. The
relative-position bias stays fp32 under bf16 autocast (the JAX model path
rounds it to q's dtype).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.blocks import DropPath
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.ops.kernels.window_attention import window_attention


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws, ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """Static [ws*ws, ws*ws] lookup into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Mask for shifted-window attention: [num_windows, N, N] additive
    mask, 0 within a region, -100 across regions."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Window multi-head self-attention with a relative position bias.

    ``forward(x, mask)``: x ``[num_windows*B, N, C]``, mask ``[nW, N, N]``
    float32 additive (zeros ``[1, N, N]`` for an unshifted block)."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.tensor(_relative_position_index(window_size).reshape(-1), dtype=torch.long),
            persistent=False)

    def relative_position_bias(self) -> torch.Tensor:
        """[heads, N, N], gathered from the table (its gradient is the
        gather's backward, an ``index_add``)."""
        n = self.window_size ** 2
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.view(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        bnw, n, c = x.shape
        head_dim = self.dim // self.num_heads
        # q, k, v [bnw, H, N, D] as views of the packed projection
        q, k, v = (t.permute(0, 2, 1, 3)
                   for t in self.qkv(x).view(bnw, n, 3, self.num_heads, head_dim).unbind(2))
        out = window_attention(q, k, v, self.relative_position_bias(), mask,
                               1.0 / math.sqrt(head_dim))
        return self.proj(out.transpose(1, 2).reshape(bnw, n, c))


class SwinBlock(nn.Module):
    """NHWC in and out. The window size is fixed: a map that is no multiple
    of it is zero-padded (after ``norm1``) at the bottom and right, and the
    padded tokens take part in the attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.dp1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.dp2 = DropPath(drop_path)
        self._masks: dict[tuple, torch.Tensor] = {}  # per padded (h, w) and device

    def _mask(self, hp: int, wp: int, device: torch.device) -> torch.Tensor:
        key = (hp, wp, device)
        if key not in self._masks:
            n = self.window_size ** 2
            mask = (_shift_attn_mask(hp, wp, self.window_size, self.shift) if self.shift > 0
                    else np.zeros((1, n, n), np.float32))
            self._masks[key] = torch.tensor(mask, device=device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        shortcut = x
        x = self.norm1(x)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        windows = window_partition(x, ws).reshape(-1, ws * ws, c)
        attn = self.attn(windows, self._mask(hp, wp, x.device))
        x = window_reverse(attn.reshape(-1, ws, ws, c), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if ph or pw:
            x = x[:, :h, :w]
        x = shortcut + self.dp1(x)
        hmlp = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + self.dp2(hmlp)


class PatchMerging(nn.Module):
    """2x2 patch concat + LayerNorm + linear reduce ``in_dim`` -> ``out_dim``
    (NHWC; an odd map is zero-padded at the bottom and right)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_dim, eps=1e-5)
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = x.shape[1] % 2, x.shape[2] % 2
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """NCHW image -> five NCHW endpoints: the patch embedding (os4), the
    ends of stages 0-2 before each merge (os4, os8, os16) and the last
    block's output (os32, no final norm). ``endpoint_channels`` lists their
    widths, ``endpoint_strides`` their output strides and ``out_channels``
    the last one's width."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 return_endpoints: bool = True):
        super().__init__()
        self.depths = tuple(depths)
        self.return_endpoints = return_endpoints
        # flax's nn.Conv pads "SAME": bottom/right for a size that is no multiple of 4
        self.patch_embed = Conv2d(3, embed_dim, 4, stride=4, padding="SAME")
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.endpoint_channels = [embed_dim]
        total = sum(self.depths)
        block_idx = 0
        for s, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            dim = embed_dim * 2 ** s
            if s > 0:
                self.endpoint_channels.append(dim // 2)
                self.add_module(f"merge{s}", PatchMerging(dim // 2, dim))
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", SwinBlock(
                    dim, heads, window_size, shift=0 if i % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio,
                    drop_path=drop_path_rate * block_idx / max(1, total - 1)))
                block_idx += 1
        self.out_channels = embed_dim * 2 ** (len(self.depths) - 1)
        self.endpoint_channels.append(self.out_channels)
        self.endpoint_strides = [4] + [4 * 2 ** s for s in range(len(self.depths))]

    def forward(self, x: torch.Tensor):
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        endpoints = [x]
        for s, depth in enumerate(self.depths):
            if s > 0:
                endpoints.append(x)
                x = self._modules[f"merge{s}"](x)
            for i in range(depth):
                x = self._modules[f"stage{s}_block{i}"](x)
        endpoints.append(x)
        if self.return_endpoints:
            return [e.permute(0, 3, 1, 2) for e in endpoints]
        return x.permute(0, 3, 1, 2)


_VARIANTS = {
    # name: (embed_dim, depths, heads, window)
    "swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "swin_small": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "swin_base": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7),
    "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 7),
    "swin_base_384": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12),
    "swin_large_384": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12),
    # reference vocabulary alias
    "swin_tiny_224": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
}


def _make_ctor(name, dim, depths, heads, window):
    def ctor(output_stride=32, return_endpoints=True, **kwargs):
        del output_stride  # the hierarchy is fixed; heads consume the pyramid
        return SwinTransformer(embed_dim=dim, depths=depths, num_heads=heads,
                               window_size=window, return_endpoints=return_endpoints,
                               **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_dim, _depths, _heads, _win) in _VARIANTS.items():
    register_backbone(_name, _make_ctor(_name, _dim, _depths, _heads, _win))
