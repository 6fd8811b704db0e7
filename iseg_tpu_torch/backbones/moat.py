"""MOAT backbones, variants 0-4 (counterpart of ``iseg_tpu/backbones/moat.py``).

A two-conv stem (3x3/2 conv + BN + GELU, 3x3 conv), two MBConv stages and two
MOAT stages, each stage's first block strided 2. A block is a pre-norm MBConv:
BN -> 1x1 expand to 4x (no bias) -> BN + GELU -> 3x3 depthwise -> BN + GELU ->
[squeeze-excite, MBConv stages only] -> 1x1 shrink (bias), added to a shortcut
(2x2 average pool, "SAME" with the padded zeros counted, in
``promote_types(dtype, float32)``; then a 1x1 conv with bias where the width
changes). A MOAT block follows with LayerNorm (epsilon 1e-5) and multi-head
attention (``num_heads = C // 32``) over whole-map windows by default, or over
``window_size`` windows of the map zero-padded at the bottom and right; with
``use_pos_emb`` a learned relative-position bias per head, stored at
``pos_emb_sizes`` and resized to the window (``jax.image.resize``'s
antialiased bilinear), is added to the logits. The attention is
:func:`iseg_tpu_torch.nn.attention.dot_product_attention`: SDPA on the card,
the plain version on the CPU, the bias as an additive float mask. MBConv
blocks drop their branch with a survival probability that decays linearly over
the blocks; MOAT blocks keep the base one.

NCHW in; the endpoints are ``[stem os2, os4, os8, os16, os32]``. MOAT has no
atrous rewrite: ``output_stride`` is ignored, as in the JAX package. The
module names are the flax tree's (``stem0_conv``, ``stem0_norm``,
``stem1_conv``, ``stage{s}_block{i}`` with ``shortcut``, ``pre_norm``,
``expand_conv``, ``expand_norm``, ``depthwise_conv``, ``depthwise_norm``,
``se``, ``shrink_conv``, ``attn_norm``, ``attn`` with ``q_proj``, ``k_proj``,
``v_proj``, ``o_proj`` and ``rel_pos_embed``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.attention import dot_product_attention
from iseg_tpu_torch.nn.blocks import DropPath, SqueezeExcite
from iseg_tpu_torch.nn.conv import Conv2d, _bn_kwargs, pad_same
from iseg_tpu_torch.nn.norm import normalization
from iseg_tpu_torch.ops.resize import resize_image


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


@functools.lru_cache(maxsize=64)
def rel_pos_index(h: int, w: int) -> np.ndarray:
    """[h*w, h*w] flat indices into a (2h-1, 2w-1) relative-position grid."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                      axis=-1).reshape(-1, 2)
    rel = coords[None, :, :] - coords[:, None, :]  # [S, T, 2]
    return (rel[..., 0] + h - 1) * (2 * w - 1) + rel[..., 1] + w - 1


class MOATAttention(nn.Module):
    """Multi-head attention over ``[B, S, C]`` tokens, q pre-scaled by
    ``head_dim ** -0.5``; with ``pos_embedding_size`` the bare parameter
    ``rel_pos_embed`` ``[heads, 2p-1, 2p-1]`` gives the logits' bias."""

    def __init__(self, dim: int, num_heads: int, pos_embedding_size: Optional[int] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.pos_embedding_size = pos_embedding_size
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.o_proj = nn.Linear(dim, dim)
        self.rel_pos_embed = None
        if pos_embedding_size is not None:
            p = pos_embedding_size
            self.rel_pos_embed = nn.Parameter(torch.zeros(num_heads, 2 * p - 1, 2 * p - 1))

    def relative_bias(self, window_hw: tuple[int, int]) -> torch.Tensor:
        """[heads, S, S] bias of a ``window_hw`` window."""
        wh, ww = window_hw
        table = self.rel_pos_embed
        if table.shape[1:] != (2 * wh - 1, 2 * ww - 1):
            table = resize_image(table.permute(1, 2, 0), (2 * wh - 1, 2 * ww - 1), "bilinear",
                                 antialias=True).permute(2, 0, 1)
        idx = torch.as_tensor(rel_pos_index(wh, ww), device=table.device)
        return table.reshape(self.num_heads, -1)[:, idx]

    def forward(self, x: torch.Tensor, window_hw: tuple[int, int]) -> torch.Tensor:
        b, s, _ = x.shape
        head_dim = self.dim // self.num_heads
        q, k, v = (proj(x).view(b, s, self.num_heads, head_dim)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        bias = self.relative_bias(window_hw)[None] if self.rel_pos_embed is not None else None
        out = dot_product_attention(q, k, v, bias=bias, scale=head_dim ** -0.5)
        return self.o_proj(out.reshape(b, s, self.dim))


class MOATBlock(nn.Module):
    """The MBConv body, and with ``use_attention`` the attention half."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1, expand_ratio: int = 4,
                 se_ratio: Optional[float] = 0.25, survival_prob: Optional[float] = None,
                 use_attention: bool = False, window_size: Optional[Sequence[int]] = None,
                 pos_embedding_size: Optional[int] = None, norm: str = "sync_batch_norm"):
        super().__init__()
        inner = filters * expand_ratio
        self.stride = stride
        self.window_size = tuple(window_size) if window_size is not None else None

        def bn(ch):
            return normalization(norm, **_bn_kwargs(norm))(ch)

        self.shortcut = (Conv2d(in_channels, filters, 1, bias=True)
                         if in_channels != filters else None)
        self.pre_norm = bn(in_channels)
        self.expand_conv = Conv2d(in_channels, inner, 1, bias=False)
        self.expand_norm = bn(inner)
        self.depthwise_conv = Conv2d(inner, inner, 3, stride=stride, groups=inner, bias=False)
        self.depthwise_norm = bn(inner)
        self.se = (SqueezeExcite(inner, max(1, int(filters * se_ratio)), inner_act="silu")
                   if se_ratio is not None else None)
        self.shrink_conv = Conv2d(inner, filters, 1, bias=True)
        rate = 0.0
        if survival_prob is not None and 0 < survival_prob < 1:
            rate = 1.0 - survival_prob
        self.dp_mbconv = DropPath(rate)
        self.use_attention = use_attention
        if use_attention:
            self.attn_norm = nn.LayerNorm(filters, eps=1e-5)
            self.attn = MOATAttention(filters, max(1, filters // 32), pos_embedding_size)
            self.dp_attn = DropPath(rate)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.stride > 1:
            pooled = pad_same(x.to(torch.promote_types(x.dtype, torch.float32)), 2, self.stride)
            shortcut = F.avg_pool2d(pooled, 2, self.stride).to(x.dtype)
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut)
        h = _gelu(self.expand_norm(self.expand_conv(self.pre_norm(x))))
        h = _gelu(self.depthwise_norm(self.depthwise_conv(h)))
        if self.se is not None:
            h = self.se(h)
        x = shortcut + self.dp_mbconv(self.shrink_conv(h))
        if not self.use_attention:
            return x

        n, c, hh, ww = x.shape
        h = self.attn_norm(x.permute(0, 2, 3, 1))  # NHWC
        wh, www = self.window_size if self.window_size is not None else (hh, ww)
        ph, pw = (wh - hh % wh) % wh, (www - ww % www) % www
        if ph or pw:
            h = F.pad(h, (0, 0, 0, pw, 0, ph))
        hp, wp = hh + ph, ww + pw
        h = h.reshape(n, hp // wh, wh, wp // www, www, c).permute(0, 1, 3, 2, 4, 5)
        h = self.attn(h.reshape(-1, wh * www, c), (wh, www))
        h = h.reshape(n, hp // wh, wp // www, wh, www, c).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(n, hp, wp, c)[:, :hh, :ww]
        return x + self.dp_attn(h.permute(0, 3, 1, 2))


class MOAT(nn.Module):
    def __init__(self, stem_filters: int = 64, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 3, 7, 2),
                 block_types: Sequence[str] = ("mbconv", "mbconv", "moat", "moat"),
                 use_pos_emb: bool = False,
                 pos_emb_sizes: Sequence[Optional[int]] = (None, None, 14, 7),
                 window_size: Optional[Sequence[int]] = None,
                 survival_prob: Optional[float] = 0.8, return_endpoints: bool = True,
                 norm: str = "sync_batch_norm", in_channels: int = 3):
        super().__init__()
        self.return_endpoints = return_endpoints
        self.stem0_conv = Conv2d(in_channels, stem_filters, 3, stride=2, bias=True)
        self.stem0_norm = normalization(norm, **_bn_kwargs(norm))(stem_filters)
        self.stem1_conv = Conv2d(stem_filters, stem_filters, 3, bias=True)
        self.endpoint_channels, self.endpoint_strides = [stem_filters], [2]
        total = sum(depths)
        block_id = 0
        ch = stem_filters
        self._stages: list[list[str]] = []
        for stage_idx, (dim, depth, btype) in enumerate(zip(dims, depths, block_types)):
            names = []
            for i in range(depth):
                sp = survival_prob
                if sp is not None and btype == "mbconv":
                    sp = 1.0 - (1.0 - sp) * block_id / total
                name = f"stage{stage_idx}_block{i}"
                self.add_module(name, MOATBlock(
                    ch, dim, stride=2 if i == 0 else 1,
                    se_ratio=0.25 if btype == "mbconv" else None, survival_prob=sp,
                    use_attention=btype == "moat", window_size=window_size,
                    pos_embedding_size=pos_emb_sizes[stage_idx] if use_pos_emb else None,
                    norm=norm))
                names.append(name)
                ch = dim
                block_id += 1
            self._stages.append(names)
            self.endpoint_channels.append(dim)
            self.endpoint_strides.append(4 * 2 ** stage_idx)
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        x = self.stem1_conv(_gelu(self.stem0_norm(self.stem0_conv(x))))
        endpoints = [x]
        for names in self._stages:
            for name in names:
                x = self._modules[name](x)
            endpoints.append(x)
        return endpoints if self.return_endpoints else x


_VARIANTS = {
    # name: (stem, dims, depths, survival_prob)
    "moat0": (64, (96, 192, 384, 768), (2, 3, 7, 2), 0.8),
    "moat1": (64, (96, 192, 384, 768), (2, 6, 14, 2), 0.7),
    "moat2": (128, (128, 256, 512, 1024), (2, 6, 14, 2), 0.7),
    "moat3": (160, (160, 320, 640, 1280), (2, 12, 28, 2), 0.4),
    "moat4": (256, (256, 512, 1024, 2048), (2, 12, 28, 2), 0.3),
}


def _make_ctor(name, stem, dims, depths, sp):
    def ctor(output_stride=32, return_endpoints=True, use_pos_emb=False, **kwargs):
        del output_stride
        return MOAT(stem_filters=stem, dims=dims, depths=depths, survival_prob=sp,
                    use_pos_emb=use_pos_emb, return_endpoints=return_endpoints, **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_s, _dims, _depths, _sp) in _VARIANTS.items():
    register_backbone(_name, _make_ctor(_name, _s, _dims, _depths, _sp))
