"""InternImage backbone, DCNv3-based (counterpart of
``iseg_tpu/backbones/intern_image.py``): conv stem to os4, four stages of
(DCNv3 + LN + MLP) blocks with layer scale and drop-path, bias-free
strided-conv downsampling between stages.

The module tree mirrors the flax one (``stem_conv1``, ``stem_norm1``,
``stage{s}_block{i}/dcn/...``, ``norm1``, ``norm2``, ``mlp_fc1``,
``mlp_fc2``, ``gamma1``, ``gamma2``, ``downsample{s}``,
``downsample_norm{s}``, ``stage{s}_norm``), so
:mod:`iseg_tpu_torch.convert` maps weights by path.

The backbone takes an NCHW image and returns NCHW endpoints like the other
backbones of the port; the blocks work on NHWC tokens as in the JAX
module, and the convs see them as channels_last NCHW views.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from iseg_tpu_torch.backbones.registry import register_backbone
from iseg_tpu_torch.nn.blocks import DropPath
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.nn.dcn import DCNv3


def _nhwc_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Run an NCHW conv on an NHWC tensor; both permutes are views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class InternImageBlock(nn.Module):
    """NHWC in and out. ``use_post_norm`` applies ``norm1``/``norm2`` AFTER
    the DCN and the MLP instead of before; ``layer_scale`` (None for no
    scaling) is the initial value of the per-channel ``gamma1``/``gamma2``."""

    def __init__(self, dim: int, groups: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 layer_scale: Optional[float] = None, use_post_norm: bool = False,
                 dcn_sampling: str = "gather", dcn_max_local_offset: int = 2):
        super().__init__()
        self.layer_scale = layer_scale
        self.use_post_norm = use_post_norm
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.dcn = DCNv3(dim, dim, groups=groups, sampling=dcn_sampling,
                         max_local_offset=dcn_max_local_offset)
        self.dp1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.dp2 = DropPath(drop_path)
        if layer_scale is not None:
            self.gamma1 = nn.Parameter(torch.full((dim,), float(layer_scale)))
            self.gamma2 = nn.Parameter(torch.full((dim,), float(layer_scale)))

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self.dcn(x)) if self.use_post_norm else self.dcn(self.norm1(x))
        if self.layer_scale is not None:
            h = h * self.gamma1
        x = x + self.dp1(h)
        h = self.norm2(self._mlp(x)) if self.use_post_norm else self._mlp(self.norm2(x))
        if self.layer_scale is not None:
            h = h * self.gamma2
        return x + self.dp2(h)


class InternImage(nn.Module):
    """NCHW image -> five NCHW endpoints: the os2 stem feature and the four
    stage outputs (os4 to os32; normed unless ``use_post_norm``).
    ``endpoint_channels`` lists their widths, ``endpoint_strides`` their
    output strides and ``out_channels`` the last one's width.

    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations; the
    recompute draws the same drop-path masks. ``dcn_overrides`` maps a block
    name (``"stage{S}_block{I}"``) to its own ``(sampling,
    max_local_offset)``; :meth:`clone` rebuilds the backbone with other
    arguments (flax's ``Module.clone``), as DCN calibration does."""

    def __init__(self, channels: int = 64, depths: Sequence[int] = (4, 4, 18, 4),
                 groups: Sequence[int] = (4, 8, 16, 32), mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2, layer_scale: Optional[float] = None,
                 use_post_norm: bool = False, remat: bool = False,
                 dcn_sampling: str = "gather", dcn_max_local_offset: int = 2,
                 dcn_overrides: Optional[Mapping[str, tuple]] = None,
                 return_endpoints: bool = True):
        super().__init__()
        self.config = dict(channels=channels, depths=tuple(depths), groups=tuple(groups),
                           mlp_ratio=mlp_ratio, drop_path_rate=drop_path_rate,
                           layer_scale=layer_scale, use_post_norm=use_post_norm, remat=remat,
                           dcn_sampling=dcn_sampling, dcn_max_local_offset=dcn_max_local_offset,
                           dcn_overrides=dcn_overrides, return_endpoints=return_endpoints)
        self.dcn_overrides = dict(dcn_overrides) if dcn_overrides else None
        self.depths = tuple(depths)
        self.use_post_norm = use_post_norm
        self.remat = remat
        self.return_endpoints = return_endpoints
        # stem: two stride-2 convs -> os4
        self.stem_conv1 = Conv2d(3, channels // 2, 3, stride=2, padding="SAME")
        self.stem_norm1 = nn.LayerNorm(channels // 2, eps=1e-6)
        self.stem_conv2 = Conv2d(channels // 2, channels, 3, stride=2, padding="SAME")
        self.stem_norm2 = nn.LayerNorm(channels, eps=1e-6)
        self.endpoint_channels = [channels // 2]
        total = sum(self.depths)
        block_idx = 0
        for s, (depth, g) in enumerate(zip(self.depths, groups)):
            dim = channels * 2 ** s
            if s > 0:
                self.add_module(f"downsample{s}", Conv2d(dim // 2, dim, 3, stride=2,
                                                         bias=False, padding="SAME"))
                self.add_module(f"downsample_norm{s}", nn.LayerNorm(dim, eps=1e-6))
            for i in range(depth):
                name = f"stage{s}_block{i}"
                sampling, r = dcn_sampling, dcn_max_local_offset
                if dcn_overrides and name in dcn_overrides:
                    sampling, r = dcn_overrides[name]
                self.add_module(name, InternImageBlock(
                    dim, g, mlp_ratio=mlp_ratio,
                    drop_path=drop_path_rate * block_idx / max(1, total - 1),
                    layer_scale=layer_scale, use_post_norm=use_post_norm,
                    dcn_sampling=sampling, dcn_max_local_offset=r))
                block_idx += 1
            if not use_post_norm:
                self.add_module(f"stage{s}_norm", nn.LayerNorm(dim, eps=1e-6))
            self.endpoint_channels.append(dim)
        self.out_channels = self.endpoint_channels[-1]
        self.endpoint_strides = [2] + [4 * 2 ** s for s in range(len(self.depths))]

    @torch.no_grad()
    def clone(self, **changes) -> "InternImage":
        """A new InternImage built with this one's arguments and ``changes``
        (for example ``dcn_overrides``), holding copies of this one's
        parameters and buffers on their devices, in their dtypes and memory
        formats, in this one's train or eval mode, its drop-path layers
        drawing from the same generators."""
        new = InternImage(**{**self.config, **changes})
        new.load_state_dict({k: v.clone() for k, v in self.state_dict().items()}, assign=True)
        for mine, theirs in zip(new.modules(), self.modules()):
            if isinstance(mine, DropPath):
                mine.generator = theirs.generator
        return new.train(self.training)

    def _run_block(self, block: InternImageBlock, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return block(x)
        # checkpoint's own RNG bookkeeping covers torch's default generators
        # only: the drop-path layers' explicit generators are rewound for the
        # recompute here, and put back where they were after it
        generators = {id(m.generator): m.generator for m in (block.dp1, block.dp2)
                      if m.generator is not None}.values()
        at_forward = [(gen, gen.get_state()) for gen in generators]
        calls = [0]

        def run(inp):
            calls[0] += 1
            if calls[0] == 1:
                return block(inp)
            now = [(gen, gen.get_state()) for gen, _ in at_forward]
            for gen, state in at_forward:
                gen.set_state(state)
            try:
                return block(inp)
            finally:
                for gen, state in now:
                    gen.set_state(state)

        return checkpoint(run, x, use_reentrant=False)

    def forward(self, x: torch.Tensor):
        x = self.stem_conv1(x).permute(0, 2, 3, 1)
        x = F.gelu(self.stem_norm1(x), approximate="none")
        endpoints = [x]  # the os2 feature after conv1/norm1/act
        x = self.stem_norm2(_nhwc_conv(self.stem_conv2, x))
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = _nhwc_conv(self._modules[f"downsample{s}"], x)
                x = self._modules[f"downsample_norm{s}"](x)
            for i in range(depth):
                x = self._run_block(self._modules[f"stage{s}_block{i}"], x)
            if not self.use_post_norm:
                x = self._modules[f"stage{s}_norm"](x)
            endpoints.append(x)
        if self.return_endpoints:
            return [e.permute(0, 3, 1, 2) for e in endpoints]
        return x.permute(0, 3, 1, 2)


_VARIANTS = {
    # name: (channels, depths, groups, layer_scale, use_post_norm)
    "intern_image_tiny": (64, (4, 4, 18, 4), (4, 8, 16, 32), 1.0, False),
    "intern_image_small": (80, (4, 4, 21, 4), (5, 10, 20, 40), 1.0, True),
    "intern_image_base": (112, (4, 4, 21, 4), (7, 14, 28, 56), 1.0, True),
    "intern_image_large": (160, (5, 5, 22, 5), (10, 20, 40, 80), 1.0, True),
    "intern_image_huge": (320, (6, 6, 32, 6), (10, 20, 40, 80), None, False),
}


def _make_ctor(name, ch, depths, groups, ls, post_norm):
    def ctor(output_stride=32, return_endpoints=True, **kwargs):
        del output_stride  # the hierarchy is fixed
        return InternImage(channels=ch, depths=depths, groups=groups, layer_scale=ls,
                           use_post_norm=post_norm, return_endpoints=return_endpoints,
                           **kwargs)

    ctor.__name__ = name
    return ctor


for _name, (_ch, _d, _g, _ls, _pn) in _VARIANTS.items():
    register_backbone(_name, _make_ctor(_name, _ch, _d, _g, _ls, _pn))
