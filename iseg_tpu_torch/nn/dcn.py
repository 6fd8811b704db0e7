"""Deformable convolutions v2 and v3 (counterpart of ``iseg_tpu/nn/dcn.py``).

Both modules take and return NHWC tensors, as the JAX modules do: DCNv3
works on ``nn.Linear`` outputs, so channels-last is its natural layout, and
the samplers of :mod:`iseg_tpu_torch.ops.deform` are NHWC. The submodule
names mirror the flax tree (``value_proj``, ``dw_conv``, ``offset_norm``,
``offset_head``, ``mask_head``, ``output_proj``; ``offset_conv``), so
:mod:`iseg_tpu_torch.convert` maps weights by path.

In the two dense-local modes of ``DCNv3`` the sampling is
:func:`iseg_tpu_torch.ops.deform.dense_local_flat`: the hand-written CUDA
kernels on a CUDA tensor, their plain versions on a CPU tensor. There is no
switch between them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.ops.deform import (
    dcnv3_ref_effective_offsets_grouped,
    dcnv3_sample_ref,
    deform_dense_local_taps,
    deform_im2col,
    dense_local_flat,
)

DCNV3_SAMPLING_MODES = ("auto", "gather", "gather_centered", "dense_local", "dense_local_ref")


def _zero_init(module: nn.Module) -> nn.Module:
    """Mark a conv or linear layer whose kernel starts at zero (flax's
    ``zeros_init``); :func:`iseg_tpu_torch.nn.initializers.initialize`
    honours the mark."""
    module.zero_init_kernel = True
    with torch.no_grad():
        module.weight.zero_()
        if module.bias is not None:
            module.bias.zero_()
    return module


class DCNv2(nn.Module):
    """Modulated deformable conv: a regular conv gives per-tap offsets and
    sigmoid modulation (zero-initialized, so the layer starts as a plain
    conv), the input is sampled bilinearly at the deformed taps, and the
    taps are reduced by a dense ``[K*K*C, filters]`` kernel.

    ``forward(x, offset_input=None)``: with ``offset_input`` the offset conv
    reads it instead of ``x`` (feature alignment); its width is
    ``offset_in_channels``. ``sampling`` is ``"gather"`` (exact, unbounded
    offsets) or ``"dense_local"`` (offsets clamped to
    ``+-max_local_offset``, stride and dilation 1 only; other geometry
    falls back to the gather)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, use_bias: bool = True, sampling: str = "gather",
                 max_local_offset: int = 2, offset_in_channels: Optional[int] = None):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.dilation = k, stride, dilation
        self.sampling, self.max_local_offset = sampling, max_local_offset
        self.offset_conv = _zero_init(Conv2d(
            offset_in_channels if offset_in_channels is not None else in_channels,
            3 * k * k, k, stride=stride, dilation=dilation, padding="SAME"))
        self.kernel = nn.Parameter(torch.empty(k * k * in_channels, filters))
        nn.init.normal_(self.kernel, std=(k * k * in_channels) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(filters)) if use_bias else None

    def forward(self, x: torch.Tensor, offset_input: Optional[torch.Tensor] = None):
        n, h, w, c = x.shape
        k = self.kernel_size
        kk = k * k
        src = x if offset_input is None else offset_input
        off_mask = self.offset_conv(src.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        ho, wo = off_mask.shape[1], off_mask.shape[2]
        offsets = off_mask[..., :2 * kk].reshape(n, ho, wo, kk, 2)
        mask = torch.sigmoid(off_mask[..., 2 * kk:])
        if self.sampling == "dense_local" and self.stride == 1 and self.dilation == 1:
            taps = deform_dense_local_taps(x, offsets, kernel_size=k,
                                           max_offset=self.max_local_offset)
        else:
            taps = deform_im2col(x, offsets, kernel_size=k, stride=self.stride,
                                 dilation=self.dilation)  # [N, Ho, Wo, K*K, C]
        taps = taps * mask[..., None].to(taps.dtype)
        out = F.linear(taps.reshape(n, ho, wo, kk * c), self.kernel.t(), self.bias)
        return out.to(taps.dtype)


class DCNv3(nn.Module):
    """Grouped deformable conv v3: value projection -> offsets and
    softmax modulation per group from a depthwise-conv feature -> grouped
    sampling -> output projection. NHWC in and out.

    ``sampling``:

    * ``"gather"``: reference-exact sampling (half-pixel base grid,
      ``(dim-2)`` scaling; what published InternImage weights were trained
      with), unbounded offsets, index gathers;
    * ``"dense_local_ref"``: the same semantics through
      :func:`dense_local_flat` on the transposed value plane, exact while
      every effective offset stays within ``+-max_local_offset``; square
      stride-1 dilation-1 maps only, else it resolves to ``"gather"``;
    * ``"gather_centered"``: centred sampling (tap centres at integer
      pixels, zero outside);
    * ``"dense_local"``: the centred semantics through
      :func:`dense_local_flat`, offsets clamped to ``+-max_local_offset``;
      stride-1 dilation-1 only, else it resolves to ``"gather_centered"``;
    * ``"auto"``: ``"dense_local_ref"`` when the map qualifies,
      ``"gather"`` otherwise.
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3, groups: int = 4,
                 stride: int = 1, dilation: int = 1, offset_scale: float = 1.0,
                 sampling: str = "gather", max_local_offset: int = 2):
        super().__init__()
        if filters % groups != 0:
            raise ValueError(f"filters {filters} not divisible by groups {groups}")
        k = kernel_size
        self.filters, self.kernel_size, self.groups = filters, k, groups
        self.stride, self.dilation, self.offset_scale = stride, dilation, offset_scale
        self.sampling, self.max_local_offset = sampling, max_local_offset
        self.value_proj = nn.Linear(in_channels, filters)
        self.dw_conv = Conv2d(in_channels, in_channels, k, stride=stride, groups=in_channels,
                              padding="SAME")
        self.offset_norm = nn.LayerNorm(in_channels, eps=1e-6)
        self.offset_head = _zero_init(nn.Linear(in_channels, 2 * groups * k * k))
        self.mask_head = _zero_init(nn.Linear(in_channels, groups * k * k))
        self.output_proj = nn.Linear(filters, filters)
        # a list while calibrate_dcn_sampling runs: each forward on a
        # qualifying map appends its max |effective offset|
        self.offset_magnitudes: Optional[list] = None

    def resolve_sampling(self, h: int, w: int) -> str:
        """The sampler an ``h x w`` input takes under ``self.sampling``."""
        sampling = self.sampling
        if sampling not in DCNV3_SAMPLING_MODES:
            raise ValueError(f"unknown DCNv3 sampling mode {sampling!r}")
        local_ok = self.stride == 1 and self.dilation == 1
        if sampling == "auto":
            return "dense_local_ref" if (h == w and local_ok) else "gather"
        if sampling == "dense_local" and not local_ok:
            # stay in the centred semantics family
            return "gather_centered"
        if sampling == "dense_local_ref" and not (h == w and local_ok):
            return "gather"  # same reference semantics, general geometry
        return sampling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        k, g = self.kernel_size, self.groups
        kk = k * k
        gc = self.filters // g
        v = self.value_proj(x)
        feat = self.dw_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        feat = F.gelu(self.offset_norm(feat), approximate="none")
        offsets = self.offset_head(feat)
        ho, wo = offsets.shape[1], offsets.shape[2]
        offsets = offsets.reshape(n, ho, wo, g, kk, 2)
        # softmax over the K*K taps per group, in fp32
        modul = torch.softmax(self.mask_head(feat).reshape(n, ho, wo, g, kk).float(), dim=-1)
        modul = modul.to(v.dtype)

        sampling = self.resolve_sampling(h, w)
        if (self.offset_magnitudes is not None and h == w and self.stride == 1
                and self.dilation == 1):
            eff_dy, eff_dx = dcnv3_ref_effective_offsets_grouped(
                offsets, h, w, kernel_size=k, offset_scale=self.offset_scale)
            self.offset_magnitudes.append(float(torch.maximum(eff_dy.abs().max(),
                                                              eff_dx.abs().max())))

        if sampling in ("dense_local", "dense_local_ref"):
            # the values stay [N, H, W, G*gc]: no group fold
            m_flat = modul.reshape(n, ho, wo, g * kk)
            if sampling == "dense_local":
                off_dy = offsets[..., 0].reshape(n, ho, wo, g * kk) * self.offset_scale
                off_dx = offsets[..., 1].reshape(n, ho, wo, g * kk) * self.offset_scale
                out = dense_local_flat(v, off_dy, off_dx, m_flat, g, k, self.max_local_offset)
            else:
                eff_dy, eff_dx = dcnv3_ref_effective_offsets_grouped(
                    offsets, h, w, kernel_size=k, offset_scale=self.offset_scale)
                # the reference's output-index quirk: one spatial transpose
                # of the value plane, taken as a view by the CUDA kernels
                vt = v.transpose(1, 2)
                out = dense_local_flat(vt, eff_dy, eff_dx, m_flat, g, k, self.max_local_offset)
            return self.output_proj(out)

        # fold groups into the batch dim for the gather paths
        vg = v.reshape(n, h, w, g, gc).permute(0, 3, 1, 2, 4).reshape(n * g, h, w, gc)
        off_b = offsets.permute(0, 3, 1, 2, 4, 5).reshape(n * g, ho, wo, kk, 2)
        mod_b = modul.permute(0, 3, 1, 2, 4).reshape(n * g, ho, wo, kk)
        if sampling == "gather_centered":
            taps = deform_im2col(vg, off_b * self.offset_scale, kernel_size=k,
                                 stride=self.stride, dilation=self.dilation)
            out = torch.einsum("bhwtc,bhwt->bhwc", taps, mod_b)
        else:
            out = dcnv3_sample_ref(vg, off_b, mod_b, kernel_size=k, stride=self.stride,
                                   dilation=self.dilation, offset_scale=self.offset_scale)
        out = out.reshape(n, g, ho, wo, gc).permute(0, 2, 3, 1, 4).reshape(n, ho, wo, g * gc)
        return self.output_proj(out)


@torch.no_grad()
def calibrate_dcn_sampling(model: nn.Module, x: torch.Tensor, train: bool = False,
                           max_dense_r: int = 6, margin: float = 0.5) -> dict:
    """Measure each DCNv3 layer's max reference-effective offset magnitude
    on a sample batch and recommend a per-layer sampling mode.

    The dense-local path is exact while every effective offset stays within
    its clamp ``max_local_offset`` = r, at a cost growing with ``(K + 2r)^2``
    in the plain version. This runs ``model(x)`` once (in eval mode unless
    ``train``), reads each layer's max |effective offset|, and recommends
    the smallest exact r per layer, falling back to the gather path when r
    would exceed ``max_dense_r``. Layers on non-square or strided maps
    record nothing.

    Returns ``{layer_path: {"max_offset_mag": float, "recommended_r": int,
    "recommended_sampling": str}}`` with ``/``-separated module paths.
    """
    layers = {name.replace(".", "/"): m for name, m in model.named_modules()
              if isinstance(m, DCNv3)}
    was_training = model.training
    model.train(train)
    for m in layers.values():
        m.offset_magnitudes = []
    try:
        model(x)
        recorded = {path: list(m.offset_magnitudes) for path, m in layers.items()}
    finally:
        for m in layers.values():
            m.offset_magnitudes = None
        model.train(was_training)
    report = {}
    for path, mags in recorded.items():
        if not mags:
            continue
        mag = max(mags)
        r = int(np.ceil(mag + margin))
        report[path] = {
            "max_offset_mag": mag,
            "recommended_r": r,
            "recommended_sampling": "dense_local_ref" if r <= max_dense_r else "gather",
        }
    return report
