"""Parameter initialization the way flax does it by default.

flax's ``nn.Conv``/``nn.Dense`` draw their kernel from ``lecun_normal``
(variance scaling 1.0, fan-in, truncated normal at two standard
deviations) and start their bias at zero; flax's BatchNorm starts at
scale 1, bias 0, mean 0, var 1, its LayerNorm at scale 1, bias 0; Swin's
relative-position-bias table and the ViT and EVA positional embeddings
are normal with std 0.02, their class tokens and ``SelfAttention2D``'s
gate start at zero; DCN's offset and
modulation layers start at zero (a deformable conv starts as a plain one)
and InternImage's and ConvNeXt's layer-scale vectors at their
``layer_scale`` (ConvNeXt's ``layer_scale_init``); the factory's group,
layer and RMS norms at scale 1, bias 0; ConvNeXt-V2's GRN ``gamma`` and
``beta`` at zero; MOAT's relative-position tables normal with std 0.02. Gemma's
``QuantDense`` kernels are ``lecun_normal`` too, its embedding table is
``variance_scaling(1.0, "fan_in", "normal", out_axis=0)`` (a plain normal
with std ``1 / sqrt(D)``), its RMSNorm scales start at zero and the int8
scales it carries at one. The MoE layer's router and experts are
``lecun_normal`` (the expert axis counts as receptive field).
:func:`initialize` does the same for a whole module tree from an explicit
``torch.Generator``. The values are drawn in fp32 on the generator's device
and copied to the parameters' device: a CPU generator gives the same
weights on every device, and a CUDA generator fills a model of billions of
parameters on the card in seconds. (The numbers differ from JAX's for the
same seed: a parity test carries JAX's weights over with
:mod:`iseg_tpu_torch.convert` instead.)
"""

from __future__ import annotations

import math

import torch
from torch import nn

from iseg_tpu_torch.backbones.convnext import ConvNeXtBlock
from iseg_tpu_torch.backbones.eva import Eva
from iseg_tpu_torch.backbones.intern_image import InternImageBlock
from iseg_tpu_torch.backbones.moat import MOATAttention
from iseg_tpu_torch.backbones.swin import WindowAttention
from iseg_tpu_torch.backbones.vit import VisionTransformer
from iseg_tpu_torch.nn.attention import SelfAttention2D
from iseg_tpu_torch.nn.blocks import GlobalResponseNorm
from iseg_tpu_torch.nn.dcn import DCNv2
from iseg_tpu_torch.nn.moe import MoEFeedForward
from iseg_tpu_torch.nn.norm import BatchNorm, ChannelLayerNorm, ChannelRMSNorm, GroupNorm, RMSNorm
from iseg_tpu_torch.ops.quant import QuantDense, QuantEmbed

# std of a unit normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator,
                  fan_in: int | None = None) -> torch.Tensor:
    """Fill an OIHW conv or [out, in] linear weight like flax's lecun_normal
    (``fan_in`` defaults to the elements of one output row)."""
    if fan_in is None:
        fan_in = tensor[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    values = torch.empty(tensor.shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(values, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        tensor.copy_(values)
    return tensor


@torch.no_grad()
def initialize(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter and BN statistic of ``module`` in place.

    Raises on a module type that holds parameters but has no rule here, so
    no parameter silently keeps torch's own default initialization.
    """
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if getattr(m, "zero_init_kernel", False):
                m.weight.zero_()
            else:
                lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, (nn.LayerNorm, GroupNorm, ChannelLayerNorm, ChannelRMSNorm)):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ConvNeXtBlock):
            if m.gamma is not None:
                m.gamma.fill_(m.layer_scale_init)
        elif isinstance(m, GlobalResponseNorm):
            m.gamma.zero_()
            m.beta.zero_()
        elif isinstance(m, MOATAttention):
            if m.rel_pos_embed is not None:
                table = m.rel_pos_embed
                table.copy_(torch.empty(table.shape, device=generator.device)
                            .normal_(0.0, 0.02, generator=generator))
        elif isinstance(m, WindowAttention):
            table = m.relative_position_bias_table
            table.copy_(torch.empty(table.shape, device=generator.device)
                        .normal_(0.0, 0.02, generator=generator))
        elif isinstance(m, (VisionTransformer, Eva)):
            m.pos_embed.copy_(torch.empty(m.pos_embed.shape, device=generator.device)
                              .normal_(0.0, 0.02, generator=generator))
            if m.cls_token is not None:
                m.cls_token.zero_()
        elif isinstance(m, SelfAttention2D):
            m.gamma.zero_()
        elif isinstance(m, InternImageBlock):
            if m.layer_scale is not None:
                m.gamma1.fill_(m.layer_scale)
                m.gamma2.fill_(m.layer_scale)
        elif isinstance(m, DCNv2):
            lecun_normal_(m.kernel.t(), generator)  # [filters, K*K*C]: fan-in K*K*C
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, QuantDense):
            # flax's lecun_normal takes the kernel's second-to-last axis as
            # the input axis and every axis before it as receptive field, so
            # for a (*contract, *features) kernel fan_in is everything but
            # the last feature axis (for query/key/value [D, heads, d] that
            # is D * heads, not D)
            lecun_normal_(m.weight, generator, fan_in=m.weight.numel() // m.features[-1])
            m.kernel_scale.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, QuantEmbed):
            table = m.embedding
            std = math.sqrt(1.0 / table.shape[1])
            table.copy_(torch.empty(table.shape, dtype=torch.float32, device=generator.device)
                        .normal_(0.0, std, generator=generator))
            m.embedding_scale.fill_(1.0)
        elif isinstance(m, RMSNorm):
            m.scale.zero_()
        elif isinstance(m, MoEFeedForward):
            # lecun_normal of [D, E], [E, D, d_ff], [E, d_ff, D]: fan_in is
            # the input axis times the receptive field (the expert axis)
            dim = m.router.shape[0]
            lecun_normal_(m.router, generator, fan_in=dim)
            lecun_normal_(m.w1, generator, fan_in=m.num_experts * dim)
            lecun_normal_(m.w2, generator, fan_in=m.num_experts * m.d_ff)
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"no initialization rule for {name or 'the root'} "
                            f"({type(m).__name__})")
    return module
