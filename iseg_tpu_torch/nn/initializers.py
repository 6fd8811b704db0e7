"""Parameter initialization the way flax does it by default.

flax's ``nn.Conv``/``nn.Dense`` draw their kernel from ``lecun_normal``
(variance scaling 1.0, fan-in, truncated normal at two standard
deviations) and start their bias at zero; flax's BatchNorm starts at
scale 1, bias 0, mean 0, var 1. :func:`initialize` does the same for a
whole module tree from an explicit ``torch.Generator``. The values are
drawn on the CPU and copied to the parameters' device, so a seed gives
the same weights on every device. (The numbers differ from JAX's for the
same seed: a parity test carries JAX's weights over with
:mod:`iseg_tpu_torch.convert` instead.)
"""

from __future__ import annotations

import math

import torch
from torch import nn

from iseg_tpu_torch.nn.norm import BatchNorm

# std of a unit normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill an OIHW conv or [out, in] linear weight like flax's lecun_normal."""
    fan_in = tensor[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    values = torch.empty(tensor.shape, dtype=torch.float32)
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
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"no initialization rule for {name or 'the root'} "
                            f"({type(m).__name__})")
    return module
