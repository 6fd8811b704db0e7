"""Numeric guards (counterpart of ``iseg_tpu/ops/numerics.py``, the part
the ported heads and losses use)."""

from __future__ import annotations

import torch


def replace_non_finite(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NaN -> value, +/-Inf -> the dtype's finite max/min."""
    finfo = torch.finfo(x.dtype)
    return torch.nan_to_num(x, nan=value, posinf=finfo.max, neginf=finfo.min)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / sqrt(max(sum(x^2), eps))`` along ``dim``."""
    return x / torch.sqrt(torch.clamp(x.square().sum(dim=dim, keepdim=True), min=eps))
