"""Numeric guards (counterpart of ``iseg_tpu/ops/numerics.py``, the part
the ported heads use)."""

from __future__ import annotations

import torch


def replace_non_finite(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NaN -> value, +/-Inf -> the dtype's finite max/min."""
    finfo = torch.finfo(x.dtype)
    return torch.nan_to_num(x, nan=value, posinf=finfo.max, neginf=finfo.min)
