"""Numeric guards and stabilized ops (counterpart of
``iseg_tpu/ops/numerics.py``): the leveled ``check_numerics``, NaN and Inf
scrubbing, a gradient guard, a masked softmax that never gives NaN, L2
normalization and a Python-bool-aware ``where``."""

from __future__ import annotations

import torch

_LARGE_NEGATIVE = -1e9

# Global check level, as in the JAX package: 0 = off, 1 = report, 2 = report + scrub.
_CHECK_NUMERICS_LEVEL = 0


def set_check_numerics_level(level: int) -> None:
    """Set the global numeric-check level (0=off, 1=report, 2=report+scrub)."""
    global _CHECK_NUMERICS_LEVEL
    _CHECK_NUMERICS_LEVEL = int(level)


def get_check_numerics_level() -> int:
    return _CHECK_NUMERICS_LEVEL


def check_numerics(x: torch.Tensor, message: str = "tensor") -> torch.Tensor:
    """Leveled numeric check.

    Level 0 (the default): identity, no cost. Level 1: prints the count of
    non-finite entries when any exist. Level 2: also replaces NaN -> 0 and
    +/-Inf with the dtype's finite extremes so downstream math stays finite.

    Cost: at level 1 or 2 the count is read back to the host, so on a CUDA
    tensor every call waits for the device to finish the work queued
    before it (the JAX package keeps the report inside the compiled program
    with ``jax.debug.print``). Keep the level at 0 on a timed path.
    """
    level = _CHECK_NUMERICS_LEVEL
    if level <= 0 or not x.dtype.is_floating_point:
        return x
    bad = int((~torch.isfinite(x)).sum())
    if bad > 0:
        print(f"[check_numerics] {message}: {bad} non-finite values")
    if level >= 2:
        x = replace_non_finite(x)
    return x


def replace_nan(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NaN -> value."""
    return torch.where(torch.isnan(x), torch.tensor(value, dtype=x.dtype, device=x.device), x)


def replace_non_finite(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NaN -> value, +/-Inf -> the dtype's finite max/min."""
    finfo = torch.finfo(x.dtype)
    return torch.nan_to_num(x, nan=value, posinf=finfo.max, neginf=finfo.min)


class _GuardGrads(torch.autograd.Function):
    """Identity forward; the backward scrubs NaN/Inf from the gradient
    (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return replace_non_finite(g)


def guard_grads(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward replaces NaN with 0 and +/-Inf with
    the dtype's finite extremes, so a single bad gradient cannot poison the
    whole update."""
    return _GuardGrads.apply(x)


def safed_softmax(logits: torch.Tensor, mask: torch.Tensor | None = None,
                  dim: int = -1) -> torch.Tensor:
    """Masked, numerically-safe softmax: masked positions get a large
    negative fill before the softmax, and rows that are fully masked give
    zeros (not NaN). The row maximum is held constant for the gradient."""
    if mask is not None:
        mask = mask.to(torch.bool)
        logits = torch.where(mask, logits,
                             torch.tensor(_LARGE_NEGATIVE, dtype=logits.dtype,
                                          device=logits.device))
    m = torch.amax(logits, dim=dim, keepdim=True).detach()
    unnorm = torch.exp(logits - m)
    if mask is not None:
        unnorm = torch.where(mask, unnorm, torch.zeros_like(unnorm))
    denom = unnorm.sum(dim=dim, keepdim=True)
    return torch.where(denom > 0, unnorm / torch.clamp(denom, min=1e-12),
                       torch.zeros_like(unnorm))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / sqrt(max(sum(x^2), eps))`` along ``dim``."""
    return x / torch.sqrt(torch.clamp(x.square().sum(dim=dim, keepdim=True), min=eps))


def smart_where(cond, a, b):
    """``a if cond else b`` for a Python bool, ``torch.where`` otherwise."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)
