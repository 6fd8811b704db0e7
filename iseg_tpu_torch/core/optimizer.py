"""Optimizer factory, SGD subset (counterpart of
``iseg_tpu/core/optimizer.py``).

The step is written here, not taken from ``torch.optim``, because it must
be the optax chain the JAX package builds:

    scrub_nonfinite -> clip_by_global_norm -> trace(momentum)
      -> add_decayed_weights(mask) -> scale_by_learning_rate(schedule)

i.e. ``t = g + m * t; u = -lr * (t + wd * p)``: the decay is added AFTER
the momentum trace (``torch.optim.SGD(weight_decay=...)`` folds it into
the trace). With ``keras_momentum`` the trace comes after the LR scale:
``u = -lr * (g + wd * p); t = u + m * t; step = t``.

Parameters and updates are dicts keyed by flax-style paths
(``backbone/stem0/conv/kernel``, see :func:`iseg_tpu_torch.convert.param_tree`),
so :func:`weight_decay_mask` decides exactly as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import torch

# Name fragments excluded from weight decay: norm params, biases, positional
# embeddings, class tokens, relative-position tables, logits convs.
NO_WEIGHT_DECAY_PATTERNS = (
    "bias",
    "scale",
    "norm",
    "bn",
    "pos_embed",
    "position_embedding",
    "cls_token",
    "class_token",
    "relative_position",
    "gamma",
    "beta",
    "logit_scale",
    "logits",
    "patch_embed",
)

Schedule = Callable[[int], float]


def warmup_poly_decay(
    base_learning_rate: float,
    decay_steps: int,
    end_learning_rate: float = 0.0,
    power: float = 0.9,
    warmup_steps: int = 0,
    warmup_learning_rate: float = 0.0,
    ref_exact: bool = False,
) -> Schedule:
    """Poly decay with linear warmup. ``ref_exact`` reproduces the
    reference's clamp quirk: the step is clamped to ``decay_steps -
    warmup_steps`` BEFORE the warmup is subtracted, so with warmup the LR
    never reaches the end value."""

    def schedule(step: int) -> float:
        step = float(step)
        warm = warmup_learning_rate + (base_learning_rate - warmup_learning_rate) * (
            step / max(1.0, warmup_steps))
        decay_total = max(1.0, decay_steps - warmup_steps)
        if ref_exact:
            cur = min(step, decay_total)
            p = min(max((cur - warmup_steps) / decay_total, 0.0), 1.0)
        else:
            p = min(max((step - warmup_steps) / decay_total, 0.0), 1.0)
        decayed = (base_learning_rate - end_learning_rate) * (1.0 - p) ** power
        decayed = decayed + end_learning_rate
        if warmup_steps <= 0:
            return decayed
        return warm if step < warmup_steps else decayed

    return schedule


def weight_decay_mask(params: Mapping[str, torch.Tensor],
                      extra_no_decay: Sequence[str] = ()) -> dict[str, bool]:
    """True where weight decay applies (decided on the lowercased path)."""
    patterns = tuple(NO_WEIGHT_DECAY_PATTERNS) + tuple(extra_no_decay)
    return {path: not any(p in path.lower() for p in patterns) for path in params}


def scrub_nonfinite(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Replace NaN/Inf gradients with zero."""
    return [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads]


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm exceeds max_norm (computed on the device, no sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    trigger = norm < max_norm
    return [torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


@dataclasses.dataclass
class SGDState:
    count: int  # updates applied so far (the schedule's step)
    trace: Optional[list[torch.Tensor]]  # momentum buffers, in parameter order


class SGD:
    """The optax SGD chain of ``get_optimizer(name="sgd")`` as one object
    with optax's ``init``/``update`` interface over path-keyed dicts."""

    def __init__(self, schedule: Schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                 decay_mask: Optional[Mapping[str, bool]] = None,
                 clip_norm: Optional[float] = None, scrub_nan_grads: bool = True,
                 keras_momentum: bool = False):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.decay_mask = dict(decay_mask) if decay_mask is not None else None
        self.clip_norm = clip_norm
        self.scrub_nan_grads = scrub_nan_grads
        self.keras_momentum = keras_momentum

    def _uses_trace(self) -> bool:
        return not self.keras_momentum or bool(self.momentum)

    @torch.no_grad()
    def init(self, params: Mapping[str, torch.Tensor]) -> SGDState:
        trace = [torch.zeros_like(p) for p in params.values()] if self._uses_trace() else None
        return SGDState(count=0, trace=trace)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: SGDState,
               params: Mapping[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], SGDState]:
        names = list(params)
        if list(grads) != names:
            raise ValueError("grads and params must have the same paths in the same order")
        u = list(grads.values())
        if self.scrub_nan_grads:
            u = scrub_nonfinite(u)
        if self.clip_norm is not None:
            u = clip_by_global_norm(u, self.clip_norm)
        trace = state.trace
        if not self.keras_momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, u)
            u = list(trace)
        if self.weight_decay:
            mask = self.decay_mask
            u = [ui + self.weight_decay * p if (mask is None or mask[n]) else ui
                 for n, ui, p in zip(names, u, params.values())]
        u = torch._foreach_mul(u, -self.schedule(state.count))
        if self.keras_momentum and self.momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, u)
            u = list(trace)
        return dict(zip(names, u)), SGDState(count=state.count + 1, trace=trace)


def get_optimizer(
    params: Mapping[str, torch.Tensor],
    name: str = "sgd",
    learning_rate: float = 0.007,
    end_learning_rate: float = 0.0,
    train_steps: int = 30000,
    warmup_steps: int = 0,
    warmup_learning_rate: float = 0.0,
    decay_strategy: Optional[str] = "poly",
    poly_power: float = 0.9,
    sgd_momentum: float = 0.9,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
    lr_multipliers: Optional[Mapping[str, float]] = None,
    extra_no_decay: Sequence[str] = (),
    scrub_nan_grads: bool = True,
    keras_momentum: bool = False,
    poly_ref_exact: bool = False,
) -> tuple[SGD, Schedule]:
    """Build the optimizer + schedule; returns ``(tx, schedule)``.

    ``params`` is the path-keyed parameter dict
    (:func:`iseg_tpu_torch.convert.param_tree`). Only SGD with a poly or
    constant schedule is ported; other optimizers, cosine decay and
    ``lr_multipliers`` raise.
    """
    if decay_strategy in ("poly", "polynomial"):
        schedule = warmup_poly_decay(
            learning_rate, train_steps, end_learning_rate=end_learning_rate,
            power=poly_power, warmup_steps=warmup_steps,
            warmup_learning_rate=warmup_learning_rate, ref_exact=poly_ref_exact)
    elif decay_strategy in (None, "none", "constant"):
        def schedule(step: int) -> float:
            return learning_rate
    elif decay_strategy == "cosine":
        raise NotImplementedError("cosine decay is not ported to iseg_tpu_torch yet")
    else:
        raise ValueError(f"unknown decay strategy: {decay_strategy!r}")

    name = name.lower()
    if name in ("adam", "amsgrad", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported to iseg_tpu_torch yet")
    if name != "sgd":
        raise ValueError(f"unknown optimizer: {name!r}")
    if lr_multipliers:
        raise NotImplementedError("lr_multipliers are not ported to iseg_tpu_torch yet")
    mask = weight_decay_mask(params, extra_no_decay) if weight_decay else None
    tx = SGD(schedule, momentum=sgd_momentum, weight_decay=weight_decay, decay_mask=mask,
             clip_norm=clip_norm, scrub_nan_grads=scrub_nan_grads,
             keras_momentum=keras_momentum)
    return tx, schedule
