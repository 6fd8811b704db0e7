"""Optimizer factory (counterpart of ``iseg_tpu/core/optimizer.py``).

The steps are written here, not taken from ``torch.optim``, because they
must be the optax chains the JAX package builds:

    sgd:   scrub_nonfinite -> clip_by_global_norm -> trace(momentum)
             -> add_decayed_weights(mask) -> scale_by_lr_multipliers
             -> scale_by_learning_rate(schedule)
    adam / adamw / amsgrad: the same with scale_by_adam (or
             scale_by_amsgrad) in place of the trace
    keras_adam=True: scrub_nonfinite -> clip_by_global_norm -> keras_adamw

i.e. for SGD ``t = g + m * t; u = -lr * mult * (t + wd * p)``: the decay is
added AFTER the momentum trace (``torch.optim.SGD(weight_decay=...)`` folds
it into the trace), and for Adam after the moment scaling. With
``keras_momentum`` the trace comes after the LR scale.

Parameters and updates are dicts keyed by flax-style paths
(``backbone/stem0/conv/kernel``, see :func:`iseg_tpu_torch.convert.param_tree`),
so :func:`weight_decay_mask`, :func:`lr_multiplier_tree` and the
multi-optimizer's labels decide on the same lower-cased ``/``-joined
strings as the JAX package. Every transform has optax's interface:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; states are dataclasses of tensors (lists in parameter order) and
ints, which ``core/checkpoint.py`` saves field by field.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
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


# ------------------------------------------------------------------ schedules

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


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(step: int) -> float:
        count = min(float(step), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay(
    base_learning_rate: float,
    decay_steps: int,
    alpha: float = 0.0,
    warmup_steps: int = 0,
) -> Schedule:
    """Cosine decay with linear warmup, as optax's
    ``warmup_cosine_decay_schedule``: the warmup rises linearly from 0 to
    the base LR, ``decay_steps`` INCLUDES the warmup, and the floor is
    ``alpha * base_learning_rate``. With a warmup the values are fp32, as
    optax gives them (its linear warmup divides the integer step in fp32,
    and the joined schedule takes that type)."""
    if warmup_steps <= 0:
        return _cosine_decay(base_learning_rate, decay_steps, alpha=alpha)
    end_value = alpha * base_learning_rate
    cosine = _cosine_decay(base_learning_rate, decay_steps - warmup_steps,
                           alpha=end_value / base_learning_rate if base_learning_rate else 0.0)
    f32 = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f32(1.0) - f32(min(max(step, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(0.0 - base_learning_rate) * frac + f32(base_learning_rate))
        return float(f32(cosine(step - warmup_steps)))

    return schedule


# ------------------------------------------------- masks and multipliers by path

def weight_decay_mask(params: Mapping[str, torch.Tensor],
                      extra_no_decay: Sequence[str] = ()) -> dict[str, bool]:
    """True where weight decay applies (decided on the lowercased path)."""
    patterns = tuple(NO_WEIGHT_DECAY_PATTERNS) + tuple(extra_no_decay)
    return {path: not any(p in path.lower() for p in patterns) for path in params}


def lr_multiplier_tree(params: Mapping[str, torch.Tensor], multipliers: Mapping[str, float],
                       default: float = 1.0) -> dict[str, float]:
    """Per-leaf LR multipliers from ``{name regex: multiplier}``: the first
    regex that ``search``es the lowercased path wins, else ``default``."""
    compiled = [(re.compile(k), v) for k, v in multipliers.items()]

    def decide(path: str) -> float:
        s = path.lower()
        for rx, v in compiled:
            if rx.search(s):
                return v
        return default

    return {path: decide(path) for path in params}


def layerwise_decay_multipliers(params: Mapping[str, torch.Tensor], decay_rate: float,
                                layer_index_fn: Callable[[str], Optional[int]],
                                num_layers: int) -> dict[str, float]:
    """Layerwise LR decay: ``decay_rate ** max(0, num_layers - i)`` for the
    layer index ``layer_index_fn(lowercased path)`` (1.0 where it is None)."""
    out = {}
    for path in params:
        idx = layer_index_fn(path.lower())
        out[path] = 1.0 if idx is None else decay_rate ** max(0, num_layers - idx)
    return out


def scrub_nonfinite(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Replace NaN/Inf gradients with zero."""
    return [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads]


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm exceeds max_norm (computed on the device, no sync)."""
    if not grads:
        return grads
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    trigger = norm < max_norm
    return [torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


@dataclasses.dataclass
class EmptyState:
    pass


class ScaleByLrMultipliers:
    """optax transform scaling each update by its path's multiplier (1.0
    for a path the tree does not name): matched by path, so it works on a
    multi-optimizer's group as on the whole tree."""

    def __init__(self, multiplier_tree: Mapping[str, float]):
        self.multipliers = dict(multiplier_tree)

    def init(self, params: Mapping[str, torch.Tensor]) -> EmptyState:
        return EmptyState()

    @torch.no_grad()
    def update(self, updates: Mapping[str, torch.Tensor], state: EmptyState,
               params: Optional[Mapping[str, torch.Tensor]] = None):
        return {k: u * self.multipliers.get(k, 1.0) for k, u in updates.items()}, state


def scale_by_lr_multipliers(multiplier_tree: Mapping[str, float]) -> ScaleByLrMultipliers:
    return ScaleByLrMultipliers(multiplier_tree)


# ------------------------------------------------------------------- the chains

class _Chain:
    """What the chains of :func:`get_optimizer` share: the gradients
    scrubbed and clipped first, then (after the transform's own moments)
    the masked weight decay, the per-path multipliers and the scheduled LR.
    ``update`` returns updates to ADD to the params."""

    def __init__(self, schedule: Schedule, weight_decay: float = 0.0,
                 decay_mask: Optional[Mapping[str, bool]] = None,
                 clip_norm: Optional[float] = None, scrub_nan_grads: bool = True,
                 multipliers: Optional[Mapping[str, float]] = None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.decay_mask = dict(decay_mask) if decay_mask is not None else None
        self.clip_norm = clip_norm
        self.scrub_nan_grads = scrub_nan_grads
        self.multipliers = dict(multipliers) if multipliers is not None else None

    def _prepare(self, grads: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor]) -> tuple[list[str], list[torch.Tensor]]:
        names = list(params)
        if list(grads) != names:
            raise ValueError("grads and params must have the same paths in the same order")
        u = list(grads.values())
        if self.scrub_nan_grads:
            u = scrub_nonfinite(u)
        if self.clip_norm is not None:
            u = clip_by_global_norm(u, self.clip_norm)
        return names, u

    def _finish(self, names: list[str], u: list[torch.Tensor],
                params: Mapping[str, torch.Tensor], count: int) -> list[torch.Tensor]:
        """add_decayed_weights(mask) -> multipliers -> -lr."""
        if self.weight_decay:
            mask = self.decay_mask
            u = [ui + self.weight_decay * p if (mask is None or mask[n]) else ui
                 for n, ui, p in zip(names, u, params.values())]
        if self.multipliers is not None:
            u = [ui * self.multipliers.get(n, 1.0) for n, ui in zip(names, u)]
        return torch._foreach_mul(u, -self.schedule(count))


@dataclasses.dataclass
class SGDState:
    count: int  # updates applied so far (the schedule's step)
    trace: Optional[list[torch.Tensor]]  # momentum buffers, in parameter order


class SGD(_Chain):
    """The optax SGD chain of ``get_optimizer(name="sgd")``."""

    def __init__(self, schedule: Schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                 decay_mask: Optional[Mapping[str, bool]] = None,
                 clip_norm: Optional[float] = None, scrub_nan_grads: bool = True,
                 keras_momentum: bool = False,
                 multipliers: Optional[Mapping[str, float]] = None):
        super().__init__(schedule, weight_decay, decay_mask, clip_norm, scrub_nan_grads,
                         multipliers)
        self.momentum = momentum
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
        names, u = self._prepare(grads, params)
        trace = state.trace
        if not self.keras_momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, u)
            u = list(trace)
        u = self._finish(names, u, params, state.count)
        if self.keras_momentum and self.momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, u)
            u = list(trace)
        return dict(zip(names, u)), SGDState(count=state.count + 1, trace=trace)


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied so far (the bias correction's and schedule's step)
    mu: list[torch.Tensor]  # first moments, in parameter order
    nu: list[torch.Tensor]  # second moments
    # AMSGrad's running maximum, None otherwise: of the bias-corrected second
    # moments on the optax chain (optax's nu_max), of the raw ones in keras_adamw
    nu_hat: Optional[list[torch.Tensor]]


class Adam(_Chain):
    """optax ``scale_by_adam`` (``scale_by_amsgrad`` with ``amsgrad``) in
    the chain of ``get_optimizer(name="adam" | "adamw" | "amsgrad")``:
    ``m_hat / (sqrt(v_hat) + eps)``, then the decoupled decay (added after
    the moment scaling), the multipliers and the LR."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, amsgrad: bool = False, weight_decay: float = 0.0,
                 decay_mask: Optional[Mapping[str, bool]] = None,
                 clip_norm: Optional[float] = None, scrub_nan_grads: bool = True,
                 multipliers: Optional[Mapping[str, float]] = None):
        super().__init__(schedule, weight_decay, decay_mask, clip_norm, scrub_nan_grads,
                         multipliers)
        self.b1, self.b2, self.eps, self.amsgrad = b1, b2, eps, amsgrad

    @torch.no_grad()
    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p) for p in params.values()]  # noqa: E731
        return AdamState(count=0, mu=zeros(), nu=zeros(),
                         nu_hat=zeros() if self.amsgrad else None)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], AdamState]:
        names, u = self._prepare(grads, params)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(u, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(u, u), 1 - b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(state.mu, 1 - b1 ** count)
        nu_hat = torch._foreach_div(state.nu, 1 - b2 ** count)
        if self.amsgrad:
            torch._foreach_maximum_(state.nu_hat, nu_hat)
            nu_hat = state.nu_hat
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        u = self._finish(names, torch._foreach_div(mu_hat, denom), params, state.count)
        return dict(zip(names, u)), AdamState(count, state.mu, state.nu, state.nu_hat)


class KerasAdamW(_Chain):
    """The exact Keras-3 Adam / AdamW / AMSGrad step as one terminal
    transform (it returns the final signed update). Where it differs from
    the optax chain: eps stays OUTSIDE the bias correction,
    ``lr * mult * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``; the
    decoupled decay ``lr * wd * w`` uses the base scheduled LR, without the
    multiplier. The LR and the bias factor are fp32 scalars, as the JAX
    package computes them."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7, weight_decay: float = 0.0,
                 decay_mask: Optional[Mapping[str, bool]] = None,
                 multipliers: Optional[Mapping[str, float]] = None, amsgrad: bool = False,
                 clip_norm: Optional[float] = None, scrub_nan_grads: bool = False):
        super().__init__(schedule, weight_decay, decay_mask, clip_norm, scrub_nan_grads,
                         multipliers)
        self.b1, self.b2, self.eps, self.amsgrad = b1, b2, eps, amsgrad

    init = Adam.init

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], AdamState]:
        names, u = self._prepare(grads, params)
        t = state.count + 1
        f32 = np.float32
        lr = f32(self.schedule(state.count))
        bias = (np.sqrt(f32(1.0) - f32(self.b2) ** f32(t))
                / (f32(1.0) - f32(self.b1) ** f32(t)))
        torch._foreach_add_(state.mu, torch._foreach_mul(
            torch._foreach_sub(u, state.mu), 1.0 - self.b1))
        torch._foreach_add_(state.nu, torch._foreach_mul(
            torch._foreach_sub(torch._foreach_mul(u, u), state.nu), 1.0 - self.b2))
        if self.amsgrad:
            torch._foreach_maximum_(state.nu_hat, state.nu)
        denom = torch._foreach_add(torch._foreach_sqrt(
            state.nu_hat if self.amsgrad else state.nu), self.eps)
        mults = self.multipliers or {}
        mask = self.decay_mask
        decay = float(lr * f32(self.weight_decay))
        out = []
        for n, m, d, w in zip(names, state.mu, denom, params.values()):
            step = (m * float(lr * f32(mults.get(n, 1.0)) * bias)) / d
            if self.weight_decay and (mask is None or mask[n]):
                step = step + decay * w
            out.append(-step)
        return dict(zip(names, out)), AdamState(t, state.mu, state.nu, state.nu_hat)


def keras_adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
                weight_decay: float = 0.0, wd_mask: Optional[Mapping[str, bool]] = None,
                multiplier_tree: Optional[Mapping[str, float]] = None,
                amsgrad: bool = False) -> KerasAdamW:
    """The Keras-3 Adam step alone (no scrub, no clip): see :class:`KerasAdamW`."""
    return KerasAdamW(schedule, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                      decay_mask=wd_mask, multipliers=multiplier_tree, amsgrad=amsgrad)


# ----------------------------------------------------- multi-optimizer, accumulation

@dataclasses.dataclass
class MultiTransformState:
    inner_states: dict[str, Any]  # group label -> that group's transform state


class MultiTransform:
    """optax.multi_transform: each parameter group (by label) is updated by
    its own transform, which sees only that group's paths."""

    def __init__(self, transforms: Mapping[str, Any], labels: Mapping[str, str]):
        missing = set(labels.values()) - set(transforms)
        if missing:
            raise ValueError(f"parameter labels {sorted(missing)} have no transform; "
                             f"transforms: {sorted(transforms)}")
        self.transforms = dict(transforms)
        self.labels = dict(labels)

    def _group(self, tree: Mapping[str, Any], label: str) -> dict[str, Any]:
        return {k: v for k, v in tree.items() if self.labels[k] == label}

    def init(self, params: Mapping[str, torch.Tensor]) -> MultiTransformState:
        return MultiTransformState({g: tx.init(self._group(params, g))
                                    for g, tx in self.transforms.items()})

    def update(self, grads: Mapping[str, torch.Tensor], state: MultiTransformState,
               params: Mapping[str, torch.Tensor]):
        updates, inner = {}, dict(state.inner_states)
        for g, tx in self.transforms.items():
            group_params = self._group(params, g)
            if not group_params:
                continue
            group_updates, inner[g] = tx.update(self._group(grads, g), inner[g], group_params)
            updates.update(group_updates)
        return {k: updates[k] for k in params}, MultiTransformState(inner)


@dataclasses.dataclass
class MultiStepsState:
    mini_step: int  # micro-steps accumulated since the last real update
    gradient_step: int  # real updates so far
    inner_opt_state: Any
    acc_grads: list[torch.Tensor]  # running mean of the micro-gradients, in parameter order


class MultiSteps:
    """optax.MultiSteps with the gradient mean: keeps the running mean of
    the micro-batch gradients (``acc + (g - acc) / (n + 1)``), returns zero
    updates for ``every - 1`` micro-steps, and on every ``every``-th passes
    the mean to the inner transform (whose schedule therefore counts real
    updates) and starts again from zero."""

    def __init__(self, inner, every: int):
        self.inner = inner
        self.every = every

    @torch.no_grad()
    def init(self, params: Mapping[str, torch.Tensor]) -> MultiStepsState:
        return MultiStepsState(mini_step=0, gradient_step=0,
                               inner_opt_state=self.inner.init(params),
                               acc_grads=[torch.zeros_like(p) for p in params.values()])

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: MultiStepsState,
               params: Mapping[str, torch.Tensor]):
        names = list(params)
        if list(grads) != names:
            raise ValueError("grads and params must have the same paths in the same order")
        n = state.mini_step
        acc = state.acc_grads
        torch._foreach_add_(acc, torch._foreach_div(
            torch._foreach_sub(list(grads.values()), acc), n + 1))
        if n < self.every - 1:
            updates = {k: torch.zeros_like(a) for k, a in zip(names, acc)}
            return updates, MultiStepsState(n + 1, state.gradient_step,
                                            state.inner_opt_state, acc)
        updates, inner = self.inner.update(dict(zip(names, acc)), state.inner_opt_state, params)
        # an inner transform that hands a gradient back unchanged returns acc
        # itself: copy such an update before acc is reset
        acc_ids = {id(a) for a in acc}
        updates = {k: (v.clone() if id(v) in acc_ids else v) for k, v in updates.items()}
        torch._foreach_zero_(acc)
        return updates, MultiStepsState(0, state.gradient_step + 1, inner, acc)


def with_grad_accum(tx, every: int):
    """Gradient accumulation: apply ``tx`` once per ``every`` micro-steps
    (:class:`MultiSteps`). ``every`` micro-batches of size B are one step
    at batch ``every * B`` for a per-sample-mean loss; the schedule inside
    ``tx`` counts real updates; BN running statistics still update every
    micro-step."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    if every == 1:
        return tx
    return MultiSteps(tx, every)


# -------------------------------------------------------------------- factories

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
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_epsilon: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
    lr_multipliers: Optional[Mapping[str, float]] = None,
    extra_no_decay: Sequence[str] = (),
    scrub_nan_grads: bool = True,
    keras_momentum: bool = False,
    keras_adam: bool = False,
    poly_ref_exact: bool = False,
) -> tuple[Any, Schedule]:
    """Build the optimizer + schedule; returns ``(tx, schedule)``.

    ``params`` is the path-keyed parameter dict
    (:func:`iseg_tpu_torch.convert.param_tree`). ``decay_strategy`` is
    "poly", "cosine" (the floor is ``end_learning_rate``) or None/"constant";
    ``name`` is "sgd", "adam", "amsgrad" or "adamw" (on the optax chain the
    latter two differ only by AMSGrad's maximum; ``keras_adam`` takes the
    Keras-3 step instead). ``lr_multipliers`` maps path regexes to LR
    multipliers (:func:`lr_multiplier_tree`).
    """
    if decay_strategy in ("poly", "polynomial"):
        schedule = warmup_poly_decay(
            learning_rate, train_steps, end_learning_rate=end_learning_rate,
            power=poly_power, warmup_steps=warmup_steps,
            warmup_learning_rate=warmup_learning_rate, ref_exact=poly_ref_exact)
    elif decay_strategy == "cosine":
        schedule = warmup_cosine_decay(
            learning_rate, train_steps, warmup_steps=warmup_steps,
            alpha=end_learning_rate / learning_rate if learning_rate else 0.0)
    elif decay_strategy in (None, "none", "constant"):
        def schedule(step: int) -> float:
            return learning_rate
    else:
        raise ValueError(f"unknown decay strategy: {decay_strategy!r}")

    name = name.lower()
    mask = weight_decay_mask(params, extra_no_decay) if weight_decay else None
    mults = lr_multiplier_tree(params, lr_multipliers) if lr_multipliers else None
    common = dict(clip_norm=clip_norm, scrub_nan_grads=scrub_nan_grads, multipliers=mults)
    if name == "sgd":
        tx = SGD(schedule, momentum=sgd_momentum, weight_decay=weight_decay, decay_mask=mask,
                 keras_momentum=keras_momentum, **common)
    elif name in ("adam", "amsgrad", "adamw") and keras_adam:
        # the decay is AdamW's alone on the Keras path
        decay = weight_decay if name == "adamw" else 0.0
        tx = KerasAdamW(schedule, b1=adam_beta1, b2=adam_beta2, eps=adam_epsilon,
                        weight_decay=decay, decay_mask=mask if decay else None,
                        amsgrad=name == "amsgrad", **common)
    elif name in ("adam", "amsgrad", "adamw"):
        # a requested decay never vanishes: decoupled, after the moments
        tx = Adam(schedule, b1=adam_beta1, b2=adam_beta2, eps=adam_epsilon,
                  amsgrad=name == "amsgrad", weight_decay=weight_decay, decay_mask=mask,
                  **common)
    else:
        raise ValueError(f"unknown optimizer: {name!r}")
    return tx, schedule


def get_multi_optimizer(params: Mapping[str, torch.Tensor], label_fn: Callable[[str], str],
                        optimizers: Mapping[str, Any]) -> MultiTransform:
    """Route parameter groups to sub-optimizers: ``label_fn(lowercased
    path) -> label``, one transform per label."""
    return MultiTransform(optimizers, {path: label_fn(path.lower()) for path in params})


def get_optimizer_list(params: Mapping[str, torch.Tensor], group_patterns: Sequence[str],
                       names: Sequence[str], learning_rates: Sequence[float],
                       default_group: int = 0, **common_kwargs) -> MultiTransform:
    """One optimizer per entry of the aligned lists: ``group_patterns[i]``
    (a regex searched in the lowercased path) selects the params of
    optimizer ``i``; unmatched params go to ``default_group``."""
    if not (len(group_patterns) == len(names) == len(learning_rates)):
        raise ValueError("group_patterns/names/learning_rates must align")
    compiled = [(i, re.compile(p)) for i, p in enumerate(group_patterns)]

    def label_fn(path: str) -> str:
        for i, rx in compiled:
            if rx.search(path):
                return str(i)
        return str(default_group)

    optimizers = {str(i): get_optimizer(params, name=n, learning_rate=lr, **common_kwargs)[0]
                  for i, (n, lr) in enumerate(zip(names, learning_rates))}
    return get_multi_optimizer(params, label_fn, optimizers)
