"""Training step (counterpart of ``iseg_tpu/core/train.py``, step subset):
``TrainState``, ``create_train_state``, ``make_train_step``.

PyTorch runs eagerly, so there is no jit: a step is one forward (under
bf16 autocast when the compute dtype is bf16), one backward, the optimizer
update applied in place, and the BN running-stat update, which the
forward makes in training mode. The host loop (``CoreTrain``: checkpoints,
SIGTERM, resume) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from iseg_tpu_torch.convert import batch_stats_tree, param_tree
from iseg_tpu_torch.core.optimizer import SGD
from iseg_tpu_torch.nn.blocks import set_dropout_generator
from iseg_tpu_torch.nn.initializers import initialize


@dataclasses.dataclass
class TrainState:
    """The model (which holds params and BN batch_stats), the optimizer and
    its state, and an optional EMA of the params.

    ``params`` and ``batch_stats`` are flax-path-keyed views of the
    module's own tensors; updates are applied to them in place.
    """

    step: int
    model: nn.Module
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    tx: SGD
    opt_state: Any
    ema_params: Optional[dict[str, torch.Tensor]] = None
    ema_decay: Optional[float] = None

    @torch.no_grad()
    def apply_gradients(self, grads: dict[str, torch.Tensor]) -> "TrainState":
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        torch._foreach_add_(list(self.params.values()), list(updates.values()))
        if self.ema_params is not None:
            d = self.ema_decay
            for e, p in zip(self.ema_params.values(), self.params.values()):
                e.copy_(e * d + (1.0 - d) * p.to(e.dtype))
        self.step += 1
        return self

    def eval_variables(self) -> dict:
        """Path-keyed variables for evaluation: EMA params when tracked,
        else the raw params, plus the BN running stats."""
        params = self.ema_params if self.ema_params is not None else self.params
        return {"params": params, "batch_stats": self.batch_stats}


def create_train_state(
    model: nn.Module,
    generator: Optional[torch.Generator],
    tx: SGD,
    ema_decay: Optional[float] = None,
    initialized: bool = False,
) -> TrainState:
    """Initialize ``model`` from ``generator`` (flax's default init; pass
    ``initialized=True`` for weights already loaded, e.g. with
    :func:`iseg_tpu_torch.convert.load_flax`) and wrap it with ``tx``.

    Dropout draws from a generator on the model's device, seeded from
    ``generator`` (torch's default generator when it is None).
    ``ema_decay`` (e.g. 0.999) tracks an EMA of the params, started at
    their initial values.
    """
    if not initialized:
        if generator is None:
            raise ValueError("create_train_state needs a generator to initialize the model")
        initialize(model, generator)
    params = param_tree(model)
    device = next(iter(params.values())).device
    if generator is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        set_dropout_generator(model, torch.Generator(device=device).manual_seed(seed))
    return TrainState(
        step=0,
        model=model,
        params=params,
        batch_stats=batch_stats_tree(model),
        tx=tx,
        opt_state=tx.init(params),
        ema_params=({k: v.detach().clone() for k, v in params.items()}
                    if ema_decay is not None else None),
        ema_decay=ema_decay,
    )


def make_train_step(loss_fn: Callable, compute_dtype: torch.dtype = torch.float32) -> Callable:
    """Build ``train_step(state, batch) -> (state, parts)``.

    ``loss_fn(outputs, labels) -> (total, parts)`` is typically
    ``model.build_loss_fn()``; ``compute_dtype`` is the env's (bf16 runs
    the forward under autocast). ``batch`` holds ``image`` [N, H, W, 3]
    float and ``label`` [N, H, W] int.
    """

    def train_step(state: TrainState, batch: dict):
        model = state.model
        model.train()
        image = batch["image"]
        with torch.autocast(image.device.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            outputs = model(image)
        loss, parts = loss_fn(outputs, batch["label"])
        params = list(state.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        state.apply_gradients(dict(zip(state.params, grads)))
        return state, {k: v.detach() for k, v in parts.items()}

    return train_step
