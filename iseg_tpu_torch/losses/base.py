"""Shared loss plumbing (counterpart of ``iseg_tpu/losses/base.py``)."""

from __future__ import annotations

import torch

from iseg_tpu_torch.ops.resize import resize_image
from iseg_tpu_torch.parallel.collectives import active_group, all_reduce_values, world_size


def prepare_labels(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Squeeze a trailing channel dim and nearest-resize labels to the
    logits' spatial size (NHWC logits, [N, H, W] labels)."""
    if labels.ndim == logits.ndim and labels.shape[-1] == 1:
        labels = labels[..., 0]
    if labels.ndim == 3 and logits.ndim == 4:
        if labels.shape[1:3] != logits.shape[1:3]:
            labels = resize_image(labels[..., None], logits.shape[1:3], "nearest")[..., 0]
    return labels


def global_valid_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)``; under an active data-parallel group of
    ``d`` ranks, ``d * total / max(sum of the ranks' counts, 1)``, whose mean
    over the ranks (the step averages the gradients) is the mean over the
    global batch's pixels, as the JAX package takes it."""
    group = active_group()
    d = world_size(group)
    if d == 1:
        return total / torch.clamp(count, min=1.0)
    return total * float(d) / torch.clamp(all_reduce_values(count.detach(), group=group),
                                           min=1.0)


def valid_mask(labels: torch.Tensor, ignore_label: int) -> torch.Tensor:
    """fp32 mask of pixels that participate in the loss."""
    return (labels != ignore_label).to(torch.float32)
