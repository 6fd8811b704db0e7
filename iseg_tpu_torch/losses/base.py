"""Shared loss plumbing (counterpart of ``iseg_tpu/losses/base.py``)."""

from __future__ import annotations

import torch

from iseg_tpu_torch.ops.resize import resize_image


def prepare_labels(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Squeeze a trailing channel dim and nearest-resize labels to the
    logits' spatial size (NHWC logits, [N, H, W] labels)."""
    if labels.ndim == logits.ndim and labels.shape[-1] == 1:
        labels = labels[..., 0]
    if labels.ndim == 3 and logits.ndim == 4:
        if labels.shape[1:3] != logits.shape[1:3]:
            labels = resize_image(labels[..., None], logits.shape[1:3], "nearest")[..., 0]
    return labels


def valid_mask(labels: torch.Tensor, ignore_label: int) -> torch.Tensor:
    """fp32 mask of pixels that participate in the loss."""
    return (labels != ignore_label).to(torch.float32)
