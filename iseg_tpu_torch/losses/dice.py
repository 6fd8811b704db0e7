"""Mask / dice loss family (counterpart of ``iseg_tpu/losses/dice.py``).
NHWC logits, ``[N, H, W]`` labels, as the JAX package."""

from __future__ import annotations

import torch

from iseg_tpu_torch.losses.base import prepare_labels, valid_mask


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
              smooth: float = 1.0, from_logits: bool = True) -> torch.Tensor:
    """Soft multi-class dice over valid pixels, averaged over images and
    classes. With ``ignore_label == 0`` the classes stored 1..C shift to
    channels 0..C-1, as the cross-entropy term does."""
    labels = prepare_labels(labels, logits)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    num_classes = logits.shape[-1]
    mask = valid_mask(labels, ignore_label).to(logits.dtype)[..., None]
    if ignore_label == 0:
        labels = labels - 1
    safe_labels = torch.where(mask[..., 0] > 0, labels, torch.zeros_like(labels))
    # a label outside [0, C) that is not ignored matches no class (jax.nn.one_hot)
    classes = torch.arange(num_classes, device=labels.device)
    one_hot = (safe_labels[..., None] == classes).to(logits.dtype) * mask
    probs = torch.softmax(logits, dim=-1) if from_logits else logits
    probs = probs * mask
    dims = tuple(range(1, logits.ndim - 1))  # spatial
    intersection = (probs * one_hot).sum(dim=dims)
    denom = probs.sum(dim=dims) + one_hot.sum(dim=dims)
    dice = (2.0 * intersection + smooth) / (denom + smooth)
    return (1.0 - dice).mean()


def mask_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
              dice_weight: float = 1.0, ce_weight: float = 1.0) -> torch.Tensor:
    """Cross-entropy + dice."""
    from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label

    loss = 0.0
    if ce_weight:
        loss = loss + ce_weight * cross_entropy_ignore_label(logits, labels,
                                                             ignore_label=ignore_label)
    if dice_weight:
        loss = loss + dice_weight * dice_loss(logits, labels, ignore_label=ignore_label)
    return loss
