"""Ignore-label categorical cross-entropy (+ focal variant), counterpart of
``iseg_tpu/losses/cross_entropy.py``.

Logits are NHWC ``[N, H, W, C]``; everything is computed in fp32. The true
class is picked by a comparison-reduce, as in the JAX package, so a label
outside ``[0, C)`` that is not ``ignore_label`` picks nothing (its CE is 0
while it still counts in the ``valid_mean`` denominator).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from iseg_tpu_torch.losses.base import prepare_labels, valid_mask


def softmax_focal_loss(
    log_probs: torch.Tensor,
    one_hot: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[float] = 0.25,
) -> torch.Tensor:
    """Per-pixel focal CE given log-probs and one-hot labels."""
    probs = torch.exp(log_probs)
    pt = torch.sum(one_hot * probs, dim=-1)
    ce = -torch.sum(one_hot * log_probs, dim=-1)
    loss = ((1.0 - pt) ** gamma) * ce
    if alpha is not None:
        loss = alpha * loss
    return loss


def cross_entropy_ignore_label(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_classes: Optional[int] = None,
    ignore_label: int = 255,
    class_weights: Optional[Sequence[float]] = None,
    label_smoothing: float = 0.0,
    use_focal: bool = False,
    focal_gamma: float = 2.0,
    focal_alpha: Optional[float] = 0.25,
    ohem_fn: Optional[Callable] = None,
    reduction: str = "valid_mean",
    global_batch_size: Optional[int] = None,
) -> torch.Tensor:
    """The framework's default segmentation loss.

    ``reduction``: "valid_mean" (mean over contributing pixels), "sum",
    "none", "all_mean" (divide by the constant N*H*W) or "global_batch"
    (divide by the constant ``global_batch_size``).
    """
    if ohem_fn is not None:
        raise NotImplementedError("OHEM is not ported to iseg_tpu_torch yet")
    labels = prepare_labels(labels, logits)
    logits = logits.to(torch.float32)
    if num_classes is None:
        num_classes = logits.shape[-1]

    mask = valid_mask(labels, ignore_label)
    labels = labels.to(torch.int64)
    if ignore_label == 0:
        # classes are stored as 1..C when the ignore id is 0: class k maps to
        # logit channel k-1
        labels = labels - 1
    safe_labels = torch.where(mask > 0, labels, 0)

    log_probs = F.log_softmax(logits, dim=-1)
    class_ids = torch.arange(logits.shape[-1], device=logits.device)
    sel = class_ids == safe_labels[..., None]
    true_lp = torch.where(sel, log_probs, 0.0).sum(dim=-1)

    if label_smoothing > 0.0:
        mean_lp = log_probs.mean(dim=-1)
        base_ce = -(1.0 - label_smoothing) * true_lp - label_smoothing * mean_lp
    else:
        base_ce = -true_lp

    if use_focal:
        pt = torch.exp(true_lp)
        pixel_loss = ((1.0 - pt) ** focal_gamma) * base_ce
        if focal_alpha is not None:
            pixel_loss = focal_alpha * pixel_loss
    else:
        pixel_loss = base_ce

    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
        pixel_weights = torch.where(sel, w, 0.0).sum(dim=-1)
        pixel_loss = pixel_loss * pixel_weights
        weight_map = pixel_weights * mask
    else:
        weight_map = mask

    pixel_loss = pixel_loss * mask

    if reduction == "none":
        return pixel_loss
    total = pixel_loss.sum()
    if reduction == "sum":
        return total
    if reduction == "all_mean":
        return total / float(pixel_loss.numel())
    if reduction == "global_batch":
        if global_batch_size is None:
            raise ValueError(
                "reduction='global_batch' requires global_batch_size "
                "(total images per step across all replicas)")
        return total / float(global_batch_size)
    if reduction != "valid_mean":
        raise ValueError(
            f"unknown reduction {reduction!r}: expected none/sum/"
            "all_mean/global_batch/valid_mean")
    return total / torch.clamp(weight_map.sum(), min=1.0)
