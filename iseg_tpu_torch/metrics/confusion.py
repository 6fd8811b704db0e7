"""Confusion-matrix accumulation (counterpart of
``iseg_tpu/metrics/confusion.py``): one ``torch.bincount`` over
``label * C + pred`` with weights, on the tensors' device."""

from __future__ import annotations

from typing import Optional

import torch


def confusion_matrix(
    labels: torch.Tensor,
    preds: torch.Tensor,
    num_classes: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[C, C] float32 confusion matrix; rows = true class, cols = predicted.

    ``weights`` (same shape as labels) zeroes out ignored pixels; callers
    use :func:`iseg_tpu_torch.metrics.process_seg_metric_inputs` to build
    it. Counts are summed in float32 (exact below 2^24 per update); the
    running total is kept in float64 on the host by
    :class:`iseg_tpu_torch.metrics.MeanIoU`.
    """
    labels = labels.reshape(-1).to(torch.int64)
    preds = preds.reshape(-1).to(torch.int64)
    if weights is None:
        w = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    else:
        w = weights.reshape(-1).to(torch.float32)
    # clamp (masked pixels have weight 0, their value is irrelevant)
    labels = labels.clamp(0, num_classes - 1)
    preds = preds.clamp(0, num_classes - 1)
    cm = torch.bincount(labels * num_classes + preds, weights=w,
                        minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes).to(torch.float32)
