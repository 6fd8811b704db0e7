"""Metric input preprocessing (``process_seg_metric_inputs`` of
``iseg_tpu/metrics/wrapper.py``): ignore-label masking, argmax and label
resize before a confusion-matrix metric."""

from __future__ import annotations

import torch

from iseg_tpu_torch.ops.resize import resize_image


def process_seg_metric_inputs(labels: torch.Tensor, preds: torch.Tensor,
                              ignore_label: int = 255):
    """Returns (labels, pred_ids, weights) ready for a confusion-matrix
    metric. ``preds`` may be logits [N,H,W,C] (argmax'd) or class ids."""
    if labels.ndim == 4 and labels.shape[-1] == 1:
        labels = labels[..., 0]

    if preds.ndim == labels.ndim + 1:
        # logits: resize labels to the logits' resolution if needed, then argmax
        if tuple(preds.shape[1:3]) != tuple(labels.shape[1:3]):
            labels = resize_image(labels[..., None], tuple(preds.shape[1:3]), "nearest")[..., 0]
        preds = preds.argmax(dim=-1)

    not_ignore = labels != ignore_label
    if ignore_label == 0:
        # classes stored 1..C shift down to 0..C-1, matching the CE loss's shift
        labels = labels - 1
    weights = not_ignore.to(torch.float32)
    safe_labels = torch.where(not_ignore, labels, torch.zeros_like(labels))
    return safe_labels, preds, weights
