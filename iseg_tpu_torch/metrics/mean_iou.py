"""Streaming mean IoU (counterpart of ``iseg_tpu/metrics/mean_iou.py``): a
per-batch confusion matrix on the device, a float64 running total on the
host."""

from __future__ import annotations

import numpy as np
import torch

from iseg_tpu_torch.metrics.confusion import confusion_matrix
from iseg_tpu_torch.metrics.wrapper import process_seg_metric_inputs


def iou_from_confusion(cm) -> tuple[np.ndarray, float]:
    """(per_class_iou, mean_iou) from a [C, C] confusion matrix: classes
    that never appear (row + col == 0) are excluded from the mean.
    Host-side float64 math."""
    cm = np.asarray(cm, np.float64)
    tp = np.diagonal(cm)
    row = np.sum(cm, axis=1)
    col = np.sum(cm, axis=0)
    denom = row + col - tp
    valid = denom > 0
    iou = np.where(valid, tp / np.maximum(denom, 1e-12), 0.0)
    mean = float(np.sum(iou) / max(np.sum(valid), 1.0))
    return iou, mean


class MeanIoU:
    """``update_state(labels, preds_or_logits)`` then ``result()``."""

    def __init__(self, num_classes: int, ignore_label: int = 255, name: str = "mean_iou"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.name = name
        self.reset_state()

    def reset_state(self) -> None:
        self.total_cm = np.zeros((self.num_classes, self.num_classes), np.float64)

    @torch.no_grad()
    def update_state(self, labels: torch.Tensor, preds: torch.Tensor) -> None:
        """``preds`` may be [N,H,W] class ids or [N,H,W,C] logits."""
        labels, preds, w = process_seg_metric_inputs(labels, preds,
                                                     ignore_label=self.ignore_label)
        cm = confusion_matrix(labels, preds, self.num_classes, weights=w)
        self.total_cm += cm.cpu().numpy().astype(np.float64)

    def result(self) -> float:
        return iou_from_confusion(self.total_cm)[1]

    def per_class_iou(self) -> np.ndarray:
        return iou_from_confusion(self.total_cm)[0]
