"""Metric input preprocessing (counterpart of ``iseg_tpu/metrics/wrapper.py``):
``process_seg_metric_inputs`` (ignore-label masking, argmax and label
resize before a confusion-matrix metric) and ``SegMetricWrapper``."""

from __future__ import annotations

from typing import Callable, Optional

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


class SegMetricWrapper:
    """Wrap an inner metric object with seg-input preprocessing + an optional
    pre-compute fn (reference ``seg_metric_wrapper.py:72-92``)."""

    def __init__(self, metric, ignore_label: int = 255,
                 pre_compute_fn: Optional[Callable] = None, name: Optional[str] = None):
        self.metric = metric
        self.ignore_label = ignore_label
        self.pre_compute_fn = pre_compute_fn
        self.name = name or getattr(metric, "name", "metric")

    def update_state(self, labels, preds):
        if self.pre_compute_fn is not None:
            labels, preds = self.pre_compute_fn(labels, preds)
        # the wrapper's whole contract: preprocessing runs before the inner
        # metric (reference seg_metric_wrapper.py:95-102). Wrap RAW metrics
        # (e.g. a bare confusion accumulator); self-preprocessing metrics
        # like MeanIoU need no wrapper and would double-process.
        labels, preds, weights = process_seg_metric_inputs(
            labels, preds, ignore_label=self.ignore_label)
        try:
            self.metric.update_state(labels, preds, weights)
        except TypeError:  # inner metric without a sample-weight arg
            self.metric.update_state(labels, preds)

    def result(self):
        return self.metric.result()

    def reset_state(self):
        self.metric.reset_state()
