"""Segmentation metrics: confusion matrix and streaming mean IoU."""

from iseg_tpu_torch.metrics.confusion import confusion_matrix
from iseg_tpu_torch.metrics.mean_iou import MeanIoU, iou_from_confusion
from iseg_tpu_torch.metrics.wrapper import process_seg_metric_inputs

__all__ = ["MeanIoU", "confusion_matrix", "iou_from_confusion", "process_seg_metric_inputs"]
