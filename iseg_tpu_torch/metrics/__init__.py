"""Segmentation metrics: confusion matrix, streaming mean IoU, the metric
builder and the input-preprocessing wrapper."""

from iseg_tpu_torch.metrics.builder import SegMetricBuilder
from iseg_tpu_torch.metrics.confusion import confusion_matrix
from iseg_tpu_torch.metrics.mean_iou import MeanIoU, iou_from_confusion
from iseg_tpu_torch.metrics.wrapper import SegMetricWrapper, process_seg_metric_inputs

__all__ = ["MeanIoU", "SegMetricBuilder", "SegMetricWrapper", "confusion_matrix",
           "iou_from_confusion", "process_seg_metric_inputs"]
