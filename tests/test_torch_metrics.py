"""The port's confusion matrix and mean IoU against ``iseg_tpu.metrics``.

Counts are small integers in float32 on both sides, so the matrices are
equal exactly; the IoU is host-side float64 numpy on both sides (rtol
1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.metrics.confusion import confusion_matrix as j_confusion_matrix
from iseg_tpu.metrics.mean_iou import MeanIoU as JMeanIoU
from iseg_tpu.metrics.mean_iou import iou_from_confusion as j_iou_from_confusion
from iseg_tpu.metrics.wrapper import process_seg_metric_inputs as j_process
from iseg_tpu_torch.metrics import (
    MeanIoU,
    confusion_matrix,
    iou_from_confusion,
    process_seg_metric_inputs,
)

torch.set_num_threads(1)

C = 5


def _data(seed=0, n=2, h=9, w=11, ignore_label=255, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    lo = 1 if ignore_label == 0 else 0
    labels = rng.randint(lo, C + lo, (n, h, w))
    labels = np.where(rng.rand(n, h, w) < ignore_frac, ignore_label, labels).astype(np.int32)
    preds = rng.randint(0, C, (n, h, w)).astype(np.int32)
    logits = rng.randn(n, h, w, C).astype(np.float32)
    return labels, preds, logits


@pytest.mark.parametrize("weighted", [False, True])
def test_torch_confusion_matrix_matches_jax(weighted):
    labels, preds, _ = _data(ignore_frac=0.0)
    w = np.random.RandomState(1).randint(0, 2, labels.shape).astype(np.float32)
    t = confusion_matrix(torch.tensor(labels), torch.tensor(preds), C,
                         torch.tensor(w) if weighted else None)
    j = j_confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), C,
                           jnp.asarray(w) if weighted else None)
    assert t.dtype == torch.float32 and tuple(t.shape) == (C, C)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(t.sum()) == (w.sum() if weighted else labels.size)


def test_torch_confusion_matrix_clamps_out_of_range():
    labels = np.array([[[-3, 9, 2]]], np.int32)
    preds = np.array([[[7, -1, 2]]], np.int32)
    t = confusion_matrix(torch.tensor(labels), torch.tensor(preds), C)
    j = j_confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), C)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("ignore_label", [255, 0])
@pytest.mark.parametrize("kind", ["ids", "logits", "logits_low_res", "labels_with_channel"])
def test_torch_process_seg_metric_inputs_matches_jax(kind, ignore_label):
    labels, preds, logits = _data(ignore_label=ignore_label)
    if kind == "ids":
        p = preds
    elif kind == "logits_low_res":  # labels are resized (nearest) to the logits
        p = logits[:, :5, :6]
    else:
        p = logits
    if kind == "labels_with_channel":
        labels = labels[..., None]
    t = process_seg_metric_inputs(torch.tensor(labels), torch.tensor(p), ignore_label)
    j = j_process(jnp.asarray(labels), jnp.asarray(p), ignore_label)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ignore_label", [255, 0])
def test_torch_mean_iou_with_ignored_pixels_matches_jax(ignore_label):
    t_metric, j_metric = MeanIoU(C, ignore_label), JMeanIoU(C, ignore_label)
    valid = 0
    for seed, use_logits in ((0, False), (1, True), (2, True)):
        labels, preds, logits = _data(seed, ignore_label=ignore_label)
        p = logits if use_logits else preds
        t_metric.update_state(torch.tensor(labels), torch.tensor(p))
        j_metric.update_state(jnp.asarray(labels), jnp.asarray(p))
        valid += int((labels != ignore_label).sum())
    assert t_metric.total_cm.dtype == np.float64
    np.testing.assert_array_equal(t_metric.total_cm, j_metric.total_cm)
    assert t_metric.total_cm.sum() == valid  # ignored pixels are not counted
    np.testing.assert_allclose(t_metric.result(), j_metric.result(), rtol=1e-12)
    np.testing.assert_allclose(t_metric.per_class_iou(), j_metric.per_class_iou(), rtol=1e-12)
    t_metric.reset_state()
    assert t_metric.total_cm.sum() == 0 and t_metric.result() == 0.0


def test_torch_iou_from_confusion_skips_absent_classes():
    cm = np.array([[3, 1, 0], [2, 4, 0], [0, 0, 0]], np.float64)  # class 2 never appears
    t_iou, t_mean = iou_from_confusion(cm)
    j_iou, j_mean = j_iou_from_confusion(cm)
    np.testing.assert_array_equal(t_iou, j_iou)
    assert t_mean == j_mean == pytest.approx((3 / 6 + 4 / 7) / 2)
