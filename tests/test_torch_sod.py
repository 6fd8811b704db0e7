"""The port's salient-object-detection metrics (``iseg_tpu_torch/metrics/sod``,
numpy and scipy copies) against the JAX package's on seeded maps: every
per-image score, every streaming metric class over a batch, and every
FmeasureV2 handler in its dynamic, adaptive and binary modes, each result
equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import iseg_tpu.metrics.sod as jsod
import iseg_tpu_torch.metrics.sod as tsod

torch.set_num_threads(1)


def _maps(seed=0, n=3, hw=(48, 40)):
    """Ground truths (0/255 uint8 blobs) and float saliency maps in [0, 1]
    that follow them with noise."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for _ in range(n):
        gt = np.zeros(hw, np.uint8)
        for _ in range(3):
            y, x = rng.randint(0, hw[0] - 12), rng.randint(0, hw[1] - 12)
            gt[y:y + rng.randint(4, 12), x:x + rng.randint(4, 12)] = 255
        pred = np.clip(0.7 * (gt > 0) + 0.4 * rng.rand(*hw), 0.0, 1.0)
        gts.append(gt)
        preds.append(pred)
    return gts, preds


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn", ["mae_score", "s_measure", "e_measure", "f_measures",
                                "weighted_f_measure", "hce_score"])
def test_torch_sod_scores_equal_jax(fn):
    for gt, pred in zip(*_maps()):
        _equal(getattr(tsod, fn)(pred, gt), getattr(jsod, fn)(pred, gt))
    gt = np.zeros((16, 16), np.uint8)  # the empty-foreground edge case
    pred = np.random.RandomState(1).rand(16, 16)
    _equal(getattr(tsod, fn)(pred, gt), getattr(jsod, fn)(pred, gt))


@pytest.mark.parametrize("cls", ["MAEMetric", "SMeasureMetric", "EMeasureMetric",
                                 "WeightedFMetric", "HCEMetric", "FMeasureV2Metric"])
def test_torch_sod_streaming_metrics_equal_jax(cls):
    gts, preds = _maps(seed=2)
    batch_gt = np.stack(gts)[..., None]
    batch_pred = np.stack(preds)[..., None]
    mine, theirs = getattr(tsod, cls)(), getattr(jsod, cls)()
    for m in (mine, theirs):
        m.update_state(batch_gt, batch_pred)
        m.update_state(gts[0], preds[1])
    _equal(mine.result(), theirs.result())


HANDLERS = ["BERHandler", "DICEHandler", "FPRHandler", "FmeasureHandler", "IOUHandler",
            "KappaHandler", "OverallAccuracyHandler", "PrecisionHandler", "RecallHandler",
            "SensitivityHandler", "SpecificityHandler", "TNRHandler", "TPRHandler"]


@pytest.mark.parametrize("name", HANDLERS)
def test_torch_fmeasurev2_handlers_equal_jax(name):
    gts, preds = _maps(seed=3)
    for kw in (dict(with_dynamic=True, with_adaptive=True),
               dict(with_dynamic=False, with_adaptive=False, with_binary=True)):
        mine, theirs = getattr(tsod, name)(**kw), getattr(jsod, name)(**kw)
        for m in (mine, theirs):
            for gt, pred in zip(gts, preds):
                m.update_state(pred, gt)
        _equal(mine.result(), theirs.result())
    from iseg_tpu.metrics.sod.fmeasurev2 import safe_divide as j_safe
    from iseg_tpu_torch.metrics.sod.fmeasurev2 import safe_divide as t_safe
    _equal(t_safe(np.array([1.0, 0.0]), np.array([0.0, 2.0])),
           j_safe(np.array([1.0, 0.0]), np.array([0.0, 2.0])))
