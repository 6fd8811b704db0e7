"""FmeasureV2 handler family: threshold-sweep binary-classification metrics
(a numpy copy of ``iseg_tpu/metrics/sod/fmeasurev2.py``).

Parity with the reference ``metrics/sod/fmeasurev2.py`` (``TFBaseHandler``
:22 — dynamic 256-threshold histogram sweep :198, adaptive 2x-mean
binarization :180, fixed-0.5 binary mode :144, sample/dataset aggregation —
and the nine metric handlers :300-757) and ``sod_metric_utils.py``
(``prepare_data`` mapminmax normalization :67, ``get_adaptive_threshold``
:98, ``safe_divide`` :138).

Host-eval tier: numpy, vectorized over all 256 thresholds at once (one
histogram + cumsum per image instead of 256 threshold passes).
"""

from __future__ import annotations

import abc

import numpy as np


def safe_divide(numerator, denominator):
    """0-when-denominator-0 division (reference ``sod_metric_utils.py:138``)."""
    numerator = np.asarray(numerator, np.float64)
    denominator = np.asarray(denominator, np.float64)
    out = np.zeros_like(numerator)
    np.divide(numerator, denominator, out=out, where=denominator != 0)
    return out


def get_adaptive_threshold(matrix, max_value: float = 1.0) -> float:
    """min(2 * mean, max_value) (reference ``sod_metric_utils.py:98``)."""
    return min(2.0 * float(np.mean(matrix)), max_value)


def prepare_data(pred, gt):
    """uint8 grayscale -> (pred float in [0,1] mapminmax-normalized,
    gt bool thresholded at 128) (reference ``sod_metric_utils.py:67``).

    Already-binary/unit-range gt ({0,1} float or bool, the convention the
    sibling ``sod_metrics`` module accepts) thresholds at 0.5 — under the
    uint8 rule ``gt > 128`` such masks would silently become
    all-background and every handler would report 0."""
    gt = np.asarray(gt)
    gt = gt > (0.5 if gt.max() <= 1 else 128)
    pred = np.asarray(pred, np.float64)
    if pred.max() > 1:
        pred = pred / 255.0
    pmax, pmin = pred.max(), pred.min()
    if pmax != pmin:
        pred = (pred - pmin) / (pmax - pmin)
    return pred, gt


def validate_and_normalize_input(pred, gt, normalize: bool = True):
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    if pred.shape != gt.shape:
        raise ValueError(
            f"shape mismatch between prediction {pred.shape} and ground "
            f"truth {gt.shape}")
    if normalize:
        return prepare_data(pred, gt)
    return pred.astype(np.float64), gt.astype(bool)


class BaseHandler(abc.ABC):
    """Streaming handler (reference ``fmeasurev2.py:22``): accumulates the
    metric under three binarization regimes —

    - dynamic: all 256 uint8 thresholds at once (curve / mean / max)
    - adaptive: per-image threshold = min(2*mean(pred), 1)
    - binary: fixed 0.5; ``sample_based=False`` accumulates a single
      dataset-level confusion matrix instead of averaging per image
    """

    def __init__(self, with_dynamic: bool, with_adaptive: bool, *,
                 with_binary: bool = False, sample_based: bool = True,
                 name: str = "base_handler"):
        self.name = name
        self.with_dynamic = with_dynamic
        self.with_adaptive = with_adaptive
        self.with_binary = with_binary
        self.sample_based = sample_based
        self.reset_state()

    @abc.abstractmethod
    def compute_metric(self, tp, fp, tn, fn):
        ...

    def reset_state(self):
        self.dynamic_results_sum = np.zeros(256, np.float64)
        self.dynamic_count = 0.0
        self.adaptive_results_sum = 0.0
        self.adaptive_count = 0.0
        self.binary_results_sum = 0.0
        self.binary_count = 0.0
        self.binary_tp = self.binary_fp = 0.0
        self.binary_tn = self.binary_fn = 0.0

    @staticmethod
    def _get_statistics(binary, gt, fg, bg):
        tp = float(np.count_nonzero(binary[gt]))
        fp = float(np.count_nonzero(binary[~gt]))
        return {"tp": tp, "fp": fp, "tn": bg - fp, "fn": fg - tp}

    @staticmethod
    def _dynamically_binarizing(pred, gt, fg, bg):
        """TP/FP/TN/FN for every threshold in 255..0 via one histogram +
        reversed cumsum per region (reference ``fmeasurev2.py:198-238``)."""
        pred_uint8 = (pred * 255.0).astype(np.int64)
        tp_hist = np.bincount(pred_uint8[gt], minlength=256)[:256]
        fp_hist = np.bincount(pred_uint8[~gt], minlength=256)[:256]
        tps = np.cumsum(tp_hist[::-1]).astype(np.float64)
        fps = np.cumsum(fp_hist[::-1]).astype(np.float64)
        return {"tp": tps, "fp": fps, "tn": bg - fps, "fn": fg - tps}

    def update_state(self, pred, gt, normalize: bool = True):
        pred, gt = validate_and_normalize_input(pred, gt, normalize)
        fg = float(np.count_nonzero(gt))
        bg = float(gt.size) - fg

        if self.with_dynamic:
            stats = self._dynamically_binarizing(pred, gt, fg, bg)
            self.dynamic_results_sum += self.compute_metric(**stats)
            self.dynamic_count += 1.0
        if self.with_adaptive:
            binary = pred >= get_adaptive_threshold(pred)
            stats = self._get_statistics(binary, gt, fg, bg)
            self.adaptive_results_sum += float(self.compute_metric(**stats))
            self.adaptive_count += 1.0
        if self.with_binary:
            stats = self._get_statistics(pred > 0.5, gt, fg, bg)
            if self.sample_based:
                self.binary_results_sum += float(self.compute_metric(**stats))
                self.binary_count += 1.0
            else:
                self.binary_tp += stats["tp"]
                self.binary_fp += stats["fp"]
                self.binary_tn += stats["tn"]
                self.binary_fn += stats["fn"]

    def result(self) -> dict:
        results = {}
        if self.with_dynamic:
            results["dynamic"] = safe_divide(
                self.dynamic_results_sum, self.dynamic_count)
        if self.with_adaptive:
            results["adaptive"] = float(safe_divide(
                self.adaptive_results_sum, self.adaptive_count))
        if self.with_binary:
            if self.sample_based:
                results["binary"] = float(safe_divide(
                    self.binary_results_sum, self.binary_count))
            else:
                results["binary"] = float(self.compute_metric(
                    self.binary_tp, self.binary_fp,
                    self.binary_tn, self.binary_fn))
        return results


class IOUHandler(BaseHandler):
    """iou = tp / (tp + fp + fn) (reference ``fmeasurev2.py:300``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="iou", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(tp, tp + fp + fn)


class SpecificityHandler(BaseHandler):
    """specificity = tn / (tn + fp) (reference ``fmeasurev2.py:342``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="specificity",
                 **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(tn, tn + fp)


TNRHandler = SpecificityHandler


class DICEHandler(BaseHandler):
    """dice = 2tp / (2tp + fp + fn) (reference ``fmeasurev2.py:389``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="dice", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(2.0 * tp, tp + fn + tp + fp)


class OverallAccuracyHandler(BaseHandler):
    """oa = (tp + tn) / total (reference ``fmeasurev2.py:432``)."""

    def __init__(self, with_dynamic, with_adaptive, *,
                 name="overall_accuracy", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(tp + tn, tp + fp + tn + fn)


class KappaHandler(BaseHandler):
    """kappa = (oa - p_e) / (1 - p_e) (reference ``fmeasurev2.py:475``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="kappa", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        total = tp + fp + tn + fn
        oa = safe_divide(tp + tn, total)
        p_e = safe_divide((tp + fp) * (tp + fn) + (tn + fn) * (tn + tp),
                          np.square(np.asarray(total, np.float64)))
        return safe_divide(oa - p_e, 1.0 - p_e)


class PrecisionHandler(BaseHandler):
    """precision = tp / (tp + fp) (reference ``fmeasurev2.py:530``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="precision", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(tp, tp + fp)


class RecallHandler(BaseHandler):
    """recall = tp / (tp + fn) (reference ``fmeasurev2.py:568``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="recall", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(tp, tp + fn)


TPRHandler = RecallHandler
SensitivityHandler = RecallHandler


class FPRHandler(BaseHandler):
    """fpr = fp / (tn + fp) (reference ``fmeasurev2.py:615``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="fpr", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return safe_divide(fp, tn + fp)


class BERHandler(BaseHandler):
    """ber = 1 - (tpr + tnr)/2 (reference ``fmeasurev2.py:657``)."""

    def __init__(self, with_dynamic, with_adaptive, *, name="ber", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)

    def compute_metric(self, tp, fp, tn, fn):
        return 1.0 - 0.5 * (safe_divide(tp, tp + fn)
                            + safe_divide(tn, tn + fp))


class FmeasureHandler(BaseHandler):
    """fmeasure = (b+1) P R / (b P + R), b = beta^2
    (reference ``fmeasurev2.py:703``)."""

    def __init__(self, with_dynamic, with_adaptive, *, beta: float = 0.3,
                 name="fmeasure", **kw):
        super().__init__(with_dynamic, with_adaptive, name=name, **kw)
        self.beta = beta

    def compute_metric(self, tp, fp, tn, fn):
        precision = safe_divide(tp, tp + fp)
        recall = safe_divide(tp, tp + fn)
        return safe_divide((self.beta + 1.0) * precision * recall,
                           self.beta * precision + recall)
