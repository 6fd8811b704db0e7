"""Metric-set assembly keyed by output name (a copy of
``iseg_tpu/metrics/builder.py``).

Parity with the reference's ``metrics/utils.py:12`` ``SegMetricBuilder``:
multi-output models get a metric list per ``output_N`` key (main output
first, aux outputs after — reference ``core_model.py:543``).
"""

from __future__ import annotations

from typing import Optional

from iseg_tpu_torch.metrics.mean_iou import MeanIoU


class SegMetricBuilder:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self._metrics: dict[str, list] = {}

    def add(self, output_name: Optional[str] = None, use_iou: bool = True, extra=()):
        """Add the default metric set for one model output
        (reference ``metrics/utils.py:20-58``)."""
        key = output_name or f"output_{len(self._metrics)}"
        metrics = []
        if use_iou:
            metrics.append(
                MeanIoU(self.num_classes, self.ignore_label, name=f"{key}_miou")
            )
        metrics.extend(extra)
        self._metrics[key] = metrics
        return self

    def build(self) -> dict[str, list]:
        return dict(self._metrics)

    def update_state(self, labels, outputs: dict):
        for key, metrics in self._metrics.items():
            if key not in outputs:
                continue
            for m in metrics:
                m.update_state(labels, outputs[key])

    def results(self) -> dict[str, float]:
        out = {}
        for key, metrics in self._metrics.items():
            for m in metrics:
                out[m.name] = m.result()
        return out

    def reset_state(self):
        for metrics in self._metrics.values():
            for m in metrics:
                m.reset_state()
