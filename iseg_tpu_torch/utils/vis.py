"""Visualization manager: a global tensor-record registry for debugging
(counterpart of ``iseg_tpu/utils/vis.py``).

``record`` passes its tensor through unchanged. While ``enabled`` is true
at the time of the call it also stores a host copy (``detach().cpu()`` as
numpy), which waits for the device: never call it inside a region that
must not synchronize (a timed step, a CUDA graph capture). While disabled
it stores nothing and copies nothing.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


class VisualizationManager:
    def __init__(self):
        self.enabled = False
        self._records: dict[str, list] = {}

    def record(self, name: str, tensor: Any) -> Any:
        """Record ``tensor`` under ``name`` when enabled; returns it
        unchanged either way."""
        if self.enabled:
            value = tensor.detach().cpu().numpy() if isinstance(tensor, torch.Tensor) else tensor
            self._records.setdefault(name, []).append(np.asarray(value))
        return tensor

    def get(self, name: str) -> list:
        return self._records.get(name, [])

    def names(self) -> list[str]:
        return sorted(self._records)

    def clear(self) -> None:
        self._records.clear()


_MANAGER: Optional[VisualizationManager] = None


def get_visualization_manager() -> VisualizationManager:
    global _MANAGER
    if _MANAGER is None:
        _MANAGER = VisualizationManager()
    return _MANAGER
