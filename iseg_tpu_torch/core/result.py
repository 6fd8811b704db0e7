"""Result descriptor (copy of ``iseg_tpu/core/result.py``): a small record
drivers use to describe a model run configuration."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class CoreResult:
    name: str = ""
    loss_rates: Optional[Sequence[float]] = None
    use_ohem: bool = False
