"""Profiling / step-timing utilities (counterpart of
``iseg_tpu/utils/profiling.py``).

Parity with the reference's TensorBoard-profiler window
(``core_train.py:121-126`` ``profile_batch`` at 10% of the epoch when
``use_profiler=True``) via ``torch.profiler`` traces, plus a lightweight
wall-clock step timer (the ``TimeCallback`` analogue for steps, copied).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's when CUDA is available) and write it to ``logdir`` as a
    Chrome trace, ``trace.<pid>.<ns>.json`` (open in Perfetto or
    ``chrome://tracing``). Queued device work is waited for before the
    trace stops."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


class StepTimer:
    """Rolling step timer: call ``tick()`` once per step (after blocking on
    outputs); ``summary()`` gives p50/p90/mean seconds."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    def summary(self) -> dict:
        if not self._times:
            return {}
        s = sorted(self._times)
        n = len(s)
        return {
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            # nearest-rank p90: ceil(0.9n)-1, NOT int(0.9n) (which lands
            # on the max for most n — one recompile straggler would then
            # masquerade as the p90)
            "p90_s": s[max(0, -(-9 * n // 10) - 1)],
            "steps": n,
        }
