"""Training callbacks (a copy of ``iseg_tpu/core/callbacks.py``).

Parity with the reference's ``callbacks/`` package: ``CheckpointSaver``
(``ckpt_saver.py:11-26``), ``TimeCallback`` wall-clock liveness print
(``time_callback.py:16-25``), and ``ModelCallback`` epoch-event forwarding
(``model_callback.py:11-36``). ``CoreTrain`` already owns the checkpoint
cadence; these cover the user-extensible hook surface.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Callback:
    def on_epoch_begin(self, epoch: int, state) -> None: ...

    def on_epoch_end(self, epoch: int, state, logs: Optional[dict] = None) -> None: ...

    def on_train_end(self, state) -> None: ...


class TimeCallback(Callback):
    """Print wall-clock per epoch for hang detection
    (reference ``callbacks/time_callback.py:16-25``)."""

    def __init__(self):
        self._t0 = None

    def on_epoch_begin(self, epoch, state):
        self._t0 = time.time()
        print(f"[time] epoch {epoch} begin at {time.strftime('%H:%M:%S')}", flush=True)

    def on_epoch_end(self, epoch, state, logs=None):
        dt = time.time() - (self._t0 or time.time())
        print(f"[time] epoch {epoch} took {dt:.1f}s", flush=True)


class CheckpointSaver(Callback):
    """Epoch-end checkpoint save via ModelHelper
    (reference ``callbacks/ckpt_saver.py:18-26``)."""

    def __init__(self, model_helper):
        self.model_helper = model_helper

    def on_epoch_end(self, epoch, state, logs=None):
        self.model_helper.save(int(state.step), state)


class LambdaCallback(Callback):
    """Forward epoch events to arbitrary fns
    (reference ``callbacks/model_callback.py:11-36``)."""

    def __init__(
        self,
        on_epoch_begin: Optional[Callable] = None,
        on_epoch_end: Optional[Callable] = None,
        on_train_end: Optional[Callable] = None,
    ):
        self._begin = on_epoch_begin
        self._end = on_epoch_end
        self._train_end = on_train_end

    def on_epoch_begin(self, epoch, state):
        if self._begin:
            self._begin(epoch, state)

    def on_epoch_end(self, epoch, state, logs=None):
        if self._end:
            self._end(epoch, state, logs)

    def on_train_end(self, state):
        if self._train_end:
            self._train_end(state)
