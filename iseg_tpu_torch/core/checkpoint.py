"""Checkpoint management (counterpart of ``iseg_tpu/core/checkpoint.py``,
where orbax writes): ``ModelHelper`` saves a train state with
``torch.save`` and restores it into a live one.

Layout: ``<checkpoint_dir>/<step>/state.pt``, one directory per step. A
save writes into a temporary directory ``.tmp-<step>-*`` beside them,
flushes it to disk, and renames it into place with ``os.replace``, so a
write killed half-way leaves only a temporary directory, which
``all_steps`` and the restores never read (a later ``ModelHelper`` on the
same directory removes it). ``max_to_keep`` keeps the newest steps.

The file holds ``{"step", "params", "batch_stats", "opt_state",
"ema_params"?}``: flax-path-keyed CPU tensors (``convert.param_tree``
paths), the optimizer state's fields as nested dicts (SGD's step count and
momentum buffers; Adam's count, moments and AMSGrad maximum; a
multi-optimizer's state per group; the accumulator's mini-step, update
count, running gradient mean and inner state), and the EMA of the params
when the state tracks one. It is read back with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import torch

from iseg_tpu_torch.parallel.mesh import process_rank_and_count

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


def _to_host(value):
    """Tensors (nested in dicts, lists, tuples and dataclasses) -> CPU copies. CUDA
    tensors go through pinned buffers with one synchronize at the end."""
    pending = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.device.type == "cuda":
                out = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                out.copy_(v, non_blocking=True)
                pending.append(v.device)
                return out
            return v.clone()
        if dataclasses.is_dataclass(v):
            return {f.name: walk(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        return v

    out = walk(value)
    for device in set(pending):
        torch.cuda.synchronize(device)
    return out


def _snapshot(state) -> dict:
    out = {
        "step": int(state.step),
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
    }
    if getattr(state, "ema_params", None) is not None:
        out["ema_params"] = state.ema_params
    return _to_host(out)


@torch.no_grad()
def _copy_into(dst, src, what: str):
    """Copy ``src`` into ``dst``'s own tensors (same structure; a dataclass
    state was saved as the dict of its fields); returns what the field
    should hold afterwards."""
    if dataclasses.is_dataclass(dst):
        fields = [f.name for f in dataclasses.fields(dst)]
        if not isinstance(src, dict) or sorted(src) != sorted(fields):
            raise KeyError(f"checkpoint {what} has fields {sorted(src or {})}, the state "
                           f"{fields}")
        for name in fields:
            setattr(dst, name, _copy_into(getattr(dst, name), src[name], f"{what}/{name}"))
        return dst
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint {what}: saved {getattr(src, 'shape', type(src))}, "
                             f"state has {tuple(dst.shape)}")
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            missing = sorted(set(dst) - set(src or {}))
            extra = sorted(set(src or {}) - set(dst))
            raise KeyError(f"checkpoint {what}: keys differ (missing {missing[:5]}, "
                           f"unexpected {extra[:5]})")
        for k in dst:
            _copy_into(dst[k], src[k], f"{what}/{k}")
        return dst
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"checkpoint {what}: saved length differs from the state's")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{what}[{i}]")
        return dst
    return src


class ModelHelper:
    """Save and restore train states under ``checkpoint_dir`` (reference
    ``modelhelper.py:59``: save / restore with ``max_to_keep``)."""

    def __init__(self, checkpoint_dir: str, max_to_keep: int = 3, async_save: bool = False):
        """``async_save=True`` makes ``save()`` return once the state is
        copied to host memory; the file is written on a thread. ``wait()``
        (called before the next save, at restore, and by ``CoreTrain`` at
        the end of ``train``) blocks until the last save is durable and
        raises its error if it failed."""
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        if process_rank_and_count()[0] == 0:
            for name in os.listdir(self.checkpoint_dir):  # left by a killed write
                if name.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.checkpoint_dir, name), ignore_errors=True)

    def save(self, step: int, state: Any) -> None:
        """Save the train state (step, params, batch_stats, opt_state, and
        ema_params when tracked) as checkpoint ``step``.

        In a process group of several ranks (data parallelism: every rank
        holds the same state) rank 0 writes it and every rank returns after
        a barrier that follows the write, so any rank may restore it next;
        the write is then synchronous."""
        rank, world = process_rank_and_count()
        if world > 1:
            if rank == 0:
                self.wait()
                self._write(step, _snapshot(state))
            torch.distributed.barrier()
            return
        self.wait()
        snapshot = _snapshot(state)
        if not self.async_save:
            self._write(step, snapshot)
            return

        def run():
            try:
                self._write(step, snapshot)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint-{step}", daemon=False)
        self._thread.start()

    def _write(self, step: int, snapshot: dict) -> None:
        tmp = tempfile.mkdtemp(prefix=f"{_TMP_PREFIX}{step}-", dir=self.checkpoint_dir)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(snapshot, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.checkpoint_dir, str(step))
        if os.path.exists(final):  # the same step saved again: the new one wins
            shutil.rmtree(final)
        os.replace(tmp, final)
        fd = os.open(self.checkpoint_dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if self.max_to_keep:
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.checkpoint_dir, str(old)), ignore_errors=True)

    def wait(self) -> None:
        """Block until an in-flight async save is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> list[int]:
        """Steps with a complete checkpoint, oldest first."""
        steps = []
        for name in os.listdir(self.checkpoint_dir):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.checkpoint_dir, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_latest(self) -> Optional[dict]:
        self.wait()  # flush any in-flight save
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.checkpoint_dir, str(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_latest(self, template_state: Any) -> Optional[Any]:
        """Restore the newest checkpoint into ``template_state`` and return
        it, or None when there is none (reference ``modelhelper.py:125``).

        Values are copied into the state's own tensors (``params`` and
        ``batch_stats`` are views of the model's, the momentum buffers the
        optimizer's), so the model trains on the restored weights. EMA
        switched on since the save starts from the restored params; EMA
        switched off ignores the saved one."""
        saved = self._load_latest()
        if saved is None:
            return None
        state = template_state
        _copy_into(state.params, saved["params"], "params")
        _copy_into(state.batch_stats, saved["batch_stats"], "batch_stats")
        _copy_into(state.opt_state, saved["opt_state"], "opt_state")
        if getattr(state, "ema_params", None) is not None:
            _copy_into(state.ema_params, saved.get("ema_params", saved["params"]), "ema_params")
        state.step = int(saved["step"])
        return state

    def restore_latest_variables(self, variables_template: dict) -> Optional[dict]:
        """Restore only ``params`` and ``batch_stats`` for eval and predict
        programs (an eval process has no optimizer). Returns a variables dict
        of new tensors on the template's devices and dtypes, with the EMA
        params in place of the params when the checkpoint has them, or None
        when there is no checkpoint."""
        saved = self._load_latest()
        if saved is None:
            return None
        out = {}
        for col in ("params", "batch_stats"):
            if variables_template.get(col) is None:
                continue
            src = saved["ema_params"] if col == "params" and "ema_params" in saved else saved[col]
            out[col] = {}
            for path, t in variables_template[col].items():
                if path not in src:
                    raise KeyError(f"checkpoint has no {col} leaf {path!r}")
                out[col][path] = src[path].to(device=t.device, dtype=t.dtype)
        return out
