"""Explicit collectives over the data axis (counterpart of
``iseg_tpu/parallel/collectives.py``).

GSPMD inserts the JAX package's reductions for it; the port issues them by
hand. Every rank issues the same collectives in the same order (each
function here is called at the same point of the same program on every
rank), so no rank waits on a collective another rank never makes.

Without a group (``group=None`` and no active data-parallel group) each
function is the identity over one rank.

Backends: NCCL does all of these on the card. Gloo does ``all_reduce``
and ``broadcast`` of CUDA tensors, but not ``all_gather`` or
``reduce_scatter``: a CUDA tensor given to one of those under gloo is
copied to host memory, reduced there and copied back, explicitly here,
and each such call adds one to ``HOST_STAGED[name]``. It is never a quiet
retry: any other failure raises.

:func:`data_parallel` makes a group the *active* one for the code inside
it: :class:`~iseg_tpu_torch.nn.norm.SyncBatchNorm` and the losses read it
(:func:`active_group`) to take their moments and denominators over the
global batch. ``make_train_step(..., mesh=)`` and ``evaluate`` enter it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from iseg_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, process_group_active

HOST_STAGED = {"all_gather": 0, "reduce_scatter": 0}

_ACTIVE: list = []  # stack of active data-parallel groups (None = one rank)


def reset_host_staged() -> None:
    for k in HOST_STAGED:
        HOST_STAGED[k] = 0


@contextlib.contextmanager
def data_parallel(mesh, axis: str = DATA_AXIS):
    """Make ``mesh``'s ``axis`` group the active data-parallel group inside
    the block (``mesh=None``: one rank, nothing changes)."""
    _ACTIVE.append(axis_group(mesh, axis) if mesh is not None else None)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_group():
    """The active data-parallel group, or None (one rank)."""
    return _ACTIVE[-1] if _ACTIVE else None


def _resolve(group):
    if group is None:
        group = active_group()
    if group is None or not process_group_active():
        return None
    return group


def world_size(group=None) -> int:
    """Ranks in ``group`` (the active group when None); 1 without one."""
    group = _resolve(group)
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    group = _resolve(group)
    return 0 if group is None else dist.get_rank(group)


def comm_device(group=None) -> torch.device:
    """Where a small tensor for a collective of ``group`` lives: this
    rank's card under NCCL, the host otherwise."""
    group = _resolve(group)
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host_staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce_values(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Sum (or mean) of ``x`` over the ranks, as a new tensor (reference
    ``distribution/distribution_utils.py:158``, SUM only there)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported all-reduce op: {op}")
    group = _resolve(group)
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    if op == "mean":
        out = out / dist.get_world_size(group)
    return out


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``x`` over the ranks; returns ``x``."""
    group = _resolve(group)
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0, in rank order."""
    group = _resolve(group)
    if group is None:
        return x
    n = dist.get_world_size(group)
    staged = _host_staged(x, group)
    src = x.detach().contiguous()
    if staged:
        HOST_STAGED["all_gather"] += 1
        src = src.cpu()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.chunk(n)), src, group=group)
    return out.to(x.device) if staged else out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of the ranks' ``x``, of which this rank keeps its slice of dim 0
    (which must divide the group's size)."""
    group = _resolve(group)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not divide {n} ranks")
    staged = _host_staged(x, group)
    src = x.detach().contiguous()
    if staged:
        HOST_STAGED["reduce_scatter"] += 1
        src = src.cpu()
    chunks = list(src.chunk(n))
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.device) if staged else out


def barrier(group=None) -> None:
    group = _resolve(group)
    if group is not None:
        dist.barrier(group=group)


def global_rows(n: int, group=None) -> tuple[int, slice]:
    """``(n * d, this rank's rows)`` for a random draw over a batch whose
    ranks hold ``n`` rows each: every rank draws the global batch's values
    from the same seeded generator and keeps its own slice, so a rank's
    dropout masks and augment are its slice of what one process drawing for
    the whole batch would draw. ``(n, all rows)`` without a group."""
    d, r = world_size(group), rank(group)
    return n * d, slice(r * n, (r + 1) * n)


def global_batch_size(local_batch: int, group=None) -> int:
    """The global batch of a step whose ranks each hold ``local_batch``."""
    return local_batch * world_size(group)


class AnyRankVote:
    """A non-blocking vote: ``result()`` is True on every rank when
    ``flag`` was true on any rank. The all-reduce is issued here and read in
    ``result()``; under NCCL its answer comes back to pinned host memory
    behind an event, so a vote read a step after it was cast waits for that
    step's collective and not for the work queued since."""

    def __init__(self, flag: bool, device: Optional[torch.device] = None, group=None):
        self._group = _resolve(group)
        self._flag = bool(flag)
        if self._group is None:
            return
        self._t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                               device=device if device is not None else comm_device(group))
        self._work = dist.all_reduce(self._t, op=dist.ReduceOp.SUM, group=self._group,
                                     async_op=True)
        self._event = None
        if self._t.is_cuda:
            self._work.wait()  # the current stream waits for it; the host does not
            self._host = torch.empty(1, dtype=torch.int32, pin_memory=True)
            self._host.copy_(self._t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def result(self) -> bool:
        if self._group is None:
            return self._flag
        if self._event is not None:
            self._event.synchronize()
            return bool(self._host.item() > 0)
        self._work.wait()
        return bool(self._t.item() > 0)
