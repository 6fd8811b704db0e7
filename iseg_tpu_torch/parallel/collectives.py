"""Explicit collectives over the mesh's axes (counterpart of
``iseg_tpu/parallel/collectives.py``, and of the collectives GSPMD and
``shard_map`` insert for the JAX package).

GSPMD inserts the JAX package's reductions for it; the port issues them by
hand. Every rank issues the same collectives in the same order (each
function here is called at the same point of the same program on every
rank), so no rank waits on a collective another rank never makes.

Without a group (``group=None`` and no active data-parallel group) each
function is the identity over one rank.

Backends: NCCL does all of these on the card. Gloo does ``all_reduce``
and ``broadcast`` of CUDA tensors, but not ``all_gather``,
``reduce_scatter`` or point-to-point sends: a CUDA tensor given to one of
those under gloo is copied to host memory, sent or reduced there and
copied back, explicitly here, and each such call adds one to
``HOST_STAGED[name]``. It is never a quiet retry: any other failure raises.

The differentiable collectives (tensor, sequence, pipeline and expert
parallelism) follow one rule for their backward: a value that every rank
holds alike (an explicitly replicated output) carries one gradient, not one
per rank. So :func:`reduce_from` (an all-reduce) passes its gradient
through, :func:`copy_to` (the identity on a replicated input whose uses
differ by rank) sums its gradient over the ranks, :func:`gather_from`
either keeps this rank's slice of its gradient (a replicated consumer) or
reduce-scatters it (a consumer that differs by rank), and :func:`ppermute`
sends its gradient back along the inverse rotation, as ``lax.ppermute``'s
transpose does. Held to the serial computation's gradient, not to a literal
transcription of ``psum``'s transpose, which would count a replicated
gradient once per rank.

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

HOST_STAGED = {"all_gather": 0, "reduce_scatter": 0, "ppermute": 0}
# calls of the model-parallel collectives (forward and backward alike), for
# the smoke's counts of rotations and reductions a layer
CALLS = {"ppermute": 0, "all_reduce": 0, "all_gather": 0}

_ACTIVE: list = []  # stack of active data-parallel groups (None = one rank)


def reset_host_staged() -> None:
    """Set ``HOST_STAGED`` and ``CALLS`` to 0."""
    for counts in (HOST_STAGED, CALLS):
        for k in counts:
            counts[k] = 0


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
    CALLS["all_gather"] += 1
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


# ------------------------------------------------- differentiable collectives

def explicit_group(group):
    """``group`` when a process group runs; None otherwise. The model-parallel
    collectives take their group explicitly: None is one rank, never the
    active data-parallel group."""
    return group if group is not None and process_group_active() else None


def _peer(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank)


def _sendrecv(x: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Send ``x`` to group rank ``send_to`` and return what group rank
    ``recv_from`` sends (same shape and type). Under gloo a CUDA tensor is
    staged through host memory."""
    staged = _host_staged(x, group)
    src = x.detach().contiguous()
    if staged:
        HOST_STAGED["ppermute"] += 1
        src = src.cpu()
    out = torch.empty_like(src)
    CALLS["ppermute"] += 1
    ops = [dist.P2POp(dist.isend, src, _peer(group, send_to), group),
           dist.P2POp(dist.irecv, out, _peer(group, recv_from), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


def ppermute_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + shift) % n)]`` over
    ``group``, without a gradient: this rank sends ``x`` to rank ``r +
    shift`` and gets rank ``r - shift``'s."""
    group = explicit_group(group)
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if shift % n == 0:
        return x
    return _sendrecv(x, group, (r + shift) % n, (r - shift) % n)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute_shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return ppermute_shift(grad.contiguous(), ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Differentiable rotation over ``group``: rank ``r``'s ``x`` goes to
    rank ``(r + shift) % n``. Its backward is the inverse rotation."""
    group = explicit_group(group)
    return x if group is None else _PPermute.apply(x, group, shift)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().contiguous().clone()
    CALLS["all_reduce"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' ``x`` (an all-reduce), replicated; its gradient
    passes through to each rank's term once."""
    group = explicit_group(group)
    if group is None:
        return x
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The identity on a replicated ``x`` that each rank goes on to use
    differently (its own heads, experts or pipeline stage); the backward
    sums the ranks' gradients, so every rank holds the whole one."""
    group = explicit_group(group)
    if group is None:
        return x
    return _CopyTo.apply(x, group)


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    # [n * m, ...] in rank order along dim 0, then back to ``dim``
    return all_gather(x.movedim(dim, 0).contiguous(), group).movedim(0, dim)


def _slice_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[dim] // n
    return x.narrow(dim, r * m, m).contiguous()


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad_mode):
        ctx.group, ctx.dim, ctx.grad_mode = group, dim, grad_mode
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.grad_mode == "slice":
            return _slice_dim(grad, ctx.group, ctx.dim), None, None, None
        moved = grad.movedim(ctx.dim, 0).contiguous()
        return reduce_scatter(moved, ctx.group).movedim(0, ctx.dim), None, None, None


def gather_from(x: torch.Tensor, group, dim: int = 0, grad: str = "slice") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, on every
    rank. ``grad="slice"``: what consumes the result is the same on every
    rank (the tied readout's logits), so the backward keeps this rank's
    slice of the gradient; ``grad="reduce_scatter"``: each rank consumes it
    differently (its own queries against the gathered keys), so the backward
    sums the ranks' gradients and keeps this rank's slice."""
    if grad not in ("slice", "reduce_scatter"):
        raise ValueError(f"gather_from: grad must be 'slice' or 'reduce_scatter', got {grad!r}")
    group = explicit_group(group)
    if group is None:
        return x
    return _GatherFrom.apply(x, group, dim, grad)


def all_reduce_grads(params, group) -> None:
    """Sum the ``.grad`` of each parameter over ``group`` in place (the
    gradient of parameters that every rank holds whole, used on a slice of
    the data or the sequence: data and sequence parallelism). The
    parameters are summed in the order given; every rank gives the same."""
    group = explicit_group(group)
    if group is None:
        return
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=group)
