"""Pipeline parallelism: the GPipe schedule over a mesh axis (counterpart of
``iseg_tpu/parallel/pipeline.py``).

Each rank of the ``stage`` axis owns one stage: its parameters, and after a
backward their gradients. The schedule is the JAX function's, tick for
tick:

* ``num_microbatches + num_stages - 1`` ticks; at tick ``t`` every stage runs
  its function on its current state (stage ``s`` works on microbatch ``t -
  s``), and passes its output to the next stage with a rotation over the
  axis (:func:`~iseg_tpu_torch.parallel.collectives.ppermute`; the wrap back
  to stage 0 is masked out there). The last tick's send feeds nothing and is
  not made;
* per-microbatch constants (positions, labels) are never sent: every rank
  holds them all and indexes the microbatch its stage is working on;
* the last stage banks its finished microbatches, and one all-reduce of the
  bank (zeros on the other stages) gives every rank the outputs;
* selections are ``torch.where`` on the stage's flags, as in the JAX
  function, so every tick's output stays in the autograd graph on every
  rank, the bubble ticks included (with a zero gradient): autograd then runs
  every rotation's backward (the inverse rotation) on every rank, in the
  same order, and builds the backward schedule that ``jax.grad`` builds
  through the ``lax.scan``.

The input enters through :func:`~iseg_tpu_torch.parallel.collectives.copy_to`
over the axis (only stage 0 reads it, so its gradient is summed there: the
transpose of ``shard_map``'s replicated input), and the output leaves through
an all-reduce whose gradient passes through once.

``batch_axis`` composes data parallelism on a ``(data, stage)`` mesh: each
data shard runs its own pipeline on its rows of every microbatch; the
outputs are all-gathered over it, and the stage parameters enter through
``copy_to`` over it, so their gradients are summed over the data shards (the
``psum`` the ``shard_map`` transpose makes).

Bubble fraction is the usual (S - 1) / (M + S - 1).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from iseg_tpu_torch.parallel import collectives as C
from iseg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

__all__ = ["pipeline_spmd", "stack_params", "unstack_params"]


def stack_params(param_list: list[Any]) -> Any:
    """Stack identically-structured trees along a new leading axis (the
    stage or layer axis). Inverse of :func:`unstack_params`."""
    leaves0, spec = tree_flatten(param_list[0])
    columns = [tree_flatten(p)[0] for p in param_list]
    stacked = [torch.stack([col[i] for col in columns]) for i in range(len(leaves0))]
    return tree_unflatten(stacked, spec)


def unstack_params(stacked: Any, n: int) -> list[Any]:
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def pipeline_spmd(stage_fn: Callable[..., Any], mesh, axis: str, num_microbatches: int,
                  batch_axis: Optional[str] = None) -> Callable[..., Any]:
    """Build a pipelined ``f(stage_params, x, const=None) -> y``.

    ``stage_fn(params, state[, const_mb]) -> state`` maps one microbatch
    through one stage; ``state`` is a tensor or a tree of tensors ``[mb,
    ...]`` of a fixed structure. ``stage_params`` is THIS rank's stage (the
    ``s``-th entry of a :func:`stack_params` stack, ``s`` its coordinate on
    ``axis``). ``x`` and ``const`` are the global batch ``[B, ...]`` on every
    rank; the split into microbatches is internal. ``y`` is the global
    output, on every rank. Without a mesh (or with one stage) the stages are
    the one stage: ``y = stage_fn`` over the microbatches.
    """
    m = num_microbatches
    if m < 1:
        raise ValueError("num_microbatches must be >= 1")
    num_stages = axis_size(mesh, axis)
    stage = axis_rank(mesh, axis)
    group = axis_group(mesh, axis) if num_stages > 1 else None
    n_data = axis_size(mesh, batch_axis) if batch_axis is not None else 1
    data_group = axis_group(mesh, batch_axis) if n_data > 1 else None
    data_rank = axis_rank(mesh, batch_axis) if n_data > 1 else 0

    def pipelined(stage_params, x, const=None):
        leaves = tree_flatten(x)[0]
        b = leaves[0].shape[0]
        if b % m != 0:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        mb = b // m
        if mb % n_data != 0:
            raise ValueError(
                f"microbatch size {mb} (= batch {b} / {m} microbatches) is not divisible by the "
                f"{batch_axis!r}-axis size {n_data}; pick num_microbatches so each microbatch "
                "splits evenly across the data shards")
        mbl = mb // n_data
        device = leaves[0].device
        params = tree_map(lambda p: C.copy_to(p, data_group), stage_params)
        x = tree_map(lambda a: C.copy_to(C.copy_to(a, group), data_group), x)

        def split(a):  # [B, ...] -> this data shard's rows of each microbatch
            a = a.reshape(m, mb, *a.shape[1:])
            return a[:, data_rank * mbl:(data_rank + 1) * mbl]

        micro = tree_map(split, x)
        cmicro = tree_map(split, const) if const is not None else None
        is_first = torch.tensor(stage == 0, device=device)
        is_last = torch.tensor(stage == num_stages - 1, device=device)

        def compute(recv, bank, t):
            x_in = tree_map(lambda a: a[min(max(t, 0), m - 1)], micro)
            state = tree_map(lambda a, r: torch.where(is_first, a, r), x_in, recv)
            if cmicro is not None:
                # stage s works on microbatch t - s
                const_mb = tree_map(lambda a: a[min(max(t - stage, 0), m - 1)], cmicro)
                y = stage_fn(params, state, const_mb)
            else:
                y = stage_fn(params, state)
            # the last stage banks finished microbatch t - (S - 1)
            out_t = t - (num_stages - 1)
            idx = min(max(out_t, 0), m - 1)
            write = is_last & torch.tensor(out_t >= 0, device=device)

            def put(buf, yv):
                buf = list(buf)
                buf[idx] = torch.where(write, yv, buf[idx])
                return buf

            bank = [put(buf, yv) for buf, yv in zip(bank, tree_flatten(y)[0])]
            return y, bank

        spec = tree_flatten(micro)[1]
        recv = tree_map(lambda a: torch.zeros_like(a[0]), micro)
        bank = [[torch.zeros_like(a[0])] * m for a in tree_flatten(micro)[0]]
        total = m + num_stages - 1
        for t in range(total - 1):
            y, bank = compute(recv, bank, t)
            # stage i's output becomes stage i + 1's next input
            recv = tree_map(lambda a: C.ppermute(a.contiguous(), group, shift=1), y)
        _, bank = compute(recv, bank, total - 1)

        def finish(buf):
            out = torch.stack(buf)  # [M, mbl, ...]
            out = C.reduce_from(torch.where(is_last, out, torch.zeros_like(out)), group)
            out = C.gather_from(out, data_group, dim=1)  # [M, mb, ...]
            return out.reshape(b, *out.shape[2:])

        return tree_unflatten([finish(buf) for buf in bank], spec)

    return pipelined
