"""Fully-sharded data parallelism (counterpart of
``iseg_tpu/parallel/fsdp.py``): parameters and optimizer state sharded
over the data axis, ZeRO-3 style.

The JAX package places each leaf sharded over ``data`` and lets GSPMD
insert the all-gathers and reduce-scatters. The port applies FSDP2's
``fully_shard`` to the model with a ``shard_placement_fn`` built from the
same per-leaf rule (:func:`fsdp_spec`): shard the largest dim that the
axis size divides; keep a leaf replicated when it is small (fewer than
``min_size`` elements: biases, norm scales) or no dim divides. FSDP2 can
shard a parameter only, never replicate one, so the replicated leaves are
handed to ``fully_shard`` as ``ignored_params``: they stay plain tensors
on every rank, and ``make_train_step(..., mesh=)`` averages their
gradients with the same fixed-order all-reduce as plain data parallelism.
The train state holds them as replicated ``DTensor`` views of the same
storage (:func:`replicated_view`), so the optimizer sees one kind of
tensor.
The sharded leaves are ``DTensor`` parameters; FSDP2 all-gathers them for
the forward and the backward and reduce-scatters (averages) their
gradients, so the train step takes those gradients from ``.grad`` after a
``backward()``. The optimizer's state is made by ``zeros_like`` of the
parameters (``core/optimizer.py``), so it takes their placements: each
rank holds its shard of every moment.

``fsdp_spec`` and ``fsdp_shardings`` return specs as tuples with one
entry per dim, the axis name or None, as ``jax.sharding.PartitionSpec``
lists them (``()`` is replicated).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from iseg_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

__all__ = ["fsdp_spec", "fsdp_shardings", "shard_fsdp", "sharded_dim", "fsdp_mesh",
           "replicated_view"]


def fsdp_spec(shape, axis_size_: int, axis: str = DATA_AXIS, min_size: int = 2 ** 14) -> tuple:
    """Spec sharding the largest ``axis_size_``-divisible dim of ``shape``
    over ``axis`` (the first of equal ones); ``()`` (replicated) when every
    dim is indivisible or the leaf has fewer than ``min_size`` elements."""
    shape = tuple(int(d) for d in shape)
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % axis_size_ == 0 and d > 0:
            if best is None or d > shape[best]:
                best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def sharded_dim(spec: tuple, axis: str = DATA_AXIS):
    """The dim a spec shards over ``axis``, or None."""
    return next((i for i, a in enumerate(spec) if a == axis), None)


def _size(mesh, axis: str) -> int:
    return int(mesh) if isinstance(mesh, int) else axis_size(mesh, axis)


def fsdp_shardings(tree: Any, mesh, axis: str = DATA_AXIS, min_size: int = 2 ** 14,
                   base_specs: Any = None) -> Any:
    """Leaf-wise specs of ``tree`` (a dict / list / tuple nest of tensors or
    arrays, e.g. the path-keyed params or an optimizer state), of the same
    structure. ``mesh`` is a ``DeviceMesh`` or the axis size.

    ``base_specs`` (a nest of specs matching ``tree``, e.g. a tensor-parallel
    layout) composes with FSDP: dims the base spec already shards keep their
    axis and FSDP shards the largest FREE dim over ``axis``. A leaf without
    a shape (a step count) is replicated."""
    n = _size(mesh, axis)

    def one(x, base=None):
        shape = tuple(getattr(x, "shape", ()))
        if base is None or all(a is None for a in tuple(base)):
            return fsdp_spec(shape, n, axis=axis, min_size=min_size)
        base_t = tuple(base) + (None,) * (len(shape) - len(tuple(base)))
        merged = list(base_t)
        if int(np.prod(shape, dtype=np.int64)) >= min_size:
            best = None
            for i, a in enumerate(base_t):
                if a is None and shape[i] % n == 0 and shape[i] > 0:
                    if best is None or shape[i] > shape[best]:
                        best = i
            if best is not None:
                merged[best] = axis
        return tuple(merged)

    def walk(x, base):
        if isinstance(x, dict):
            return {k: walk(v, None if base is None else base[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "shape"):
            return type(x)(walk(v, None if base is None else base[i]) for i, v in enumerate(x))
        return one(x, base)

    return walk(tree, base_specs)


def shard_fsdp(model: nn.Module, mesh, axis: str = DATA_AXIS,
               min_size: int = 2 ** 14) -> nn.Module:
    """Apply FSDP2's ``fully_shard`` to ``model`` over ``mesh``'s ``axis``,
    each parameter placed by :func:`fsdp_spec`; the replicated ones are
    ``ignored_params`` (see the module note). Call it before
    ``create_train_state``: the sharded parameters are new tensors.
    Returns ``model``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = axis_size(mesh, axis)
    placement = {}
    ignored = set()
    for p in model.parameters():
        if not p.is_contiguous():  # FSDP2 shards contiguous tensors only (not channels_last)
            p.data = p.data.contiguous()
        dim = sharded_dim(fsdp_spec(p.shape, n, axis=axis, min_size=min_size), axis)
        if dim is None:
            ignored.add(p)
        else:
            placement[id(p)] = Shard(dim)

    def shard_placement_fn(param: nn.Parameter):
        return placement[id(param)]

    sub = mesh[axis] if len(mesh.mesh_dim_names) > 1 else mesh
    fully_shard(model, mesh=sub, shard_placement_fn=shard_placement_fn,
                ignored_params=ignored or None)
    model.fsdp_mesh = sub
    return model


def fsdp_mesh(model: nn.Module):
    """The mesh :func:`shard_fsdp` sharded ``model`` over, or None."""
    return getattr(model, "fsdp_mesh", None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def replicated_view(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a replicated ``DTensor`` over ``mesh`` sharing ``t``'s
    storage: the train state holds the replicated parameters of an FSDP
    model this way, so the optimizer's foreach updates see DTensors only
    and write into the module's own tensors."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t.detach(), mesh, [Replicate()], run_check=False)
