"""Device mesh and batch placement (counterpart of
``iseg_tpu/parallel/mesh.py``).

The JAX package runs one GSPMD program over a ``("data", "model")``
``jax.sharding.Mesh``. The port runs one process per card (``torchrun
--nproc_per_node=N``, or ``mp.spawn``), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, with the same axis names and the same grid: rank ``r`` sits
at data ``r // model_parallelism``, model ``r % model_parallelism``. Vision
training is pure data parallelism (``model`` of size 1): every rank holds
the whole model and a slice of the global batch. Gemma's tensor, sequence
and pipeline parallelism and the experts of ``nn/moe.py`` take their groups
from the mesh's axes (:func:`axis_group`). The placements
:func:`batch_sharding` and :func:`replicated_sharding` are the DTensor ones,
``Shard(0)`` and ``Replicate()``.

Without a process group there is no mesh: every function here is then
the identity over one rank (``mesh=None``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def process_group_active() -> bool:
    """True when a default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def process_rank_and_count() -> tuple[int, int]:
    """This process's rank and the default group's size; (0, 1) without a
    group."""
    if process_group_active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_mesh(devices: Optional[Sequence[int]] = None, model_parallelism: int = 1,
                axis_names: tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
                device_type: Optional[str] = None):
    """A ``(data, model)`` ``DeviceMesh`` over the ranks of the process
    group (or the given ``devices``, a sequence of ranks): the ranks in
    order, reshaped ``[n // model_parallelism, model_parallelism]``, as the
    JAX package reshapes its devices. ``axis_names`` renames the two axes
    (``("data", "stage")`` for a pipeline). Its device type is the
    backend's: ``cuda`` under NCCL, or under gloo when this rank's current
    device is a card and ``device_type`` says so; ``cpu`` otherwise.

    Raises without a process group
    (``common_env_setup(initialize_distributed=True)`` starts one)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not process_group_active():
        raise RuntimeError("create_mesh needs a process group: call "
                           "common_env_setup(initialize_distributed=True) first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(ranks)
    if n == 0 or n % model_parallelism != 0:
        raise ValueError(f"model_parallelism={model_parallelism} does not divide {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(np.asarray(ranks).reshape(n // model_parallelism, model_parallelism))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def _axis_index(mesh, axis: str) -> int:
    """Position of ``axis`` among ``mesh``'s axes; raises for an axis the
    mesh does not have, as the JAX package does for an unknown mesh axis."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {names}")
    return names.index(axis)


def axis_size(mesh, axis: str = DATA_AXIS) -> int:
    """Size of ``axis`` of ``mesh`` (1 without a mesh). Raises for an axis
    the mesh does not have."""
    return 1 if mesh is None else int(mesh.size(_axis_index(mesh, axis)))


def axis_rank(mesh, axis: str = DATA_AXIS) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh). Raises for
    an axis the mesh does not have."""
    if mesh is None:
        return 0
    _axis_index(mesh, axis)
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str = DATA_AXIS):
    """The process group of ``axis``: the ranks that share every other
    coordinate with this one, ordered along ``axis`` (None without a mesh).
    Raises for an axis the mesh does not have."""
    if mesh is None:
        return None
    _axis_index(mesh, axis)
    return mesh.get_group(axis)


def batch_sharding(mesh=None, ndim: int = 1, axis: str = DATA_AXIS) -> list:
    """Placements of an activation batch: dim 0 over ``data``."""
    from torch.distributed.tensor import Shard

    return [Shard(0)]


def replicated_sharding(mesh=None) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()]


def shard_batch(mesh, batch: Any, axis: str = DATA_AXIS) -> Any:
    """This rank's contiguous slice ``[r * n / d, (r + 1) * n / d)`` along
    dim 0 of a (nested dict / list of) GLOBAL batch, the same on every rank
    (as a single-process JAX run sees it); the batch must divide the axis
    size ``d``. Without a mesh the batch passes through.

    Only a caller that holds the global batch slices it here (``evaluate``,
    a test feeding one batch to every rank). A loader that partitions by
    process (``make_shard_dataset_fn``) yields each process its LOCAL batch,
    which ``CoreTrain`` takes as it is, the rule of the JAX package's
    ``shard_batch`` on several processes
    (``jax.make_array_from_process_local_data``)."""
    n_shards = axis_size(mesh, axis)
    if mesh is None:
        return batch
    r = axis_rank(mesh, axis)

    def _put(x):
        if not hasattr(x, "shape"):
            return x
        if x.shape[0] % n_shards != 0:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by the {axis}-axis size "
                f"{n_shards}; use a batch that is a multiple of the device count (the "
                "reference drops remainders for the same reason, core_train.py:155-183)")
        per = x.shape[0] // n_shards
        return x[r * per:(r + 1) * per]

    return _tree_map(_put, batch)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass
class MeshEnv:
    """The mesh and the dtype policy (counterpart of the JAX package's
    ``MeshEnv``); ``mesh`` None is one device."""

    mesh: Any = None
    seed: int = 0
    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def num_devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.size())

    @property
    def data_parallelism(self) -> int:
        return axis_size(self.mesh, DATA_AXIS)

    @property
    def model_parallelism(self) -> int:
        return axis_size(self.mesh, MODEL_AXIS)
