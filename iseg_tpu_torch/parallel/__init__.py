"""Device mesh, collectives and fully-sharded data parallelism
(counterpart of ``iseg_tpu/parallel``).

The JAX package expresses distribution as shardings on one GSPMD program;
the port runs one process per card and issues its collectives by hand
(:mod:`.collectives`), over a ``DeviceMesh`` with the same
``("data", "model")`` axes (:mod:`.mesh`). Vision data parallelism with
SyncBN and FSDP (:mod:`.fsdp`) are here; tensor, pipeline, ring and
expert parallelism are ROADMAP item 25b.
"""

from iseg_tpu_torch.parallel.collectives import (all_gather, all_reduce_values, barrier,
                                                 data_parallel, global_batch_size,
                                                 reduce_scatter)
from iseg_tpu_torch.parallel.fsdp import fsdp_shardings, fsdp_spec, shard_fsdp
from iseg_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, MeshEnv, batch_sharding,
                                          create_mesh, replicated_sharding, shard_batch)

__all__ = [
    "MeshEnv",
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "all_reduce_values",
    "all_gather",
    "reduce_scatter",
    "barrier",
    "data_parallel",
    "global_batch_size",
    "fsdp_spec",
    "fsdp_shardings",
    "shard_fsdp",
    "DATA_AXIS",
    "MODEL_AXIS",
]
