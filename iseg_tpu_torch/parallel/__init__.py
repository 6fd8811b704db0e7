"""Device mesh, collectives, ring attention, the pipeline schedule and
fully-sharded data parallelism (counterpart of ``iseg_tpu/parallel``).

The JAX package expresses distribution as shardings on one GSPMD program;
the port runs one process per card and issues its collectives by hand
(:mod:`.collectives`, differentiable where a backward crosses ranks), over a
``DeviceMesh`` with the same ``("data", "model")`` axes (:mod:`.mesh`).
Vision data parallelism with SyncBN and FSDP (:mod:`.fsdp`), ring attention
(:mod:`.ring`) and the GPipe schedule (:mod:`.pipeline`) are here; Gemma's
tensor and sequence parallelism live in ``nlp/gemma/model.py``, its layout
in ``nlp/gemma/layout.py``, expert parallelism in ``nn/moe.py``.

``iseg_tpu/parallel/constrain.py`` has no counterpart: it is a GSPMD
placement hint (``with_sharding_constraint``) with no value semantics. Each
of its call sites became the collective GSPMD inserts there: sequence
parallelism's K/V all-gather (``collectives.gather_from`` in the Gemma
attention), and expert parallelism's sum of the experts' outputs
(``collectives.reduce_from`` in ``nn/moe.py``).
"""

from iseg_tpu_torch.parallel.collectives import (all_gather, all_reduce_values, barrier,
                                                 copy_to, data_parallel, gather_from,
                                                 global_batch_size, ppermute, reduce_from,
                                                 reduce_scatter)
from iseg_tpu_torch.parallel.fsdp import fsdp_shardings, fsdp_spec, shard_fsdp
from iseg_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, MeshEnv, batch_sharding,
                                          create_mesh, replicated_sharding, shard_batch)
from iseg_tpu_torch.parallel.pipeline import pipeline_spmd, stack_params, unstack_params
from iseg_tpu_torch.parallel.ring import ring_attention

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
    "ppermute",
    "reduce_from",
    "copy_to",
    "gather_from",
    "pipeline_spmd",
    "stack_params",
    "unstack_params",
    "ring_attention",
    "data_parallel",
    "global_batch_size",
    "fsdp_spec",
    "fsdp_shardings",
    "shard_fsdp",
    "DATA_AXIS",
    "MODEL_AXIS",
]
