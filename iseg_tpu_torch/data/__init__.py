"""Data pipeline (counterpart of ``iseg_tpu/data``): host-side numpy
augmentations, input normalization, loading and pre-decoded shards (copies
of the JAX package's numpy modules), and the torch parts: the on-device
augment (``device_augment``), the device-resident dataset (``resident``)
and the pinned-memory prefetch to the device (``loader.device_prefetch``).
"""

from iseg_tpu_torch.data.input_norm import (
    InputNormTypes,
    get_mean_pixel,
    inverse_normalize_input,
    normalize_input,
)
from iseg_tpu_torch.data.pipeline import AugmentationsPipeline, StandardAugmentationsPipeline
from iseg_tpu_torch.data.resident import DeviceResidentDataset
from iseg_tpu_torch.data.shards import ShardReader, make_shard_dataset_fn, shard_batches, write_shards

__all__ = [
    "InputNormTypes",
    "normalize_input",
    "inverse_normalize_input",
    "get_mean_pixel",
    "AugmentationsPipeline",
    "StandardAugmentationsPipeline",
    "DeviceResidentDataset",
    "ShardReader",
    "make_shard_dataset_fn",
    "shard_batches",
    "write_shards",
]
