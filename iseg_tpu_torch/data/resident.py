"""Device-resident dataset (counterpart of ``iseg_tpu/data/resident.py``,
single process): train from data that lives on the card.

A segmentation dataset is small next to an 80 GB card (PASCAL VOC
train-aug at 512^2 uint8 is about 8.4 GB), so the pre-decoded uint8 shards
(``data/shards.py``) are uploaded once and every training batch is a
gather on the device, followed by the on-device augment: no host->device
traffic per step beyond a ``[batch]`` index vector.

The epoch order is ``np.random.default_rng((seed, epoch)).shuffle`` of the
sample indices, the stream of ``shards.shard_batches``, so the resident
path serves the batches the host path would (tested). Batch selection is
computed on the host (index-only), so the gather's shapes stay fixed.

Not ported yet (ROADMAP queue 1 item 25): ``ChunkRotatingResidentDataset``,
pod partitions (``process_index``/``num_processes``) and ``mesh=``; asking
for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.data.loader import to_device


def free_device_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on ``device``, or None where the device reports none (the
    CPU)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def check_device_capacity(needed_bytes: int, free_bytes: Optional[int], safety: float = 0.8,
                          what: str = "DeviceResidentDataset") -> None:
    """Fail at construction, with the options, when the resident data would
    not fit the device's free memory with ``safety`` of it kept for the
    model's parameters, activations and optimizer state. Skipped where no
    free-byte count is known."""
    if free_bytes is None:
        return
    budget = int(free_bytes * safety)
    if needed_bytes > budget:
        gib = 1 << 30
        raise ValueError(
            f"{what}: resident data needs {needed_bytes / gib:.2f} GiB but only "
            f"{budget / gib:.2f} GiB of the free {free_bytes / gib:.2f} GiB fits the "
            f"safety budget (safety={safety}). Stream from the host instead "
            "(data.shards.make_shard_dataset_fn with data.loader.device_prefetch).")


class DeviceResidentDataset:
    """Upload a :class:`~iseg_tpu_torch.data.shards.ShardReader` (or raw
    ``(images, labels)`` uint8 arrays) to ``device`` once; serve batches as
    gathers on the device.

    The upload goes in chunks of ``chunk_samples`` through pinned memory
    into one preallocated tensor, so host memory peaks at one chunk and the
    device at the dataset's size."""

    def __init__(self, source, device="cuda", mesh=None, chunk_samples: int = 512,
                 process_index: int = 0, num_processes: int = 1, hbm_check: bool = True,
                 hbm_free_bytes: Optional[int] = None, hbm_safety: float = 0.8):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded resident dataset is not ported yet (ROADMAP queue 1 item 25)")
        if (process_index, num_processes) != (0, 1):
            raise NotImplementedError(
                "pod partitions of the resident dataset are not ported yet "
                "(ROADMAP queue 1 item 25)")
        self.device = resolve_device(device)
        if hasattr(source, "gather"):  # ShardReader
            n = len(source)
            th, tw = source.store_size
            image_shape, label_shape = (th, tw, 3), (th, tw)

            def host_chunk(start, stop):
                return source.gather(np.arange(start, stop))
        else:
            images, labels = source
            n = int(images.shape[0])
            image_shape, label_shape = tuple(images.shape[1:]), tuple(labels.shape[1:])

            def host_chunk(start, stop):
                return images[start:stop], labels[start:stop]
        if hbm_check:
            needed = n * (int(np.prod(image_shape)) + int(np.prod(label_shape)))
            free = hbm_free_bytes if hbm_free_bytes is not None else free_device_bytes(self.device)
            check_device_capacity(needed, free, safety=hbm_safety)

        self.images = torch.empty((n, *image_shape), dtype=torch.uint8, device=self.device)
        self.labels = torch.empty((n, *label_shape), dtype=torch.uint8, device=self.device)
        for start in range(0, n, chunk_samples):
            stop = min(n, start + chunk_samples)
            for dst, chunk in zip((self.images, self.labels), host_chunk(start, stop)):
                src = torch.from_numpy(np.ascontiguousarray(chunk, np.uint8))
                if self.device.type == "cuda":
                    src = src.pin_memory()
                dst[start:stop].copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.num_samples = n

    def nbytes(self) -> int:
        return self.images.nbytes + self.labels.nbytes

    def epoch_indices(self, epoch: int, seed: int = 0, shuffle: bool = True) -> np.ndarray:
        order = np.arange(self.num_samples)
        if shuffle:
            # the stream of shards.shard_batches: the resident path serves
            # the host path's batches
            np.random.default_rng((seed, epoch)).shuffle(order)
        return order

    def index_batches(self, batch_size: int, epoch: int = 0, seed: int = 0,
                      shuffle: bool = True, drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """Yield per-batch ``[batch]`` int index vectors (host numpy) over
        the same epoch stream as :meth:`batches`: the input of the resident
        train step (``core.train.make_resident_train_step``)."""
        order = self.epoch_indices(epoch, seed, shuffle)
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                return
            yield chunk

    def gather(self, indices) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 (images [n,H,W,3], labels [n,H,W]) on the device."""
        idx = to_device(np.asarray(indices, np.int64), self.device)
        return self.images.index_select(0, idx), self.labels.index_select(0, idx)

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 0, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[dict]:
        """Yield ``{"image", "label"}`` batches of uint8 device tensors."""
        for chunk in self.index_batches(batch_size, epoch, seed, shuffle, drop_remainder):
            image, label = self.gather(chunk)
            yield {"image": image, "label": label}

    def dataset_fn(self, batch_size: int, seed: int = 0, shuffle: bool = True):
        """``dataset_fn(epoch)`` for ``CoreTrain.train``."""

        def fn(epoch: int) -> Iterator[dict]:
            return self.batches(batch_size, epoch=epoch, seed=seed, shuffle=shuffle)

        return fn

    def index_dataset_fn(self, batch_size: int, seed: int = 0, shuffle: bool = True):
        """``dataset_fn(epoch)`` for ``CoreTrain(resident_dataset=self)``:
        yields ``{"index": [batch] int}`` batches; the gather, the augment
        and the step then run on the device."""

        def fn(epoch: int) -> Iterator[dict]:
            for chunk in self.index_batches(batch_size, epoch=epoch, seed=seed, shuffle=shuffle):
                yield {"index": chunk}

        return fn
