"""Device-resident dataset (counterpart of ``iseg_tpu/data/resident.py``):
train from data that lives on the card.

A segmentation dataset is small next to an 80 GB card (PASCAL VOC
train-aug at 512^2 uint8 is about 8.4 GB), so the pre-decoded uint8 shards
(``data/shards.py``) are uploaded once and every training batch is a
gather on the device, followed by the on-device augment: no host->device
traffic per step beyond a ``[batch]`` index vector.

The epoch order is ``np.random.default_rng((seed, epoch)).shuffle`` of the
sample indices, the stream of ``shards.shard_batches``, so the resident
path serves the batches the host path would (tested). Batch selection is
computed on the host (index-only), so the gather's shapes stay fixed.

Pod partitions: ``process_index``/``num_processes`` (``"auto"`` reads the
process group's rank and size; one process without a group) give each
process its equal-sized strided partition of the samples, shuffled within
the partition by ``(seed, epoch, process_index)``: the resident analogue
of ``AutoShardPolicy.DATA``.

``mesh=`` shards the dataset over the mesh's data axis on the sample
dimension: rank ``p`` of ``d`` uploads the contiguous rows ``[p * n / d,
(p + 1) * n / d)`` (``n`` truncated to a multiple of ``d``), so the cards
split the dataset instead of each holding it. The logical dataset and its
epoch order stay GLOBAL (the same on every rank); a global batch's index
vector is assembled on every rank by a masked local gather and one
batch-sized all-reduce (:func:`sharded_gather`): the per-step
traffic is one uint8 batch, never the dataset.

:class:`ChunkRotatingResidentDataset` is for a dataset larger than the
card: a resident window serves batches while a thread uploads the next
one (double-buffered), over the same batch stream.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, Optional, Union

import numpy as np
import torch

from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.data.loader import to_device
from iseg_tpu_torch.parallel import collectives
from iseg_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_size, process_rank_and_count


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


def resolve_process_grid(process_index: Union[int, str, None],
                         num_processes: Union[int, str, None]) -> tuple[int, int]:
    """``(process_index, num_processes)``, ``"auto"`` read from the process
    group (rank and size; 0 and 1 without a group)."""
    rank, count = process_rank_and_count()
    if process_index == "auto":
        process_index = rank
    if num_processes == "auto":
        num_processes = count
    return int(process_index or 0), int(num_processes or 1)


def _process_partition(n: int, process_index: int, num_processes: int) -> np.ndarray:
    """This process's equal-sized slice of ``range(n)`` (strided, truncated
    to ``n // num_processes`` so all processes run the same step count, the
    equalization of ``shards.shard_batches``)."""
    per = n // num_processes
    if per == 0:
        raise ValueError(f"{n} samples cannot be partitioned over {num_processes} processes")
    return np.arange(n)[process_index::num_processes][:per]


def sharded_gather(images: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
                   row_start: int, group) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch ``idx`` of a sample-sharded dataset on every rank:
    a masked gather of the rows this rank holds (``[row_start, row_start +
    len(images))``; zeros elsewhere), then one all-reduce of the uint8
    images and labels together. Each row is nonzero on one rank only, so
    the sum is exact; the traffic is one batch, never the dataset."""
    own = (idx >= row_start) & (idx < row_start + images.shape[0])
    local = torch.where(own, idx - row_start, torch.zeros_like(idx))
    image = images.index_select(0, local)
    label = labels.index_select(0, local)
    n = idx.shape[0]
    flat = torch.cat([image.reshape(n, -1), label.reshape(n, -1)], dim=1)
    flat = torch.where(own[:, None], flat, torch.zeros((), dtype=flat.dtype, device=flat.device))
    collectives.all_reduce_(flat, group)
    split = image[0].numel()
    return flat[:, :split].reshape(image.shape), flat[:, split:].reshape(label.shape)


def _source_rows(source, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 (images, labels) of ``rows`` of a ShardReader or an
    ``(images, labels)`` pair."""
    if hasattr(source, "gather"):
        return source.gather(rows)
    return (np.ascontiguousarray(source[0][rows]), np.ascontiguousarray(source[1][rows]))


def _source_geometry(source) -> tuple[int, tuple, tuple]:
    """(samples, image shape, label shape) of a source."""
    if hasattr(source, "gather"):
        th, tw = source.store_size
        return len(source), (th, tw, 3), (th, tw)
    images, labels = source
    return int(images.shape[0]), tuple(images.shape[1:]), tuple(labels.shape[1:])


class DeviceResidentDataset:
    """Upload a :class:`~iseg_tpu_torch.data.shards.ShardReader` (or raw
    ``(images, labels)`` uint8 arrays) to ``device`` once; serve batches as
    gathers on the device.

    The upload goes in chunks of ``chunk_samples`` through pinned memory
    into one preallocated tensor, so host memory peaks at one chunk and the
    device at this rank's part of the dataset. ``mesh`` and
    ``process_index``/``num_processes``: see the module note. On a
    mesh-sharded dataset ``row_start`` is the first global row this rank
    holds (None otherwise), and :meth:`gather` and :meth:`batches` give the
    whole global batch on every rank."""

    def __init__(self, source, device="cuda", mesh=None, chunk_samples: int = 512,
                 process_index: Union[int, str, None] = "auto",
                 num_processes: Union[int, str, None] = "auto", hbm_check: bool = True,
                 hbm_free_bytes: Optional[int] = None, hbm_safety: float = 0.8):
        self.device = resolve_device(device)
        self.mesh = mesh
        n_shards = axis_size(mesh, DATA_AXIS)
        process_index, num_processes = resolve_process_grid(process_index, num_processes)
        # a mesh over several ranks: one global sample-sharded dataset, each
        # rank holding a contiguous slice
        self._global_partition = n_shards > 1
        if self._global_partition and (
                (process_index, num_processes) != resolve_process_grid("auto", "auto")
                or num_processes != n_shards):
            raise ValueError("simulated process_index/num_processes cannot be combined with "
                             f"a mesh that spans {n_shards} processes")
        n_total, image_shape, label_shape = _source_geometry(source)
        if self._global_partition:
            n_total -= n_total % n_shards
            per = n_total // num_processes
            local = np.arange(process_index * per, (process_index + 1) * per)
            self.row_start = int(process_index * per)
            self.num_samples = n_total  # the GLOBAL logical dataset
        else:
            local = _process_partition(n_total, process_index, num_processes)
            self.row_start = None
            self.num_samples = len(local)
        if hbm_check:
            needed = len(local) * (int(np.prod(image_shape)) + int(np.prod(label_shape)))
            free = hbm_free_bytes if hbm_free_bytes is not None else free_device_bytes(self.device)
            check_device_capacity(needed, free, safety=hbm_safety)

        n = len(local)
        self.images = torch.empty((n, *image_shape), dtype=torch.uint8, device=self.device)
        self.labels = torch.empty((n, *label_shape), dtype=torch.uint8, device=self.device)
        for start in range(0, n, chunk_samples):
            stop = min(n, start + chunk_samples)
            for dst, part in zip((self.images, self.labels),
                                 _source_rows(source, local[start:stop])):
                src = torch.from_numpy(np.ascontiguousarray(part, np.uint8))
                if self.device.type == "cuda":
                    src = src.pin_memory()
                dst[start:stop].copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.process_index = process_index
        self.num_processes = num_processes

    def nbytes(self) -> int:
        return self.images.nbytes + self.labels.nbytes

    def epoch_indices(self, epoch: int, seed: int = 0, shuffle: bool = True) -> np.ndarray:
        order = np.arange(self.num_samples)
        if shuffle:
            # one process, or one global sharded dataset: the stream of
            # shards.shard_batches (the resident path serves the host path's
            # batches); per-process partitions fold the process index in
            key = ((seed, epoch) if self.num_processes == 1 or self._global_partition
                   else (seed, epoch, self.process_index))
            np.random.default_rng(key).shuffle(order)
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
        """uint8 (images [n,H,W,3], labels [n,H,W]) on the device; on a
        mesh-sharded dataset every rank passes the same global ``indices``
        and gets the whole batch."""
        idx = to_device(np.asarray(indices, np.int64), self.device)
        if self.row_start is not None:
            return sharded_gather(self.images, self.labels, idx, self.row_start,
                                  axis_group(self.mesh, DATA_AXIS))
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


class ChunkRotatingResidentDataset:
    """For a dataset LARGER than the card: a resident window of
    ``window_samples`` serves batches while a thread gathers the next
    window on the host and uploads it (double-buffered, on a stream of its
    own on a card), so the upload overlaps the serving and the steady state
    moves one window per window.

    The served batch stream equals :class:`DeviceResidentDataset`'s (and
    the host path's) for the same ``(seed, epoch)``: the epoch order is one
    permutation and the windows are consecutive slices of it, rounded to
    whole batches. ``process_index``/``num_processes`` partition as there.
    A mesh over several ranks raises, as in the JAX package: give each
    process its own partition instead. The fused index-gather step needs the
    whole dataset resident and is not offered here: train on
    :meth:`batches` (``dataset_fn``)."""

    def __init__(self, source, window_samples: int = 1024, device="cuda", mesh=None,
                 process_index: Union[int, str, None] = "auto",
                 num_processes: Union[int, str, None] = "auto", hbm_check: bool = True,
                 hbm_free_bytes: Optional[int] = None, hbm_safety: float = 0.8):
        if axis_size(mesh, DATA_AXIS) > 1:
            raise NotImplementedError(
                "ChunkRotatingResidentDataset over a mesh of several processes is not "
                "supported; give each process its own partition (process_index/"
                "num_processes) or stream from the host")
        self.device = resolve_device(device)
        self.process_index, self.num_processes = resolve_process_grid(process_index,
                                                                      num_processes)
        self._source = source
        n, image_shape, label_shape = _source_geometry(source)
        self._sample_bytes = int(np.prod(image_shape)) + int(np.prod(label_shape))
        self._rows = _process_partition(n, self.process_index, self.num_processes)
        self.num_samples = len(self._rows)
        self.window_samples = min(window_samples, self.num_samples)
        if hbm_check:
            # two windows live at once (the one served and the one inbound)
            free = hbm_free_bytes if hbm_free_bytes is not None else free_device_bytes(self.device)
            check_device_capacity(2 * self.window_samples * self._sample_bytes, free,
                                  safety=hbm_safety, what="ChunkRotatingResidentDataset")
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def nbytes(self) -> int:
        """Peak device bytes of the working set (both buffers)."""
        return 2 * self.window_samples * self._sample_bytes

    def epoch_indices(self, epoch: int, seed: int = 0, shuffle: bool = True) -> np.ndarray:
        order = np.arange(self.num_samples)
        if shuffle:
            key = ((seed, epoch) if self.num_processes == 1
                   else (seed, epoch, self.process_index))
            np.random.default_rng(key).shuffle(order)
        return order

    def _upload(self, local_idx: np.ndarray):
        """Host gather of a window and its upload; returns the device tensors
        and, on a card, the event that marks the copy done."""
        host = [torch.from_numpy(np.ascontiguousarray(a, np.uint8))
                for a in _source_rows(self._source, self._rows[local_idx])]
        if self._stream is None:
            return host[0], host[1], None
        with torch.cuda.stream(self._stream):
            dev = [h.pin_memory().to(self.device, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev[0], dev[1], done

    def _ready(self, future):
        images, labels, done = future.result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            images.record_stream(stream)
            labels.record_stream(stream)
        return images, labels

    def batches(self, batch_size: int, epoch: int = 0, seed: int = 0, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[dict]:
        """Yield ``{"image", "label"}`` batches of uint8 device tensors."""
        order = self.epoch_indices(epoch, seed, shuffle)
        # whole batches a window, so batch boundaries match the resident path
        win = max(batch_size, self.window_samples - self.window_samples % batch_size)
        segments = [order[s : s + win] for s in range(0, len(order), win)]
        if not segments:
            return
        inbound = self._pool.submit(self._upload, segments[0])
        for k, seg in enumerate(segments):
            images, labels = self._ready(inbound)
            if k + 1 < len(segments):
                # the next window's gather + upload starts before this one serves
                inbound = self._pool.submit(self._upload, segments[k + 1])
            for start in range(0, len(seg), batch_size):
                stop = min(start + batch_size, len(seg))
                if stop - start < batch_size and drop_remainder:
                    break
                yield {"image": images[start:stop], "label": labels[start:stop]}
            del images, labels

    def dataset_fn(self, batch_size: int, seed: int = 0, shuffle: bool = True):
        """``dataset_fn(epoch)`` for ``CoreTrain.train``."""

        def fn(epoch: int) -> Iterator[dict]:
            return self.batches(batch_size, epoch=epoch, seed=seed, shuffle=shuffle)

        return fn
