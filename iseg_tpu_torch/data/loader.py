"""Dataset loading + batching (a copy of ``iseg_tpu/data/loader.py``;
``device_prefetch`` moves batches to a torch device through pinned memory).

Parity with the reference's ``utils/data_loader.py`` (PNG/JPEG image +
label-PNG loading :11-33) and the dataset plumbing of ``core_train.py``
(shuffle -> repeat -> batch(drop_remainder) -> shard -> prefetch :155-195).

Multi-host (pod) sharding: ``process_shard`` mirrors ``AutoShardPolicy.DATA``
— each host reads every len(files)/num_processes-th sample.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

try:
    from PIL import Image as _PILImage

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def load_image(path: str) -> np.ndarray:
    """RGB image -> float32 [H, W, 3] in [0, 255]
    (reference ``utils/data_loader.py:11``)."""
    if not _HAS_PIL:
        raise ImportError("PIL required for image loading")
    return np.asarray(_PILImage.open(path).convert("RGB"), np.float32)


def load_label(path: str) -> np.ndarray:
    """Label PNG -> int32 [H, W] (reference ``utils/data_loader.py:33``)."""
    if not _HAS_PIL:
        raise ImportError("PIL required for label loading")
    return np.asarray(_PILImage.open(path), np.int32)


def list_images(directory: str) -> list[str]:
    """Sorted image paths (reference ``core_predict.py:173-192``)."""
    out = []
    for name in sorted(os.listdir(directory)):
        if os.path.splitext(name)[1].lower() in IMAGE_EXTS:
            out.append(os.path.join(directory, name))
    return out


class SegDirectoryDataset:
    """(image_dir, label_dir) paired dataset; labels matched by basename."""

    def __init__(self, image_dir: str, label_dir: Optional[str] = None,
                 label_ext: str = ".png"):
        self.image_paths = list_images(image_dir)
        self.label_paths = None
        if label_dir is not None:
            self.label_paths = [
                os.path.join(
                    label_dir,
                    os.path.splitext(os.path.basename(p))[0] + label_ext,
                )
                for p in self.image_paths
            ]

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, i):
        image = load_image(self.image_paths[i])
        label = load_label(self.label_paths[i]) if self.label_paths else None
        return image, label


def batched_dataset(
    dataset,
    batch_size: int,
    pipeline: Optional[Callable] = None,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = True,
    process_index: int = 0,
    num_processes: int = 1,
    num_workers: int = 0,
    prefetch_batches: int = 4,
) -> Iterator[dict]:
    """Yield {"image": [N,H,W,3] fp32, "label": [N,H,W] int32} host batches.

    ``process_shard`` (`process_index`/`num_processes`) mirrors the
    reference's pod ``AutoShardPolicy.DATA`` (``core_train.py:186-195``).

    ``num_workers > 0`` decodes + augments samples on a thread pool with a
    bounded prefetch queue — the equivalent of the reference's tf.data
    ``map(num_parallel_calls=AUTOTUNE) -> batch -> prefetch``
    (``core_train.py:155-183``). PIL decode and the numpy augment kernels
    release the GIL, so threads scale without multiprocess serialization.
    Output batches are bit-identical to the serial path (same visit order,
    same per-sample ``sample_index`` seeds)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    if num_processes > 1:
        # equalize per-process counts FIRST (shards.shard_batches does the
        # same): a host with one extra sample would produce one extra
        # batch whose collectives the other hosts never join -> SPMD hang
        order = order[: len(order) // num_processes * num_processes]
    order = order[process_index::num_processes]

    def load_one(idx: int):
        image, label = dataset[idx]
        if pipeline is not None:
            image, label = pipeline(
                image, label, sample_index=idx + epoch * len(dataset))
        return image, label

    def to_batch(images, labels):
        batch = {"image": np.stack(images).astype(np.float32)}
        if labels[0] is not None:  # unlabeled (predict-only) datasets
            batch["label"] = np.stack(labels).astype(np.int32)
        return batch

    if num_workers <= 0:
        images, labels = [], []
        for idx in order:
            image, label = load_one(int(idx))
            images.append(image)
            labels.append(label)
            if len(images) == batch_size:
                yield to_batch(images, labels)
                images, labels = [], []
        if images and not drop_remainder:
            yield to_batch(images, labels)
        return

    yield from _parallel_batches(
        load_one, [int(i) for i in order], batch_size, to_batch,
        drop_remainder, num_workers, prefetch_batches)


def _parallel_batches(load_one, order, batch_size, to_batch, drop_remainder,
                      num_workers, prefetch_batches):
    """Thread-pool decode/augment with a bounded in-order future window and
    a bounded assembled-batch queue (producer thread), so the train loop
    never waits on PNG decode while the chip is busy."""
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    out: queue.Queue = queue.Queue(maxsize=max(1, prefetch_batches))
    stop = threading.Event()
    _END = object()

    def producer():
        try:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                window = max(batch_size, 2 * num_workers)
                futures = []
                images, labels = [], []
                pos = 0

                def drain_one():
                    nonlocal images, labels
                    image, label = futures.pop(0).result()
                    images.append(image)
                    labels.append(label)
                    if len(images) == batch_size:
                        batch = to_batch(images, labels)
                        images, labels = [], []
                        while not stop.is_set():
                            try:
                                out.put(batch, timeout=0.5)
                                return
                            except queue.Full:
                                continue

                while pos < len(order) and not stop.is_set():
                    while len(futures) < window and pos < len(order):
                        futures.append(pool.submit(load_one, order[pos]))
                        pos += 1
                    drain_one()
                while futures and not stop.is_set():
                    drain_one()
                if images and not drop_remainder and not stop.is_set():
                    out.put(to_batch(images, labels))
        except BaseException as e:  # propagate to the consumer
            if not stop.is_set():
                out.put(e)
            return
        out.put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def to_device(value, device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) -> a tensor on ``device``, dtype
    kept (uint8 shards stay uint8). For a CUDA device the value is copied
    into pinned host memory and sent with a ``non_blocking`` copy, so the
    host does not wait for the device's queued work; PyTorch's pinned-memory
    allocator keeps the staging buffer until the copy has run."""
    device = torch.device(device)
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(batches: Iterator[dict], device="cuda", size: int = 2,
                    transform: Optional[Callable[[dict], dict]] = None) -> Iterator[dict]:
    """Keep ``size`` batches already sent to ``device`` ahead of the
    consumer so the host->device copy overlaps the running step (the
    reference relies on tf.data ``prefetch(AUTOTUNE)`` for this).

    ``transform`` (e.g. ``CoreTrain``'s ``inputs_process``) runs on each host
    batch before its transfer; each value goes by :func:`to_device`."""
    import collections

    it = iter(batches)
    buf: collections.deque = collections.deque()

    def enqueue() -> bool:
        try:
            b = next(it)
        except StopIteration:
            return False
        if transform is not None:
            b = transform(b)
        buf.append({k: to_device(v, device) for k, v in b.items()})
        return True

    for _ in range(max(1, size)):
        if not enqueue():
            break
    while buf:
        yield buf.popleft()
        enqueue()
