"""Pre-decoded shard dataset: train from disk at chip rate (a copy of
``iseg_tpu/data/shards.py``; the on-disk format is the same, so either
package reads the other's shards).

The reference feeds training through tf.data with per-sample PNG decode
(``utils/data_loader.py:11-33`` + ``core_train.py:155-183``); decode cost
is hidden by tf.data's parallel map on many-core hosts. This module is the
device-side alternative that removes decode from the hot path entirely:

* ``write_shards`` runs ONCE per dataset: decodes every (image, label)
  pair, resizes/pads to one canonical store size, and writes fixed-shape
  ``uint8`` npy shard files.
* ``ShardReader`` memory-maps the shards; a training batch is a fancy-index
  slice of a memmap — memcpy-rate, no decode, no per-sample Python work.
* ``shard_batches`` yields shuffled, pod-sharded uint8 host batches that go
  straight to the device; the random-scale/crop/flip recipe then runs
  on-device via ``iseg_tpu_torch.data.device_augment`` (uint8 host->device
  transfer is 4x smaller than float32).

Storage canonicalization matches the front of the reference's standard
recipe (``data_process/pipeline.py:85-170``): resize so the longer side
equals ``store_size`` (aspect preserved), pad the rest with the mean pixel
/ ignore label. Random scale/crop/flip — the per-step randomness — stays
in the augment stage, so storing one canonical size loses nothing the
standard recipe would have kept.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

INDEX_NAME = "index.json"


def _canonicalize(
    image: np.ndarray,
    label: Optional[np.ndarray],
    store_hw: Tuple[int, int],
    mean_pixel: Sequence[float],
    ignore_label: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resize (aspect-preserving, longer side fits) + pad to ``store_hw``.

    Images use PIL bilinear; labels nearest — same operators as the
    reference's resize-to-range step (``data_process/utils.py:374``). PIL is
    imported only when a sample has to be resized: samples already at or
    below the store size need numpy alone."""
    th, tw = store_hw
    h, w = image.shape[:2]
    # only ever SHRINK to fit (like the host ResizeMaxSizeAugment front):
    # upscaling small images at store time would bake in interpolation the
    # host recipe never applies — they store at native size + padding
    scale = min(th / h, tw / w, 1.0)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))

    img8 = np.clip(image, 0, 255).astype(np.uint8)
    if (nh, nw) != (h, w):
        from PIL import Image as PILImage

        img8 = np.asarray(
            PILImage.fromarray(img8).resize((nw, nh), PILImage.BILINEAR)
        )
    out_img = np.empty((th, tw, 3), np.uint8)
    out_img[:] = np.asarray(mean_pixel, np.uint8)
    out_img[:nh, :nw] = img8

    out_lab = np.full((th, tw), ignore_label, np.uint8)
    if label is not None:
        lab8 = label.astype(np.uint8)
        if (nh, nw) != (h, w):
            lab8 = np.asarray(
                PILImage.fromarray(lab8).resize((nw, nh), PILImage.NEAREST)
            )
        out_lab[:nh, :nw] = lab8
    return out_img, out_lab


def write_shards(
    dataset,
    out_dir: str,
    store_size: Tuple[int, int] = (512, 512),
    samples_per_shard: int = 256,
    mean_pixel: Sequence[float] = (127, 127, 127),
    ignore_label: int = 255,
) -> dict:
    """Decode ``dataset`` (any ``__len__``/``__getitem__ -> (image, label)``,
    e.g. ``SegDirectoryDataset``) into fixed-shape uint8 npy shards.

    Files: ``images-NNNNN.npy`` [n, H, W, 3] u8 and ``labels-NNNNN.npy``
    [n, H, W] u8, plus ``index.json``. Returns the index dict."""
    os.makedirs(out_dir, exist_ok=True)
    th, tw = store_size
    shards = []
    n = len(dataset)
    for start in range(0, n, samples_per_shard):
        count = min(samples_per_shard, n - start)
        images = np.empty((count, th, tw, 3), np.uint8)
        labels = np.empty((count, th, tw), np.uint8)
        for j in range(count):
            image, label = dataset[start + j]
            images[j], labels[j] = _canonicalize(
                np.asarray(image), label, (th, tw), mean_pixel, ignore_label
            )
        sid = len(shards)
        np.save(os.path.join(out_dir, f"images-{sid:05d}.npy"), images)
        np.save(os.path.join(out_dir, f"labels-{sid:05d}.npy"), labels)
        shards.append({"id": sid, "count": count})
    index = {
        "version": 1,
        "store_size": [th, tw],
        "num_samples": n,
        "samples_per_shard": samples_per_shard,
        "ignore_label": ignore_label,
        "mean_pixel": list(mean_pixel),
        "shards": shards,
    }
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return index


class ShardReader:
    """Memory-mapped view over a ``write_shards`` directory.

    ``reader[indices]`` gathers a uint8 batch across shards; sequential or
    near-sequential index patterns hit the page cache at memcpy rate."""

    def __init__(self, shard_dir: str):
        with open(os.path.join(shard_dir, INDEX_NAME)) as f:
            self.index = json.load(f)
        self.store_size = tuple(self.index["store_size"])
        self.ignore_label = int(self.index["ignore_label"])
        self.mean_pixel = tuple(self.index["mean_pixel"])
        self._images = []
        self._labels = []
        starts = []
        total = 0
        for shard in self.index["shards"]:
            sid = shard["id"]
            self._images.append(
                np.load(
                    os.path.join(shard_dir, f"images-{sid:05d}.npy"),
                    mmap_mode="r",
                )
            )
            self._labels.append(
                np.load(
                    os.path.join(shard_dir, f"labels-{sid:05d}.npy"),
                    mmap_mode="r",
                )
            )
            starts.append(total)
            total += shard["count"]
        self._starts = np.asarray(starts + [total])
        self.num_samples = total

    def __len__(self):
        return self.num_samples

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 (images [n,H,W,3], labels [n,H,W]) for global ``indices``."""
        indices = np.asarray(indices, np.int64)
        th, tw = self.store_size
        images = np.empty((len(indices), th, tw, 3), np.uint8)
        labels = np.empty((len(indices), th, tw), np.uint8)
        shard_ids = np.searchsorted(self._starts, indices, side="right") - 1
        for j, (idx, sid) in enumerate(zip(indices, shard_ids)):
            local = int(idx - self._starts[sid])
            images[j] = self._images[sid][local]
            labels[j] = self._labels[sid][local]
        return images, labels


def shard_batches(
    reader: ShardReader,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = True,
    process_index: int = 0,
    num_processes: int = 1,
) -> Iterator[dict]:
    """Yield ``{"image": u8 [N,H,W,3], "label": u8 [N,H,W]}`` host batches.

    Keeping uint8 end-to-end defers the float cast to the on-device augment
    (``device_augment``), quartering host->HBM DMA vs float32. Pod sharding
    mirrors the reference's ``AutoShardPolicy.DATA``
    (``core_train.py:186-195``): every ``num_processes``-th sample of the
    epoch permutation, truncated so every process yields the SAME number
    of samples — unequal per-process batch counts would deadlock SPMD
    training at the epoch boundary (one host dispatching a step whose
    collectives the others never join)."""
    order = np.arange(len(reader))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    per_process = len(order) // num_processes
    order = order[process_index::num_processes][:per_process]
    for start in range(0, len(order), batch_size):
        chunk = order[start : start + batch_size]
        if len(chunk) < batch_size and drop_remainder:
            return
        images, labels = reader.gather(chunk)
        yield {"image": images, "label": labels}


def make_shard_dataset_fn(
    shard_dir: str,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    process_index: Optional[int] = None,
    num_processes: Optional[int] = None,
):
    """``dataset_fn(epoch)`` for ``CoreTrain.train`` backed by shards.

    ``process_index``/``num_processes`` default to the process group's rank
    and size (one process without a group): each process then yields its
    own partition, its local batch, which ``CoreTrain`` takes as it is."""
    from iseg_tpu_torch.data.resident import resolve_process_grid

    reader = ShardReader(shard_dir)
    pi, np_ = resolve_process_grid("auto" if process_index is None else process_index,
                                   "auto" if num_processes is None else num_processes)

    def dataset_fn(epoch: int) -> Iterator[dict]:
        return shard_batches(
            reader,
            batch_size,
            shuffle=shuffle,
            seed=seed,
            epoch=epoch,
            process_index=pi,
            num_processes=np_,
        )

    return dataset_fn
