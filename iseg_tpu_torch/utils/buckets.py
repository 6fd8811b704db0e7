"""Shape bucketing for variable-size eval (a numpy copy of
``iseg_tpu/utils/buckets.py``).

Buckets quantize (H, W) to a small set of padded sizes, so eval over a
variable-size set sees a bounded number of input shapes (in the port: a
bounded set of cuDNN algorithm choices and caching-allocator block sizes).
Pad with the mean pixel / ignore label, crop logits back after.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def bucket_hw(
    h: int,
    w: int,
    multiple: int = 128,
    max_hw: tuple[int, int] | None = None,
) -> tuple[int, int]:
    """Round (h, w) up to the bucket grid.

    The result is always >= (h, w): ``max_hw`` caps the GRID, not the
    image — an input larger than the cap keeps its (grid-rounded) size,
    since a bucket smaller than the image would make the caller's
    ``out[:h, :w] = image`` padding write out of bounds. Resize before
    bucketing to bound compute for oversized inputs."""
    bh = math.ceil(h / multiple) * multiple
    bw = math.ceil(w / multiple) * multiple
    if max_hw is not None:
        if min(bh, max_hw[0]) >= h:
            bh = min(bh, max_hw[0])
        if min(bw, max_hw[1]) >= w:
            bw = min(bw, max_hw[1])
    return bh, bw


def pad_to_bucket(
    image: np.ndarray,
    label: np.ndarray | None = None,
    multiple: int = 128,
    mean_pixel=127.5,
    ignore_label: int = 255,
):
    """Pad one HWC image (+HW label) to its bucket. Returns
    (image, label, original_hw)."""
    h, w = image.shape[:2]
    bh, bw = bucket_hw(h, w, multiple)
    if (bh, bw) == (h, w):
        return image, label, (h, w)
    out = np.empty((bh, bw, image.shape[2]), image.dtype)
    out[:] = mean_pixel
    out[:h, :w] = image
    lout = None
    if label is not None:
        lout = np.full((bh, bw), ignore_label, label.dtype)
        lout[:h, :w] = label
    return out, lout, (h, w)


def crop_logits(logits: np.ndarray, original_hw: tuple[int, int]) -> np.ndarray:
    """Crop [**, BH, BW, C] logits back to the pre-padding size."""
    h, w = original_hw
    return logits[..., :h, :w, :]


def pad_batch_to_bucket(
    images: np.ndarray,
    labels: np.ndarray | None = None,
    multiple: int = 128,
    image_pad_value: float = 0.0,
    ignore_label: int = 255,
):
    """Pad a [N,H,W,C] image batch (+[N,H,W] labels) up to the bucket grid.

    Labels pad with ``ignore_label`` so padded pixels never contribute to
    metrics or losses. Returns (images, labels, original_hw)."""
    n, h, w = images.shape[:3]
    bh, bw = bucket_hw(h, w, multiple)
    if (bh, bw) == (h, w):
        return images, labels, (h, w)
    out = np.full((n, bh, bw) + images.shape[3:], image_pad_value, images.dtype)
    out[:, :h, :w] = images
    lout = None
    if labels is not None:
        lout = np.full((n, bh, bw), ignore_label, labels.dtype)
        lout[:, :h, :w] = labels
    return out, lout, (h, w)


def bucket_stats(sizes: Sequence[tuple[int, int]], multiple: int = 128) -> dict:
    """{bucket: count}: the distinct input shapes a size distribution
    gives (one compiled program each in the JAX package)."""
    buckets = {}
    for h, w in sizes:
        b = bucket_hw(h, w, multiple)
        buckets[b] = buckets.get(b, 0) + 1
    return buckets
