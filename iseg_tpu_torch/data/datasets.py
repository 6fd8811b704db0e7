"""Dataset-convention helpers: VOC palette, Cityscapes trainId mapping (a
copy of ``iseg_tpu/data/datasets.py``).

The reference leaves dataset conventions to driver repos but names the
datasets in ``static_strings.py``; these helpers make the standard suites
(BASELINE configs: VOC, Cityscapes, ADE20K) directly usable.
"""

from __future__ import annotations

import numpy as np


def voc_palette(num_entries: int = 256) -> list[int]:
    """The PASCAL VOC label colormap (bit-interleave algorithm), flattened
    [r0, g0, b0, r1, ...] for ``PIL.Image.putpalette``."""
    palette = []
    for i in range(num_entries):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        palette.extend([r, g, b])
    return palette


# Cityscapes: raw label id -> train id (19 classes; 255 = ignore).
_CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

CITYSCAPES_TRAIN_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)


def cityscapes_to_train_ids(label: np.ndarray, ignore_label: int = 255) -> np.ndarray:
    """Map raw Cityscapes label ids to the 19 training classes."""
    lut = np.full(256, ignore_label, np.int32)
    for raw, train in _CITYSCAPES_ID_TO_TRAIN.items():
        lut[raw] = train
    return lut[np.asarray(label, np.int64).clip(0, 255)]


VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)
