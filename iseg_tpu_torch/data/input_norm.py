"""Input normalization modes (a copy of ``iseg_tpu/data/input_norm.py``).

Parity with the reference's ``data_process/input_norm.py`` (zero-mean [-1,1]
:7, ImageNet mean/std :16-36, inverse transforms :39-62),
``input_norm_types.py:4`` (mode enum) and ``mean_pixel.py:4`` (the pad-fill
pixel per mode).
"""

from __future__ import annotations

import enum

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)  # RGB, 0-255
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


class InputNormTypes(enum.Enum):
    NONE = "none"
    ZERO_MEAN = "zero_mean"   # [0,255] -> [-1, 1]
    KERAS = "keras"           # ImageNet mean subtract (caffe-style, but RGB)
    KERAS_SCALE = "keras_scale"  # ImageNet mean/std ("torch"-style)


def normalize_input(image, norm: InputNormTypes = InputNormTypes.ZERO_MEAN):
    """image float in [0, 255] -> normalized (reference ``input_norm.py:7-36``)."""
    image = np.asarray(image, np.float32)
    if norm == InputNormTypes.NONE:
        return image
    if norm == InputNormTypes.ZERO_MEAN:
        return image / 127.5 - 1.0
    if norm == InputNormTypes.KERAS:
        return image - IMAGENET_MEAN
    if norm == InputNormTypes.KERAS_SCALE:
        return (image - IMAGENET_MEAN) / IMAGENET_STD
    raise ValueError(f"unknown norm mode {norm}")


def inverse_normalize_input(image, norm: InputNormTypes = InputNormTypes.ZERO_MEAN):
    """Inverse transforms (reference ``input_norm.py:39-62``)."""
    image = np.asarray(image, np.float32)
    if norm == InputNormTypes.NONE:
        return image
    if norm == InputNormTypes.ZERO_MEAN:
        return (image + 1.0) * 127.5
    if norm == InputNormTypes.KERAS:
        return image + IMAGENET_MEAN
    if norm == InputNormTypes.KERAS_SCALE:
        return image * IMAGENET_STD + IMAGENET_MEAN
    raise ValueError(f"unknown norm mode {norm}")


def get_mean_pixel(norm: InputNormTypes = InputNormTypes.ZERO_MEAN) -> np.ndarray:
    """Pad-fill pixel in RAW (pre-normalization) space so that after
    normalization padded pixels are ~zero (reference ``mean_pixel.py:4``)."""
    if norm == InputNormTypes.ZERO_MEAN:
        return np.array([127.5, 127.5, 127.5], np.float32)
    if norm in (InputNormTypes.KERAS, InputNormTypes.KERAS_SCALE):
        return IMAGENET_MEAN.copy()
    return np.zeros((3,), np.float32)
