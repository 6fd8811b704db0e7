"""Composable augmentation pipeline + the canonical train/eval recipes (a
copy of ``iseg_tpu/data/pipeline.py``).

Parity with the reference's ``data_process/pipeline.py``
(``AugmentationsPipeLine`` :10, ``StandardAugmentationsPipeline`` :85-170:
train = resize-max -> random-scale -> (brightness/photometric) ->
pad-to-crop-with-mean-pixel -> random-crop -> random-flip -> random-erase
-> (jpeg-quality); eval = pad only (+noise option)), followed by input
normalization (``data_process/input_norm.py``).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from iseg_tpu_torch.data.augments import (
    DataAugmentationBase,
    JpegQualityAugment,
    NoisyEvalAugment,
    PadAugment,
    PhotoMetricDistortionAugment,
    RandomBrightnessAugment,
    RandomCropAugment,
    RandomErasingAugment,
    RandomFlipAugment,
    RandomScaleAugment,
    ResizeMaxSizeAugment,
)
from iseg_tpu_torch.data.input_norm import InputNormTypes, get_mean_pixel, normalize_input


class AugmentationsPipeline:
    """Sequential augment composer (reference ``pipeline.py:10-82``)."""

    def __init__(self, augments: Sequence[DataAugmentationBase], seed: int = 0):
        self.augments = list(augments)
        self.seed = seed

    def __call__(self, image, label, sample_index: int = 0):
        """Apply to one (image, label) sample; deterministic in
        (seed, sample_index)."""
        rng = np.random.default_rng((self.seed, sample_index))
        image = np.asarray(image, np.float32)
        if label is not None:
            label = np.asarray(label)
        for aug in self.augments:
            image, label = aug(rng, image, label)
        return image, label

    def map(self, samples: Iterable, start_index: int = 0):
        for i, (image, label) in enumerate(samples):
            yield self(image, label, start_index + i)


class StandardAugmentationsPipeline(AugmentationsPipeline):
    """The canonical recipe (reference ``pipeline.py:85-170``)."""

    def __init__(
        self,
        training: bool = True,
        crop_size: tuple[int, int] = (512, 512),
        eval_crop_size: Optional[tuple[int, int]] = None,
        min_scale_factor: float = 0.5,
        max_scale_factor: float = 2.0,
        scale_step_size: float = 0.25,
        min_resize_value: Optional[int] = None,
        max_resize_value: Optional[int] = None,
        random_brightness: bool = False,
        photo_metric_distortion: bool = False,
        random_erasing: bool = False,
        jpeg_quality: bool = False,
        eval_noise_stddev: Optional[float] = None,
        flip_prob: float = 0.5,
        ignore_label: int = 255,
        norm: InputNormTypes = InputNormTypes.ZERO_MEAN,
        seed: int = 0,
    ):
        mean_pixel = get_mean_pixel(norm)
        augments: list[DataAugmentationBase] = []
        if training:
            if max_resize_value:
                augments.append(ResizeMaxSizeAugment(max_resize_value))
            augments.append(
                RandomScaleAugment(min_scale_factor, max_scale_factor, scale_step_size)
            )
            if random_brightness:
                augments.append(RandomBrightnessAugment(prob=0.5))
            if photo_metric_distortion:
                augments.append(PhotoMetricDistortionAugment())
            augments.append(PadAugment(crop_size, mean_pixel, ignore_label))
            augments.append(RandomCropAugment(crop_size))
            augments.append(RandomFlipAugment(flip_prob))
            if random_erasing:
                augments.append(RandomErasingAugment(ignore_label=ignore_label))
            if jpeg_quality:
                augments.append(JpegQualityAugment(prob=0.5))
        else:
            target = eval_crop_size or crop_size
            if target is not None:
                augments.append(PadAugment(target, mean_pixel, ignore_label))
            if eval_noise_stddev:
                augments.append(NoisyEvalAugment(eval_noise_stddev))
        super().__init__(augments, seed=seed)
        self.norm = norm
        self.training = training

    def __call__(self, image, label, sample_index: int = 0):
        image, label = super().__call__(image, label, sample_index)
        image = normalize_input(image, self.norm)
        return image, label
