"""Per-sample augmentations, host-side numpy (a copy of
``iseg_tpu/data/augments.py``).

Parity with the reference's ``data_process/augments/`` (one class per
augment, all operating on (image, label) pairs —
``augments/data_augment_base.py:9`` with the probabilistic helper :26-32)
and the DeepLab-lineage joint ops in ``data_process/utils.py``
(``random_crop`` :64, ``pad_to_bounding_box`` :161, ``flip_dim`` :248,
``get_random_scale``/``randomly_scale_image_and_label`` :303,331,
``resize_to_range`` :374).

Design: the reference's tf.data pipeline runs these on host CPU with
dynamic shapes; same here (numpy, PIL for resampling), producing
fixed-shape samples by the time they reach the device. Determinism: every
augment takes a ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

try:
    from PIL import Image as _PILImage

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


# ---------------------------------------------------------------- resizing


def _resize_np(arr: np.ndarray, hw: tuple[int, int], nearest: bool) -> np.ndarray:
    """Bilinear (images) / nearest (labels) resize on host."""
    h, w = hw
    if arr.shape[:2] == (h, w):
        return arr
    if _HAS_PIL:
        mode = _PILImage.NEAREST if nearest else _PILImage.BILINEAR
        if arr.ndim == 2:
            return np.asarray(
                _PILImage.fromarray(arr).resize((w, h), mode), arr.dtype
            )
        chans = [
            np.asarray(_PILImage.fromarray(arr[..., c]).resize((w, h), mode))
            for c in range(arr.shape[-1])
        ]
        return np.stack(chans, -1).astype(arr.dtype)
    # fallback: nearest via index math
    ys = (np.arange(h) * arr.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * arr.shape[1] / w).astype(np.int64)
    return arr[ys][:, xs]


def resize_image_label(image, label, hw):
    image = _resize_np(np.asarray(image, np.float32), hw, nearest=False)
    if label is not None:
        label = _resize_np(np.asarray(label), hw, nearest=True)
    return image, label


# ------------------------------------------------------------------- base


class DataAugmentationBase:
    """Base: optional execution probability
    (reference ``augments/data_augment_base.py:9-32``)."""

    def __init__(self, prob: Optional[float] = None, name: Optional[str] = None):
        self.prob = prob
        self.name = name or type(self).__name__

    def __call__(self, rng: np.random.Generator, image, label):
        if self.prob is not None and rng.random() > self.prob:
            return image, label
        return self.call(rng, image, label)

    def call(self, rng, image, label):
        raise NotImplementedError


class LambdaAugment(DataAugmentationBase):
    """(reference ``augments/`` lambda augment)"""

    def __init__(self, fn: Callable, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn

    def call(self, rng, image, label):
        return self.fn(image, label)


# -------------------------------------------------------------- geometric


class ResizeAugment(DataAugmentationBase):
    def __init__(self, size: tuple[int, int], **kwargs):
        super().__init__(**kwargs)
        self.size = size

    def call(self, rng, image, label):
        return resize_image_label(image, label, self.size)


class ResizeMaxSizeAugment(DataAugmentationBase):
    """Cap the long side (reference resize-max / ``resize_to_range``)."""

    def __init__(self, max_size: int, **kwargs):
        super().__init__(**kwargs)
        self.max_size = max_size

    def call(self, rng, image, label):
        h, w = image.shape[:2]
        long_side = max(h, w)
        if long_side <= self.max_size:
            return image, label
        scale = self.max_size / long_side
        hw = (max(1, int(h * scale + 0.5)), max(1, int(w * scale + 0.5)))
        return resize_image_label(image, label, hw)


class RandomScaleAugment(DataAugmentationBase):
    """Random scale jitter (reference ``random_scale_augment.py:12``;
    ``get_random_scale`` ``data_process/utils.py:303``: uniform when
    step_size == 0, discrete linspace steps otherwise; break-aspect-ratio
    mode :36-46 samples per-axis scales independently)."""

    def __init__(
        self,
        min_scale_factor: float = 0.5,
        max_scale_factor: float = 2.0,
        step_size: float = 0.25,
        break_aspect_ratio: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.min_scale = min_scale_factor
        self.max_scale = max_scale_factor
        self.step_size = step_size
        self.break_aspect_ratio = break_aspect_ratio

    def _sample_scale(self, rng):
        if self.min_scale == self.max_scale:
            return self.min_scale
        if self.step_size == 0:
            return rng.uniform(self.min_scale, self.max_scale)
        n = int((self.max_scale - self.min_scale) / self.step_size) + 1
        return float(rng.choice(np.linspace(self.min_scale, self.max_scale, n)))

    def call(self, rng, image, label):
        h, w = image.shape[:2]
        if self.break_aspect_ratio:
            sh, sw = self._sample_scale(rng), self._sample_scale(rng)
        else:
            sh = sw = self._sample_scale(rng)
        hw = (max(1, int(h * sh + 0.5)), max(1, int(w * sw + 0.5)))
        return resize_image_label(image, label, hw)


class PadAugment(DataAugmentationBase):
    """Pad to at least crop size: image with mean pixel, label with
    ignore_label (reference ``pad_augment.py``; ``pad_to_bounding_box``
    ``data_process/utils.py:161``)."""

    def __init__(self, target_hw, mean_pixel=None, ignore_label=255, center=False, **kwargs):
        super().__init__(**kwargs)
        self.target_hw = target_hw
        self.mean_pixel = (
            np.asarray(mean_pixel, np.float32) if mean_pixel is not None else 127.5
        )
        self.ignore_label = ignore_label
        self.center = center

    def call(self, rng, image, label):
        h, w = image.shape[:2]
        th = max(self.target_hw[0], h)
        tw = max(self.target_hw[1], w)
        ph, pw = th - h, tw - w
        if ph == 0 and pw == 0:
            return image, label
        top, left = (ph // 2, pw // 2) if self.center else (0, 0)
        out = np.empty((th, tw, image.shape[2]), np.float32)
        out[:] = self.mean_pixel
        out[top : top + h, left : left + w] = image
        if label is not None:
            lout = np.full((th, tw), self.ignore_label, label.dtype)
            lout[top : top + h, left : left + w] = label
            label = lout
        return out, label


class RandomCropAugment(DataAugmentationBase):
    """Joint random crop (reference ``random_crop`` ``utils.py:64``).
    Assumes the sample is already >= crop size (pad first)."""

    def __init__(self, crop_size: tuple[int, int], **kwargs):
        super().__init__(**kwargs)
        self.crop_size = crop_size

    def call(self, rng, image, label):
        ch, cw = self.crop_size
        h, w = image.shape[:2]
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        image = image[top : top + ch, left : left + cw]
        if label is not None:
            label = label[top : top + ch, left : left + cw]
        return image, label


class RandomFlipAugment(DataAugmentationBase):
    """Horizontal flip p=0.5 (reference ``flip_dim`` ``utils.py:248``)."""

    def __init__(self, flip_prob: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.flip_prob = flip_prob

    def call(self, rng, image, label):
        if rng.random() < self.flip_prob:
            image = image[:, ::-1].copy()
            if label is not None:
                label = label[:, ::-1].copy()
        return image, label


class RandomRotateAugment(DataAugmentationBase):
    """Random rotation; label filled with ignore_label
    (reference ``random_rotate_augment.py``)."""

    def __init__(self, max_angle: float = 10.0, ignore_label: int = 255, **kwargs):
        super().__init__(**kwargs)
        self.max_angle = max_angle
        self.ignore_label = ignore_label

    def call(self, rng, image, label):
        if not _HAS_PIL:
            return image, label
        angle = float(rng.uniform(-self.max_angle, self.max_angle))
        # rotate per channel to stay dtype-exact
        chans = [
            np.asarray(
                _PILImage.fromarray(image[..., c].astype(np.float32)).rotate(
                    angle, resample=_PILImage.BILINEAR, fillcolor=float(np.mean(image[..., c]))
                )
            )
            for c in range(image.shape[-1])
        ]
        image = np.stack(chans, -1).astype(np.float32)
        if label is not None:
            label = np.asarray(
                _PILImage.fromarray(label.astype(np.int32), mode="I").rotate(
                    angle, resample=_PILImage.NEAREST, fillcolor=self.ignore_label
                ),
                label.dtype,
            )
        return image, label


class PadToOddAugment(DataAugmentationBase):
    """Pad H/W to odd sizes (reference ``pad_to_odd`` augment — some
    backbones want odd inputs for aligned centers)."""

    def __init__(self, mean_pixel=127.5, ignore_label=255, **kwargs):
        super().__init__(**kwargs)
        self.mean_pixel = mean_pixel
        self.ignore_label = ignore_label

    def call(self, rng, image, label):
        h, w = image.shape[:2]
        th = h + (1 - h % 2)
        tw = w + (1 - w % 2)
        if (th, tw) == (h, w):
            return image, label
        return PadAugment((th, tw), self.mean_pixel, self.ignore_label).call(
            rng, image, label
        )


# ------------------------------------------------------------ photometric


class RandomBrightnessAugment(DataAugmentationBase):
    def __init__(self, max_delta: float = 32.0, **kwargs):
        super().__init__(**kwargs)
        self.max_delta = max_delta

    def call(self, rng, image, label):
        delta = rng.uniform(-self.max_delta, self.max_delta)
        return np.clip(image + delta, 0, 255).astype(np.float32), label


class RandomContrastAugment(DataAugmentationBase):
    def __init__(self, lower: float = 0.5, upper: float = 1.5, **kwargs):
        super().__init__(**kwargs)
        self.lower, self.upper = lower, upper

    def call(self, rng, image, label):
        f = rng.uniform(self.lower, self.upper)
        mean = image.mean(axis=(0, 1), keepdims=True)
        return np.clip((image - mean) * f + mean, 0, 255).astype(np.float32), label


class RandomSaturationAugment(DataAugmentationBase):
    def __init__(self, lower: float = 0.5, upper: float = 1.5, **kwargs):
        super().__init__(**kwargs)
        self.lower, self.upper = lower, upper

    def call(self, rng, image, label):
        f = rng.uniform(self.lower, self.upper)
        gray = image.mean(axis=-1, keepdims=True)
        return np.clip(gray + (image - gray) * f, 0, 255).astype(np.float32), label


def _rgb_to_hsv(rgb: np.ndarray):
    """Vectorized RGB[0,1] -> (h, s, v), h in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.max(axis=-1)
    mn = rgb.min(axis=-1)
    diff = mx - mn
    safe = np.where(diff > 0, diff, 1.0)
    h = np.zeros_like(mx)
    rmax = (mx == r)
    gmax = (mx == g) & ~rmax
    bmax = ~rmax & ~gmax
    h = np.where(rmax, ((g - b) / safe) % 6.0, h)
    h = np.where(gmax, (b - r) / safe + 2.0, h)
    h = np.where(bmax, (r - g) / safe + 4.0, h)
    h = np.where(diff > 0, h / 6.0, 0.0)
    s = np.where(mx > 0, diff / np.where(mx > 0, mx, 1.0), 0.0)
    return h, s, mx


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.astype(np.int32) % 6
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4], [v, q, p, p, t], v)
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4], [t, v, v, q, p], p)
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4], [p, p, t, v, v], q)
    return np.stack([r, g, b], axis=-1)


class RandomHueAugment(DataAugmentationBase):
    """Exact HSV hue shift, matching ``tf.image.adjust_hue`` (the op the
    reference's augment wraps, ``random_hue_augment.py:22``): the HSV hue
    channel (range [0, 1] = one full circle) shifts by ``delta`` mod 1.
    A YIQ chroma-plane rotation is NOT equivalent — measured against
    ``tf.image.adjust_hue`` it diverges by up to 9% of range already at
    delta=0.02 on saturated pixels."""

    def __init__(self, max_delta: float = 0.1, **kwargs):
        super().__init__(**kwargs)
        self.max_delta = max_delta

    def call(self, rng, image, label):
        delta = rng.uniform(-self.max_delta, self.max_delta)
        h, s, v = _rgb_to_hsv(np.asarray(image, np.float32) / 255.0)
        out = _hsv_to_rgb((h + delta) % 1.0, s, v) * 255.0
        return np.clip(out, 0, 255).astype(np.float32), label


class PhotoMetricDistortionAugment(DataAugmentationBase):
    """Brightness/contrast/saturation/hue combo
    (reference ``photo_metric_distortion_augment``)."""

    def __init__(self, brightness_delta=32.0, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=0.1, **kwargs):
        super().__init__(**kwargs)
        self.ops = [
            RandomBrightnessAugment(brightness_delta, prob=0.5),
            RandomContrastAugment(*contrast_range, prob=0.5),
            RandomSaturationAugment(*saturation_range, prob=0.5),
            RandomHueAugment(hue_delta, prob=0.5),
        ]

    def call(self, rng, image, label):
        order = rng.permutation(len(self.ops))
        for i in order:
            image, label = self.ops[i](rng, image, label)
        return image, label


class RandomErasingAugment(DataAugmentationBase):
    """Random erasing with noise fill + ignore-label write to the label
    (reference ``random_erasing_augment.py:12``)."""

    def __init__(self, scale=(0.02, 0.2), ratio=(0.3, 3.3), ignore_label=255,
                 fill_noise=True, prob=0.5, **kwargs):
        super().__init__(prob=prob, **kwargs)
        self.scale = scale
        self.ratio = ratio
        self.ignore_label = ignore_label
        self.fill_noise = fill_noise

    def call(self, rng, image, label):
        h, w = image.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            aspect = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                # copy before writing: the upstream augments can be
                # identity pass-throughs/views of the caller's arrays, and
                # erasing in place would corrupt an in-memory dataset
                image = image.copy()
                if label is not None:
                    label = label.copy()
                top = int(rng.integers(0, h - eh))
                left = int(rng.integers(0, w - ew))
                if self.fill_noise:
                    image[top : top + eh, left : left + ew] = rng.uniform(
                        0, 255, (eh, ew, image.shape[2])
                    ).astype(np.float32)
                else:
                    image[top : top + eh, left : left + ew] = 0
                if label is not None:
                    label[top : top + eh, left : left + ew] = self.ignore_label
                break
        return image, label


class JpegQualityAugment(DataAugmentationBase):
    """JPEG-compression artifact augment (reference ``jpeg_quality``
    augment). Requires PIL; identity otherwise."""

    def __init__(self, min_quality: int = 30, max_quality: int = 90, **kwargs):
        super().__init__(**kwargs)
        self.min_quality = min_quality
        self.max_quality = max_quality

    def call(self, rng, image, label):
        if not _HAS_PIL:
            return image, label
        import io

        q = int(rng.integers(self.min_quality, self.max_quality + 1))
        buf = io.BytesIO()
        _PILImage.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(
            buf, "JPEG", quality=q
        )
        buf.seek(0)
        return np.asarray(_PILImage.open(buf), np.float32), label


class NoisyEvalAugment(DataAugmentationBase):
    """Additive gaussian noise for robustness eval
    (reference ``noisy_eval`` augment)."""

    def __init__(self, stddev: float = 10.0, **kwargs):
        super().__init__(**kwargs)
        self.stddev = stddev

    def call(self, rng, image, label):
        noise = rng.normal(0, self.stddev, image.shape).astype(np.float32)
        return np.clip(image + noise, 0, 255).astype(np.float32), label
