"""On-device augmentation (counterpart of ``iseg_tpu/data/device_augment.py``).

The hot path of the standard recipe (random scale -> random crop -> flip ->
photometric -> erase) runs on the batch's device with static output shapes,
in a few batched launches and no Python loop over samples. It is split in
two so that draws and arithmetic can be checked apart:

* :func:`sample_augment_params` draws each sample's scale, crop offset,
  flip, brightness delta and erase box with its noise from an explicit
  ``torch.Generator``;
* :func:`apply_augment` applies them.

Random scale + crop compose into one resample with a per-sample scale and
translation, as ``jax.image.scale_and_translate(..., method="linear",
antialias=False)`` does: output index ``i`` samples input
``(i + 0.5 - t) / s - 0.5``. Inside ``[-0.5, size - 0.5]`` that kernel is a
bilinear interpolation whose weights are clamped at the border, which is
``F.grid_sample(mode="bilinear", padding_mode="border",
align_corners=False)`` at the same coordinates; outside it the mean-pixel
fill takes over, as in the JAX package. Labels take a nearest gather with the
same geometry (``torch.round`` rounds half to even, like ``jnp.round``);
out-of-source pixels get the ignore label. The flip is folded into the
sample columns. The order of the JAX package is kept: brightness, then the
mean-pixel fill, then flip, then erasing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from iseg_tpu_torch.parallel.collectives import global_rows


@dataclasses.dataclass(frozen=True)
class DeviceAugmentConfig:
    crop_size: tuple[int, int] = (512, 512)
    min_scale_factor: float = 0.5
    max_scale_factor: float = 2.0
    scale_step_size: float = 0.25
    flip_prob: float = 0.5
    random_brightness: bool = False
    brightness_max_delta: float = 32.0
    random_erasing: bool = False
    erase_prob: float = 0.5
    erase_scale: tuple[float, float] = (0.02, 0.2)
    ignore_label: int = 255
    mean_pixel: tuple[float, float, float] = (127.5, 127.5, 127.5)


@dataclasses.dataclass
class AugmentParams:
    """Per-sample draws for one batch of ``n`` samples.

    ``offset`` is the crop's position as a share of the room the scaled
    image leaves around the crop, (y, x) in [0, 1). The brightness and erase
    fields are None when the config turns those augments off."""

    scale: torch.Tensor  # [n] float32
    offset: torch.Tensor  # [n, 2] float32
    flip: torch.Tensor  # [n] bool
    brightness: Optional[torch.Tensor] = None  # [n] float32 delta
    erase: Optional[torch.Tensor] = None  # [n] bool
    erase_side: Optional[torch.Tensor] = None  # [n] float32
    erase_origin: Optional[torch.Tensor] = None  # [n, 2] int64 (top, left)
    erase_noise: Optional[torch.Tensor] = None  # [n, ch, cw, C] float32 in [0, 255)

    def rows(self, index) -> "AugmentParams":
        """The params of the samples ``index`` selects."""
        return AugmentParams(**{f.name: (None if getattr(self, f.name) is None
                                         else getattr(self, f.name)[index])
                                for f in dataclasses.fields(self)})

    def to(self, device) -> "AugmentParams":
        return AugmentParams(**{f.name: (None if getattr(self, f.name) is None
                                         else getattr(self, f.name).to(device))
                                for f in dataclasses.fields(self)})


def _uniform(generator: torch.Generator, shape, low: float, high: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def sample_augment_params(generator: torch.Generator, n: int, cfg: DeviceAugmentConfig,
                          channels: int = 3) -> AugmentParams:
    """Draw the augment of ``n`` samples on ``generator``'s device.

    The scale is one of ``linspace(min, max, steps)`` (uniform in
    [min, max) when ``scale_step_size`` is 0, fixed when min == max), as
    ``_sample_scale`` of the JAX package draws it; the erase box has side
    ``sqrt(crop area * U(erase_scale))`` and a corner drawn from
    ``[0, max(ch - 1, 1))`` x ``[0, max(cw - 1, 1))``."""
    dev = generator.device
    ch, cw = cfg.crop_size
    lo, hi = cfg.min_scale_factor, cfg.max_scale_factor
    if lo == hi:
        scale = torch.full((n,), lo, dtype=torch.float32, device=dev)
    elif cfg.scale_step_size == 0:
        scale = _uniform(generator, (n,), lo, hi)
    else:
        steps = int((hi - lo) / cfg.scale_step_size) + 1
        choice = torch.randint(0, steps, (n,), generator=generator, device=dev)
        scale = torch.linspace(lo, hi, steps, dtype=torch.float32, device=dev)[choice]
    params = AugmentParams(
        scale=scale,
        offset=torch.rand((n, 2), generator=generator, device=dev),
        flip=torch.rand((n,), generator=generator, device=dev) < cfg.flip_prob)
    if cfg.random_brightness:
        d = cfg.brightness_max_delta
        params.brightness = _uniform(generator, (n,), -d, d)
    if cfg.random_erasing:
        params.erase = torch.rand((n,), generator=generator, device=dev) < cfg.erase_prob
        area = ch * cw * _uniform(generator, (n,), *cfg.erase_scale)
        params.erase_side = torch.sqrt(area)
        params.erase_origin = torch.stack(
            [torch.randint(0, max(ch - 1, 1), (n,), generator=generator, device=dev),
             torch.randint(0, max(cw - 1, 1), (n,), generator=generator, device=dev)], 1)
        params.erase_noise = _uniform(generator, (n, ch, cw, channels), 0.0, 255.0)
    return params


def apply_augment(images: torch.Tensor, labels: torch.Tensor, params: AugmentParams,
                  cfg: DeviceAugmentConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``images`` [n, h, w, C] (any real dtype, 0-255) and ``labels``
    [n, h, w] -> float32 images [n, ch, cw, C] (raw 0-255) and int32 labels
    [n, ch, cw], on the images' device."""
    n, h, w, c = images.shape
    ch, cw = cfg.crop_size
    dev = images.device
    p = params.to(dev)
    scale = p.scale.to(torch.float32)
    # crop offset inside the scaled image; an image scaled below the crop
    # keeps offset 0 and the rest of the crop becomes padding
    ty = -p.offset[:, 0] * torch.clamp(h * scale - ch, min=0.0)
    tx = -p.offset[:, 1] * torch.clamp(w * scale - cw, min=0.0)
    ys = torch.arange(ch, dtype=torch.float32, device=dev)
    xs = torch.arange(cw, dtype=torch.float32, device=dev)
    inv = (1.0 / scale)[:, None]
    # image sample positions, in scale_and_translate's arithmetic
    sy = (ys + 0.5) * inv - ty[:, None] * inv - 0.5
    sx = (xs + 0.5) * inv - tx[:, None] * inv - 0.5
    # label gather positions, in the JAX label gather's arithmetic
    dy = (ys + 0.5 - ty[:, None]) / scale[:, None] - 0.5
    dx = (xs + 0.5 - tx[:, None]) / scale[:, None] - 0.5
    flip = p.flip[:, None]
    sx = torch.where(flip, sx.flip(1), sx)
    dx = torch.where(flip, dx.flip(1), dx)

    # normalized coordinates of align_corners=False: -1 and 1 are the outer
    # edges of the first and last pixels
    grid = torch.stack(torch.broadcast_tensors(((2.0 * sx + 1.0) / w - 1.0)[:, None, :],
                                               ((2.0 * sy + 1.0) / h - 1.0)[:, :, None]), -1)
    img = F.grid_sample(images.to(torch.float32).permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=False).permute(0, 2, 3, 1)

    yi = torch.round(dy).to(torch.int64)
    xi = torch.round(dx).to(torch.int64)
    valid = (((yi >= 0) & (yi < h))[:, :, None]) & (((xi >= 0) & (xi < w))[:, None, :])
    rows = torch.arange(n, device=dev)[:, None, None]
    lab = labels[rows, yi.clamp(0, h - 1)[:, :, None], xi.clamp(0, w - 1)[:, None, :]]
    ignore = torch.tensor(cfg.ignore_label, dtype=torch.int32, device=dev)
    lab = torch.where(valid, lab.to(torch.int32), ignore)

    # brightness BEFORE the mean-pixel fill (the host pipeline's order:
    # photometric runs before PadAugment, so padded pixels stay exactly
    # mean_pixel rather than mean + delta)
    if p.brightness is not None:
        img = torch.clamp(img + p.brightness[:, None, None, None], 0.0, 255.0)
    mean_pix = torch.tensor(cfg.mean_pixel, dtype=torch.float32, device=dev)
    img = torch.where(valid[..., None], img, mean_pix)

    if p.erase is not None:
        top = p.erase_origin[:, 0, None, None]
        left = p.erase_origin[:, 1, None, None]
        side = p.erase_side[:, None, None]
        yy = torch.arange(ch, device=dev)[None, :, None]
        xx = torch.arange(cw, device=dev)[None, None, :]
        rect = ((yy >= top) & (yy < top + side) & (xx >= left) & (xx < left + side)
                & p.erase[:, None, None])
        img = torch.where(rect[..., None], p.erase_noise.to(torch.float32), img)
        lab = torch.where(rect, ignore, lab)
    return img.contiguous(), lab


def make_device_augment(cfg: Optional[DeviceAugmentConfig] = None):
    """Returns ``augment(generator, images [N,H,W,3] raw 0-255, labels
    [N,H,W]) -> (float32 images [N,ch,cw,3], int32 labels [N,ch,cw])``.

    The draws come from ``generator`` on its own device (keep it on the
    images' device, so nothing crosses to the host). Input normalization
    (``iseg_tpu_torch.data.input_norm``) composes after."""
    cfg = cfg or DeviceAugmentConfig()

    def augment(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
        # under data parallelism: this rank's rows of the global batch's draws
        rows, mine = global_rows(images.shape[0])
        params = sample_augment_params(generator, rows, cfg, channels=images.shape[-1])
        if rows != images.shape[0]:
            params = params.rows(mine)
        return apply_augment(images, labels, params, cfg)

    return augment
