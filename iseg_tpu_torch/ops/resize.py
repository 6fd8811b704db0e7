"""Image resizing (counterpart of ``iseg_tpu/ops/resize.py``).

NHWC (or HWC) at the boundary, like the JAX package. Bilinear is
half-pixel ``F.interpolate(align_corners=False, antialias=False)``, which
is ``jax.image.resize(..., "linear", antialias=False)``. Integer maps and
``method="nearest"`` sample at half-pixel centres like
``jax.image.resize(..., "nearest")``, i.e. torch's ``"nearest-exact"`` and
not ``"nearest"``; the indices are computed here in float32 exactly as
JAX computes them, so every dtype (int labels included) takes one path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _normalize_size(size) -> tuple[int, int]:
    if isinstance(size, int):
        return (size, size)
    h, w = size
    return (int(h), int(w))


def _nearest_indices(n_out: int, n_in: int, device) -> torch.Tensor:
    # jax/_src/image/scale.py::_resize_nearest: floor(f32((i + 0.5) * in / out))
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def _resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[1] != h:
        x = x.index_select(1, _nearest_indices(h, x.shape[1], x.device))
    if x.shape[2] != w:
        x = x.index_select(2, _nearest_indices(w, x.shape[2], x.device))
    return x


def resize_bilinear_align_corners(x: torch.Tensor, size: Sequence[int] | int) -> torch.Tensor:
    """Bilinear NHWC resize with ``tf.compat.v1.image.resize(...,
    align_corners=True)`` semantics (src = i * (in-1)/(out-1))."""
    h, w = _normalize_size(size)
    if x.shape[1] == h and x.shape[2] == w:
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def resize_image(
    x: torch.Tensor,
    size: Sequence[int] | int,
    method: str = "bilinear",
    antialias: bool = False,
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize NHWC (or HWC) images to ``size=(H, W)``: bilinear for float
    tensors, nearest for integer label maps."""
    h, w = _normalize_size(size)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f"resize_image expects NHWC or HWC, got shape {tuple(x.shape)}")

    if not torch.is_floating_point(x) or method == "nearest":
        out = _resize_nearest(x, h, w)
    elif method != "bilinear":
        raise NotImplementedError(f"resize method {method!r} is not ported yet")
    elif antialias:
        raise NotImplementedError("antialiased resize is not ported yet")
    elif align_corners:
        out = resize_bilinear_align_corners(x, (h, w))
    elif x.shape[1:3] == (h, w):
        out = x
    else:
        out = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                            align_corners=False, antialias=False).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def scaled_size(height: int, width: int, scale: float) -> tuple[int, int]:
    """Scale a (H, W) pair: round-half-up per dimension, min 1."""
    return (max(1, int(height * scale + 0.5)), max(1, int(width * scale + 0.5)))
