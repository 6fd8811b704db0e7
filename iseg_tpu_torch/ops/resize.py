"""Image resizing and positional-embedding resampling (counterpart of
``iseg_tpu/ops/resize.py``).

NHWC (or HWC) at the boundary, like the JAX package. Bilinear is
half-pixel without antialias, ``jax.image.resize(..., "linear",
antialias=False)``, by interpolation matrices (:func:`_linear_matrix`):
the same values as ``F.interpolate(align_corners=False)``, but a backward
that sums in a fixed order where ``F.interpolate``'s CUDA backward adds
with atomics, so a training run through it repeats bit for bit. Bicubic is
``jax.image.resize(..., "bicubic", antialias=False)`` by interpolation
matrices (:func:`_cubic_matrix`): JAX's cubic is Keys' with a = -0.5 where
``F.interpolate``'s is a = -0.75, and JAX drops the taps that fall outside
the input and renormalizes the rest where torch clamps them to the border,
so no torch resize computes it. Integer maps and
``method="nearest"`` sample at half-pixel centres like
``jax.image.resize(..., "nearest")``, i.e. torch's ``"nearest-exact"`` and
not ``"nearest"``; the indices are computed here in float32 exactly as
JAX computes them, so every dtype (int labels included) takes one path.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


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


def _const(m: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A cached interpolation matrix as a normal tensor, also when first
    made under ``torch.inference_mode()`` (an inference tensor could not
    take part in a later training step's autograd)."""
    with torch.inference_mode(False):
        return torch.tensor(m, dtype=dtype, device=device)


@functools.lru_cache(maxsize=256)
def _linear_matrix(out_len: int, in_len: int, align_corners: bool, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``[out, in]`` weights of 1-D linear interpolation, made once per
    geometry, type and device. ``align_corners``: src = i * (in-1)/(out-1)
    (the JAX package's ``_align_corners_matrix``); else half-pixel, src =
    (i + 0.5) * in/out - 0.5 held at 0 from below (``jax.image.resize`` and
    ``F.interpolate``; no antialias), by :func:`_half_pixel_linear`."""
    if not align_corners:
        return _const(_half_pixel_linear(out_len, in_len, dtype), dtype, device)
    i = np.arange(out_len, dtype=np.float64)
    src = i * (in_len - 1) / (out_len - 1) if out_len > 1 else np.zeros(out_len)
    lo = np.minimum(np.floor(src).astype(np.int64), in_len - 1)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = src - lo
    m = np.zeros((out_len, in_len))
    np.add.at(m, (np.arange(out_len), lo), 1.0 - frac)
    np.add.at(m, (np.arange(out_len), hi), frac)
    return _const(m, dtype, device)


def _half_pixel_linear(out_len: int, in_len: int, dtype: torch.dtype) -> np.ndarray:
    """``[out, in]`` weights of ``jax.image.resize(..., "linear",
    antialias=False)``, computed as ``jax.image``'s ``compute_weight_mat``
    computes them: in float64 for float64, else in fp32 arithmetic (its
    weights' type), the triangle kernel at half-pixel sample points, each
    row renormalized to sum 1 (which holds the border samples at the edge
    pixel), and 0 for a sample point outside the input."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    inv_scale = ft(1.0 / (out_len / in_len))  # a Python float there, rounded once
    src = (np.arange(out_len, dtype=ft) + ft(0.5)) * inv_scale - ft(0.5)
    m = np.maximum(ft(0.0), ft(1.0) - np.abs(src[:, None] - np.arange(in_len, dtype=ft)[None, :]))
    total = m.sum(axis=1, keepdims=True, dtype=ft)
    m = np.where(np.abs(total) > ft(1000.0 * np.finfo(np.float32).eps),
                 m / np.where(total != 0, total, ft(1.0)), ft(0.0))
    inside = (src >= ft(-0.5)) & (src <= ft(in_len - 0.5))
    return np.where(inside[:, None], m, ft(0.0))


@functools.lru_cache(maxsize=256)
def _antialias_linear_matrix(out_len: int, in_len: int, dtype: torch.dtype,
                             device: torch.device) -> torch.Tensor:
    """``[out, in]`` weights of ``jax.image.scale_and_translate``'s linear
    resize with antialias: the triangle kernel widened by ``in / out``
    when downsampling (as it is, upsampling), at half-pixel sample points,
    each row renormalized to sum 1 (0 where its sum is within 1000 fp32
    epsilons of 0), and 0 for a sample point outside the input."""
    inv_scale = in_len / out_len
    src = (np.arange(out_len, dtype=np.float64) + 0.5) * inv_scale - 0.5
    dist = np.abs(src[:, None] - np.arange(in_len, dtype=np.float64)[None, :])
    m = np.maximum(0.0, 1.0 - dist / max(inv_scale, 1.0))
    total = m.sum(axis=1, keepdims=True)
    m = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 m / np.where(total != 0, total, 1.0), 0.0)
    inside = (src >= -0.5) & (src <= in_len - 0.5)
    return _const(np.where(inside[:, None], m, 0.0), dtype, device)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at distances ``x`` >= 0
    (``jax.image``'s ``_fill_keys_cubic_kernel``)."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


@functools.lru_cache(maxsize=256)
def _cubic_matrix(out_len: int, in_len: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``[out, in]`` weights of ``jax.image.scale_and_translate``'s bicubic
    resize without antialias: half-pixel sample points, the kernel at the
    input positions only (taps outside ``[0, in)`` are dropped), each row
    renormalized to sum 1 (0 where its sum is within 1000 fp32 epsilons of
    0), and 0 for a sample point outside the input."""
    src = (np.arange(out_len, dtype=np.float64) + 0.5) * in_len / out_len - 0.5
    m = _keys_cubic(np.abs(src[:, None] - np.arange(in_len, dtype=np.float64)[None, :]))
    total = m.sum(axis=1, keepdims=True)
    m = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 m / np.where(total != 0, total, 1.0), 0.0)
    inside = (src >= -0.5) & (src <= in_len - 0.5)
    return _const(np.where(inside[:, None], m, 0.0), dtype, device)


def _resize_matmul(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` resized by ``[h, in_h]`` and ``[w, in_w]`` interpolation
    matrices, one product per axis."""
    n, in_h, in_w, c = x.shape
    h, w = mh.shape[0], mw.shape[0]
    y = torch.matmul(mh, x.reshape(n, in_h, in_w * c)).reshape(n * h, in_w, c)
    return torch.matmul(mw, y).reshape(n, h, w, c)


def resize_bicubic_matmul(x: torch.Tensor, size: Sequence[int] | int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bicubic", antialias=False)`` of an NHWC
    tensor, by :func:`_cubic_matrix` on each axis, in ``x``'s type (its
    backward is two more products, summed in a fixed order)."""
    h, w = _normalize_size(size)
    _, in_h, in_w, _ = x.shape
    if (in_h, in_w) == (h, w):
        return x
    return _resize_matmul(x, _cubic_matrix(h, in_h, x.dtype, x.device),
                          _cubic_matrix(w, in_w, x.dtype, x.device))


def resize_bilinear_matmul(x: torch.Tensor, size: Sequence[int] | int,
                           align_corners: bool) -> torch.Tensor:
    """Bilinear NHWC resize as two products with interpolation matrices,
    one per axis, as the JAX package computes its align-corners resize. Its
    backward is two more products, so it sums in a fixed order:
    ``F.interpolate``'s CUDA backward adds with atomics, and a training run
    through it is not repeatable bit for bit. For a channels_last NCHW
    tensor's NHWC view both products take their operands without a copy."""
    h, w = _normalize_size(size)
    _, in_h, in_w, _ = x.shape
    if (in_h, in_w) == (h, w):
        return x
    return _resize_matmul(x, _linear_matrix(h, in_h, align_corners, x.dtype, x.device),
                          _linear_matrix(w, in_w, align_corners, x.dtype, x.device))


def resize_bilinear_antialias(x: torch.Tensor, size: Sequence[int] | int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` (antialias on, its
    default) of an NHWC tensor, by :func:`_antialias_linear_matrix` on each
    axis that changes size."""
    h, w = _normalize_size(size)
    _, in_h, in_w, _ = x.shape
    if (in_h, in_w) == (h, w):
        return x
    return _resize_matmul(x, _antialias_linear_matrix(h, in_h, x.dtype, x.device),
                          _antialias_linear_matrix(w, in_w, x.dtype, x.device))


def resize_bilinear_align_corners(x: torch.Tensor, size: Sequence[int] | int) -> torch.Tensor:
    """Bilinear NHWC resize with ``tf.compat.v1.image.resize(...,
    align_corners=True)`` semantics (src = i * (in-1)/(out-1)), by
    :func:`resize_bilinear_matmul`."""
    return resize_bilinear_matmul(x, size, align_corners=True)


def resize_nchw(x: torch.Tensor, size: Sequence[int] | int,
                align_corners: bool = False) -> torch.Tensor:
    """:func:`resize_bilinear_matmul` of an NCHW tensor (a view of it when
    it is channels_last), returned NCHW."""
    return resize_bilinear_matmul(x.permute(0, 2, 3, 1), size,
                                  align_corners).permute(0, 3, 1, 2)


def resize_image(
    x: torch.Tensor,
    size: Sequence[int] | int,
    method: str = "bilinear",
    antialias: bool = False,
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize NHWC (or HWC) images to ``size=(H, W)``: bilinear (or
    ``method="bicubic"``) for float tensors, nearest for integer label
    maps."""
    h, w = _normalize_size(size)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f"resize_image expects NHWC or HWC, got shape {tuple(x.shape)}")

    if not torch.is_floating_point(x) or method == "nearest":
        out = _resize_nearest(x, h, w)
    elif method not in ("bilinear", "bicubic"):
        raise NotImplementedError(f"resize method {method!r} is not ported yet")
    elif antialias and method == "bicubic":
        raise NotImplementedError("antialiased bicubic resize is not ported yet")
    elif antialias:
        out = resize_bilinear_antialias(x, (h, w))
    elif method == "bicubic":
        out = resize_bicubic_matmul(x, (h, w))
    else:
        out = resize_bilinear_matmul(x, (h, w), align_corners=align_corners)
    return out[0] if squeeze else out


def scaled_size(height: int, width: int, scale: float) -> tuple[int, int]:
    """Scale a (H, W) pair: round-half-up per dimension, min 1."""
    return (max(1, int(height * scale + 0.5)), max(1, int(width * scale + 0.5)))


def resample_abs_pos_embed(
    pos_embed: torch.Tensor,
    new_hw: tuple[int, int],
    old_hw: tuple[int, int] | None = None,
    num_prefix_tokens: int = 1,
) -> torch.Tensor:
    """Resample a ``[1, N(+prefix), C]`` absolute positional embedding to
    a ``new_hw`` grid by the bicubic resize above, so ViT-family backbones
    take any input size; the prefix tokens (the class token) pass through.
    ``old_hw`` None infers a square grid. The resize runs in
    ``promote_types(dtype, float32)`` with autocast off and casts back (the
    JAX package resizes in fp32, also for float64 input)."""
    if pos_embed.ndim != 3:
        raise ValueError(f"pos_embed must be [1, N, C], got {tuple(pos_embed.shape)}")
    grid = pos_embed[:, num_prefix_tokens:]
    n = grid.shape[1]
    if old_hw is None:
        side = int(round(n ** 0.5))
        if side * side != n:
            raise ValueError(f"cannot infer square grid from {n} tokens")
        old_hw = (side, side)
    if tuple(old_hw) == tuple(new_hw):
        return pos_embed
    (oh, ow), (nh, nw), c = old_hw, new_hw, grid.shape[-1]
    compute = torch.promote_types(grid.dtype, torch.float32)
    with torch.autocast(grid.device.type, enabled=False):
        grid = resize_bicubic_matmul(grid.to(compute).reshape(1, oh, ow, c), (nh, nw))
    grid = grid.reshape(1, nh * nw, c).to(pos_embed.dtype)
    if num_prefix_tokens:
        grid = torch.cat([pos_embed[:, :num_prefix_tokens], grid], dim=1)
    return grid
