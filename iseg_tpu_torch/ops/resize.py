"""Image resizing and positional-embedding resampling (counterpart of
``iseg_tpu/ops/resize.py``).

NHWC (or HWC) at the boundary, like the JAX package. :func:`resize_image`
takes every method of ``jax.image.resize``: ``linear`` / ``bilinear``,
``cubic`` / ``bicubic``, ``lanczos3``, ``lanczos5``, each with or without
``antialias``, and ``nearest``. The float methods are products with one
``[out, in]`` interpolation matrix per axis that changes size, built by
:func:`_scale_matrix` as ``jax.image.scale_and_translate`` builds its
weights: the method's kernel at half-pixel sample points, widened by
``in / out`` when antialiasing a downsample, each row renormalized (0 where
its sum is within 1000 fp32 epsilons of 0), 0 for a sample point outside
the input, in fp32 arithmetic (float64 for float64, the JAX package's x64
mode). Products with matrices sum in a fixed order forward and backward,
where ``F.interpolate``'s CUDA backward adds with atomics, so a training run
through them repeats bit for bit. No torch resize computes these
functions: JAX's cubic is Keys' with a = -0.5 (torch's a = -0.75) and drops
the taps outside the input and renormalizes (torch clamps to the border);
non-antialiased bilinear equals ``F.interpolate(align_corners=False)``.
Integer maps and ``method="nearest"`` sample at half-pixel centres like
``jax.image.resize(..., "nearest")``, i.e. torch's ``"nearest-exact"`` and
not ``"nearest"``; the indices are computed here in float32 exactly as JAX
computes them, so every dtype (int labels included) takes one path.
``align_corners=True`` (bilinear only) is the JAX package's align-corners
resize (src = i * (in-1)/(out-1)).
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


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at distances ``x`` >= 0
    (``jax.image``'s ``_fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(x.dtype)


def _lanczos(radius: float):
    def kernel(x: np.ndarray) -> np.ndarray:
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1)
        return np.where(x > radius, 0.0, out).astype(x.dtype)
    return kernel


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos(3.0),
            "lanczos5": _lanczos(5.0)}
# jax.image.ResizeMethod.from_string's names
_METHODS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "triangle": "linear", "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
            "lanczos3": "lanczos3", "lanczos5": "lanczos5"}


def _scale_matrix(out_len: int, in_len: int, kernel: str, antialias: bool,
                  dtype: torch.dtype) -> np.ndarray:
    """``[out, in]`` weights of ``jax.image.scale_and_translate``'s resize
    along one axis (``compute_weight_mat``), in its arithmetic: float64 for
    float64, else fp32 (its weights' type), the scale a Python float
    rounded once."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    inv_scale = ft(1.0 / (out_len / in_len))
    kernel_scale = max(inv_scale, ft(1.0)) if antialias else ft(1.0)
    src = (np.arange(out_len, dtype=ft) + ft(0.5)) * inv_scale - ft(0.5)
    dist = np.abs(src[:, None] - np.arange(in_len, dtype=ft)[None, :]) / kernel_scale
    m = _KERNELS[kernel](dist)
    total = m.sum(axis=1, keepdims=True, dtype=ft)
    m = np.where(np.abs(total) > ft(1000.0 * np.finfo(np.float32).eps),
                 m / np.where(total != 0, total, ft(1.0)), ft(0.0))
    inside = (src >= ft(-0.5)) & (src <= ft(in_len - 0.5))
    return np.where(inside[:, None], m, ft(0.0))


def _align_corners_matrix(out_len: int, in_len: int) -> np.ndarray:
    """``[out, in]`` weights of linear interpolation at src = i * (in-1)/(out-1)
    (the JAX package's ``_align_corners_matrix``)."""
    i = np.arange(out_len, dtype=np.float64)
    src = i * (in_len - 1) / (out_len - 1) if out_len > 1 else np.zeros(out_len)
    lo = np.minimum(np.floor(src).astype(np.int64), in_len - 1)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = src - lo
    m = np.zeros((out_len, in_len))
    np.add.at(m, (np.arange(out_len), lo), 1.0 - frac)
    np.add.at(m, (np.arange(out_len), hi), frac)
    return m


@functools.lru_cache(maxsize=256)
def _interp_matrix(out_len: int, in_len: int, kernel: str, antialias: bool,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`_scale_matrix` (``kernel`` ``"align_corners"``:
    :func:`_align_corners_matrix`) as a tensor, made once per geometry,
    method, type and device."""
    if kernel == "align_corners":
        return _const(_align_corners_matrix(out_len, in_len), dtype, device)
    return _const(_scale_matrix(out_len, in_len, kernel, antialias, dtype), dtype, device)


def _resize_matmul(x: torch.Tensor, size, kernel: str, antialias: bool = False) -> torch.Tensor:
    """NHWC ``x`` resized to ``size`` by one product with an interpolation
    matrix per axis that changes size (H first, then W)."""
    n, in_h, in_w, c = x.shape
    h, w = _normalize_size(size)
    if h != in_h:
        mh = _interp_matrix(h, in_h, kernel, antialias, x.dtype, x.device)
        x = torch.matmul(mh, x.reshape(n, in_h, in_w * c)).reshape(n, h, in_w, c)
    if w != in_w:
        mw = _interp_matrix(w, in_w, kernel, antialias, x.dtype, x.device)
        x = torch.matmul(mw, x.reshape(n * h, in_w, c)).reshape(n, h, w, c)
    return x


def resize_bicubic_matmul(x: torch.Tensor, size: Sequence[int] | int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bicubic", antialias=False)`` of an NHWC
    tensor, in ``x``'s type (its backward is two more products, summed in a
    fixed order)."""
    return _resize_matmul(x, size, "cubic")


def resize_bilinear_matmul(x: torch.Tensor, size: Sequence[int] | int,
                           align_corners: bool) -> torch.Tensor:
    """Bilinear NHWC resize as products with interpolation matrices, one per
    axis, as the JAX package computes its align-corners resize
    (``align_corners``) or as ``jax.image.resize(..., "linear",
    antialias=False)`` (half-pixel). Its backward is more products, so it
    sums in a fixed order: ``F.interpolate``'s CUDA backward adds with
    atomics, and a training run through it is not repeatable bit for bit.
    For a channels_last NCHW tensor's NHWC view both products take their
    operands without a copy."""
    return _resize_matmul(x, size, "align_corners" if align_corners else "linear")


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
    """Resize NHWC (or HWC) images to ``size=(H, W)`` by any method of
    ``jax.image.resize`` (integer maps by nearest), in ``x``'s type."""
    h, w = _normalize_size(size)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f"resize_image expects NHWC or HWC, got shape {tuple(x.shape)}")

    if not torch.is_floating_point(x) or method == "nearest":
        out = _resize_nearest(x, h, w)
    elif align_corners and method == "bilinear":
        out = resize_bilinear_matmul(x, (h, w), align_corners=True)
    elif method in _METHODS:
        out = _resize_matmul(x, (h, w), _METHODS[method], antialias)
    else:
        raise ValueError(f"Unknown resize method {method!r}")
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
