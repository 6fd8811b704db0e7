"""Layer helpers (counterpart of ``iseg_tpu/nn/common_layers.py``) on NCHW
tensors: pixel shuffle / unshuffle and global pooling.

The channel order of the shuffles is the JAX package's: channel ``k`` of
``[N, C*r*r, H, W]`` is ``(i, j, c)`` with ``c`` fastest, ``k = (i*r + j)
* C + c``, and lands at ``[c, h*r + i, w*r + j]``. ``F.pixel_shuffle``
splits it as ``(c, i, j)`` instead, so the two differ whenever ``C > 1``.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space: [N, C*r^2, H, W] -> [N, C, H*r, W*r]."""
    n, c, h, w = x.shape
    r = factor
    if c % (r * r) != 0:
        raise ValueError(f"channels {c} not divisible by {r * r}")
    oc = c // (r * r)
    x = x.reshape(n, r, r, oc, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)  # [n, oc, h, i, w, j]
    return x.reshape(n, oc, h * r, w * r)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Space-to-depth: [N, C, H*r, W*r] -> [N, C*r^2, H, W]."""
    n, c, hr, wr = x.shape
    r = factor
    if hr % r or wr % r:
        raise ValueError(f"spatial dims {(hr, wr)} not divisible by {r}")
    h, w = hr // r, wr // r
    x = x.reshape(n, c, h, r, w, r)
    x = x.permute(0, 3, 5, 1, 2, 4)  # [n, i, j, c, h, w]
    return x.reshape(n, c * r * r, h, w)


def global_average_pooling_2d(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=keepdims)


def global_max_pooling_2d(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    return x.amax(dim=(2, 3), keepdim=keepdims)
