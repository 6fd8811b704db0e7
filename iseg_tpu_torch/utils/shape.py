"""Static shape helpers (copy of ``iseg_tpu/utils/shape.py``): eager
tensors and arrays have static shapes, so these are named accessors for
call-site clarity."""

from __future__ import annotations


def get_tensor_shape(x) -> tuple[int, ...]:
    return tuple(int(d) for d in x.shape)


def get_hw(x) -> tuple[int, int]:
    """Spatial dims of an NHWC or HWC tensor."""
    if x.ndim == 4:
        return int(x.shape[1]), int(x.shape[2])
    if x.ndim == 3:
        return int(x.shape[0]), int(x.shape[1])
    raise ValueError(f"expected rank 3/4 image tensor, got shape {x.shape}")
