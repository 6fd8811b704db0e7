"""Endpoint selection shared by the pyramid heads (counterpart of
``iseg_tpu/nn/heads/common.py``), for NCHW endpoints.

Pyramid heads want the ``n`` coarsest DISTINCT strides in fine->coarse
order. Taking ``endpoints[-n:]`` by position assumes a strictly
fine->coarse list, which is the usual backbone contract but not universal
(Swin returns two os4 endpoints; HRNet appends an os4 concat last).
"""

from __future__ import annotations


def select_pyramid_endpoints(endpoints, n: int) -> list:
    """The ``n`` coarsest distinct-resolution endpoints, fine -> coarse.

    Ties at one resolution keep the LAST tensor (later endpoints are the
    richer ones). Falls back to ``endpoints[-n:]`` when fewer than ``n``
    4-D endpoints or distinct resolutions exist."""
    if not isinstance(endpoints, (list, tuple)):
        return [endpoints]
    spatial = [e for e in endpoints if hasattr(e, "shape") and len(e.shape) == 4]
    if len(spatial) < n:
        return list(endpoints[-n:])
    by_res: dict = {}
    for e in spatial:  # the last one at a resolution wins
        by_res[(int(e.shape[2]), int(e.shape[3]))] = e
    ordered = sorted(by_res.items(), key=lambda kv: -(kv[0][0] * kv[0][1]))
    if len(ordered) < n:
        return list(endpoints[-n:])
    return [e for _, e in ordered[-n:]]


def select_pyramid_levels(channels, strides, n: int) -> list[int]:
    """:func:`select_pyramid_endpoints`' rule on a backbone's
    ``endpoint_channels`` and ``endpoint_strides``: the widths of the
    endpoints that rule will hand a head of ``n`` levels, fine -> coarse,
    so the head can be built for the tensors it will be fed."""
    channels, strides = list(channels), list(strides)
    if len(channels) != len(strides):
        raise ValueError(f"{len(channels)} endpoint widths but {len(strides)} strides")
    # an endpoint without a stride (EVA's class token) is no map
    spatial = [(ch, s) for ch, s in zip(channels, strides) if s is not None]
    if len(spatial) < n:
        return channels[-n:]
    by_stride: dict = {}
    for ch, s in spatial:  # the last one at a resolution wins
        by_stride[s] = ch
    if len(by_stride) < n:
        return channels[-n:]
    return [by_stride[s] for s in sorted(by_stride)][-n:]
