"""Beam-search KV-cache reorder: ``out[b, i] = cache[b, parent[b, i]]``.

Counterpart of ``iseg_tpu/ops/pallas/cache_gather.py::beam_cache_gather``
(the Pallas slab-copy kernel). ``cache`` is ``[B, NB, *slab]`` of any dtype
and any trailing shape, ``parent`` ``[B, NB]`` int32 or int64 parent-beam
indices on the same device. The result is a permutation, with repeats, of
whole contiguous slabs: exact, and with no gradient (decode only).

On CUDA tensors the copy is the hand-written kernel of
``iseg_tpu_torch/csrc/cache_gather.cu`` (its note says what bounds it on the
H100); ``parent`` is read on the device, so the host never waits for it. On
CPU tensors the plain PyTorch version, :func:`beam_cache_gather_reference`
(one advanced-indexing gather), computes the same function. A CUDA tensor
never falls back to the plain version: a wrong device, index type or layout,
an ``out`` that overlaps ``cache``, or a failed build or launch raises.

A parent may appear twice, so the copy cannot run in place. A caller that
reorders every step keeps two buffers and swaps them, passing the idle one
as ``out``; without ``out`` the result is a new tensor.

``LAUNCH_COUNTS["gather"]`` counts kernel launches: one per launch, nowhere
else.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCH_COUNTS = {"gather": 0}

SOURCE = "cache_gather.cu"
_INDEX_CODES = {torch.int32: 0, torch.int64: 1}
_DOES_NOT_FIT = -1


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def build():
    """Compile (if needed) and load the CUDA library; returns the
    :class:`~iseg_tpu_torch.ops.kernels._build.Built` record."""
    from iseg_tpu_torch.ops.kernels import _build

    built = _build.load(SOURCE)
    lib = built.lib
    if not getattr(lib, "_iseg_bound", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.beam_cache_gather.argtypes = [ptr, ptr, ptr, i32, i64, i32, i64, i32, ptr]
        lib.beam_cache_gather.restype = i32
        lib._iseg_bound = True
    return built


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _check(cache: torch.Tensor, parent: torch.Tensor, out: torch.Tensor | None) -> None:
    """Checks common to both devices."""
    if cache.ndim < 2:
        raise ValueError(f"beam_cache_gather: cache {tuple(cache.shape)} must be [B, NB, *slab]")
    if tuple(parent.shape) != tuple(cache.shape[:2]):
        raise ValueError(f"beam_cache_gather: parent {tuple(parent.shape)} must be [B, NB] = "
                         f"{tuple(cache.shape[:2])}")
    if parent.dtype not in _INDEX_CODES:
        raise TypeError(f"beam_cache_gather takes int32 or int64 parent indices, "
                        f"got {parent.dtype}")
    if parent.device != cache.device:
        raise ValueError(f"beam_cache_gather: parent on {parent.device}, cache on {cache.device}")
    if not cache.is_contiguous():
        raise ValueError("beam_cache_gather takes a contiguous cache")
    if out is None:
        return
    if out.shape != cache.shape or out.dtype != cache.dtype or out.device != cache.device:
        raise ValueError(f"beam_cache_gather: out {tuple(out.shape)} {out.dtype} on {out.device} "
                         f"must match cache {tuple(cache.shape)} {cache.dtype} on {cache.device}")
    if not out.is_contiguous():
        raise ValueError("beam_cache_gather takes a contiguous out")
    lo, hi = out.data_ptr(), out.data_ptr() + _nbytes(out)
    if lo < cache.data_ptr() + _nbytes(cache) and cache.data_ptr() < hi:
        raise ValueError("beam_cache_gather: out overlaps cache; a parent may appear twice, "
                         "so the copy cannot run in place")


def copy_width(slab_bytes: int, *tensors: torch.Tensor) -> int:
    """Bytes a thread loads at once: the largest of 16, 8, 4, 2, 1 that
    divides the slab's byte count and every tensor's base address."""
    for width in (16, 8, 4, 2):
        if slab_bytes % width == 0 and all(t.data_ptr() % width == 0 for t in tensors):
            return width
    return 1


def _launch(cache: torch.Tensor, parent: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if not parent.is_contiguous():
        raise ValueError("beam_cache_gather kernel takes contiguous parent indices")
    if cache.numel() == 0:
        return out
    b, nb = cache.shape[:2]
    slab_bytes = _nbytes(cache) // (b * nb)
    lib = build().lib
    err = lib.beam_cache_gather(
        cache.data_ptr(), parent.data_ptr(), out.data_ptr(), _INDEX_CODES[parent.dtype],
        b, nb, slab_bytes, copy_width(slab_bytes, cache, out),
        torch.cuda.current_stream(cache.device).cuda_stream)
    if err == _DOES_NOT_FIT:
        raise ValueError(f"beam_cache_gather kernel: cannot launch cache {tuple(cache.shape)} "
                         f"{cache.dtype}")
    if err != 0:
        raise RuntimeError(f"beam_cache_gather kernel launch failed: CUDA error {err}")
    LAUNCH_COUNTS["gather"] += 1
    return out


def beam_cache_gather_reference(cache: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one advanced-indexing gather."""
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    return cache[rows, parent.long()]


def beam_cache_gather(cache: torch.Tensor, parent: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b, i] = cache[b, parent[b, i]]`` (see the module docstring).

    Args:
      cache: ``[B, NB, *slab]``, contiguous, any dtype.
      parent: ``[B, NB]`` int32 or int64, on cache's device, each index in
        ``[-NB, NB)``.
      out: optional buffer of cache's shape, dtype and device that does not
        overlap it; it is filled and returned.
    """
    _check(cache, parent, out)
    if cache.device.type == "cpu":
        result = beam_cache_gather_reference(cache, parent)
        return result if out is None else out.copy_(result)
    if cache.device.type == "cuda":
        return _launch(cache, parent, torch.empty_like(cache) if out is None else out)
    raise ValueError(f"beam_cache_gather: no kernel for device {cache.device}")
