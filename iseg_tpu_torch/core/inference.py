"""Inference engine: single-scale, multi-scale + flip, sliding-window,
and the sliding window sharded over the ranks of a data-parallel mesh
(counterpart of ``iseg_tpu/core/inference.py``).

Images and logits are NHWC like the model's boundary. ``apply_fn(images)
-> logits`` must return logits at its input's resolution. The window-start
grid and the overlap count map are host-side numpy constants of the static
shapes; the sweep is a Python loop over chunks of windows with plain
slices (PyTorch runs eagerly, so nothing is retraced).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from iseg_tpu_torch.ops.resize import resize_image, scaled_size


def sliding_start_indices(length: int, window: int, stride: int) -> list[int]:
    """Window start offsets covering [0, length) with a final snapped-to-end
    window."""
    if window >= length:
        return [0]
    stride = max(1, stride)
    starts = list(range(0, length - window + 1, stride))
    if starts[-1] != length - window:
        starts.append(length - window)
    return starts


def sliding_window_plan(
    image_hw: tuple[int, int],
    crop_size: tuple[int, int],
    stride_rate: float = 2.0 / 3.0,
) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """(starts [K,2], count_map [H,W,1], window_hw), all static."""
    if stride_rate > 1.0:
        # windows would leave gaps with count 0 -> 0/0 NaN logits
        raise ValueError(
            f"sliding_window stride_rate {stride_rate} > 1.0 leaves "
            "uncovered pixels between windows")
    h, w = image_hw
    wh, ww = min(crop_size[0], h), min(crop_size[1], w)
    hs = sliding_start_indices(h, wh, int(wh * stride_rate))
    ws = sliding_start_indices(w, ww, int(ww * stride_rate))
    starts = np.array([(i, j) for i in hs for j in ws], np.int32)
    counts = np.zeros((h, w, 1), np.float32)
    for i, j in starts:
        counts[i : i + wh, j : j + ww] += 1.0
    return starts, counts, (wh, ww)


def _chunk_weighted_starts(starts: np.ndarray, wb: int, multiple: int = 1) -> np.ndarray:
    """[K, 2] window starts -> [K'/wb, wb, 3] (y, x, weight) chunks, padded
    with zero-weight sentinel windows at (0, 0) so K' is a multiple of
    ``wb * multiple`` (``multiple`` > 1 for a sweep sharded over ranks)."""
    kk = len(starts)
    pad = (-kk) % (wb * multiple)
    return np.concatenate(
        [np.c_[starts, np.ones((kk, 1), np.int32)], np.zeros((pad, 3), np.int32)],
        axis=0,
    ).reshape(-1, wb, 3)


def inference_with_sliding_window(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    crop_size: tuple[int, int],
    stride_rate: float = 2.0 / 3.0,
    window_batch: int = 1,
) -> torch.Tensor:
    """Sliding-window logits: fp32 sum of the windows' logits over the
    overlap count.

    ``window_batch > 1`` folds that many windows into the batch dimension
    per model call. Every chunk has ``window_batch`` windows, so the model
    sees one batch shape; the last chunk is padded with zero-weight
    sentinel windows at (0, 0), whose logits are multiplied by 0 before
    they are added (eval-mode forwards are per-sample, so results do not
    depend on ``window_batch``)."""
    n, h, w, _ = images.shape
    starts, counts, (wh, ww) = sliding_window_plan((h, w), crop_size, stride_rate)
    if len(starts) == 1 and (wh, ww) == (h, w):
        return apply_fn(images)

    wb = max(1, min(int(window_batch), len(starts)))
    canvas = _sweep(apply_fn, images, _chunk_weighted_starts(starts, wb), (wh, ww))
    return canvas / torch.as_tensor(counts, device=canvas.device)[None]


def _sweep(apply_fn, images, chunks, window_hw) -> torch.Tensor:
    """fp32 canvas of the weighted logits of ``chunks`` ([k, wb, 3] (y, x,
    weight)) of windows of ``window_hw``, each chunk one model call."""
    n, h, w, _ = images.shape
    wh, ww = window_hw
    wb = chunks.shape[1]
    canvas = None
    for chunk in chunks:
        wins = [images[:, y : y + wh, x : x + ww] for y, x, _ in chunk]
        logits = apply_fn(torch.cat(wins, dim=0) if wb > 1 else wins[0]).to(torch.float32)
        if canvas is None:
            canvas = torch.zeros((n, h, w, logits.shape[-1]), dtype=torch.float32,
                                 device=logits.device)
        for i, (y, x, weight) in enumerate(chunk):
            canvas[:, y : y + wh, x : x + ww] += logits[i * n : (i + 1) * n] * float(weight)
    return canvas


def inference_with_sliding_window_sharded(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,
    crop_size: tuple[int, int],
    mesh,
    stride_rate: float = 2.0 / 3.0,
    axis: str = "data",
    window_batch: int = 1,
) -> torch.Tensor:
    """Sliding window with the window plan split over the ranks of
    ``mesh``'s ``axis``: every rank holds the whole ``images``, the plan is
    padded with zero-weight sentinel windows to a multiple of ranks x
    ``window_batch`` and cut into one contiguous block of chunks a rank;
    each rank sums its windows' logits on an fp32 canvas, the canvases are
    all-reduced and divided by the overlap counts. Every rank returns the
    logits. Without a mesh it is :func:`inference_with_sliding_window`'s
    sweep over the whole plan."""
    from iseg_tpu_torch.parallel.collectives import all_reduce_
    from iseg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

    n, h, w, _ = images.shape
    starts, counts, (wh, ww) = sliding_window_plan((h, w), crop_size, stride_rate)
    n_dev = axis_size(mesh, axis)
    wb = max(1, min(int(window_batch), -(-len(starts) // n_dev)))
    chunks = _chunk_weighted_starts(starts, wb, multiple=n_dev)
    per = len(chunks) // n_dev
    r = axis_rank(mesh, axis)
    canvas = _sweep(apply_fn, images, chunks[r * per:(r + 1) * per], (wh, ww))
    all_reduce_(canvas, axis_group(mesh, axis))
    return canvas / torch.as_tensor(counts, device=canvas.device)[None]


def inference_fn(
    apply_fn: Callable,
    images: torch.Tensor,
    sliding_window_crop_size: Optional[tuple[int, int]] = None,
    sliding_window_stride_rate: float = 2.0 / 3.0,
    sliding_window_batch: int = 1,
) -> torch.Tensor:
    """Dispatch direct vs sliding-window."""
    if sliding_window_crop_size is not None:
        return inference_with_sliding_window(
            apply_fn,
            images,
            sliding_window_crop_size,
            sliding_window_stride_rate,
            window_batch=sliding_window_batch,
        )
    return apply_fn(images)


def _resized_to_scale(images: torch.Tensor, scale_rate: float) -> torch.Tensor:
    """Bilinear resize to ``scale_rate`` (shared by the serial and the
    flip-pair paths, so both use the same scaling policy)."""
    if scale_rate == 1.0:
        return images
    sh, sw = scaled_size(images.shape[1], images.shape[2], scale_rate)
    return resize_image(images, (sh, sw), "bilinear")


def inference_with_scale(
    apply_fn: Callable,
    images: torch.Tensor,
    scale_rate: float,
    flipped: bool = False,
    **sliding_kwargs,
) -> torch.Tensor:
    """Resize -> (flip) -> infer -> unflip -> resize logits back."""
    h, w = images.shape[1], images.shape[2]
    x = _resized_to_scale(images, scale_rate)
    if flipped:
        x = x.flip(2)
    logits = inference_fn(apply_fn, x, **sliding_kwargs).to(torch.float32)
    if flipped:
        logits = logits.flip(2)
    if tuple(logits.shape[1:3]) != (h, w):
        logits = resize_image(logits, (h, w), "bilinear")
    return logits


def inference_with_scale_flip_pair(
    apply_fn: Callable,
    images: torch.Tensor,
    scale_rate: float,
    **sliding_kwargs,
) -> torch.Tensor:
    """Run the (identity, horizontal-flip) pair as ONE forward at 2x batch
    and return the SUM of the two logit maps (the caller counts 2 passes).

    Equal (up to fp reassociation) to two serial
    :func:`inference_with_scale` calls: the logit resize back to input
    resolution is bilinear, hence linear, so resize(l1 + unflip(l2)) ==
    resize(l1) + resize(unflip(l2))."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    x = _resized_to_scale(images, scale_rate)
    xx = torch.cat([x, x.flip(2)], dim=0)
    logits = inference_fn(apply_fn, xx, **sliding_kwargs).to(torch.float32)
    summed = logits[:n] + logits[n:].flip(2)
    if tuple(summed.shape[1:3]) != (h, w):
        summed = resize_image(summed, (h, w), "bilinear")
    return summed


def inference_with_multi_scales(
    apply_fn: Callable,
    images: torch.Tensor,
    scale_rates: Sequence[float] = (1.0,),
    flip: bool = False,
    flip_in_batch: bool = False,
    **sliding_kwargs,
) -> torch.Tensor:
    """Average fp32 logits over scales x flips. ``flip_in_batch=True``
    folds each scale's flip pair into one forward at double batch: half
    the model calls, the same results."""
    acc = None
    count = 0
    for scale in scale_rates:
        if flip and flip_in_batch:
            logits = inference_with_scale_flip_pair(apply_fn, images, scale, **sliding_kwargs)
            acc = logits if acc is None else acc + logits
            count += 2
            continue
        for flipped in ((False, True) if flip else (False,)):
            logits = inference_with_scale(apply_fn, images, scale, flipped=flipped,
                                          **sliding_kwargs)
            acc = logits if acc is None else acc + logits
            count += 1
    return acc / count
