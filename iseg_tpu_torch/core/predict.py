"""Directory -> PNG prediction (counterpart of
``iseg_tpu/core/predict.py``).

Parity with the reference's ``core_predict.py:21`` ``predict_with_dir``
(file walk, pad/normalize preprocess, predict, crop-to-original + PNG
encode) and ``default_image_predict`` (:240). The calling convention is the
port's: a model module with its own weights (on the device it predicts
on), not the JAX package's ``apply_fn, variables``; the compute dtype is an
argument (autocast), not the model's dtype policy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from iseg_tpu_torch.core.model import SegModelInferenceConfig
from iseg_tpu_torch.data.input_norm import InputNormTypes, get_mean_pixel, normalize_input
from iseg_tpu_torch.data.loader import list_images, load_image, to_device
from iseg_tpu_torch.utils.buckets import bucket_hw


def default_image_predict(
    model,
    images: torch.Tensor,
    inference_config: Optional[SegModelInferenceConfig] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """images [N, H, W, 3] -> int32 class-id map [N, H, W]: the argmax
    (first index among equal logits, as ``jnp.argmax``) of
    ``model.inference`` averaged over the config's scales and flips, under
    autocast to ``compute_dtype`` (bf16 or fp16; other types run as they
    are)."""
    cfg = inference_config or SegModelInferenceConfig()
    with torch.autocast(images.device.type, dtype=compute_dtype,
                        enabled=compute_dtype in (torch.bfloat16, torch.float16)):
        logits = model.inference(images, cfg)
    return logits.argmax(dim=-1).to(torch.int32)


def predict_with_dir(
    model,
    input_dir: str,
    output_dir: str,
    batch_size: int = 1,
    pad_multiple: int = 32,
    norm: InputNormTypes = InputNormTypes.ZERO_MEAN,
    inference_config: Optional[SegModelInferenceConfig] = None,
    palette: Optional[Sequence[int]] = None,
    verbose: bool = True,
    per_image_buckets: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> list[str]:
    """Predict every image in ``input_dir`` to a label PNG in ``output_dir``
    (mode "L", or "P" with ``palette``); returns the written paths.

    Sizes come from the image headers; pixels are loaded per batch, padded
    with the mean pixel of ``norm`` up to the bucket, normalized, and a
    partial last batch is filled with copies of its last image. The
    predictions are cropped back to each image's size.
    ``per_image_buckets=False`` pads everything to one directory-max
    bucket; ``True`` groups the images by their own ``bucket_hw`` bucket
    (far less padded compute when the directory mixes sizes)."""
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError("PIL required for predict_with_dir") from e

    os.makedirs(output_dir, exist_ok=True)
    paths = list_images(input_dir)
    if not paths:
        return []
    device = next(model.parameters()).device

    # header-only size scan: decoding every image up front would hold
    # len(paths) * H * W * 12 bytes of host memory before the first batch
    sizes = []
    for p in paths:
        with PILImage.open(p) as im:
            sizes.append((im.height, im.width))
    mean_pixel = get_mean_pixel(norm)

    if per_image_buckets:
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (h, w) in enumerate(sizes):
            groups.setdefault(bucket_hw(h, w, pad_multiple), []).append(i)
    else:
        groups = {bucket_hw(max(s[0] for s in sizes), max(s[1] for s in sizes), pad_multiple):
                  list(range(len(paths)))}

    written = []
    n_done = 0
    for (bucket_h, bucket_w), indices in groups.items():
        for start in range(0, len(indices), batch_size):
            idx_chunk = indices[start:start + batch_size]
            chunk = [load_image(paths[i]) for i in idx_chunk]
            batch = np.empty((len(chunk), bucket_h, bucket_w, 3), np.float32)
            batch[:] = mean_pixel
            for i, img in enumerate(chunk):
                batch[i, :img.shape[0], :img.shape[1]] = img
            batch = normalize_input(batch, norm)
            # fill the final partial batch up to full size: one input shape
            if len(chunk) < batch_size:
                pad = np.repeat(batch[-1:], batch_size - len(chunk), axis=0)
                batch = np.concatenate([batch, pad], axis=0)

            preds = default_image_predict(model, to_device(batch, device), inference_config,
                                          compute_dtype).cpu().numpy()
            for i, src_idx in enumerate(idx_chunk):
                h, w = sizes[src_idx]
                out = PILImage.fromarray(preds[i, :h, :w].astype(np.uint8))  # mode "L"
                if palette:
                    out.putpalette(palette)  # mode "P"
                name = os.path.splitext(os.path.basename(paths[src_idx]))[0] + ".png"
                out_path = os.path.join(output_dir, name)
                out.save(out_path)
                written.append(out_path)
            n_done += len(idx_chunk)
            if verbose:
                print(f"predicted {n_done}/{len(paths)}", flush=True)
    return written
