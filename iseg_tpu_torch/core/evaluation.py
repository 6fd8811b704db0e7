"""Evaluation loop (counterpart of ``iseg_tpu/core/evaluation.py``): an
eval loop with streaming mIoU over multi-scale + flip + sliding-window
inference.

Parity with the reference's ``evaluations/evaluation.py:19`` ``evaluate``
(custom loop, per-class IoU report at the end). The sweep runs eagerly
under ``torch.inference_mode()`` and the env's autocast. The config's
``use_cpu_cache`` (one pass per scale and flip, logits summed in pinned host
memory) and ``bucket_multiple`` (host batches padded up to the bucket grid
before they are sent to the device) are honoured here, as in the JAX
package. On a process group (``env.mesh``) every rank reads the whole
dataset and evaluates its slice of every global batch (``shard_batch``);
the confusion counts are all-reduced in int64, the loss is the global
valid-pixel mean, and rank 0 alone prints and writes the log.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from iseg_tpu_torch.convert import batch_stats_tree, param_tree
from iseg_tpu_torch.core.inference import inference_with_multi_scales, inference_with_scale
from iseg_tpu_torch.core.model import SegModelInferenceConfig
from iseg_tpu_torch.data.loader import device_prefetch
from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label
from iseg_tpu_torch.metrics.mean_iou import MeanIoU
from iseg_tpu_torch.parallel import collectives
from iseg_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_rank, shard_batch
from iseg_tpu_torch.utils.buckets import pad_batch_to_bucket


def variables_by_module_name(model: nn.Module, variables: dict) -> dict[str, torch.Tensor]:
    """Path-keyed ``{"params", "batch_stats"}`` (``convert.param_tree``
    paths, e.g. ``ModelHelper.restore_latest_variables``) -> ``{module
    state name: tensor}`` for ``torch.func.functional_call``. A collection
    left out keeps the module's own tensors; a path the model lacks, or one
    it has and the collection lacks, raises."""
    names = {id(t): n for n, t in itertools.chain(model.named_parameters(),
                                                   model.named_buffers())}
    out = {}
    for col, tree in (("params", param_tree(model)), ("batch_stats", batch_stats_tree(model))):
        given = variables.get(col)
        if given is None:
            continue
        if set(given) != set(tree):
            raise KeyError(f"{col} paths differ from the model's: missing "
                           f"{sorted(set(tree) - set(given))[:5]}, unexpected "
                           f"{sorted(set(given) - set(tree))[:5]}")
        for path, t in tree.items():
            out[names[id(t)]] = given[path]
    return out


def make_eval_step(model: nn.Module, inference_config: Optional[SegModelInferenceConfig] = None,
                   variables: Optional[dict] = None,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``eval_step(images) -> logits``: fp32 logits at the images'
    resolution, averaged over the config's scales and flips, each pass
    direct or by sliding window, with the model in eval mode (its training
    flag is restored after) under ``torch.inference_mode()`` and autocast
    to ``compute_dtype`` (bf16 or fp16; other types run as they are).

    ``variables`` (path-keyed, see :func:`variables_by_module_name`) are
    used in place of the model's own weights without writing them into it.
    Multi-scale and sliding-window passes need logits at the input's
    resolution (``upsample_logits=True``).

    With ``use_cpu_cache`` each (scale, flip) pass's fp32 logits are copied
    to host memory (pinned, for a CUDA device) and summed there in the JAX
    package's order, ``acc = l0; acc = acc + l1; ...; acc / count``: the
    device holds one pass at a time, and the step returns a CPU tensor.
    ``eval_step.seen_shapes`` collects the distinct input shapes."""
    cfg = inference_config or SegModelInferenceConfig()
    overrides = variables_by_module_name(model, variables) if variables is not None else None
    seen_shapes: set[tuple[int, ...]] = set()
    sliding = dict(sliding_window_crop_size=cfg.sliding_window_crop_size,
                   sliding_window_stride_rate=cfg.sliding_window_stride_rate,
                   sliding_window_batch=cfg.sliding_window_batch)

    def forward(x):
        out = functional_call(model, overrides, (x,)) if overrides else model(x)
        if isinstance(out, (list, tuple)):
            out = out[0]
        if isinstance(out, dict):
            out = out["output_0"]
        return out

    def cpu_cache_sweep(images: torch.Tensor) -> torch.Tensor:
        acc = staging = None
        count = 0
        for scale in cfg.scale_rates:
            for flipped in ((False, True) if cfg.flip else (False,)):
                logits = inference_with_scale(forward, images, scale, flipped=flipped, **sliding)
                if acc is None:
                    acc = _host_buffer(logits)
                    acc.copy_(logits)
                else:
                    if staging is None:
                        staging = _host_buffer(logits)
                    staging.copy_(logits)
                    acc += staging
                del logits  # the device holds one pass at a time
                count += 1
        return acc / count

    def eval_step(images: torch.Tensor) -> torch.Tensor:
        seen_shapes.add(tuple(images.shape))
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), torch.autocast(
                    images.device.type, dtype=compute_dtype,
                    enabled=compute_dtype in (torch.bfloat16, torch.float16)):
                if cfg.use_cpu_cache:
                    return cpu_cache_sweep(images)
                return inference_with_multi_scales(
                    forward, images, scale_rates=tuple(cfg.scale_rates), flip=cfg.flip,
                    flip_in_batch=cfg.flip_in_batch, **sliding)
        finally:
            model.train(was_training)

    eval_step.seen_shapes = seen_shapes
    return eval_step


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty CPU tensor of ``like``'s shape and dtype, pinned when
    ``like`` is on a CUDA device (a copy into it is a plain DMA)."""
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=like.device.type == "cuda")


def bucket_padder(multiple: int, pad_value: float, ignore_label: int) -> Callable[[dict], dict]:
    """Host-batch transform: pad ``image`` (with ``pad_value``, in the space
    the dataset yields) and ``label`` (with ``ignore_label``) up to the
    bucket grid of ``multiple``."""

    def pad(batch: dict) -> dict:
        image, label, _ = pad_batch_to_bucket(
            np.asarray(batch["image"]), np.asarray(batch["label"]), multiple=multiple,
            image_pad_value=pad_value, ignore_label=ignore_label)
        return {**batch, "image": image, "label": label}

    return pad


def evaluate(
    env,
    model: nn.Module,
    variables: Optional[dict],
    dataset: Iterable[dict],
    num_class: Optional[int] = None,
    ignore_label: Optional[int] = None,
    inference_config: Optional[SegModelInferenceConfig] = None,
    verbose: bool = True,
    compute_loss: bool = False,
    log_dir: Optional[str] = None,
    log_step: int = 0,
    metric: Optional[MeanIoU] = None,
):
    """Run eval over ``dataset`` yielding ``{"image", "label"}`` host
    batches (sent to ``env.device``; uint8 images become 0-255 floats);
    returns ``(mean_iou, per_class_iou)`` (reference ``evaluation.py:19-90``,
    which also streams a running loss: ``compute_loss``).

    ``variables`` is a path-keyed variables dict, or None for the model's
    own weights. ``metric`` is the ``MeanIoU`` to accumulate into (a new
    one when None), for a caller that reads the confusion matrix.
    ``log_dir`` writes the eval scalars (mIoU, per-class IoU, loss) to a
    TensorBoard event file + CSV at ``log_step``. With the config's
    ``bucket_multiple`` each host batch is padded up to the bucket grid
    before it is sent to the device; ``evaluate.last_num_programs`` is then
    the number of distinct input shapes the eval step saw."""
    num_class = num_class if num_class is not None else model.num_class
    ignore_label = ignore_label if ignore_label is not None else model.ignore_label
    eval_step = make_eval_step(model, inference_config, variables, env.compute_dtype)
    miou = metric if metric is not None else MeanIoU(num_class, ignore_label)

    cfg = inference_config or SegModelInferenceConfig()
    pad = (bucket_padder(cfg.bucket_multiple, cfg.bucket_pad_value, ignore_label)
           if cfg.bucket_multiple else None)
    mesh = getattr(env, "mesh", None)
    lead = axis_rank(mesh, DATA_AXIS) == 0  # rank 0 alone prints and logs
    transform = pad
    if mesh is not None:
        # each rank evaluates its slice of every global batch
        def transform(batch):
            return shard_batch(mesh, pad(batch) if pad is not None else batch)
        base_cm = miou.total_cm.copy()

    n_batches = 0
    loss_sum = 0.0
    for batch in device_prefetch(dataset, env.device, size=2, transform=transform):
        image = batch["image"]
        if not image.is_floating_point():
            image = image.to(torch.float32)
        # the CPU-cache sweep returns host logits: back beside the labels
        logits = eval_step(image).to(env.device)
        miou.update_state(batch["label"], logits)
        if compute_loss:
            # on a group each rank's share of the global valid-pixel mean
            # (``losses.base.global_valid_mean``); the ranks' mean below is it
            with collectives.data_parallel(mesh):
                loss_sum += float(cross_entropy_ignore_label(logits, batch["label"],
                                                             ignore_label=ignore_label))
        n_batches += 1
        if verbose and lead and n_batches % 50 == 0:
            msg = f"eval batch {n_batches}: running mIoU={miou.result():.4f}"
            if compute_loss:
                msg += f" loss={loss_sum / n_batches:.4f}"
            print(msg, flush=True)

    # the distinct padded shapes this eval saw (bucket accounting)
    evaluate.last_num_programs = len(eval_step.seen_shapes)
    if mesh is not None:
        # the ranks' confusion counts, summed exactly in int64
        group = axis_group(mesh, DATA_AXIS)
        mine = torch.as_tensor(np.rint(miou.total_cm - base_cm).astype(np.int64),
                               device=collectives.comm_device(group))
        miou.total_cm = base_cm + collectives.all_reduce_values(mine, group=group).cpu().numpy()
        loss_sum = float(collectives.all_reduce_values(
            torch.tensor([loss_sum], dtype=torch.float64,
                         device=collectives.comm_device(group)), "mean", group))

    per_class = miou.per_class_iou()
    if log_dir is not None and lead:
        from iseg_tpu_torch.utils.summary import ScalarLogger

        logger = ScalarLogger(log_dir)
        scalars = {"eval/mean_iou": float(miou.result())}
        if compute_loss and n_batches:
            scalars["eval/loss"] = loss_sum / n_batches
        for i, v in enumerate(per_class):
            scalars[f"eval/iou_class_{i}"] = float(v)
        logger.log(scalars, log_step)
        logger.close()
    if verbose and lead:
        print(f"eval done ({n_batches} batches): mIoU={miou.result():.4f}"
              + (f" loss={loss_sum / max(n_batches, 1):.4f}" if compute_loss else ""))
        for i, v in enumerate(per_class):
            print(f"  class {i}: IoU={v:.4f}")
    return miou.result(), per_class
