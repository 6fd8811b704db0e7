"""End-to-end segmentation training example (counterpart of
``examples/train_seg.py``).

Covers BASELINE configs #1, #2 and #3: choose backbone, head, optimizer and
crop by flag.
With ``--data_dir`` pointing at (images/, labels/) directories it trains on
real data (reading PNGs needs PIL); without it, a synthetic shapes dataset
(numpy only) is generated, so the whole pipeline runs anywhere. It trains
with ``CoreTrain`` (checkpoints in ``--ckpt_dir``, resumed at the saved
step on a rerun), then evaluates the final weights to mIoU.

Differences from the JAX example: ``--device`` (default ``cuda``; ``cpu``
runs here) replaces ``--cpu``; the checkpoint directory defaults to
``/tmp/iseg_tpu_torch_ckpt`` (the two packages' checkpoint formats differ);
an MLP-Mixer backbone is built for ``--crop`` x ``--crop`` inputs unless
``--backbone_kwargs`` names its ``input_size`` (the JAX module takes the
size of its first call). ``--pretrained`` takes a published backbone
weight file (``.h5``, ``.keras`` or a TF checkpoint; reading one needs h5py
or TensorFlow) and fills the backbone by its family's name map; the head
keeps its seeded initialization, and a backbone parameter left unmatched
stops the run before it trains.

Examples:
  python -m iseg_tpu_torch.examples.train_seg --backbone mobilenetv2 --head simpledecoder \\
      --crop 512 --batch 8 --epochs 3
  python -m iseg_tpu_torch.examples.train_seg --backbone resnet50 --head aspp --ohem \\
      --data_dir /data/voc --num_class 21
  python -m iseg_tpu_torch.examples.train_seg --backbone hrnet_w48 --head jpu --num_class 19 \\
      --optimizer adamw --lr 1e-4 --fused_loss
  python -m iseg_tpu_torch.examples.train_seg --backbone convnext_large --head fapn \\
      --output_stride 32 --num_class 19 --fused_loss
  python -m iseg_tpu_torch.examples.train_seg --device cpu --crop 32 --batch 2 --num_class 3 \\
      --backbone_kwargs '{"width_multiplier": 0.35, "include_top_conv": false}' \\
      --epochs 1 --steps_per_epoch 2
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

HEADS = ("simpledecoder", "aspp", "fpn", "jpu", "fapn", "nasfpn")


def synthetic_dataset(num_samples, crop, num_class, seed=0):
    """Blob dataset: class k = a bright square of intensity band k."""
    def make(i):
        rng = np.random.RandomState(seed * 100003 + i)
        img = np.full((crop + 32, crop + 32, 3), 127.5, np.float32)
        img += rng.randn(*img.shape) * 4
        lab = np.zeros(img.shape[:2], np.int32)
        for k in range(1, num_class):
            y, x = rng.randint(0, crop, 2)
            s = rng.randint(12, 40)
            img[y : y + s, x : x + s] = 40 + (215 * k) // num_class
            lab[y : y + s, x : x + s] = k
        return img, lab

    return make


def build_head(name: str, backbone):
    """A head by flag name at the JAX drivers' defaults, sized from
    ``backbone``'s endpoints. The pyramid heads are sized by resolution, as
    their forward picks their inputs (HRNet lists its os4 concat after the
    os32 branch; ConvNeXt starts with a ``None``)."""
    from iseg_tpu_torch.nn import heads
    from iseg_tpu_torch.nn.heads.common import select_pyramid_levels

    if name == "simpledecoder":
        return heads.SimpleDecoder(backbone.endpoint_channels)
    if name == "aspp":
        return heads.ASPP(backbone.out_channels)
    levels = {"fpn": 4, "jpu": 3, "fapn": 4, "nasfpn": 3}
    if name not in levels:
        raise ValueError(f"head {name!r} is not ported to iseg_tpu_torch; choose from {HEADS}")
    widths = select_pyramid_levels(backbone.endpoint_channels, backbone.endpoint_strides,
                                   levels[name])
    return {"fpn": heads.SemanticFPN, "jpu": heads.JPU, "fapn": heads.FAPN,
            "nasfpn": heads.NASFPN}[name](widths)


def build_model(backbone: str, head: str, num_class: int, output_stride: int = 16,
                backbone_kwargs: dict | None = None, device="cuda", **model_kwargs):
    """``SegManaged(backbone + head)`` on ``device``, channels_last."""
    import torch

    from iseg_tpu_torch.backbones import get_backbone
    from iseg_tpu_torch.core.model import SegManaged

    bb = get_backbone(backbone, output_stride=output_stride, **(backbone_kwargs or {}))
    model = SegManaged(num_class=num_class, backbone=bb, head=build_head(head, bb),
                       **model_kwargs)
    return model.to(device, memory_format=torch.channels_last)


def ingest_pretrained(model, backbone: str, weights) -> dict:
    """Initialize ``model`` (a ``SegManaged``) from seed 0 as ``CoreTrain``
    would, then fill its backbone from ``weights`` (a path or a flat
    ``{name: array}`` mapping) by the family's name map; the head keeps its
    initialization. Raises ``SystemExit`` when a backbone parameter finds
    no weight, so a run never trains from a partial ingest. Returns the
    ingest report."""
    import torch

    from iseg_tpu_torch.backbones.pretrained import name_map_for
    from iseg_tpu_torch.convert import to_flax
    from iseg_tpu_torch.core.h5_ingest import load_h5_weights_by_name
    from iseg_tpu_torch.nn.initializers import initialize

    initialize(model, torch.Generator().manual_seed(0))
    map_fn = name_map_for(backbone)
    mapping = map_fn(to_flax(model)) if map_fn is not None else None
    _, report = load_h5_weights_by_name(model, weights, name_map=mapping)
    backbone_missing = [m for m in report["missing"] if "/backbone/" in m]
    print(f"pretrained ingest: {len(report['loaded'])} loaded, "
          f"{len(backbone_missing)} backbone params unmatched")
    if backbone_missing:
        raise SystemExit("unmatched backbone params, refusing to silently train from "
                         f"partial init: {backbone_missing[:6]}")
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--backbone", default="mobilenetv2")
    p.add_argument("--backbone_kwargs", default="{}",
                   help='JSON kwargs for get_backbone, e.g. \'{"width_multiplier": 0.35}\'')
    p.add_argument("--head", default="simpledecoder", choices=HEADS)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps_per_epoch", type=int, default=50)
    p.add_argument("--num_class", type=int, default=21)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--ohem", action="store_true")
    p.add_argument("--fused_loss", action="store_true",
                   help="use the fused upsample + CE CUDA kernels")
    p.add_argument("--data_dir", default=None,
                   help="dir with images/ and labels/ subdirs; synthetic if unset")
    p.add_argument("--pretrained", default=None,
                   help="published backbone weight file (.h5, .keras or TF checkpoint)")
    p.add_argument("--ckpt_dir", default="/tmp/iseg_tpu_torch_ckpt")
    p.add_argument("--eval_scales", default="1.0")
    p.add_argument("--flip_eval", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train, checkpoint and evaluate; returns the final step, mIoU,
    per-class IoU and the host-clock ms/step of the epochs after this run's
    first (host batch preparation and augment included)."""
    args = parse_args(argv)
    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.checkpoint import ModelHelper
    from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
    from iseg_tpu_torch.core.evaluation import evaluate
    from iseg_tpu_torch.core.model import SegModelInferenceConfig
    from iseg_tpu_torch.core.optimizer import get_optimizer
    from iseg_tpu_torch.core.train import CoreTrain
    from iseg_tpu_torch.data import StandardAugmentationsPipeline

    env = common_env_setup(EnvConfig(random_seed=0, device=args.device))
    print(f"env: {env.describe()}")
    backbone_kwargs = json.loads(args.backbone_kwargs)
    if args.backbone.startswith("mlp_mixer"):  # its token MLPs fix the input size
        backbone_kwargs.setdefault("input_size", args.crop)
    model = build_model(args.backbone, args.head, args.num_class, args.output_stride,
                        backbone_kwargs, env.device, use_ohem=args.ohem,
                        upsample_logits=not args.fused_loss,
                        fuse_upsample_loss=args.fused_loss)
    if args.pretrained:
        ingest_pretrained(model, args.backbone, args.pretrained)
    tx, schedule = get_optimizer(
        param_tree(model), args.optimizer, learning_rate=args.lr,
        train_steps=args.epochs * args.steps_per_epoch,
        warmup_steps=args.steps_per_epoch // 2,
        weight_decay=args.weight_decay,
    )

    train_pipe = StandardAugmentationsPipeline(training=True, crop_size=(args.crop, args.crop))
    eval_pipe = StandardAugmentationsPipeline(training=False, crop_size=(args.crop, args.crop))

    if args.data_dir:
        from iseg_tpu_torch.data.loader import SegDirectoryDataset, batched_dataset

        train_ds = SegDirectoryDataset(os.path.join(args.data_dir, "images"),
                                       os.path.join(args.data_dir, "labels"))

        def dataset_fn(epoch):
            return batched_dataset(train_ds, args.batch, pipeline=train_pipe, shuffle=True,
                                   epoch=epoch)

        def eval_fn():
            return batched_dataset(train_ds, args.batch, pipeline=eval_pipe)
    else:
        make = synthetic_dataset(1000, args.crop, args.num_class)

        def dataset_fn(epoch):
            for s in range(args.steps_per_epoch):
                pairs = [train_pipe(*make(epoch * 10000 + s * args.batch + k),
                                    sample_index=s * args.batch + k)
                         for k in range(args.batch)]
                yield {"image": np.stack([p[0] for p in pairs]),
                       "label": np.stack([p[1] for p in pairs])}

        def eval_fn():
            for s in range(8):
                pairs = [eval_pipe(*make(990000 + s * args.batch + k)) for k in range(args.batch)]
                yield {"image": np.stack([p[0] for p in pairs]),
                       "label": np.stack([p[1] for p in pairs])}

    trainer = CoreTrain(env, model, tx,
                        checkpoint_manager=ModelHelper(args.ckpt_dir, max_to_keep=2),
                        log_every=10, lr_schedule=schedule, initialized=bool(args.pretrained))
    resumed = trainer.restore()
    history = trainer.train(dataset_fn, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                            # exact-step resume: the epoch (and the consumed
                            # prefix of it) comes from the restored step count
                            initial_epoch=-1 if resumed else 0)

    miou, per_class = evaluate(
        env, model, trainer.state.eval_variables(), eval_fn(),
        inference_config=SegModelInferenceConfig(
            scale_rates=tuple(float(s) for s in args.eval_scales.split(",")),
            flip=args.flip_eval),
        verbose=False,
    )
    print(f"final mIoU: {miou:.4f}")
    print("per-class IoU:", np.round(per_class, 4).tolist())
    later = history[1:]
    ms_per_step = (1e3 * sum(r["seconds"] for r in later) / sum(r["steps"] for r in later)
                   if later and sum(r["steps"] for r in later) else None)
    return {"resumed_from": resumed, "step": trainer.state.step, "miou": float(miou),
            "per_class_iou": [float(v) for v in per_class], "ms_per_step": ms_per_step,
            "history": history}


if __name__ == "__main__":
    main()
