"""Evaluation example (counterpart of ``examples/eval_seg.py``): restore a
checkpoint written by ``train_seg`` and compute mIoU over a labelled
(images/, labels/) directory with the full inference engine (multi-scale +
flip, sliding window, shape buckets). Reading PNGs needs PIL.

Differences from the JAX example: ``--device`` (default ``cuda``; ``cpu``
runs here) replaces ``--cpu``, and there is no device count to fit to the
batch (one card). ``--weights_h5`` takes a flat full-model ``.h5`` keyed by
flax path (``save_h5_weights`` of either package writes one; reading it
needs h5py), matched by the heuristic name matcher; an unmatched parameter
stops the run.

Examples:
  # VOC val, multi-scale + flip
  python -m iseg_tpu_torch.examples.eval_seg --data_dir /data/voc_val --num_class 21 \\
      --backbone resnet50 --head aspp --ckpt_dir /tmp/iseg_tpu_torch_ckpt \\
      --scales 0.5,0.75,1.0,1.25,1.5,1.75 --flip --bucket 32
"""

from __future__ import annotations

import argparse
import json
import os

from iseg_tpu_torch.examples.train_seg import HEADS, build_model


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True, help="dir with images/ and labels/ subdirs")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--backbone_kwargs", default="{}")
    p.add_argument("--head", default="aspp", choices=HEADS)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--num_class", type=int, default=21)
    p.add_argument("--ignore_label", type=int, default=255)
    p.add_argument("--ckpt_dir", default=None, help="checkpoint dir written by train_seg")
    p.add_argument("--weights_h5", default=None,
                   help="full-model flat .h5 keyed by flax path")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--scales", default="1.0")
    p.add_argument("--flip", action="store_true")
    p.add_argument("--sliding", type=int, default=None,
                   help="sliding-window crop size (e.g. 512)")
    p.add_argument("--bucket", type=int, default=None,
                   help="pad eval shapes to multiples (a bounded set of input shapes for "
                        "variable-size val sets)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate and print one JSON line; returns the same dict."""
    args = parse_args(argv)
    if not (args.ckpt_dir or args.weights_h5):
        raise SystemExit("pass --ckpt_dir or --weights_h5")

    from iseg_tpu_torch.convert import batch_stats_tree, param_tree
    from iseg_tpu_torch.core.checkpoint import ModelHelper
    from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
    from iseg_tpu_torch.core.evaluation import evaluate
    from iseg_tpu_torch.core.model import SegModelInferenceConfig
    from iseg_tpu_torch.data import StandardAugmentationsPipeline
    from iseg_tpu_torch.data.loader import SegDirectoryDataset, batched_dataset

    env = common_env_setup(EnvConfig(random_seed=0, device=args.device))
    model = build_model(args.backbone, args.head, args.num_class, args.output_stride,
                        json.loads(args.backbone_kwargs), env.device,
                        ignore_label=args.ignore_label)
    variables = {"params": param_tree(model), "batch_stats": batch_stats_tree(model)}
    if args.ckpt_dir:
        helper = ModelHelper(args.ckpt_dir)
        variables = helper.restore_latest_variables(variables)
        if variables is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
        print(f"restored step {helper.all_steps()[-1]} from {args.ckpt_dir}")
    else:
        from iseg_tpu_torch.core.h5_ingest import load_h5_weights_by_name

        _, report = load_h5_weights_by_name(model, args.weights_h5)
        print(f"ingested {len(report['loaded'])} weights, {len(report['missing'])} unmatched")
        if report["missing"]:
            raise SystemExit(f"unmatched: {report['missing'][:6]}")

    config = SegModelInferenceConfig(
        scale_rates=tuple(float(s) for s in args.scales.split(",")),
        flip=args.flip,
        sliding_window_crop_size=(args.sliding, args.sliding) if args.sliding else None,
        bucket_multiple=args.bucket,
    )
    ds = SegDirectoryDataset(os.path.join(args.data_dir, "images"),
                             os.path.join(args.data_dir, "labels"))
    # native-size eval (crop_size=None disables the eval pad); shape variety
    # is handled by bucket_multiple / the sliding window
    pipe = StandardAugmentationsPipeline(training=False, crop_size=None)
    batches = batched_dataset(ds, args.batch, pipeline=pipe, drop_remainder=False)
    miou, per_class = evaluate(env, model, variables, batches, num_class=args.num_class,
                               ignore_label=args.ignore_label, inference_config=config)
    result = {
        "miou": round(float(miou), 5),
        "per_class_iou": [round(float(v), 5) for v in per_class],
        "images": len(ds),
        "config": {"scales": args.scales, "flip": args.flip, "sliding": args.sliding,
                   "bucket": args.bucket},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
