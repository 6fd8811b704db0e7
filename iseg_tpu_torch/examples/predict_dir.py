"""Predict every image in a directory to label PNGs (counterpart of
``examples/predict_dir.py``; ``core.predict.predict_with_dir``). Reading
and writing PNGs needs PIL.

  python -m iseg_tpu_torch.examples.predict_dir --input_dir imgs/ --output_dir preds/ \\
      --backbone resnet50 --head aspp --ckpt_dir /tmp/iseg_tpu_torch_ckpt

With ``--ckpt_dir`` the weights come from its newest checkpoint, and a
directory without one is refused (predicting from random weights writes
garbage PNGs). ``--device`` (default ``cuda``; ``cpu`` runs here) is the
port's.
"""

from __future__ import annotations

import argparse

from iseg_tpu_torch.examples.train_seg import build_model


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--head", default="aspp", choices=("aspp", "simpledecoder"))
    p.add_argument("--num_class", type=int, default=21)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--scales", default="1.0")
    p.add_argument("--flip", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Predict and return the written paths."""
    args = parse_args(argv)

    import torch

    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.checkpoint import ModelHelper
    from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
    from iseg_tpu_torch.core.model import SegModelInferenceConfig
    from iseg_tpu_torch.core.optimizer import get_optimizer
    from iseg_tpu_torch.core.predict import predict_with_dir
    from iseg_tpu_torch.core.train import create_train_state

    env = common_env_setup(EnvConfig(device=args.device))
    model = build_model(args.backbone, args.head, args.num_class, args.output_stride,
                        device=env.device)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.0)
    state = create_train_state(model, torch.Generator().manual_seed(0), tx)
    if args.ckpt_dir:
        restored = ModelHelper(args.ckpt_dir).restore_latest(state)
        if restored is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
        print(f"restored checkpoint at step {restored.step}")

    written = predict_with_dir(
        model, args.input_dir, args.output_dir, batch_size=args.batch,
        inference_config=SegModelInferenceConfig(
            scale_rates=tuple(float(s) for s in args.scales.split(",")), flip=args.flip),
        compute_dtype=env.compute_dtype,
    )
    print(f"wrote {len(written)} predictions to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
