"""End-to-end verification drive (counterpart of ``tools/verify_drive.py``):
synthetic data -> augment pipeline -> ``CoreTrain`` with checkpoints ->
multi-scale + flip + sliding-window ``evaluate`` -> a fresh trainer
restores the last step with equal parameters.

MobileNetV2 (width 0.35, output stride 16, no top conv) + SimpleDecoder,
3 classes, 32x32 crops, batch 8, fp32 (the JAX drive's model has no
compute dtype), BN momentum 0.9 (short-run statistic settling), SGD at lr
0.2 with 5 warm-up steps over 5 x 20 steps; eval at scales (0.75, 1.0) +
flip with a 24x24 sliding window. It asserts mIoU > 0.7 and the restore.

  python -m iseg_tpu_torch.examples.verify_drive               # on the card
  python -m iseg_tpu_torch.examples.verify_drive --device cpu

``--epochs``, ``--steps_per_epoch`` and ``--min_miou`` shorten the drive
(a smoke run); the checkpoints go to ``--ckpt_dir``, a temporary directory
removed afterwards when it is not given.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

CROP, BATCH, NC = 32, 8, 3


def make(i):
    rng = np.random.RandomState(i)
    img = np.full((CROP + 8, CROP + 8, 3), 127.5, np.float32)
    img += rng.randn(*img.shape) * 4
    lab = np.zeros(img.shape[:2], np.int32)
    for k in range(1, NC):
        y, x = rng.randint(0, CROP, 2)
        s = rng.randint(8, 20)
        img[y:y + s, x:x + s] = 40 + (215 * k) // NC
        lab[y:y + s, x:x + s] = k
    return img, lab


def build_model(device):
    import torch

    from iseg_tpu_torch.backbones import get_backbone
    from iseg_tpu_torch.core.model import SegManaged
    from iseg_tpu_torch.nn.heads import SimpleDecoder

    bb = get_backbone("mobilenetv2", output_stride=16, width_multiplier=0.35,
                      include_top_conv=False)
    model = SegManaged(num_class=NC, backbone=bb, head=SimpleDecoder(bb.endpoint_channels))
    return model.to(device, memory_format=torch.channels_last)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--steps_per_epoch", type=int, default=20)
    p.add_argument("--min_miou", type=float, default=0.7)
    p.add_argument("--ckpt_dir", default=None)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.ckpt_dir is not None:
        return _drive(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory(prefix="iseg_verify_") as ckpt_dir:
        return _drive(args, ckpt_dir)


def _drive(args, ckpt_dir: str) -> dict:
    import torch

    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.checkpoint import ModelHelper
    from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
    from iseg_tpu_torch.core.evaluation import evaluate
    from iseg_tpu_torch.core.model import SegModelInferenceConfig
    from iseg_tpu_torch.core.optimizer import get_optimizer
    from iseg_tpu_torch.core.train import CoreTrain
    from iseg_tpu_torch.data import StandardAugmentationsPipeline
    from iseg_tpu_torch.nn import norm

    steps = args.epochs * args.steps_per_epoch
    env = common_env_setup(EnvConfig(random_seed=0, mixed_precision=False, device=args.device))
    print(f"env: {env.describe()}", flush=True)
    previous_momentum = norm._BN_MOMENTUM_OVERRIDE
    norm.set_bn_momentum(0.9)  # read when the BN layers are built
    try:
        model, fresh_model = build_model(env.device), build_model(env.device)
    finally:
        norm.set_bn_momentum(previous_momentum)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.2, train_steps=steps,
                          warmup_steps=5)
    pipe = StandardAugmentationsPipeline(training=True, crop_size=(CROP, CROP))
    epipe = StandardAugmentationsPipeline(training=False, crop_size=(CROP, CROP))

    def ds(epoch):
        for s in range(args.steps_per_epoch):
            pairs = [pipe(*make(epoch * 1000 + s * BATCH + k), sample_index=s * BATCH + k)
                     for k in range(BATCH)]
            yield {"image": np.stack([p[0] for p in pairs]),
                   "label": np.stack([p[1] for p in pairs])}

    def eds():
        for s in range(4):
            pairs = [epipe(*make(99000 + s * BATCH + k)) for k in range(BATCH)]
            yield {"image": np.stack([p[0] for p in pairs]),
                   "label": np.stack([p[1] for p in pairs])}

    trainer = CoreTrain(env, model, tx, checkpoint_manager=ModelHelper(ckpt_dir, max_to_keep=2),
                        log_every=20)
    trainer.restore()
    history = trainer.train(ds, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    miou, _ = evaluate(env, model, trainer.state.eval_variables(), eds(),
                       inference_config=SegModelInferenceConfig(
                           scale_rates=(0.75, 1.0), flip=True, sliding_window_crop_size=(24, 24)),
                       verbose=False)
    print("mIoU", miou, flush=True)
    if not miou > args.min_miou:
        raise AssertionError(f"mIoU {miou} is not above {args.min_miou}")
    t2 = CoreTrain(env, fresh_model, tx, checkpoint_manager=ModelHelper(ckpt_dir, max_to_keep=2))
    t2.restore()
    if t2.state.step != steps:
        raise AssertionError(f"restored step {t2.state.step}, expected {steps}")
    for k, v in trainer.state.params.items():
        if not torch.equal(t2.state.params[k], v):
            raise AssertionError(f"restored parameter {k} differs from the trained one")
    print("restore OK step", t2.state.step, flush=True)
    print("VERIFY_E2E_PASS", flush=True)
    return {"miou": float(miou), "step": t2.state.step,
            "losses": [r["loss"] for r in history]}


if __name__ == "__main__":
    main()
