"""Train from pre-decoded shards (counterpart of
``examples/train_from_shards.py``).

Workflow:

  1. ``--prepare``: decode an (images/, labels/) directory once into
     fixed-shape uint8 npy shards (``iseg_tpu_torch.data.shards.write_shards``;
     reading PNGs needs PIL); without ``--data_dir`` a synthetic dataset is
     generated (numpy only), so this runs anywhere.
  2. train with either input mode:
     - ``--mode resident`` (default): upload the shards to the device once;
       every batch is a gather on the device + the device augment, and
       only a [batch] index vector crosses from the host per step. Use when
       the dataset fits the device (VOC at 512^2 uint8 is about 8.4 GB).
     - ``--mode stream``: memmap gather on the host + pinned-memory
       prefetch to the device, then the device augment.

Examples:
  python -m iseg_tpu_torch.examples.train_from_shards --prepare --shard_dir shards
  python -m iseg_tpu_torch.examples.train_from_shards --shard_dir shards --epochs 3
  python -m iseg_tpu_torch.examples.train_from_shards --shard_dir shards --device cpu \\
      --backbone resnet18 --store_size 64 --crop 48 --steps_per_epoch 2
"""

from __future__ import annotations

import argparse
import os

import numpy as np


class _SyntheticDataset:
    """Blob dataset (the recipe of the JAX package's example)."""

    def __init__(self, n, size, num_class):
        self.n, self.size, self.num_class = n, size, num_class

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(100003 + i)
        s = self.size
        img = np.full((s, s, 3), 127.5, np.float32)
        lab = np.zeros((s, s), np.int32)
        k = rng.randint(1, self.num_class)
        y, x = rng.randint(0, s // 2, 2)
        h, w = rng.randint(s // 4, s // 2, 2)
        img[y:y + h, x:x + w] = 60.0 + 40.0 * k
        lab[y:y + h, x:x + w] = k
        return img, lab


def build_model(backbone: str, head: str, num_class: int, device):
    """A fused-loss ``SegManaged`` of a registered backbone and a ported head
    (``train_seg.build_model``)."""
    from iseg_tpu_torch.examples import train_seg

    return train_seg.build_model(backbone, head, num_class, device=device,
                                 upsample_logits=False, fuse_upsample_loss=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prepare", action="store_true", help="write shards then exit")
    p.add_argument("--data_dir", default=None,
                   help="directory with images/ and labels/ (else synthetic)")
    p.add_argument("--shard_dir", default="iseg_shards_example")
    p.add_argument("--mode", choices=("resident", "stream"), default="resident")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backbone", default="resnet50", help="a registered backbone")
    p.add_argument("--head", default="aspp")
    p.add_argument("--store_size", type=int, default=128)
    p.add_argument("--crop", type=int, default=96)
    p.add_argument("--num_class", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--log_dir", default=None, help="TensorBoard/CSV scalar log directory")
    args = p.parse_args(argv)

    from iseg_tpu_torch.data.shards import ShardReader, write_shards

    if args.prepare or not os.path.exists(os.path.join(args.shard_dir, "index.json")):
        if args.data_dir:
            from iseg_tpu_torch.data.loader import SegDirectoryDataset

            dataset = SegDirectoryDataset(os.path.join(args.data_dir, "images"),
                                          os.path.join(args.data_dir, "labels"))
        else:
            dataset = _SyntheticDataset(64, args.store_size, args.num_class)
        index = write_shards(dataset, args.shard_dir,
                             store_size=(args.store_size, args.store_size))
        print(f"wrote {index['num_samples']} samples, {len(index['shards'])} shards -> "
              f"{args.shard_dir}")
        if args.prepare:
            return None

    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
    from iseg_tpu_torch.core.optimizer import get_optimizer
    from iseg_tpu_torch.core.train import CoreTrain
    from iseg_tpu_torch.data.device_augment import DeviceAugmentConfig, make_device_augment
    from iseg_tpu_torch.nn import norm

    norm.set_bn_momentum(0.9)  # short-run statistic settling (verify skill)
    env = common_env_setup(EnvConfig(device=args.device))
    print(f"env: {env.describe()}")
    model = build_model(args.backbone, args.head, args.num_class, env.device)
    train_steps = args.epochs * args.steps_per_epoch
    tx, schedule = get_optimizer(param_tree(model), "sgd", learning_rate=args.lr,
                                 train_steps=train_steps, warmup_steps=5)
    augment = make_device_augment(DeviceAugmentConfig(crop_size=(args.crop, args.crop),
                                                      ignore_label=255))
    resident = None
    if args.mode == "resident":
        from iseg_tpu_torch.data.resident import DeviceResidentDataset

        resident = DeviceResidentDataset(ShardReader(args.shard_dir), device=env.device)
        print(f"resident: {resident.num_samples} samples, {resident.nbytes() / 1e6:.1f} MB "
              "in device memory")
        dataset_fn = resident.index_dataset_fn(batch_size=args.batch)
    else:
        from iseg_tpu_torch.data.shards import make_shard_dataset_fn

        dataset_fn = make_shard_dataset_fn(args.shard_dir, batch_size=args.batch)

    trainer = CoreTrain(env, model, tx, device_augment=augment, log_every=10,
                        log_dir=args.log_dir, lr_schedule=schedule, resident_dataset=resident)
    history = trainer.train(dataset_fn, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch)
    print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
