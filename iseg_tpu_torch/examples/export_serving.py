"""Export a segmentation model as a standalone serving artifact, then serve
it (counterpart of ``examples/export_serving.py``).

Builds a model (MobileNetV2 + SimpleDecoder by default), restores a
checkpoint when asked, writes its inference function with the weights
inside as a ``torch.export`` archive (``core.export.export_inference``),
and loads an archive WITHOUT any model code to serve a directory of images::

  python -m iseg_tpu_torch.examples.export_serving --out model.pt2 [--int8]
  python -m iseg_tpu_torch.examples.export_serving --serve model.pt2 --input imgs/

Without ``--ckpt`` the weights are drawn from seed 0. ``--int8`` stores the
weights as int8 + per-channel scales (a file of about a quarter of the
size). It runs on the card, where the artifact then serves; ``--cpu``
names the CPU. Reading ``--input`` images needs PIL, imported only then.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--backbone", default="mobilenetv2")
    p.add_argument("--num_class", type=int, default=21)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--ckpt", default=None, help="checkpoint dir to restore")
    p.add_argument("--out", default=None, help="write the artifact here")
    p.add_argument("--serve", default=None, help="load an artifact and serve")
    p.add_argument("--input", default=None, help="image dir for --serve")
    p.add_argument("--output", default="label", choices=["logits", "probs", "label"])
    p.add_argument("--int8", action="store_true", help="int8 weights in the artifact")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def serve(args) -> dict:
    """Load ``args.serve`` and serve ``args.input`` (or one zero image);
    imports no model code."""
    import numpy as np

    from iseg_tpu_torch.core.export import load_exported

    t0 = time.perf_counter()
    serve_fn = load_exported(args.serve)
    load_s = time.perf_counter() - t0
    shapes = {}
    if args.input:
        from PIL import Image

        for name in sorted(os.listdir(args.input)):
            img = np.asarray(Image.open(os.path.join(args.input, name)).convert("RGB")
                             .resize((args.size, args.size)), np.float32) / 127.5 - 1.0
            shapes[name] = tuple(serve_fn(img[None]).shape)
            print(name, shapes[name])
    else:
        pred = serve_fn(np.zeros((1, args.size, args.size, 3), np.float32))
        shapes["zeros"] = tuple(pred.shape)
        print("artifact OK, output shape:", shapes["zeros"])
    return {"load_s": load_s, "shapes": shapes}


def export(args) -> dict:
    """Build (and restore) the model and write ``args.out``."""
    import torch

    from iseg_tpu_torch.backbones import get_backbone
    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.export import export_inference
    from iseg_tpu_torch.core.model import SegManaged
    from iseg_tpu_torch.nn.heads import SimpleDecoder
    from iseg_tpu_torch.nn.initializers import initialize

    device = "cpu" if args.cpu else "cuda"
    bb = get_backbone(args.backbone, output_stride=16)
    model = SegManaged(num_class=args.num_class, backbone=bb,
                       head=SimpleDecoder(bb.endpoint_channels, filters=256))
    model = model.to(device, memory_format=torch.channels_last)
    initialize(model, torch.Generator().manual_seed(0))
    if args.ckpt:
        from iseg_tpu_torch.core.checkpoint import ModelHelper
        from iseg_tpu_torch.core.optimizer import get_optimizer
        from iseg_tpu_torch.core.train import create_train_state

        tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.0)
        state = create_train_state(model, torch.Generator().manual_seed(0), tx)
        if ModelHelper(args.ckpt).restore_latest(state) is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt}")
    out = args.out or "model.pt2"
    t0 = time.perf_counter()
    blob = export_inference(model, None, (args.size, args.size), output=args.output,
                            int8_weights=args.int8, path=out)
    seconds = time.perf_counter() - t0
    print(f"wrote {out} ({len(blob) / 1e6:.1f} MB, output={args.output}, "
          f"{'int8' if args.int8 else 'float'} weights, batch-polymorphic) in {seconds:.1f} s")
    return {"path": out, "bytes": len(blob), "export_s": seconds}


def main(argv=None) -> dict:
    args = parse_args(argv)
    return serve(args) if args.serve else export(args)


if __name__ == "__main__":
    main()
