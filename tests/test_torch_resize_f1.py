"""Fault F1: no training-path resize of the port calls ``F.interpolate``,
whose CUDA backward adds with atomics (a run through it does not repeat
bit for bit). Every half-pixel bilinear resize takes interpolation
matrices (``ops/resize.py``), whose backward is two products in a fixed
order.

* one train step of each path that resized through ``F.interpolate``
  before, with ``F.interpolate`` patched to raise: the unfused loss at more
  than 64 classes and under OHEM (``core/model.py`` ``build_loss_fn``),
  ``upsample_logits`` (``SegManaged.forward``), SemanticFPN
  (``nn/heads/fpn.py``) and SimpleDecoder (``nn/heads/simpledecoder.py``);
  each twice from the same weights, ending bit for bit equal;
* ``resize_image``'s default bilinear against ``jax.image.resize(...,
  antialias=False)`` up- and down-sampling: float32 within 1e-6 of max
  |value|, float64 (under x64) within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iseg_tpu_torch.convert import param_tree
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.examples.train_seg import build_model
from iseg_tpu_torch.ops.resize import resize_image

torch.set_num_threads(1)

RESNET = {}
MBV2 = dict(width_multiplier=0.35, include_top_conv=False)

# (backbone, head, classes, backbone kwargs, model kwargs)
PATHS = {
    "unfused_loss_above_64_classes": ("resnet18", "aspp", 70, RESNET,
                                      dict(upsample_logits=False, fuse_upsample_loss=True)),
    "unfused_loss_under_ohem": ("resnet18", "aspp", 5, RESNET,
                                dict(upsample_logits=False, fuse_upsample_loss=True,
                                     use_ohem=True, ohem_min_kept=500)),
    "upsample_logits": ("resnet18", "aspp", 5, RESNET, dict(upsample_logits=True)),
    "semantic_fpn": ("resnet18", "fpn", 5, RESNET, dict(upsample_logits=True)),
    "simple_decoder": ("mobilenetv2", "simpledecoder", 5, MBV2, dict(upsample_logits=True)),
}


def _raise(*args, **kwargs):
    raise AssertionError("F.interpolate called on a training path")


def _run(name, seed=0):
    backbone, head, classes, bb_kwargs, kwargs = PATHS[name]
    torch.manual_seed(seed)
    model = build_model(backbone, head, classes, backbone_kwargs=bb_kwargs, device="cpu",
                        **kwargs)
    tx, _ = topt.get_optimizer(param_tree(model), "sgd", learning_rate=0.05, train_steps=10)
    state = create_train_state(model, torch.Generator().manual_seed(seed), tx)
    rng = np.random.RandomState(seed)
    batch = {"image": torch.tensor(rng.rand(2, 64, 64, 3), dtype=torch.float32),
             "label": torch.tensor(rng.randint(0, classes, (2, 64, 64)), dtype=torch.int32)}
    step = make_train_step(model.build_loss_fn(), seed=seed)
    losses = []
    for _ in range(2):
        state, parts = step(state, batch)
        losses.append(float(parts["loss"]))
    return losses, {k: v.detach().clone() for k, v in state.params.items()}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_torch_f1_train_path_takes_no_interpolate(name, monkeypatch):
    monkeypatch.setattr(F, "interpolate", _raise)
    losses, params = _run(name)
    assert np.isfinite(losses).all()
    again, params_again = _run(name)
    assert again == losses
    for k, v in params.items():
        assert torch.equal(v, params_again[k]), k


@pytest.mark.parametrize("size", [(23, 29), (5, 3), (16, 7)], ids=["up", "down", "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_torch_f1_resize_image_matches_jax_image_resize(size, dtype):
    x = np.random.RandomState(1).randn(2, 9, 11, 4).astype(dtype)
    got = resize_image(torch.tensor(x), size).numpy()
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 4), "bilinear",
                                           antialias=False))
    assert got.dtype == want.dtype == np.dtype(dtype)
    tol = 1e-6 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
