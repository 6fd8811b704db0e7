"""The ViT and EVA02 slices as a whole against ``iseg_tpu``: a small backbone
+ ``ASPP`` in ``SegManaged``, with the flax weights carried over by
``convert.load_flax``, trained a few steps in both packages.

* ViT + ASPP at 19 classes with ``fuse_upsample_loss=True``: the fused
  upsample + CE route (on the CPU its plain sums; no kernel is launched);
* EVA02 + ASPP at 150 classes with ``fuse_upsample_loss=True``: above 64
  classes both packages take the unfused resize + CE;
* each: eval-mode logits (fp32, 1e-5 of max |logit|) and their loss (rtol
  1e-5), then 2 train steps (SGD, momentum, weight decay, poly decay) in
  float64 on both sides with dropout at 0: per-step losses rtol 1e-6, then
  the params and BN statistics trees rtol 1e-5 / atol 1e-6 (``to_flax``
  returns float32), as ``tests/test_torch_swin_train.py`` holds Swin;
* ``train_seg --backbone vit_small_patch16 --head aspp`` with a narrow
  MLP (``--backbone_kwargs '{"mlp_ratio": 1.0, ...}'``; the variant fixes
  width, depth and heads, as in the JAX package), 2 steps on the CPU at
  32x32 (2x2 tokens).

The JAX package runs unchanged here: its fp32 softmax and pos-embed resize
inside a float64 run stay within these tolerances (the modules are held at
1e-9 in ``tests/test_torch_vit.py`` and ``tests/test_torch_eva.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.eva import Eva as JEva
from iseg_tpu.backbones.vit import VisionTransformer as JViT
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu_torch.backbones.eva import Eva as TEva
from iseg_tpu_torch.backbones.vit import VisionTransformer as TViT
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.examples import train_seg
from iseg_tpu_torch.losses import cross_entropy_ignore_label
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP
from iseg_tpu_torch.ops.kernels import upsample_ce
from iseg_tpu_torch.ops.resize import resize_image

torch.set_num_threads(1)

SMALL = dict(patch_size=16, dim=64, depth=2, num_heads=4, pretrain_grid=3)
HW, BATCH = (64, 96), 2
OPT = dict(learning_rate=0.01, train_steps=1000, weight_decay=1e-4)
SLICES = {"vit": (JViT, TViT, 19), "eva": (JEva, TEva, 150)}


def _slice_pair(name):
    jbb, tbb, num_class = SLICES[name]
    jm = JSegManaged(num_class=num_class, backbone=jbb(**SMALL),
                     head=JASPP(filters=16, dropout_rate=0.0),
                     upsample_logits=False, fuse_upsample_loss=True)
    bb = tbb(**SMALL)
    tm = TSegManaged(num_class=num_class, backbone=bb,
                     head=TASPP(bb.out_channels, filters=16, dropout_rate=0.0),
                     upsample_logits=False, fuse_upsample_loss=True)
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    load_flax(tm, variables)
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, *HW, 3).astype(np.float32)
    label = rng.randint(0, num_class, (BATCH, *HW))
    label = np.where(rng.rand(BATCH, *HW) < 0.1, 255, label).astype(np.int32)
    return jm, tm, variables, {"image": image, "label": label}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_torch_transformer_slice_eval_logits_and_loss_match_jax(name):
    jm, tm, variables, batch = _slice_pair(name)
    num_class = SLICES[name][2]
    j_logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(batch["image"]))
    t_logits = tm.inference(torch.tensor(batch["image"]))
    assert tuple(t_logits.shape) == j_logits.shape == (BATCH, HW[0] // 16, HW[1] // 16, num_class)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(j_logits)).max())
    j_loss, _ = jm.build_loss_fn()(j_logits, jnp.asarray(batch["label"]))
    labels = torch.tensor(batch["label"])
    upsample_ce.reset_launch_counts()
    t_loss, _ = tm.build_loss_fn()(t_logits, labels)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert upsample_ce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}
    if num_class > upsample_ce.MAX_FUSED_CLASSES:  # the unfused resize + CE, as in JAX
        unfused = cross_entropy_ignore_label(resize_image(t_logits, HW, "bilinear"), labels,
                                             num_classes=num_class)
        assert float(t_loss) == float(unfused)


@pytest.mark.parametrize("name", sorted(SLICES))
def test_torch_transformer_slice_two_train_steps_match_jax(name):
    jm, tm, variables, batch = _slice_pair(name)
    tm.double()
    t_tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    t_state = create_train_state(tm, None, t_tx, initialized=True)
    t_step = make_train_step(tm.build_loss_fn())
    t_batch = {"image": torch.tensor(batch["image"], dtype=torch.float64),
               "label": torch.tensor(batch["label"])}
    t_losses = []
    for _ in range(2):
        t_state, t_parts = t_step(t_state, t_batch)
        t_losses.append(float(t_parts["loss"]))
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx, _ = jopt.get_optimizer(variables["params"], "sgd", **OPT)
        j_state = j_create_train_state(jm, jax.random.PRNGKey(0), (BATCH, *HW, 3), j_tx,
                                       variables=variables)
        j_step = j_make_train_step(jm.build_loss_fn(), donate=False)
        j_batch = {"image": jnp.asarray(batch["image"], jnp.float64),
                   "label": jnp.asarray(batch["label"])}
        j_losses = []
        for _ in range(2):
            j_state, j_parts = j_step(j_state, j_batch, jax.random.PRNGKey(1))
            j_losses.append(float(j_parts["loss"]))
        j_trees = {"params": flatten(jax.tree_util.tree_map(np.asarray, j_state.params)),
                   "batch_stats": flatten(jax.tree_util.tree_map(np.asarray,
                                                                 j_state.batch_stats))}
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
    assert t_losses[1] != t_losses[0]
    ours = to_flax(tm)
    for col, theirs in j_trees.items():
        mine = flatten(ours[col])
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{col}/{k}")
    moved = flatten(ours["params"])["backbone/pos_embed"] - np.asarray(
        flatten(variables["params"])["backbone/pos_embed"])
    assert np.abs(moved).max() > 0  # the pos-embed trains through its resize


def test_torch_train_seg_trains_a_narrow_vit(tmp_path):
    result = train_seg.main([
        "--device", "cpu", "--backbone", "vit_small_patch16", "--head", "aspp",
        "--backbone_kwargs", '{"mlp_ratio": 1.0, "drop_path_rate": 0.1}', "--crop", "32",
        "--batch", "2", "--num_class", "3", "--epochs", "1", "--steps_per_epoch", "2",
        "--fused_loss", "--ckpt_dir", str(tmp_path)])
    assert result["step"] == 2 and np.isfinite(result["miou"])
    assert all(np.isfinite(r["loss"]) for r in result["history"])
