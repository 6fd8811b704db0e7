"""The slice as a whole against ``iseg_tpu``: a small ConvNeXt + FaPN in
``SegManaged`` with the fused upsample + CE loss, the flax weights carried
over by ``convert.load_flax``, trained three SGD steps in both packages; and
the zoo's reach through the registry and the example drivers.

* ConvNeXt (depths (1, 1, 1, 1), widths (16, 32, 48, 64), layer scales set
  to random values) + ``FAPN(filters=16)``, 5 classes, 64 x 96, batch 2,
  logits at os4, ``fuse_upsample_loss=True`` (on the CPU the kernels'
  plain sums; no kernel is launched): eval logits in fp32 to 1e-5 of max
  |logit| and their loss rtol 1e-5; then 3 SGD steps (momentum, weight
  decay, poly decay) in float64 on both sides: per-step losses rtol 1e-6,
  then the params tree rtol 1e-5 / atol 1e-6 (``to_flax`` returns
  float32). The JAX DCNv2 rounds its tap product to fp32 inside a float64
  run (``preferred_element_type``): ``keep_float64`` swaps in float64 there.
  After the first step the offset convs move off zero, and both packages
  then sample at fractional points with fp32 coordinates (a few fp32 ulps
  apart), well inside these tolerances;
* ``list_backbones()`` of the port equals the JAX package's; every name
  builds (on the meta device); ``train_seg.build_head`` builds all six
  heads for backbones of every endpoint layout, and ``eval_seg`` accepts
  them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.convnext import ConvNeXt as JConvNeXt
from iseg_tpu.backbones.registry import list_backbones as j_list_backbones
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn import dcn as jdcn
from iseg_tpu.nn.heads.fapn import FAPN as JFAPN
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones.convnext import ConvNeXt as TConvNeXt
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.examples import eval_seg, train_seg
from iseg_tpu_torch.nn.heads import FAPN as TFAPN
from iseg_tpu_torch.nn.heads.common import select_pyramid_levels
from iseg_tpu_torch.ops.kernels import upsample_ce
from torch_zoo_helpers import keep_float64, randomize

torch.set_num_threads(1)

SMALL = dict(depths=(1, 1, 1, 1), dims=(16, 32, 48, 64))
HW, BATCH, NUM_CLASS = (64, 96), 2, 5
OPT = dict(learning_rate=0.01, train_steps=1000, weight_decay=1e-4)


def _slice_pair():
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JConvNeXt(**SMALL), head=JFAPN(filters=16),
                     upsample_logits=False, fuse_upsample_loss=True)
    bb = TConvNeXt(**SMALL)
    head = TFAPN(select_pyramid_levels(bb.endpoint_channels, bb.endpoint_strides, 4),
                 filters=16)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb, head=head, upsample_logits=False,
                     fuse_upsample_loss=True)
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))
    gammas = sorted({k.rsplit("/", 1)[0] for k in flatten(variables["params"])
                     if k.endswith("/gamma")})
    variables = randomize(variables, gammas, 0.5, seed=2)
    load_flax(tm, variables)
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, *HW, 3).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (BATCH, *HW))
    label = np.where(rng.rand(BATCH, *HW) < 0.1, 255, label).astype(np.int32)
    return jm, tm, variables, {"image": image, "label": label}


def test_torch_convnext_fapn_slice_eval_logits_and_loss_match_jax():
    jm, tm, variables, batch = _slice_pair()
    j_logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(batch["image"]))
    t_logits = tm.inference(torch.tensor(batch["image"]))
    assert tuple(t_logits.shape) == j_logits.shape == (BATCH, 16, 24, NUM_CLASS)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(j_logits)).max())
    j_loss, _ = jm.build_loss_fn()(j_logits, jnp.asarray(batch["label"]))
    upsample_ce.reset_launch_counts()
    t_loss, _ = tm.build_loss_fn()(t_logits, torch.tensor(batch["label"]))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert upsample_ce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}


def test_torch_convnext_fapn_slice_three_train_steps_match_jax(monkeypatch):
    jm, tm, variables, batch = _slice_pair()
    tm.double()
    t_tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    t_state = create_train_state(tm, None, t_tx, initialized=True)
    t_step = make_train_step(tm.build_loss_fn())
    t_batch = {"image": torch.tensor(batch["image"], dtype=torch.float64),
               "label": torch.tensor(batch["label"])}
    t_losses = []
    for _ in range(3):
        t_state, t_parts = t_step(t_state, t_batch)
        t_losses.append(float(t_parts["loss"]))
    keep_float64(monkeypatch, jdcn)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx, _ = jopt.get_optimizer(variables["params"], "sgd", **OPT)
        j_state = j_create_train_state(jm, jax.random.PRNGKey(0), (BATCH, *HW, 3), j_tx,
                                       variables=variables)
        j_step = j_make_train_step(jm.build_loss_fn(), donate=False)
        j_batch = {"image": jnp.asarray(batch["image"], jnp.float64),
                   "label": jnp.asarray(batch["label"])}
        j_losses = []
        for _ in range(3):
            j_state, j_parts = j_step(j_state, j_batch, jax.random.PRNGKey(1))
            j_losses.append(float(j_parts["loss"]))
        j_params = flatten(jax.tree_util.tree_map(np.asarray, j_state.params))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
    assert t_losses[2] != t_losses[0]
    mine = flatten(to_flax(tm)["params"])
    assert sorted(mine) == sorted(j_params)
    for k in j_params:
        np.testing.assert_allclose(mine[k], j_params[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # the DCNv2 offset convs left zero and trained, so the last steps deformed
    offsets = mine["head/align2/depack_l2/offset_conv/kernel"]
    assert np.abs(offsets).max() > 0


def test_torch_list_backbones_equals_jax_and_every_name_builds():
    names = list_backbones()
    assert names == j_list_backbones() and len(names) == 67
    with torch.device("meta"):
        for name in names:
            kw = {"input_size": 512} if name.startswith("mlp_mixer") else {}
            bb = get_backbone(name, **kw)
            assert len(bb.endpoint_channels) == len(bb.endpoint_strides), name
            assert bb.endpoint_channels[-1] == bb.out_channels, name
    with pytest.raises(KeyError, match="unknown backbone 'no_such_net'"):
        get_backbone("no_such_net")


PYRAMID_BACKBONES = {"convnext": ("convnext_tiny", {}), "efficientnet": ("efficientnetb0", {}),
                     "xception": ("xception65", dict(output_stride=16)), "moat": ("moat0", {}),
                     "hrnet": ("hrnet_w32", dict(stage_modules=(1, 1, 1, 1)))}


@pytest.mark.parametrize("key", sorted(PYRAMID_BACKBONES))
def test_torch_build_head_builds_every_head(key):
    """All six heads on backbones of every endpoint layout (a leading
    ``None``, repeated strides, HRNet's concat last). The Mixer's one
    endpoint takes the heads that read one map; the pyramid heads need
    three or four levels, in the JAX package as here."""
    name, kw = PYRAMID_BACKBONES[key]
    with torch.device("meta"):
        bb = get_backbone(name, **kw)
        for head in train_seg.HEADS:
            assert train_seg.build_head(head, bb).out_channels, (name, head)
        mixer = get_backbone("mlp_mixer_b16")
        assert train_seg.build_head("aspp", mixer).out_channels == 256
    for head in ("fapn", "nasfpn"):
        args = eval_seg.parse_args(["--data_dir", "d", "--head", head, "--backbone", name])
        assert args.head == head
