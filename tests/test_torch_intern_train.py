"""The InternImage slice as a whole against ``iseg_tpu``: a narrow
InternImage (``dcn_sampling="auto"``, so every DCNv3 layer samples through
``dense_local_flat``) + ASPP (dropout 0) + the fused upsample + CE loss in
``SegManaged``, flax weights carried over by ``convert.load_flax``.

* 3 train steps (SGD, momentum, weight decay, poly decay) in float64 on
  both sides, drop-path 0: per-step losses rtol 1e-6, then the whole params
  and batch_stats trees rtol 1e-5 / atol 1e-6 (``to_flax`` returns
  float32). float64 because JAX's own fp32 gradients of a tiny model are a
  poor reference (see ``tests/test_torch_train.py``). The JAX sampler and
  both sides' effective offsets stay fp32 inside, which the tolerances
  absorb.
* ``inference`` with scales (0.75, 1.0), flip and a square sliding window
  against ``iseg_tpu.core.inference`` in fp32, atol 1e-4.

On the CPU the sampler and the loss are the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iseg_tpu.backbones.intern_image import InternImage as JInternImage
from iseg_tpu.core import inference as jinf
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu_torch.backbones.intern_image import InternImage as TInternImage
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax, unflatten
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.model import SegModelInferenceConfig
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP
from iseg_tpu_torch.ops.kernels import deform_local, upsample_ce

torch.set_num_threads(1)

SMALL = dict(channels=16, depths=(1, 1, 2, 1), groups=(1, 2, 4, 8), drop_path_rate=0.0,
             layer_scale=1.0, dcn_sampling="auto")
NUM_CLASS, HW, BATCH = 5, 96, 2
OPT = dict(learning_rate=0.01, train_steps=1000, weight_decay=1e-4)


def _slice_pair(fused=True):
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JInternImage(**SMALL), head=JASPP(filters=16, dropout_rate=0.0),
                     upsample_logits=not fused, fuse_upsample_loss=fused)
    bb = TInternImage(**SMALL)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb, head=TASPP(bb.out_channels, filters=16, dropout_rate=0.0),
                     upsample_logits=not fused, fuse_upsample_loss=fused)
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))
    # flax zeros the offset and modulation heads: give them values, so the
    # samplers leave the integer grid and the heads get real gradients
    rng = np.random.RandomState(1)
    flat = flatten(variables["params"])
    for path, a in flat.items():
        if "/offset_head/" in path or "/mask_head/" in path:
            flat[path] = (0.3 * rng.randn(*np.shape(a))).astype(np.float32)
    variables = {"params": unflatten(flat), "batch_stats": variables["batch_stats"]}
    load_flax(tm, variables)
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
    label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
    return jm, tm, variables, {"image": image, "label": label}


def test_torch_intern_slice_three_train_steps_match_jax():
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
    # CPU tensors take the plain versions: no kernel is launched
    assert upsample_ce.LAUNCH_COUNTS == deform_local.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx, _ = jopt.get_optimizer(variables["params"], "sgd", **OPT)
        j_state = j_create_train_state(jm, jax.random.PRNGKey(0), (BATCH, HW, HW, 3), j_tx,
                                       variables=variables)
        j_step = j_make_train_step(jm.build_loss_fn(), donate=False)
        j_batch = {"image": jnp.asarray(batch["image"], jnp.float64),
                   "label": jnp.asarray(batch["label"])}
        j_losses = []
        for _ in range(3):
            j_state, j_parts = j_step(j_state, j_batch, jax.random.PRNGKey(1))
            j_losses.append(float(j_parts["loss"]))
        j_trees = {"params": flatten(jax.tree_util.tree_map(np.asarray, j_state.params)),
                   "batch_stats": flatten(jax.tree_util.tree_map(np.asarray,
                                                                 j_state.batch_stats))}
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
    assert len(set(t_losses)) == 3
    assert t_state.step == int(j_state.step) == 3
    ours = to_flax(tm)
    for col, theirs in j_trees.items():
        mine = flatten(ours[col])
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{col}/{k}")
    # the sampler's inputs train: offset head, modulation head, layer scale
    before = flatten(variables["params"])
    for leaf in ("backbone/stage2_block1/dcn/offset_head/kernel",
                 "backbone/stage2_block1/dcn/mask_head/kernel",
                 "backbone/stage0_block0/gamma1"):
        assert np.abs(flatten(ours["params"])[leaf] - np.asarray(before[leaf])).max() > 0, leaf


def test_torch_intern_slice_inference_matches_jax():
    jm, tm, variables, batch = _slice_pair(fused=False)
    cfg = dict(scale_rates=(0.75, 1.0), flip=True, sliding_window_crop_size=(64, 64))
    j_apply = jax.jit(lambda x: jm.apply(variables, x, train=False))
    want = jinf.inference_with_multi_scales(j_apply, jnp.asarray(batch["image"]), **cfg)
    got = tm.inference(torch.tensor(batch["image"]), SegModelInferenceConfig(**cfg))
    assert tuple(got.shape) == want.shape == (BATCH, HW, HW, NUM_CLASS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # the fused model's low-res logits and loss, single scale
    jf, tf, variables, batch = _slice_pair(fused=True)
    j_logits = jax.jit(lambda v, x: jf.apply(v, x, train=False))(
        variables, jnp.asarray(batch["image"]))
    t_logits = tf.inference(torch.tensor(batch["image"]))
    assert tuple(t_logits.shape) == j_logits.shape == (BATCH, HW // 32, HW // 32, NUM_CLASS)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)
    j_loss, _ = jf.build_loss_fn()(j_logits, jnp.asarray(batch["label"]))
    t_loss, _ = tf.build_loss_fn()(t_logits, torch.tensor(batch["label"]))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)


def test_torch_intern_slice_initializes_and_trains_with_drop_path_and_remat():
    """Flax-style init from a generator and train steps in train mode with
    drop-path on, with and without recomputing the blocks: same losses."""
    losses = {}
    for remat in (False, True):
        bb = TInternImage(**dict(SMALL, drop_path_rate=0.3, remat=remat))
        tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                         head=TASPP(bb.out_channels, filters=16),
                         upsample_logits=False, fuse_upsample_loss=True)
        tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
        state = create_train_state(tm, torch.Generator().manual_seed(0), tx)
        assert float(bb.stage0_block0.gamma2.detach().min()) == 1.0
        _, _, _, batch = _slice_pair()
        batch = {k: torch.tensor(v) for k, v in batch.items()}
        step = make_train_step(tm.build_loss_fn())
        losses[remat] = []
        for _ in range(2):
            state, parts = step(state, batch)
            losses[remat].append(float(parts["loss"]))
        assert np.isfinite(losses[remat]).all() and state.step == 2
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
