"""The Swin slice as a whole against ``iseg_tpu``: a small Swin backbone +
``SemanticFPN`` + the fused upsample + CE loss in ``SegManaged``, with the
flax weights carried over by ``convert.load_flax`` (which consumes every
leaf of the tree or raises).

* eval-mode logits at output stride 4 (fp32, atol/rtol 2e-4: four stages
  of attention and LayerNorm, then the FPN's convs, each summing in another
  order);
* the fused loss of those logits (rtol 1e-5);
* 2 train steps (SGD, momentum, weight decay, poly decay) in float64 on
  both sides, drop-path 0: per-step losses rtol 1e-6, then the whole params
  and batch_stats trees rtol 1e-5 / atol 1e-6 (``to_flax`` returns float32).
  float64 because JAX's own fp32 gradients of a tiny model are a poor
  reference (see ``tests/test_torch_train.py``).

On the CPU the window attention is its plain version and the loss the
kernels' plain sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iseg_tpu.backbones.swin import SwinTransformer as JSwin
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn.heads.fpn import SemanticFPN as JSemanticFPN
from iseg_tpu_torch.backbones.swin import SwinTransformer as TSwin
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.nn.heads.fpn import SemanticFPN as TSemanticFPN
from iseg_tpu_torch.ops.kernels import upsample_ce, window_attention

torch.set_num_threads(1)

SMALL = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=7,
             drop_path_rate=0.0)
NUM_CLASS, HW, BATCH = 5, 64, 2
OPT = dict(learning_rate=0.01, train_steps=1000, weight_decay=1e-4)


def _slice_pair():
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JSwin(**SMALL),
                     head=JSemanticFPN(filters=16, fuse_filters=8),
                     upsample_logits=False, fuse_upsample_loss=True)
    bb = TSwin(**SMALL)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                     head=TSemanticFPN(bb.endpoint_channels[-4:], filters=16, fuse_filters=8),
                     upsample_logits=False, fuse_upsample_loss=True)
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))
    load_flax(tm, variables)
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
    label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
    return jm, tm, variables, {"image": image, "label": label}


def test_torch_swin_slice_eval_logits_and_fused_loss_match_jax():
    jm, tm, variables, batch = _slice_pair()
    j_logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(batch["image"]))
    t_logits = tm.inference(torch.tensor(batch["image"]))
    # five Swin endpoints reach the head; the logits come at output stride 4
    assert tuple(t_logits.shape) == j_logits.shape == (BATCH, HW // 4, HW // 4, NUM_CLASS)
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=2e-4, rtol=2e-4)
    j_loss, _ = jm.build_loss_fn()(j_logits, jnp.asarray(batch["label"]))
    t_loss, parts = tm.build_loss_fn()(t_logits, torch.tensor(batch["label"]))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert set(parts) == {"output_0_loss", "loss"}


def test_torch_swin_slice_two_train_steps_match_jax():
    jm, tm, variables, batch = _slice_pair()
    tm.double()
    t_tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    t_state = create_train_state(tm, None, t_tx, initialized=True)
    t_step = make_train_step(tm.build_loss_fn())
    t_batch = {"image": torch.tensor(batch["image"], dtype=torch.float64),
               "label": torch.tensor(batch["label"])}
    upsample_ce.reset_launch_counts()
    window_attention.reset_launch_counts()
    t_losses = []
    for _ in range(2):
        t_state, t_parts = t_step(t_state, t_batch)
        t_losses.append(float(t_parts["loss"]))
    # CPU tensors take the plain versions: no kernel is launched
    assert upsample_ce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}
    assert not any(window_attention.LAUNCH_COUNTS.values())
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx, _ = jopt.get_optimizer(variables["params"], "sgd", **OPT)
        j_state = j_create_train_state(jm, jax.random.PRNGKey(0), (BATCH, HW, HW, 3), j_tx,
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
    assert t_state.step == int(j_state.step) == 2
    ours = to_flax(tm)
    for col, theirs in j_trees.items():
        mine = flatten(ours[col])
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{col}/{k}")
    table = "backbone/stage2_block1/attn/relative_position_bias_table"
    assert np.abs(flatten(ours["params"])[table]
                  - np.asarray(flatten(variables["params"])[table])).max() > 0  # it trains


def test_torch_swin_slice_initializes_and_trains_with_drop_path():
    """Flax-style init from a generator (LayerNorm 1/0, table std 0.02) and
    a train step in train mode with the default drop-path rate."""
    bb = TSwin(**dict(SMALL, drop_path_rate=0.2))
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                     head=TSemanticFPN(bb.endpoint_channels[-4:], filters=16, fuse_filters=8),
                     upsample_logits=False, fuse_upsample_loss=True)
    tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    state = create_train_state(tm, torch.Generator().manual_seed(0), tx)
    table = bb.stage3_block0.attn.relative_position_bias_table.detach()
    assert 0.01 < float(table.std()) < 0.03 and float(bb.patch_norm.weight.detach().min()) == 1.0
    _, _, _, batch = _slice_pair()
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    step = make_train_step(tm.build_loss_fn())
    state, first = step(state, batch)
    state, second = step(state, batch)
    assert np.isfinite(float(first["loss"])) and np.isfinite(float(second["loss"]))
    assert state.step == 2
