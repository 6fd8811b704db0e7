"""The port's optimizer and train step against ``iseg_tpu``'s.

* ``warmup_poly_decay`` and the SGD chain against optax, step by step;
* the slice as a whole: ``SegManaged`` (reduced ResNet + ASPP, fused
  upsample + CE loss, low-res logits) over 3 weight-synced train steps
  against ``iseg_tpu.core.train.make_train_step``: per-step losses, then
  the full params and batch_stats trees;
* fused vs unfused inside the port.

On the CPU. Tolerances: schedules rtol 1e-5 (Python float64 here, float32
in JAX, whose ``1 - p`` near the end of the decay keeps about 5e-6 of
relative error); optimizer updates rtol 1e-6 / atol 1e-7 (the same float32
arithmetic); the slice's 3 steps run in float64 on both sides (see that
test): losses rtol 1e-6, params and batch_stats rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu_torch.backbones.resnet import ResNet as TResNet
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.env import common_env_setup
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP

torch.set_num_threads(1)

# ------------------------------------------------------------------ schedule

SCHEDULES = {
    "poly": dict(base_learning_rate=0.01, decay_steps=100),
    "poly_warmup": dict(base_learning_rate=0.02, decay_steps=100, warmup_steps=10,
                        warmup_learning_rate=0.001, end_learning_rate=1e-4, power=0.9),
    "poly_warmup_ref_exact": dict(base_learning_rate=0.02, decay_steps=100, warmup_steps=10,
                                  ref_exact=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_torch_warmup_poly_decay_matches_jax(name):
    t = topt.warmup_poly_decay(**SCHEDULES[name])
    j = jopt.warmup_poly_decay(**SCHEDULES[name])
    for step in [0, 1, 5, 9, 10, 11, 50, 90, 99, 100, 150]:
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5, atol=1e-12)


# ------------------------------------------------------------------ SGD chain

PATHS = {
    "backbone/stem0/conv/kernel": (3, 3, 4, 8),
    "backbone/stem0/norm/scale": (8,),
    "backbone/stem0/norm/bias": (8,),
    "head/project/conv/kernel": (1, 1, 8, 6),
    "logits_conv/kernel": (1, 1, 6, 5),
    "logits_conv/bias": (5,),
}

SGD_CASES = {
    "plain": dict(),
    "weight_decay": dict(weight_decay=1e-2),
    "keras_momentum": dict(keras_momentum=True),
    "keras_momentum_weight_decay": dict(keras_momentum=True, weight_decay=1e-2),
    "clip_and_nan_scrub": dict(clip_norm=0.5, weight_decay=1e-3),
}


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_torch_sgd_chain_matches_optax(case):
    kw = dict(learning_rate=0.05, train_steps=10, warmup_steps=2, **SGD_CASES[case])
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in PATHS.items()}
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    # optax expects the nested tree the flax model would give
    j_tree = {}
    for path, v in j_params.items():
        node = j_tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    j_tx, _ = jopt.get_optimizer(j_tree, "sgd", **kw)
    j_state = j_tx.init(j_tree)
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    t_tx, _ = topt.get_optimizer(t_params, "sgd", **kw)
    t_state = t_tx.init(t_params)
    for step in range(3):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in PATHS.items()}
        if case == "clip_and_nan_scrub":
            grads["backbone/stem0/conv/kernel"][0, 0, 0, :2] = [np.nan, np.inf]
        g_tree = jax.tree_util.tree_map(jnp.asarray, _nest(grads))
        j_upd, j_state = j_tx.update(g_tree, j_state, j_tree)
        j_tree = optax.apply_updates(j_tree, j_upd)
        t_upd, t_state = t_tx.update({k: torch.tensor(v) for k, v in grads.items()},
                                     t_state, t_params)
        t_params = {k: t_params[k] + t_upd[k] for k in t_params}
        j_flat = flatten(jax.tree_util.tree_map(np.asarray, j_tree))
        for k in PATHS:
            np.testing.assert_allclose(t_params[k].numpy(), j_flat[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} at step {step}")


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_torch_weight_decay_mask_matches_jax_on_slice_paths():
    jm, tm, variables, _ = _slice_pair()
    j_mask = flatten(jopt.weight_decay_mask(variables["params"]))
    t_mask = topt.weight_decay_mask(param_tree(tm))
    assert t_mask == j_mask
    assert any(t_mask.values()) and not all(t_mask.values())


def test_torch_unported_optimizers_raise():
    # every optimizer and schedule of the JAX package is ported
    # (tests/test_torch_optimizer.py); unknown names raise as there
    topt.get_optimizer({}, "adamw")
    topt.get_optimizer({}, "sgd", decay_strategy="cosine")
    with pytest.raises(ValueError):
        topt.get_optimizer({}, "lamb")
    with pytest.raises(ValueError):
        topt.get_optimizer({}, "sgd", decay_strategy="exponential")


# ------------------------------------------------------------------ the slice

SMALL_RESNET = dict(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True,
                    slim_stack=True, output_stride=16, multi_grid=(1, 2, 4))
NUM_CLASS, HW, BATCH = 5, 64, 2


def _slice_pair(fused=True):
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JResNet(**SMALL_RESNET),
                     head=JASPP(filters=32, dropout_rate=0.0),
                     upsample_logits=not fused, fuse_upsample_loss=fused)
    bb = TResNet(**SMALL_RESNET)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                     head=TASPP(bb.out_channels, filters=32, dropout_rate=0.0),
                     upsample_logits=not fused, fuse_upsample_loss=fused)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
    load_flax(tm, variables)
    return jm, tm, variables, _batch()


def _batch():
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
    label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
    return {"image": image, "label": label}


OPT = dict(learning_rate=0.01, train_steps=1000, weight_decay=1e-4)


def test_torch_slice_three_train_steps_match_jax():
    """Both sides run the network in float64 (the logits are still cast to
    fp32 before the loss, as the model does). In fp32 the JAX reference is
    itself off its own float64 result by up to 10% on some stage-3
    gradients of this tiny model: at 4x4 features and batch 2, ReLU masks
    flip on fp32 rounding. In float64 the two agree to about 1e-6."""
    jm, tm, variables, batch = _slice_pair(fused=True)
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
    # losses: the fp32 loss of float64 logits, rounded alike on both sides
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
    assert t_state.step == int(j_state.step) == 3
    ours = to_flax(tm)
    for col, theirs in j_trees.items():
        mine = flatten(ours[col])
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            # to_flax returns float32: compare at float32 resolution
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{col}/{k}")


def test_torch_slice_eval_logits_match_jax():
    jm, tm, variables, batch = _slice_pair(fused=True)
    j_logits = np.asarray(jm.apply(variables, jnp.asarray(batch["image"]), train=False))
    t_logits = tm.inference(torch.tensor(batch["image"])).numpy()
    assert t_logits.shape == j_logits.shape == (BATCH, HW // 16, HW // 16, NUM_CLASS)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-4, rtol=1e-4)
    assert tm.training  # inference restores the training flag


def test_torch_slice_fused_matches_unfused():
    _, fused, variables, batch = _slice_pair(fused=True)
    _, unfused, _, _ = _slice_pair(fused=False)
    load_flax(unfused, variables)
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    losses = []
    for model in (fused, unfused):
        tx, _ = topt.get_optimizer(param_tree(model), "sgd", **OPT)
        state = create_train_state(model, None, tx, initialized=True)
        _, parts = make_train_step(model.build_loss_fn())(state, t_batch)
        losses.append(float(parts["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for k, v in flatten(to_flax(fused)["params"]).items():
        np.testing.assert_allclose(v, flatten(to_flax(unfused)["params"])[k], atol=1e-6,
                                   err_msg=k)


def test_torch_train_state_ema_tracks_params():
    _, tm, _, batch = _slice_pair()
    tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    state = create_train_state(tm, None, tx, ema_decay=0.5, initialized=True)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = make_train_step(tm.build_loss_fn())(
        state, {k: torch.tensor(v) for k, v in batch.items()})
    for k, p in state.params.items():
        torch.testing.assert_close(state.ema_params[k], 0.5 * before[k] + 0.5 * p.detach())
    assert state.eval_variables()["params"] is state.ema_params


def test_torch_env_setup(monkeypatch):
    env = common_env_setup(device="cpu", mixed_precision=False, random_seed=3)
    assert env.compute_dtype == torch.float32 and env.device.type == "cpu"
    assert env.generator.initial_seed() == 3
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert "tf32(matmul=False, cudnn=False)" in env.describe()
    assert common_env_setup(device="cpu").compute_dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common_env_setup(device="cuda")
