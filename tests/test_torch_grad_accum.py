"""Gradient accumulation in the port (``with_grad_accum``,
``CoreTrain(grad_accum_every=k)``) against ``iseg_tpu``'s, on the CPU; the
counterpart of ``tests/test_train.py``'s accumulation tests.

* k micro-steps of a BN-free model apply nothing for k - 1 of them, then
  one update equal to a step on the concatenated batch (rtol 1e-12 in
  float64), and equal to the JAX package's (rtol 1e-9);
* on a reduced ResNet + ASPP with SGD, a cosine schedule and an EMA, in
  float64 on both sides: params, EMA and BN statistics after every
  micro-step equal the JAX train step's (rtol 1e-5 / atol 1e-6, as the
  slice tests of ``tests/test_torch_train.py``); the params and the EMA
  stay put on the odd micro-steps, bit for bit, and move on the even ones;
  the BN statistics move on every one;
* ``CoreTrain`` checkpointed in the middle of an accumulation (a SIGTERM
  before the 4th batch: saved at micro-step 3) resumes to micro-step 6
  equal to the uninterrupted run bit for bit: params, EMA, BN statistics
  and every optimizer state (Adam's count and moments, the accumulator's
  running mean and mini-step); the logged learning rate reads the schedule
  at ``step // k``.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu_torch.backbones.resnet import ResNet as TResNet
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.checkpoint import ModelHelper
from iseg_tpu_torch.core.env import common_env_setup
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import CoreTrain, create_train_state, make_train_step
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP

torch.set_num_threads(1)


# ------------------------------------------------------------ BN-free model

def _mse(outputs, labels):
    loss = ((outputs - labels) ** 2).mean()
    return loss, {"loss": loss}


def test_torch_grad_accum_matches_big_batch_and_jax():
    rng = np.random.RandomState(0)
    big = {"image": rng.rand(8, 16), "label": rng.rand(8, 4)}
    w0, b0 = rng.randn(16, 4), rng.randn(4)

    def port(tx_fn, batches):
        model = nn.Linear(16, 4).double()
        with torch.no_grad():
            model.weight.copy_(torch.tensor(w0.T))
            model.bias.copy_(torch.tensor(b0))
        state = create_train_state(model, None, tx_fn(param_tree(model)), initialized=True)
        step = make_train_step(_mse)
        history = []
        for b in batches:
            state, _ = step(state, {k: torch.tensor(v) for k, v in b.items()})
            history.append(model.weight.detach().clone())
        return history

    def sgd(params):
        return topt.get_optimizer(params, "sgd", learning_rate=0.5, decay_strategy=None,
                                  sgd_momentum=0.0)[0]

    micro = [{k: v[2 * i: 2 * i + 2] for k, v in big.items()} for i in range(4)]
    accumulated = port(lambda p: topt.with_grad_accum(sgd(p), 4), micro)
    for w in accumulated[:3]:  # mid-accumulation: untouched
        assert torch.equal(w, torch.tensor(w0.T))
    (one_step,) = port(sgd, [big])
    np.testing.assert_allclose(accumulated[-1].numpy(), one_step.numpy(), rtol=1e-12)

    with jax.enable_x64(True):
        params = {"kernel": jnp.asarray(w0), "bias": jnp.asarray(b0)}
        tx = jopt.with_grad_accum(optax.sgd(0.5), 4)
        state = tx.init(params)
        for b in micro:
            g = jax.grad(lambda p: jnp.mean((b["image"] @ p["kernel"] + p["bias"] - b["label"])
                                            ** 2))(params)
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
        np.testing.assert_allclose(accumulated[-1].numpy().T, np.asarray(params["kernel"]),
                                   rtol=1e-9)


# ------------------------------------------------------------ a model with BN

SMALL_RESNET = dict(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True,
                    slim_stack=True, output_stride=16, multi_grid=(1, 2, 4))
NUM_CLASS, HW, BATCH, EVERY = 5, 32, 2, 2
# SGD with momentum and a cosine schedule here (Adam normalizes each step to
# about the LR, so the fp32 rounding of the logits both models take their
# loss from moves its float64 params by more: Adam itself is held at rtol
# 1e-9 in tests/test_torch_optimizer.py); no warmup, as optax's starts at
# LR 0 and the first real update would leave the params where they were
OPT = dict(name="sgd", learning_rate=0.05, train_steps=4, weight_decay=1e-2,
           decay_strategy="cosine")
# AdamW with a warmup for the CoreTrain run, held against itself bit for bit
ADAMW = dict(name="adamw", learning_rate=0.01, train_steps=3, weight_decay=1e-2,
             decay_strategy="cosine", warmup_steps=1)
EMA = 0.9


def _micro_batches(n):
    rng = np.random.RandomState(7)
    for _ in range(n):
        label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
        label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
        yield {"image": rng.rand(BATCH, HW, HW, 3), "label": label}


def _pair():
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JResNet(**SMALL_RESNET),
                     head=JASPP(filters=16, dropout_rate=0.0), upsample_logits=False,
                     fuse_upsample_loss=True)
    bb = TResNet(**SMALL_RESNET)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                     head=TASPP(bb.out_channels, filters=16, dropout_rate=0.0),
                     upsample_logits=False, fuse_upsample_loss=True)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, HW, HW, 3))))
    load_flax(tm, variables)
    return jm, tm, variables


def test_torch_grad_accum_ema_gate_and_steps_match_jax():
    jm, tm, variables = _pair()
    batches = list(_micro_batches(4))
    tm.double()
    tx = topt.with_grad_accum(topt.get_optimizer(param_tree(tm), **OPT)[0], EVERY)
    state = create_train_state(tm, None, tx, ema_decay=EMA, initialized=True)
    step = make_train_step(tm.build_loss_fn())
    ours = []
    for b in batches:
        before = ({k: v.clone() for k, v in state.params.items()},
                  {k: v.clone() for k, v in state.ema_params.items()},
                  {k: v.clone() for k, v in state.batch_stats.items()})
        state, _ = step(state, {"image": torch.tensor(b["image"]),
                                "label": torch.tensor(b["label"])})
        moved = [not all(torch.equal(a, b) for a, b in zip(old.values(), new.values()))
                 for old, new in zip(before, (state.params, state.ema_params,
                                              state.batch_stats))]
        ours.append((flatten(to_flax(tm)),
                     {k: v.detach().numpy().copy() for k, v in state.ema_params.items()},
                     moved))
    assert state.opt_state.gradient_step == 2 and state.opt_state.inner_opt_state.count == 2
    assert state.step == 4
    assert [m for _, _, m in ours] == [[False, False, True], [True, True, True]] * 2

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx = jopt.with_grad_accum(jopt.get_optimizer(v64["params"], **OPT)[0], EVERY)
        j_state = j_create_train_state(jm, jax.random.PRNGKey(0), (BATCH, HW, HW, 3), j_tx,
                                       ema_decay=EMA, variables=v64)
        j_step = j_make_train_step(jm.build_loss_fn(), donate=False)
        for b, (t_vars, t_ema, _) in zip(batches, ours):
            j_state, _ = j_step(j_state, {"image": jnp.asarray(b["image"]),
                                          "label": jnp.asarray(b["label"])},
                                jax.random.PRNGKey(1))
            theirs = {**{f"params/{k}": v for k, v in flatten(
                jax.tree_util.tree_map(np.asarray, j_state.params)).items()},
                **{f"batch_stats/{k}": v for k, v in flatten(
                    jax.tree_util.tree_map(np.asarray, j_state.batch_stats)).items()}}
            j_ema = flatten(jax.tree_util.tree_map(np.asarray, j_state.ema_params))
            assert sorted(t_vars) == sorted(theirs)
            for k in theirs:
                np.testing.assert_allclose(t_vars[k], theirs[k], rtol=1e-5, atol=1e-6, err_msg=k)
            for k in j_ema:
                want = j_ema[k]
                got = t_ema[k].transpose(2, 3, 1, 0) if t_ema[k].ndim == 4 else t_ema[k]
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ CoreTrain resume

def _u8_batches(epoch):
    rng = np.random.RandomState(epoch)
    for _ in range(6):
        yield {"image": rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
               "label": rng.randint(0, NUM_CLASS, (2, 32, 32)).astype(np.uint8)}


def _trainer(ckpt=None, log_dir=None):
    bb = TResNet(**SMALL_RESNET)
    model = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                        head=TASPP(bb.out_channels, filters=16, dropout_rate=0.3),
                        upsample_logits=False, fuse_upsample_loss=True)
    inner, sched = topt.get_optimizer(param_tree(model), **ADAMW)
    env = common_env_setup(device="cpu", mixed_precision=False)
    return CoreTrain(env, model, topt.with_grad_accum(inner, EVERY), seed=3,
                     log_every=1 if log_dir else 0, log_dir=log_dir, lr_schedule=sched,
                     checkpoint_manager=ModelHelper(ckpt) if ckpt else None,
                     ema_decay=0.99, grad_accum_every=EVERY)


def _flat_state(trainer):
    s = trainer.state
    o = s.opt_state
    inner = o.inner_opt_state
    tensors = {**{f"p/{k}": v for k, v in s.params.items()},
               **{f"e/{k}": v for k, v in s.ema_params.items()},
               **{f"b/{k}": v for k, v in s.batch_stats.items()},
               **{f"acc/{i}": v for i, v in enumerate(o.acc_grads)},
               **{f"mu/{i}": v for i, v in enumerate(inner.mu)},
               **{f"nu/{i}": v for i, v in enumerate(inner.nu)}}
    return tensors, (s.step, o.mini_step, o.gradient_step, inner.count)


def test_torch_core_train_resumes_mid_accumulation_exactly(tmp_path):
    full = _trainer(log_dir=str(tmp_path / "log"))
    full.train(_u8_batches, epochs=1, steps_per_epoch=6)

    def preempting(epoch):
        # two batches in flight: batch 3 (0-based) is drawn once step 2 has
        # run, and the loop stops after step 3, in the middle of an
        # accumulation
        for i, batch in enumerate(_u8_batches(epoch)):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    first = _trainer(str(tmp_path / "ckpt"))
    first.train(preempting, epochs=1, steps_per_epoch=6)
    assert first.checkpoint_manager.all_steps() == [3]
    assert first.state.opt_state.mini_step == 1
    resumed = _trainer(str(tmp_path / "ckpt"))
    assert resumed.restore() == 3
    assert resumed.state.opt_state.mini_step == 1 and resumed.state.opt_state.gradient_step == 1
    live = resumed.state.opt_state.acc_grads[0]
    resumed.train(_u8_batches, epochs=1, steps_per_epoch=6, initial_epoch=-1)
    assert resumed.state.opt_state.acc_grads[0] is live  # restored into, never rebound
    a, a_counts = _flat_state(resumed)
    b, b_counts = _flat_state(full)
    assert a_counts == b_counts == (6, 0, 3, 3)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    import csv

    with open(tmp_path / "log" / "scalars.csv") as f:
        rows = [r for r in csv.DictReader(f) if r["tag"] == "train/learning_rate"]
    sched = topt.get_optimizer({}, **ADAMW)[1]
    np.testing.assert_allclose([float(r["value"]) for r in rows],
                               [sched(s // EVERY) for s in range(1, 7)], rtol=1e-6)


# ------------------------------------------------------------ checkpoint states

def _state_leaves(value, prefix="opt_state"):
    """(path, tensor or int) of every leaf of a nested optimizer state."""
    import dataclasses

    if dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from _state_leaves(getattr(value, f.name), f"{prefix}/{f.name}")
    elif isinstance(value, dict):
        for k, v in value.items():
            yield from _state_leaves(v, f"{prefix}/{k}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _state_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, value


TX_KINDS = {
    "adam": lambda p: topt.get_optimizer(p, "adam")[0],
    "amsgrad": lambda p: topt.get_optimizer(p, "amsgrad")[0],
    "keras_adamw": lambda p: topt.get_optimizer(p, "adamw", keras_adam=True,
                                                weight_decay=1e-2)[0],
    "multi_optimizer": lambda p: topt.get_optimizer_list(
        p, ["bias", "kernel"], ["sgd", "amsgrad"], [0.1, 0.01]),
    "accum_multi_optimizer": lambda p: topt.with_grad_accum(topt.get_optimizer_list(
        p, ["bias", "kernel"], ["sgd", "adamw"], [0.1, 0.01], weight_decay=1e-2), 3),
}


@pytest.mark.parametrize("kind", sorted(TX_KINDS))
def test_torch_checkpoint_round_trips_each_optimizer_state(kind, tmp_path):
    """``ModelHelper`` saves every new state field by field (Adam's count,
    mu, nu and nu_hat; each group's state; the accumulator's running mean,
    mini-step and update count) and restores it into the live tensors."""
    rng = np.random.RandomState(0)

    def trained(steps):
        torch.manual_seed(0)
        model = nn.Linear(6, 3)
        state = create_train_state(model, None, TX_KINDS[kind](param_tree(model)),
                                   initialized=True, ema_decay=0.5)
        step = make_train_step(_mse)
        for _ in range(steps):
            state, _ = step(state, {"image": torch.tensor(rng.rand(4, 6), dtype=torch.float32),
                                    "label": torch.tensor(rng.rand(4, 3), dtype=torch.float32)})
        return state

    saved = trained(4)  # mid-accumulation for the accumulating kind
    ModelHelper(str(tmp_path)).save(saved.step, saved)
    fresh = trained(0)
    live = [v for _, v in _state_leaves(fresh.opt_state) if isinstance(v, torch.Tensor)]
    ModelHelper(str(tmp_path)).restore_latest(fresh)
    a, b = list(_state_leaves(saved.opt_state)), list(_state_leaves(fresh.opt_state))
    assert [k for k, _ in a] == [k for k, _ in b] and len(a) > 2
    for (k, x), (_, y) in zip(a, b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), k
    restored = [v for _, v in b if isinstance(v, torch.Tensor)]
    assert len(restored) == len(live) and all(u is v for u, v in zip(restored, live))
    for name in ("params", "ema_params"):
        for k, v in getattr(saved, name).items():
            assert torch.equal(v, getattr(fresh, name)[k]), (name, k)
