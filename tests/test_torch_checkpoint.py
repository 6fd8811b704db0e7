"""The port's ``ModelHelper`` (``torch.save`` in an atomic rename) against
the JAX package's orbax ``ModelHelper``: the same steps kept under
``max_to_keep``, and the behaviours of the JAX one: a round trip into the
live state (the module's own tensors, the momentum and its count), EMA
switched on or off between runs, ``restore_latest_variables`` preferring
the EMA, async saves; and a killed write ignored. On the CPU; values are
compared bitwise."""

import os
import types

import jax.numpy as jnp
import pytest
import torch
from torch import nn

from iseg_tpu.core.checkpoint import ModelHelper as JModelHelper
from iseg_tpu_torch.convert import batch_stats_tree, param_tree
from iseg_tpu_torch.core import checkpoint as tckpt
from iseg_tpu_torch.core.checkpoint import ModelHelper
from iseg_tpu_torch.core.optimizer import get_optimizer
from iseg_tpu_torch.core.train import create_train_state
from iseg_tpu_torch.nn.conv import ConvNormAct

torch.set_num_threads(1)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = ConvNormAct(3, 4, kernel_size=3)
        self.logits_conv = nn.Conv2d(4, 2, 1)

    def forward(self, x):
        return self.logits_conv(self.block(x))


def _state(seed=0, ema_decay=None):
    model = Tiny()
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.1, train_steps=10)
    return create_train_state(model, torch.Generator().manual_seed(seed), tx, ema_decay=ema_decay)


def _step(state, seed=0):
    """One SGD step on a fixed batch (moves params, momentum, BN stats)."""
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(seed))
    loss = state.model(x).square().mean()
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return state.apply_gradients(dict(zip(state.params, grads)))


def _assert_state_equal(a, b, ema=True):
    assert a.step == b.step
    for col in ("params", "batch_stats") + (("ema_params",) if ema else ()):
        ta, tb = getattr(a, col), getattr(b, col)
        assert list(ta) == list(tb)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), f"{col}/{k}"
    assert a.opt_state.count == b.opt_state.count
    for x, y in zip(a.opt_state.trace, b.opt_state.trace):
        assert torch.equal(x, y)


@pytest.mark.parametrize("async_save", [False, True])
def test_torch_checkpoint_round_trip_into_live_state(tmp_path, async_save):
    state = _state(ema_decay=0.9)
    for _ in range(3):
        state = _step(state)
    helper = ModelHelper(str(tmp_path), async_save=async_save)
    helper.save(state.step, state)
    helper.wait()
    other = _state(seed=1, ema_decay=0.9)  # other weights, step 0
    module_tensors = {k: v for k, v in other.params.items()}
    restored = ModelHelper(str(tmp_path)).restore_latest(other)
    assert restored is other and other.step == 3
    _assert_state_equal(state, other)
    # written into the module's own tensors: the model itself now holds them
    for k, v in param_tree(other.model).items():
        assert v is module_tensors[k] and torch.equal(v, state.params[k])
    for k, v in batch_stats_tree(other.model).items():
        assert torch.equal(v, state.batch_stats[k])
    # and training goes on from there alike
    _assert_state_equal(_step(state, 5), _step(other, 5))


def test_torch_checkpoint_restore_without_checkpoint_is_none(tmp_path):
    helper = ModelHelper(str(tmp_path / "new"))
    assert helper.restore_latest(_state()) is None
    assert helper.restore_latest_variables({"params": {}}) is None
    assert helper.all_steps() == [] and helper.latest_step() is None


def test_torch_checkpoint_max_to_keep_matches_orbax(tmp_path):
    j_helper = JModelHelper(str(tmp_path / "jax"), max_to_keep=2)
    t_helper = ModelHelper(str(tmp_path / "torch"), max_to_keep=2)
    j_state = types.SimpleNamespace(step=jnp.zeros((), jnp.int32), params={"w": jnp.ones(3)},
                                    batch_stats={}, opt_state={"c": jnp.zeros(())},
                                    ema_params=None)
    state = _state()
    kept = []
    for step in (1, 2, 5, 7):
        j_state.step = jnp.asarray(step, jnp.int32)
        j_helper.save(step, j_state)
        state.step = step
        t_helper.save(step, state)
        kept.append((list(t_helper.all_steps()), list(j_helper.all_steps())))
    for ours, theirs in kept:
        assert ours == sorted(theirs)
    assert kept[-1][0] == [5, 7]
    assert sorted(os.listdir(tmp_path / "torch")) == ["5", "7"]


def test_torch_checkpoint_ignores_a_killed_write(tmp_path):
    state = _state()
    helper = ModelHelper(str(tmp_path))
    state.step = 4
    helper.save(4, state)
    saved = {k: v.clone() for k, v in state.params.items()}
    # a write killed after creating its temporary directory, and one killed
    # half-way through the file: neither is a checkpoint
    for name in (".tmp-9-abc", ".tmp-12-def"):
        os.makedirs(tmp_path / name)
    (tmp_path / ".tmp-12-def" / tckpt.STATE_FILE).write_bytes(b"\x80\x02truncated")
    os.makedirs(tmp_path / "15")  # a step directory without its file
    assert helper.all_steps() == [4]
    other = _state(seed=3)
    assert helper.restore_latest(other).step == 4
    for k in saved:
        assert torch.equal(other.params[k], saved[k])
    # a new helper on the directory removes the temporaries
    ModelHelper(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["15", "4"]


def test_torch_checkpoint_same_step_saved_again_replaces(tmp_path):
    state = _state()
    helper = ModelHelper(str(tmp_path))
    helper.save(0, state)
    state = _step(state)
    state.step = 0
    helper.save(0, state)
    other = _state(seed=2)
    helper.restore_latest(other)
    _assert_state_equal(state, other, ema=False)


def test_torch_checkpoint_ema_switched_on(tmp_path):
    """Saved without EMA, restored into a state with EMA: the EMA starts from
    the restored params (the JAX helper seeds it the same way)."""
    state = _step(_state())
    ModelHelper(str(tmp_path)).save(1, state)
    other = _state(seed=4, ema_decay=0.99)
    ModelHelper(str(tmp_path)).restore_latest(other)
    _assert_state_equal(state, other, ema=False)
    for k in state.params:
        assert torch.equal(other.ema_params[k], state.params[k])
        assert other.ema_params[k] is not other.params[k]


def test_torch_checkpoint_ema_switched_off(tmp_path):
    state = _step(_state(ema_decay=0.5))
    ModelHelper(str(tmp_path)).save(1, state)
    other = _state(seed=4)
    ModelHelper(str(tmp_path)).restore_latest(other)
    assert other.ema_params is None
    _assert_state_equal(state, other, ema=False)


@pytest.mark.parametrize("ema", [False, True])
def test_torch_restore_latest_variables(tmp_path, ema):
    state = _step(_state(ema_decay=0.5 if ema else None))
    ModelHelper(str(tmp_path)).save(1, state)
    fresh = Tiny().double()
    template = {"params": param_tree(fresh), "batch_stats": batch_stats_tree(fresh)}
    variables = ModelHelper(str(tmp_path)).restore_latest_variables(template)
    assert sorted(variables) == ["batch_stats", "params"]
    want = state.ema_params if ema else state.params
    for k, v in variables["params"].items():
        assert v.dtype == torch.float64 and v is not template["params"][k]
        assert torch.equal(v, want[k].double())
    if ema:
        assert any(not torch.equal(state.ema_params[k], state.params[k]) for k in want)
    for k, v in variables["batch_stats"].items():
        assert torch.equal(v, state.batch_stats[k].double())
    only = ModelHelper(str(tmp_path)).restore_latest_variables({"params": template["params"]})
    assert list(only) == ["params"]


def test_torch_checkpoint_shape_mismatch_raises(tmp_path):
    state = _state()
    ModelHelper(str(tmp_path)).save(0, state)
    other = _state()
    path = next(iter(other.params))
    with torch.no_grad():
        other.params[path] = torch.zeros(1)
    with pytest.raises(ValueError, match="checkpoint params"):
        ModelHelper(str(tmp_path)).restore_latest(other)


def test_torch_checkpoint_async_error_surfaces_in_wait(tmp_path, monkeypatch):
    helper = ModelHelper(str(tmp_path), async_save=True)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", fail)
    helper.save(1, _state())
    with pytest.raises(OSError, match="disk full"):
        helper.wait()
    assert helper.all_steps() == []
