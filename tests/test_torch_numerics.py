"""The rest of the port's numeric guards (``iseg_tpu_torch/ops/numerics.py``)
and its small copies (``core/result.py``, ``utils/shape.py``,
``static_strings.py``) against the JAX package's:

* ``check_numerics`` at levels 0, 1 and 2 (identity, a report of the
  non-finite count, then the scrub), ``replace_nan``, ``smart_where``;
* ``guard_grads``: identity forward, and its gradient, NaN and Inf
  scrubbed, equals the JAX custom VJP's;
* ``safed_softmax`` with and without a mask (a fully masked row gives
  zeros), values and input gradients in float64;
* ``CoreResult``, ``get_tensor_shape`` / ``get_hw`` and every constant of
  ``static_strings`` equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iseg_tpu.static_strings as jstrings
import iseg_tpu_torch.static_strings as tstrings
from iseg_tpu.core.result import CoreResult as JCoreResult
from iseg_tpu.ops import numerics as jnum
from iseg_tpu.utils import shape as jshape
from iseg_tpu_torch.core.result import CoreResult
from iseg_tpu_torch.ops import numerics as tnum
from iseg_tpu_torch.utils import shape as tshape

torch.set_num_threads(1)

BAD = np.array([[1.0, np.nan, -2.0], [np.inf, 0.5, -np.inf]], np.float32)


@pytest.fixture
def level():
    yield
    tnum.set_check_numerics_level(0)
    jnum.set_check_numerics_level(0)


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_torch_check_numerics_levels_equal_jax(lvl, level, capsys):
    tnum.set_check_numerics_level(lvl)
    jnum.set_check_numerics_level(lvl)
    assert tnum.get_check_numerics_level() == jnum.get_check_numerics_level() == lvl
    got = tnum.check_numerics(torch.tensor(BAD), "probe")
    want = np.asarray(jnum.check_numerics(jnp.asarray(BAD), "probe"))
    np.testing.assert_array_equal(got.numpy(), want)
    out = capsys.readouterr().out
    assert ("[check_numerics] probe: 3 non-finite values" in out) == (lvl >= 1)
    ints = torch.tensor([1, 2])
    assert tnum.check_numerics(ints) is ints  # integer tensors pass untouched


def test_torch_replace_nan_and_smart_where_equal_jax():
    np.testing.assert_array_equal(tnum.replace_nan(torch.tensor(BAD), 7.0).numpy(),
                                  np.asarray(jnum.replace_nan(jnp.asarray(BAD), 7.0)))
    np.testing.assert_array_equal(tnum.replace_non_finite(torch.tensor(BAD)).numpy(),
                                  np.asarray(jnum.replace_non_finite(jnp.asarray(BAD))))
    a, b = np.arange(6.0).reshape(2, 3), -np.ones((2, 3))
    cond = a > 2
    assert tnum.smart_where(True, "a", "b") == jnum.smart_where(True, "a", "b") == "a"
    assert tnum.smart_where(False, "a", "b") == "b"
    np.testing.assert_array_equal(
        tnum.smart_where(torch.tensor(cond), torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jnum.smart_where(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b))))


def test_torch_guard_grads_scrubs_gradients_as_jax():
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    upstream = np.array([np.nan, np.inf, -np.inf, 0.25], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnum.guard_grads(v) * upstream))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    out = tnum.guard_grads(t)
    torch.testing.assert_close(out.detach(), t.detach(), rtol=0, atol=0)
    (out * torch.tensor(upstream)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert np.isfinite(t.grad.numpy()).all()


@pytest.mark.parametrize("masked", [False, True])
def test_torch_safed_softmax_equals_jax(masked):
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5) * 4
    mask = rng.rand(3, 5) > 0.4 if masked else None
    if masked:
        mask[1] = False  # a fully masked row: zeros, not NaN
    weights = rng.randn(3, 5)
    with jax.enable_x64(True):
        jm = None if mask is None else jnp.asarray(mask)
        want_p = np.asarray(jnum.safed_softmax(jnp.asarray(logits), jm))
        jgrad = np.asarray(jax.grad(
            lambda v: jnp.sum(jnum.safed_softmax(v, jm) * weights))(jnp.asarray(logits)))
    t = torch.tensor(logits, requires_grad=True)
    got = tnum.safed_softmax(t, None if mask is None else torch.tensor(mask))
    (got * torch.tensor(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want_p, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=1e-12, atol=1e-15)
    if masked:
        assert (got.detach().numpy()[1] == 0).all()


def test_torch_small_copies_equal_jax():
    assert [f.name for f in dataclasses.fields(CoreResult)] == \
        [f.name for f in dataclasses.fields(JCoreResult)]
    assert dataclasses.asdict(CoreResult()) == dataclasses.asdict(JCoreResult())
    assert CoreResult("x", (1.0, 0.4), True) == CoreResult(name="x", loss_rates=(1.0, 0.4),
                                                           use_ohem=True)
    for arr in (np.zeros((2, 5, 7, 3)), np.zeros((5, 7, 3))):
        assert tshape.get_hw(torch.tensor(arr)) == jshape.get_hw(jnp.asarray(arr))
        assert tshape.get_tensor_shape(torch.tensor(arr)) == jshape.get_tensor_shape(arr)
    with pytest.raises(ValueError, match="rank 3/4"):
        tshape.get_hw(np.zeros((3, 3)))
    public = sorted(k for k in vars(jstrings) if not k.startswith("_"))
    assert public == sorted(k for k in vars(tstrings) if not k.startswith("_"))
    for k in public:
        assert getattr(tstrings, k) == getattr(jstrings, k), k
