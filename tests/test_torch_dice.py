"""The port's dice, mask, smooth-L1 and pixel-contrastive losses and
``l2_normalize`` against ``iseg_tpu``'s, on the same numpy inputs, on the
CPU.

Tolerances: values rtol 1e-5 in fp32 (sums over a few thousand pixels in
another order), gradients to 1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.losses import common as jcommon
from iseg_tpu.losses import dice as jdice
from iseg_tpu.ops.numerics import l2_normalize as j_l2_normalize
from iseg_tpu_torch.losses import (dice_loss, mask_loss, pixel_contrastive_loss,
                                   smooth_l1_loss)
from iseg_tpu_torch.ops.numerics import l2_normalize

torch.set_num_threads(1)

C = 6


def _data(ignore_label=255, seed=0, shape=(2, 12, 10)):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(*shape, C)).astype(np.float32)
    low = 1 if ignore_label == 0 else 0
    labels = rng.randint(low, C + low, shape)
    labels = np.where(rng.rand(*shape) < 0.15, ignore_label, labels).astype(np.int32)
    return logits, labels


def _grad_close(t_grad, j_grad, what=""):
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(t_grad.numpy(), j_grad, atol=1e-5 * np.abs(j_grad).max(),
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("ignore_label", [255, 0])
@pytest.mark.parametrize("from_logits", [True, False])
def test_torch_dice_loss_matches_jax(ignore_label, from_logits):
    """With ``ignore_label == 0`` the classes stored 1..C shift to channels
    0..C-1, as in the CE term."""
    logits, labels = _data(ignore_label)
    if not from_logits:
        logits = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    kw = dict(ignore_label=ignore_label, smooth=0.5, from_logits=from_logits)
    j_val, j_grad = jax.value_and_grad(
        lambda x: jdice.dice_loss(x, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    val = dice_loss(t, torch.tensor(labels), **kw)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    _grad_close(t.grad, j_grad)


def test_torch_dice_loss_label_outside_the_classes_matches_no_class():
    """A label in [C, ...) that is not ignored gets an all-zero one-hot row
    in both (``jax.nn.one_hot``), not an error."""
    logits, labels = _data()
    labels[0, 0, :3] = C + 2
    j = jdice.dice_loss(jnp.asarray(logits), jnp.asarray(labels))
    t = dice_loss(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_torch_dice_loss_resizes_labels_to_the_logits():
    logits, _ = _data(shape=(2, 6, 5))
    _, labels = _data(shape=(2, 12, 10), seed=1)
    j = jdice.dice_loss(jnp.asarray(logits), jnp.asarray(labels))
    t = dice_loss(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


@pytest.mark.parametrize("ignore_label", [255, 0])
@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.0, 2.0), (0.5, 0.0)],
                         ids=["both", "ce_only", "dice_only"])
def test_torch_mask_loss_matches_jax(ignore_label, weights):
    logits, labels = _data(ignore_label, seed=2)
    kw = dict(ignore_label=ignore_label, dice_weight=weights[0], ce_weight=weights[1])
    j_val, j_grad = jax.value_and_grad(
        lambda x: jdice.mask_loss(x, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    val = mask_loss(t, torch.tensor(labels), **kw)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    _grad_close(t.grad, j_grad)


@pytest.mark.parametrize("delta", [1.0, 0.3])
def test_torch_smooth_l1_loss_matches_jax(delta):
    rng = np.random.RandomState(3)
    pred, target = rng.randn(2, 7, 5, 4).astype(np.float32), rng.randn(2, 7, 5, 4)
    j_val, j_grad = jax.value_and_grad(
        lambda p: jcommon.smooth_l1_loss(p, jnp.asarray(target), delta))(jnp.asarray(pred))
    t = torch.tensor(pred, requires_grad=True)
    val = smooth_l1_loss(t, torch.tensor(target), delta)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    _grad_close(t.grad, j_grad)


@pytest.mark.parametrize("hw,max_samples", [((8, 8), 1024), ((45, 45), 1024), ((9, 7), 20)],
                         ids=["all_pixels", "ceil_stride", "few_samples"])
def test_torch_pixel_contrastive_loss_matches_jax(hw, max_samples):
    """Pixels at the ceiling-division stride (45 x 45 = 2025 pixels -> stride
    2, 1013 samples spread over the whole image, not the first 1024)."""
    rng = np.random.RandomState(4)
    feats = rng.randn(2, *hw, 8).astype(np.float32)
    labels = rng.randint(0, 3, (2, *hw))
    labels = np.where(rng.rand(2, *hw) < 0.2, 255, labels).astype(np.int32)
    kw = dict(temperature=0.2, max_samples=max_samples)
    j_val, j_grad = jax.jit(jax.value_and_grad(
        lambda f: jcommon.pixel_contrastive_loss(f, jnp.asarray(labels), **kw)))(
        jnp.asarray(feats))
    t = torch.tensor(feats, requires_grad=True)
    val = pixel_contrastive_loss(t, torch.tensor(labels), **kw)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    _grad_close(t.grad, j_grad)
    if hw == (45, 45):  # the bottom rows take part: their features get gradients
        assert float(t.grad[:, -1].abs().sum()) > 0


def test_torch_l2_normalize_matches_jax():
    x = np.random.RandomState(5).randn(3, 4, 6).astype(np.float32)
    x[0, 0] = 0.0  # the eps floor
    for dim in (-1, 1):
        np.testing.assert_allclose(l2_normalize(torch.tensor(x), dim=dim).numpy(),
                                   np.asarray(j_l2_normalize(jnp.asarray(x), axis=dim)),
                                   rtol=1e-6, atol=1e-7)
