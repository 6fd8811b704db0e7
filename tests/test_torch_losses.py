"""The port's losses (``iseg_tpu_torch.losses``) and the model's loss
plumbing (``SegFoundation.build_loss_fn``) against ``iseg_tpu``'s, on the
same numpy inputs.

fp32 on the CPU. Tolerances: losses rtol 1e-5 and gradients rtol 1e-5 /
atol 1e-7 (the same fp32 log-softmax, summed in another order); through
the model's loss function, gradients rtol 1e-4 / atol 1e-6, the fused
loss's tolerance (``test_torch_upsample_ce.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.losses import base as jbase
from iseg_tpu.losses import cross_entropy as jce
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.model import SegModelInferenceConfig as TSegModelInferenceConfig
from iseg_tpu_torch.losses import base as tbase
from iseg_tpu_torch.losses import cross_entropy as tce

torch.set_num_threads(1)

RTOL, GRAD_ATOL = 1e-5, 1e-7
C = 5


def _data(shape=(2, 6, 7), seed=0, ignore_label=255, label_shape=None):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(*shape, C)).astype(np.float32)
    label_shape = label_shape or shape
    labels = rng.randint(0, C, label_shape)
    if ignore_label == 0:
        labels = labels + 1  # classes stored as 1..C
    labels = np.where(rng.rand(*label_shape) < 0.2, ignore_label, labels)
    return logits, labels.astype(np.int32)


CE_CASES = {
    "valid_mean": dict(),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "all_mean": dict(reduction="all_mean"),
    "global_batch": dict(reduction="global_batch", global_batch_size=4),
    "class_weights": dict(class_weights=[0.5, 1.0, 2.0, 0.0, 1.5]),
    "focal": dict(use_focal=True),
    "focal_no_alpha": dict(use_focal=True, focal_alpha=None, focal_gamma=1.5),
    "label_smoothing": dict(label_smoothing=0.1),
    "ignore_label_0_shifts_classes": dict(ignore_label=0),
    "labels_at_twice_the_logits_size": dict(label_shape=(2, 12, 14)),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_torch_cross_entropy_ignore_label_matches_jax(case):
    kw = dict(CE_CASES[case])
    logits, labels = _data(ignore_label=kw.get("ignore_label", 255),
                           label_shape=kw.pop("label_shape", None))

    def t_loss(x):
        return tce.cross_entropy_ignore_label(x, torch.tensor(labels), **kw)

    def j_loss(x):
        return jce.cross_entropy_ignore_label(x, jnp.asarray(labels), **kw)

    x = torch.tensor(logits, requires_grad=True)
    t_out = t_loss(x)
    j_out = j_loss(jnp.asarray(logits))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=RTOL,
                               atol=GRAD_ATOL)
    (t_grad,) = torch.autograd.grad(t_out.sum(), x)
    j_grad = jax.grad(lambda v: j_loss(v).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=RTOL, atol=GRAD_ATOL)


def test_torch_softmax_focal_loss_matches_jax():
    logits, labels = _data()
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    one_hot = np.eye(C, dtype=np.float32)[np.where(labels == 255, 0, labels)]
    t = tce.softmax_focal_loss(torch.tensor(log_probs), torch.tensor(one_hot), gamma=1.5)
    j = jce.softmax_focal_loss(jnp.asarray(log_probs), jnp.asarray(one_hot), gamma=1.5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)


def test_torch_prepare_labels_and_valid_mask_match_jax():
    logits, labels = _data(label_shape=(2, 13, 9))
    t = tbase.prepare_labels(torch.tensor(labels[..., None]), torch.tensor(logits))
    j = jbase.prepare_labels(jnp.asarray(labels[..., None]), jnp.asarray(logits))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tbase.valid_mask(t, 255).numpy(),
                                  np.asarray(jbase.valid_mask(j, 255)))


def test_torch_cross_entropy_unported_options_raise():
    # OHEM and aux outputs are ported (tests/test_torch_ohem.py,
    # tests/test_torch_aux.py); a reduction missing its argument raises
    logits, labels = _data()
    with pytest.raises(ValueError):
        tce.cross_entropy_ignore_label(torch.tensor(logits), torch.tensor(labels),
                                       reduction="global_batch")
    assert TSegManaged(num_class=C, num_aux_loss=1).custom_losses_weights() == [1.0, 0.4]
    TSegManaged(num_class=C, use_ohem=True).build_loss_fn()


@pytest.mark.parametrize("field,value", [
    ("scale_rates", (0.75, 1.0)), ("flip", True), ("sliding_window_crop_size", (8, 8)),
    ("bucket_multiple", 32), ("use_cpu_cache", True), ("bucket_pad_value", 1.0),
])
def test_torch_inference_config_unported_fields_raise(field, value):
    # every field is ported and accepted now: multi-scale, flip and the
    # sliding window by SegBase.inference, the host-offloaded accumulator
    # and shape bucketing by evaluate (tests/test_torch_buckets.py)
    TSegModelInferenceConfig(scale_rates=[1.0])  # the default, given as a list
    assert getattr(TSegModelInferenceConfig(**{field: value}), field) == value


GATE_CASES = {
    # fused loss on low-res logits (the plain version on the CPU)
    "fused": dict(fuse_upsample_loss=True),
    # fusion requested but gated out: the low-res logits are upsampled first
    "gated_by_class_weights": dict(fuse_upsample_loss=True,
                                   class_weights=[1.0, 2.0, 0.5, 1.0, 1.0]),
    "gated_by_focal": dict(fuse_upsample_loss=True, use_focal_loss=True),
    "gated_by_reduction": dict(fuse_upsample_loss=True, loss_reduction="all_mean"),
    # no fusion: the loss runs at the logits' resolution on nearest labels
    "unfused_low_res": dict(),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_torch_build_loss_fn_gate_matches_jax(case):
    kw = GATE_CASES[case]
    logits, labels = _data(shape=(2, 4, 5), label_shape=(2, 16, 20))
    t_fn = TSegManaged(num_class=C, upsample_logits=False, **kw).build_loss_fn()
    j_fn = JSegManaged(num_class=C, upsample_logits=False, **kw).build_loss_fn()
    x = torch.tensor(logits, requires_grad=True)
    t_total, t_parts = t_fn(x, torch.tensor(labels))
    j_total, j_parts = j_fn(jnp.asarray(logits), jnp.asarray(labels))
    assert sorted(t_parts) == sorted(j_parts) == ["loss", "output_0_loss"]
    np.testing.assert_allclose(float(t_total.detach()), float(j_total), rtol=RTOL)
    (t_grad,) = torch.autograd.grad(t_total, x)
    j_grad = jax.grad(lambda v: j_fn(v, jnp.asarray(labels))[0])(jnp.asarray(logits))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-4, atol=1e-6)
