"""The port's fused upsample + CE (``iseg_tpu_torch.ops.kernels.upsample_ce``)
against the JAX package's Pallas kernel (interpret mode on the CPU) and its
unfused reference. The CUDA kernel against the plain version is in
``test_torch_cuda_kernels.py``.

Tolerances: fp32 losses agree to rtol 1e-5 and gradients to rtol 1e-4 /
atol 1e-6 (the interpolation weights are formed in float32 here and in
float64 numpy matrices on the JAX side, and the sums run in another order).
bf16 inputs are upcast to fp32 by both sides before any arithmetic, so they
hold the fp32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops.pallas import upsample_ce as jax_uce
from iseg_tpu_torch.ops.kernels import upsample_ce as uce

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _data(n=2, h=4, w=4, c=5, hh=16, ww=16, seed=0, ignore_frac=0.2, ignore_label=255):
    rng = np.random.RandomState(seed)
    src = rng.randn(n, h, w, c).astype(np.float32)
    labels = rng.randint(0, c, (n, hh, ww))
    labels = np.where(rng.rand(n, hh, ww) < ignore_frac, ignore_label, labels)
    return src, labels.astype(np.int32)


def _torch_loss_and_grad(fn, src, labels, dtype=torch.float32, **kw):
    s = torch.tensor(src, dtype=dtype, requires_grad=True)
    loss = fn(s, torch.tensor(labels), **kw)
    (g,) = torch.autograd.grad(loss, s)
    return float(loss.detach()), g.float().numpy()


def _jax_loss_and_grad(fn, src, labels, dtype=jnp.float32, **kw):
    loss, g = jax.value_and_grad(lambda s: fn(s, jnp.asarray(labels), **kw))(
        jnp.asarray(src, dtype))
    return float(loss), np.asarray(g.astype(jnp.float32))


CASES = {
    "square_2x4x4x5_to_16": dict(n=2, h=4, w=4, c=5, hh=16, ww=16),
    "non_square_ratio_1x4x8x5_to_12x24": dict(n=1, h=4, w=8, c=5, hh=12, ww=24),
    "downsample_1x6x6x3_to_4x4": dict(n=1, h=6, w=6, c=3, hh=4, ww=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_fused_loss_and_grad_match_jax_kernel(case):
    src, labels = _data(**CASES[case])
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_reference_matches_jax_reference(case):
    src, labels = _data(**CASES[case])
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy_reference, src, labels)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy_reference, src, labels)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_matches_own_reference():
    src, labels = _data()
    f_loss, f_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    r_loss, r_grad = _torch_loss_and_grad(uce.upsample_cross_entropy_reference, src, labels)
    np.testing.assert_allclose(f_loss, r_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(f_grad, r_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_all_ignored_gives_zero_loss_and_grad():
    src, _ = _data()
    labels = np.full((2, 16, 16), 255, np.int32)
    loss, grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert loss == 0.0
    np.testing.assert_array_equal(grad, 0.0)


def test_torch_fused_squeezes_trailing_label_dim():
    src, labels = _data()
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels[..., None])
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src,
                                        labels[..., None], interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_bf16_input_matches_jax_kernel():
    src, labels = _data()
    src = np.asarray(jnp.asarray(src, jnp.bfloat16).astype(jnp.float32))  # bf16-exact
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                          dtype=torch.bfloat16)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        dtype=jnp.bfloat16, interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    # both gradients are rounded to bf16 (8 mantissa bits) at the end
    np.testing.assert_allclose(t_grad, j_grad, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("ignore_label", [255, 0])
def test_torch_fused_odd_labels_keep_kernel_semantics(ignore_label):
    """A label >= C that is not ignored has CE = lse; ignore_label=0 does
    not shift the classes. Both as the TPU kernel does."""
    src, labels = _data(c=5, ignore_label=ignore_label)
    labels[:, :2, :] = 7  # out of range, not ignored
    t_loss, t_grad = _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                          ignore_label=ignore_label)
    j_loss, j_grad = _jax_loss_and_grad(jax_uce.upsample_cross_entropy, src, labels,
                                        ignore_label=ignore_label, interpret=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_torch_fused_cpu_path_launches_no_kernel():
    src, labels = _data()
    uce.reset_launch_counts()
    _torch_loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert uce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}


def test_torch_fused_rejects_mismatched_target_hw():
    src, labels = _data()
    with pytest.raises(ValueError):
        uce.upsample_cross_entropy(torch.tensor(src), torch.tensor(labels), target_hw=(8, 8))
