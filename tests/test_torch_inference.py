"""The port's inference engine against ``iseg_tpu.core.inference``.

The model is one small 3x3 conv (the same kernel on both sides, as
``apply_fn``), so the logits come at the window's resolution. Same numpy
images. fp32 on the CPU; tolerance atol 1e-5 / rtol 1e-5 (conv sums and
the canvas accumulate in another order; the plans are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iseg_tpu.core import inference as jinf
from iseg_tpu_torch.core import inference as tinf
from iseg_tpu_torch.core.model import SegManaged, SegModelInferenceConfig

torch.set_num_threads(1)

ATOL = RTOL = 1e-5
NUM_CLASS = 4
KERNEL = np.random.RandomState(7).randn(3, 3, 3, NUM_CLASS).astype(np.float32)  # HWIO


def j_apply(x):
    return jax.lax.conv_general_dilated(x, jnp.asarray(KERNEL), (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def t_apply(x):
    w = torch.tensor(KERNEL).permute(3, 2, 0, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def _images(n=2, h=21, w=30, seed=0):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


PLANS = {
    "even": ((24, 24), (8, 8), 0.5),
    "snapped_last_window": ((21, 30), (8, 12), 2.0 / 3.0),
    "crop_larger_than_image": ((10, 40), (16, 16), 2.0 / 3.0),
    "stride_one_pixel": ((6, 5), (4, 4), 0.1),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_torch_sliding_window_plan_matches_jax(name):
    hw, crop, rate = PLANS[name]
    t_starts, t_counts, t_win = tinf.sliding_window_plan(hw, crop, rate)
    j_starts, j_counts, j_win = jinf.sliding_window_plan(hw, crop, rate)
    np.testing.assert_array_equal(t_starts, j_starts)
    np.testing.assert_array_equal(t_counts, j_counts)
    assert t_win == j_win and t_counts.min() >= 1
    for wb in (1, 3):
        np.testing.assert_array_equal(tinf._chunk_weighted_starts(t_starts, wb),
                                      jinf._chunk_weighted_starts(j_starts, wb))


def test_torch_sliding_window_plan_rejects_gaps():
    with pytest.raises(ValueError, match="stride_rate"):
        tinf.sliding_window_plan((16, 16), (8, 8), 1.5)
    assert tinf.sliding_start_indices(10, 4, 3) == jinf.sliding_start_indices(10, 4, 3) \
        == [0, 3, 6]
    assert tinf.sliding_start_indices(11, 4, 3) == [0, 3, 6, 7]


@pytest.mark.parametrize("window_batch", [1, 3])
def test_torch_sliding_window_matches_jax(window_batch):
    x = _images()
    # 4 x 4 = 16 windows of 8x12: in chunks of 3 the last one has 2 sentinels
    j = jinf.inference_with_sliding_window(j_apply, jnp.asarray(x), (8, 12),
                                           window_batch=window_batch)
    calls = []

    def counting(win):
        calls.append(tuple(win.shape))
        return t_apply(win)

    t = tinf.inference_with_sliding_window(counting, torch.tensor(x), (8, 12),
                                           window_batch=window_batch)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
    starts, _, _ = tinf.sliding_window_plan((21, 30), (8, 12))
    assert len(calls) == -(-len(starts) // window_batch)
    assert set(calls) == {(2 * window_batch, 8, 12, 3)}  # one batch shape for the model


def test_torch_sliding_window_sentinels_carry_no_weight():
    """5 windows in chunks of 2: the sixth is a zero-weight sentinel at
    (0, 0). If it counted, the top-left window would be added twice."""
    x = _images(n=1, h=8, w=24)
    starts, _, _ = tinf.sliding_window_plan((8, 24), (8, 8), 0.5)
    assert len(starts) == 5
    one = tinf.inference_with_sliding_window(t_apply, torch.tensor(x), (8, 8), 0.5, 1)
    two = tinf.inference_with_sliding_window(t_apply, torch.tensor(x), (8, 8), 0.5, 2)
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-6, rtol=1e-6)


def test_torch_sliding_window_single_window_is_direct():
    x = torch.tensor(_images(h=8, w=8))
    out = tinf.inference_with_sliding_window(t_apply, x, (16, 16))
    np.testing.assert_array_equal(out.numpy(), t_apply(x).numpy())


MULTI = {
    "scales": dict(scale_rates=(0.5, 1.0, 1.25)),
    "flip": dict(scale_rates=(0.75, 1.0), flip=True),
    "flip_in_batch": dict(scale_rates=(0.75, 1.0), flip=True, flip_in_batch=True),
    "flip_sliding": dict(scale_rates=(1.0, 1.5), flip=True, sliding_window_crop_size=(16, 16),
                         sliding_window_batch=3),
    "flip_in_batch_sliding": dict(scale_rates=(0.75,), flip=True, flip_in_batch=True,
                                  sliding_window_crop_size=(8, 12),
                                  sliding_window_stride_rate=0.5),
}


@pytest.mark.parametrize("name", sorted(MULTI))
def test_torch_multi_scale_flip_matches_jax(name):
    x = _images()
    j = jinf.inference_with_multi_scales(j_apply, jnp.asarray(x), **MULTI[name])
    t = tinf.inference_with_multi_scales(t_apply, torch.tensor(x), **MULTI[name])
    assert t.dtype == torch.float32 and tuple(t.shape) == (2, 21, 30, NUM_CLASS)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_torch_flip_in_batch_equals_serial_flips():
    x = torch.tensor(_images())
    kw = dict(scale_rates=(0.75, 1.0), flip=True)
    serial = tinf.inference_with_multi_scales(t_apply, x, **kw)
    paired = tinf.inference_with_multi_scales(t_apply, x, flip_in_batch=True, **kw)
    np.testing.assert_allclose(paired.numpy(), serial.numpy(), atol=1e-6, rtol=1e-6)


def test_torch_model_inference_honours_the_config():
    """``SegBase.inference(x, config)`` is ``inference_with_multi_scales``
    over the model's eval-mode forward, and restores the training flag."""
    model = SegManaged(num_class=NUM_CLASS)  # no backbone or head: the 1x1 logits conv
    with torch.no_grad():
        model.logits_conv.weight.copy_(torch.tensor(KERNEL[1, 1]).t()[:, :, None, None])
        model.logits_conv.bias.zero_()
    x = torch.tensor(_images())
    cfg = SegModelInferenceConfig(scale_rates=(0.75, 1.0), flip=True, flip_in_batch=True,
                                  sliding_window_crop_size=(8, 12), sliding_window_batch=2)
    model.train()
    got = model.inference(x, cfg)
    assert model.training
    model.eval()
    with torch.no_grad():
        want = tinf.inference_with_multi_scales(
            model, x, scale_rates=(0.75, 1.0), flip=True, flip_in_batch=True,
            sliding_window_crop_size=(8, 12), sliding_window_batch=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(model.inference(x).numpy(), model(x).detach().numpy())
