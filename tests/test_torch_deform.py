"""The plain samplers of ``iseg_tpu_torch.ops.deform`` against
``iseg_tpu.ops.deform``: same inputs from a seed, fp32, atol 1e-5 (the two
sides do the same arithmetic; gathers and sums differ only in order). The
JAX side is jitted, shapes are tiny.
"""

import jax
import numpy as np
import pytest
import torch

from iseg_tpu.ops import deform as jdeform
from iseg_tpu_torch.ops import deform as tdeform

torch.set_num_threads(1)

ATOL = 1e-5


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def test_torch_bilinear_gather_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    # inside, on the border, outside, and exact integers
    coords = rng.uniform(-2, 8, (2, 40, 2)).astype(np.float32)
    coords[:, :5] = np.round(coords[:, :5])
    want = jax.jit(jdeform.bilinear_gather)(x, coords)
    got = tdeform.bilinear_gather(*_t(x, coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_torch_deform_im2col_matches_jax(stride, dilation):
    rng = np.random.RandomState(1)
    n, h, w, c, k = 2, 7, 6, 3, 3
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, (n, ho, wo, k * k, 2)).astype(np.float32)
    want = jax.jit(lambda a, b: jdeform.deform_im2col(a, b, k, stride, dilation))(x, off)
    got = tdeform.deform_im2col(*_t(x, off), kernel_size=k, stride=stride, dilation=dilation)
    assert tuple(got.shape) == (n, ho, wo, k * k, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("stride,dilation,scale", [(1, 1, 1.0), (2, 1, 1.0), (1, 2, 0.5)])
def test_torch_dcnv3_sample_ref_matches_jax(stride, dilation, scale):
    rng = np.random.RandomState(2)
    b, h, w, c, k = 3, 6, 8, 4, 3
    pad = dilation * (k - 1) // 2
    ho = (h + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1
    wo = (w + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = rng.uniform(-3, 3, (b, ho, wo, k * k, 2)).astype(np.float32)
    mask = rng.rand(b, ho, wo, k * k).astype(np.float32)
    want = jax.jit(lambda *a: jdeform.dcnv3_sample_ref(*a, k, stride, dilation, scale))(
        x, off, mask)
    got = tdeform.dcnv3_sample_ref(*_t(x, off, mask), kernel_size=k, stride=stride,
                                   dilation=dilation, offset_scale=scale)
    assert tuple(got.shape) == (b, ho, wo, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_torch_ref_effective_offsets_match_jax_grouped_and_ungrouped():
    rng = np.random.RandomState(3)
    b, hw, g, k = 2, 6, 3, 3
    off = rng.uniform(-1, 1, (b, hw, hw, g, k * k, 2)).astype(np.float32)
    want_dy, want_dx = jax.jit(
        lambda o: jdeform.dcnv3_ref_effective_offsets_grouped(o, hw, hw, k, 0.75))(off)
    got_dy, got_dx = tdeform.dcnv3_ref_effective_offsets_grouped(
        torch.tensor(off), hw, hw, kernel_size=k, offset_scale=0.75)
    assert got_dy.dtype == torch.float32 and tuple(got_dy.shape) == (b, hw, hw, g * k * k)
    np.testing.assert_allclose(got_dy.numpy(), np.asarray(want_dy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=ATOL, rtol=0)
    want = jax.jit(lambda o: jdeform.dcnv3_ref_effective_offsets(o, hw, hw, k, 0.75))(off[:, :, :, 0])
    got = tdeform.dcnv3_ref_effective_offsets(torch.tensor(off[:, :, :, 0]), hw, hw,
                                              kernel_size=k, offset_scale=0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the grouped form is the ungrouped one per group
    np.testing.assert_array_equal(got_dy[..., :k * k].numpy(), got[..., 0].numpy())
    with pytest.raises(ValueError, match="square"):
        tdeform.dcnv3_ref_effective_offsets_grouped(torch.tensor(off), hw, hw + 1)
    with pytest.raises(ValueError, match="square"):
        tdeform.dcnv3_ref_effective_offsets(torch.tensor(off[:, :, :, 0]), hw, hw + 1)


def test_torch_dense_local_ref_equals_reference_sampling_in_range():
    """dense_local(transpose(x), effective offsets) is dcnv3_sample_ref
    wherever the effective offsets stay inside the clamp: small raw offsets
    on a map whose position term (about -1.5 px at the far edge) fits r = 2."""
    rng = np.random.RandomState(4)
    b, hw, c, k = 2, 8, 4, 3
    x = torch.tensor(rng.randn(b, hw, hw, c).astype(np.float32))
    off = torch.tensor(rng.uniform(-0.4, 0.4, (b, hw, hw, k * k, 2)).astype(np.float32))
    mask = torch.tensor(rng.rand(b, hw, hw, k * k).astype(np.float32))
    eff = tdeform.dcnv3_ref_effective_offsets(off, hw, hw, kernel_size=k)
    assert float(eff.abs().max()) < 2.0
    got = tdeform.deform_dense_local(x.transpose(1, 2).contiguous(), eff, mask, k, 2)
    want = tdeform.dcnv3_sample_ref(x, off, mask, kernel_size=k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_torch_deform_dense_local_taps_matches_jax_and_the_gather():
    rng = np.random.RandomState(5)
    b, h, w, c, k, r = 2, 6, 5, 3, 3, 2
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = rng.uniform(-3, 3, (b, h, w, k * k, 2)).astype(np.float32)
    want = jax.jit(lambda a, o: jdeform.deform_dense_local_taps(a, o, k, r))(x, off)
    got = tdeform.deform_dense_local_taps(*_t(x, off), kernel_size=k, max_offset=r)
    assert tuple(got.shape) == (b, h, w, k * k, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    inside = np.clip(off, -r, r)
    gathered = tdeform.deform_im2col(*_t(x, inside), kernel_size=k)
    np.testing.assert_allclose(got.numpy(), gathered.numpy(), atol=ATOL, rtol=0)
