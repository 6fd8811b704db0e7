"""Every method of ``jax.image.resize`` in the port's ``resize_image``
(``iseg_tpu_torch/ops/resize.py``) against the JAX package's
``resize_image`` (which calls ``jax.image.resize``), on the CPU.

Methods ``linear`` / ``bilinear``, ``cubic`` / ``bicubic``, ``lanczos3``,
``lanczos5``, each with and without ``antialias``, upsampling, downsampling
and both at once, at odd sizes, NHWC and HWC. Tolerance: fp32 within 1e-5 of
max(1, max |out|) (the interpolation weights are built in the same fp32
arithmetic; the Lanczos kernel's ``sin`` is numpy's here and XLA's there,
and the two products sum in another order); float64 (JAX's x64 mode) within
1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.ops import resize as jresize
from iseg_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)

F32_RTOL = 1e-5
F64_RTOL = 1e-12
METHODS = ("linear", "bilinear", "cubic", "bicubic", "lanczos3", "lanczos5")
SIZES = {"up": (17, 23), "down": (5, 3), "mixed": (4, 21)}


def _check(got: torch.Tensor, want, rtol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("direction", sorted(SIZES))
@pytest.mark.parametrize("antialias", [False, True], ids=["plain", "antialias"])
@pytest.mark.parametrize("method", METHODS)
def test_torch_resize_method_matches_jax(method, antialias, direction):
    x = np.random.RandomState(0).randn(2, 9, 7, 3).astype(np.float32)
    size = SIZES[direction]
    want = jresize.resize_image(jnp.asarray(x), size, method, antialias=antialias)
    got = tresize.resize_image(torch.tensor(x), size, method, antialias=antialias)
    _check(got, want, F32_RTOL)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos5"])
def test_torch_resize_method_float64_and_hwc(method):
    x = np.random.RandomState(1).randn(11, 6, 2)
    with jax.enable_x64(True):
        want = jresize.resize_image(jnp.asarray(x), (7, 13), method, antialias=True)
        want = np.asarray(want)
    got = tresize.resize_image(torch.tensor(x), (7, 13), method, antialias=True)
    assert got.dtype == torch.float64
    _check(got, want, F64_RTOL)


def test_torch_resize_method_same_size_and_unknown():
    """An axis that keeps its size is not resampled (as in jax.image, whose
    Lanczos weights at integer distances are not exactly 0 and 1), and an
    unknown method raises."""
    x = torch.tensor(np.random.RandomState(2).randn(1, 6, 5, 2).astype(np.float32))
    assert torch.equal(tresize.resize_image(x, (6, 5), "lanczos3"), x)
    half = tresize.resize_image(x, (6, 9), "lanczos3", antialias=True)
    want = jresize.resize_image(jnp.asarray(x.numpy()), (6, 9), "lanczos3", antialias=True)
    _check(half, want, F32_RTOL)
    with pytest.raises(ValueError, match="Unknown resize method"):
        tresize.resize_image(x, (3, 3), "gaussian")
