"""The CUDA kernels of ``iseg_tpu_torch`` against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA GPU and skips
without one. This file imports no JAX, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: the kernels sum in another order than the plain versions
(per-pixel online log-sum-exp, block partials, per-footprint gathers), so
fp32 losses agree to rtol 1e-5 and fp32 gradients to rtol 1e-4 / atol
1e-6. With bf16 logits both sides read the same bf16 values and compute in
fp32; the kernel's gradient is then rounded to bf16 (rtol 1e-2).
"""

import numpy as np
import pytest
import torch

from iseg_tpu_torch.ops.kernels import upsample_ce as uce

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _data(device, n, h, w, c, hh, ww, seed=0, ignore_frac=0.1, ignore_label=255):
    rng = np.random.RandomState(seed)
    src = torch.tensor(rng.randn(n, h, w, c).astype(np.float32), device=device)
    labels = rng.randint(0, c, (n, hh, ww))
    labels = np.where(rng.rand(n, hh, ww) < ignore_frac, ignore_label, labels)
    return src, torch.tensor(labels.astype(np.int32), device=device)


def _loss_and_grad(fn, src, labels, **kw):
    s = src.detach().clone().requires_grad_(True)
    loss = fn(s, labels, **kw)
    (g,) = torch.autograd.grad(loss, s)
    torch.cuda.synchronize()
    return float(loss.detach()), g.float().cpu().numpy()


SHAPES = {
    "main_path_16x32x32x21_to_512": (16, 32, 32, 21, 512, 512),
    "non_square_2x5x9x21_to_37x70": (2, 5, 9, 21, 37, 70),
    "many_classes_2x8x8x40_to_64": (2, 8, 8, 40, 64, 64),
    "downsample_2x16x16x7_to_10": (2, 16, 16, 7, 10, 10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_upsample_ce_matches_plain_version(cuda_device, shape, dtype):
    src, labels = _data(cuda_device, *SHAPES[shape])
    src = src.to(dtype)
    uce.reset_launch_counts()
    k_loss, k_grad = _loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert uce.LAUNCH_COUNTS == {"fwd": 1, "bwd": 1}
    r_loss, r_grad = _loss_and_grad(uce.upsample_cross_entropy_reference, src, labels)
    np.testing.assert_allclose(k_loss, r_loss, rtol=1e-5)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(k_grad, r_grad, rtol=rtol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("ignore_label", [255, 0])
def test_cuda_upsample_ce_odd_labels_match_plain_sums(cuda_device, ignore_label):
    src, labels = _data(cuda_device, 2, 4, 4, 5, 16, 16, ignore_label=ignore_label)
    labels[:, :2] = 7  # out of range and not ignored: CE = lse
    k_loss, k_grad = _loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                    ignore_label=ignore_label)

    def plain(s, lab, ignore_label):
        loss_sum, valid = uce.fused_sums_plain(s, lab, ignore_label)
        return loss_sum / torch.clamp(valid, min=1.0)

    p_loss, p_grad = _loss_and_grad(plain, src, labels, ignore_label=ignore_label)
    np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5)
    np.testing.assert_allclose(k_grad, p_grad, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_upsample_ce_all_ignored(cuda_device):
    src, labels = _data(cuda_device, 2, 4, 4, 5, 16, 16)
    labels.fill_(255)
    loss, grad = _loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert loss == 0.0
    np.testing.assert_array_equal(grad, 0.0)


@pytest.mark.cuda
def test_cuda_upsample_ce_is_deterministic(cuda_device):
    src, labels = _data(cuda_device, 4, 32, 32, 21, 256, 256)
    first = _loss_and_grad(uce.upsample_cross_entropy, src, labels)
    second = _loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert first[0] == second[0]
    np.testing.assert_array_equal(first[1], second[1])


@pytest.mark.cuda
def test_cuda_upsample_ce_rejects_wrong_inputs(cuda_device):
    src, labels = _data(cuda_device, 2, 4, 4, 5, 16, 16)
    with pytest.raises(TypeError):
        uce.upsample_cross_entropy(src.half(), labels)
    with pytest.raises(ValueError):
        uce.upsample_cross_entropy(src.transpose(1, 2), labels)
    with pytest.raises(ValueError):
        uce.upsample_cross_entropy(src, labels.cpu())
