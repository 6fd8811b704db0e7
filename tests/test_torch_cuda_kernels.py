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
from iseg_tpu_torch.ops.kernels import window_attention as wa

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


# ------------------------------------------------------------ window attention

def _wa_inputs(device, bnw, h, n, d, nw, dtype, seed=0, packed=False):
    rng = np.random.RandomState(seed)
    if packed:  # views of one [bnw, N, 3, H, D] projection, as the Swin block gives
        qkv = torch.tensor(rng.randn(bnw, n, 3, h, d).astype(np.float32), device=device)
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.to(dtype).unbind(2))
    else:
        q, k, v = (torch.tensor(rng.randn(bnw, h, n, d).astype(np.float32),
                                device=device).to(dtype) for _ in range(3))
    bias = torch.tensor((rng.randn(h, n, n) * 0.1).astype(np.float32), device=device)
    if nw == 1:
        mask = torch.zeros((1, n, n), device=device)
    else:
        mask = torch.tensor(np.where(rng.rand(nw, n, n) > 0.7, -100.0, 0.0)
                            .astype(np.float32), device=device)
    dout = torch.tensor(rng.randn(bnw, h, n, d).astype(np.float32), device=device).to(dtype)
    return q, k, v, bias, mask, dout


def _wa_run(fn, q, k, v, bias, mask, dout, scale):
    # detach() keeps a view's strides, so packed inputs stay packed
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    bias = bias.detach().clone().requires_grad_(True)
    out = fn(q, k, v, bias, mask, scale)
    grads = torch.autograd.grad(out, (q, k, v, bias), dout)
    torch.cuda.synchronize()
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


WA_SHAPES = {
    # (bnw, H, N, D, nW)
    "swin_l_stage3_shifted": (72, 48, 49, 32, 9),
    "swin_l_stage2_unshifted": (200, 24, 49, 32, 1),
    "small_shifted": (6, 3, 49, 32, 3),
    "odd_n_d": (5, 2, 20, 24, 1),
    "ragged_tiles_n10_d30": (3, 2, 10, 30, 2),
    "window12_n144": (4, 4, 144, 32, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed_qkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(WA_SHAPES))
def test_cuda_window_attention_matches_plain_version(cuda_device, shape, dtype, packed):
    bnw, h, n, d, nw = WA_SHAPES[shape]
    args = _wa_inputs(cuda_device, bnw, h, n, d, nw, dtype, packed=packed)
    scale = 1.0 / np.sqrt(d)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, scale)
    assert wa.LAUNCH_COUNTS == {"fwd": 1, "bwd": 1}
    want = _wa_run(wa.window_attention_reference, *args, scale)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=atol, atol=atol, err_msg=name)
    db_tol = (2e-5 if dtype == torch.float32 else 1e-3) * max(1.0, np.abs(want[4]).max())
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=db_tol, err_msg="dbias")


@pytest.mark.cuda
def test_cuda_window_attention_is_deterministic(cuda_device):
    args = _wa_inputs(cuda_device, 200, 24, 49, 32, 25, torch.bfloat16)
    first = _wa_run(wa.window_attention, *args, 0.17)
    second = _wa_run(wa.window_attention, *args, 0.17)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_window_attention_rejects_wrong_inputs(cuda_device):
    q, k, v, bias, mask, _ = _wa_inputs(cuda_device, 4, 2, 49, 32, 1, torch.float32)
    with pytest.raises(TypeError):
        wa.window_attention(q.half(), k.half(), v.half(), bias, mask, 1.0)
    with pytest.raises(TypeError):
        wa.window_attention(q, k, v, bias.bfloat16(), mask, 1.0)
    with pytest.raises(ValueError):
        wa.window_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3),
                            bias, mask, 1.0)
    with pytest.raises(ValueError):
        wa.window_attention(q, k, v, bias[:1], mask, 1.0)
    with pytest.raises(ValueError):
        wa.window_attention(q, k.cpu(), v, bias, mask, 1.0)
    big = torch.zeros((1, 1, 400, 32), device=cuda_device)
    with pytest.raises(ValueError, match="do not fit"):
        wa.window_attention(big, big, big, torch.zeros((1, 400, 400), device=cuda_device),
                            torch.zeros((1, 400, 400), device=cuda_device), 1.0)
