"""The CUDA kernels of ``iseg_tpu_torch`` against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA GPU and skips
without one. This file imports no JAX, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: the kernels sum in another order than the plain versions
(per-pixel online log-sum-exp, block partials, per-footprint gathers), so
fp32 losses agree to rtol 1e-5 and fp32 gradients to rtol 1e-4 / atol
1e-6. With bf16 logits both sides read the same bf16 values and compute in
fp32; the kernel's gradient is then rounded to bf16 (rtol 1e-2). The
dense-local kernels sum the same products as their plain versions in
another order: fp32 atol 2e-5 of max(1, max |plain|); with bf16 values the
outputs that are rounded to bf16 get 1e-2 of it. The beam cache gather is a
copy: bitwise equal to its plain version for every dtype and slab size. The
window-attention forward and backward in bf16 run on the tensor cores (p,
and in the backward ds, rounded to bf16 as operands): 1e-2 of max(1, max
|plain|), 1e-3 for dbias. In fp32 they run on the tensor cores in split
TF32 (hi + lo operands, lo hi + hi lo + hi hi products), which keeps them
within the fp32 tolerance: 1e-4 of max(1, max |plain|) at Swin-L's shapes,
rtol and atol 2e-5 at the small ones. The global-attention pair (bf16, p
and ds rounded to bf16 as operands) is held to the same bf16 tolerance,
1e-2 of max(1, max |plain|), its bias form's dbias (fp32, ds unrounded) to
1e-3 of it, its fp32 form (split TF32) to the fp32 tolerance, 1e-4 of it,
and its two runs to each other bit for bit.
"""

import numpy as np
import pytest
import torch

from iseg_tpu_torch.ops.kernels import deform_local as dl
from iseg_tpu_torch.ops.kernels import global_attention as ga
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


# the backbone zoo's paths: ConvNeXt-L + FaPN's os4 logits of 512x1024 crops
# (the first non-square source on a path), Xception-65 + ASPP's os16 ones of
# 512x512 crops
ZOO_SHAPES = {
    "convnext_fapn_8x128x256x19_to_512x1024": (8, 128, 256, 19, 512, 1024),
    "xception_16x32x32x21_to_512": (16, 32, 32, 21, 512, 512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(ZOO_SHAPES))
def test_cuda_upsample_ce_matches_plain_version_at_zoo_shapes(cuda_device, shape, dtype):
    """Loss rtol 1e-5; dsrc within 1e-4 (f32) or 1e-2 (bf16) of max |dsrc|,
    as ``chip_smoke.py``'s UCE_TOL."""
    src, labels = _data(cuda_device, *ZOO_SHAPES[shape])
    src = src.to(dtype)
    uce.reset_launch_counts()
    k_loss, k_grad = _loss_and_grad(uce.upsample_cross_entropy, src, labels)
    assert uce.LAUNCH_COUNTS == {"fwd": 1, "bwd": 1}
    r_loss, r_grad = _loss_and_grad(uce.upsample_cross_entropy_reference, src, labels)
    np.testing.assert_allclose(k_loss, r_loss, rtol=1e-5)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(k_grad, r_grad, rtol=0, atol=rtol * np.abs(r_grad).max())


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
@pytest.mark.parametrize("ignore_label", [255, 0])
def test_cuda_upsample_ce_above_64_classes_is_the_unfused_loss(cuda_device, ignore_label):
    """Above 64 classes the fused loss is the unfused resize + CE on the
    card too, as in the JAX package, and launches no kernel."""
    src, labels = _data(cuda_device, 2, 8, 8, 150, 64, 64, ignore_label=ignore_label)
    labels[:, :3] = 152  # out of range, not ignored
    uce.reset_launch_counts()
    got = _loss_and_grad(uce.upsample_cross_entropy, src, labels, ignore_label=ignore_label)
    assert uce.LAUNCH_COUNTS == {"fwd": 0, "bwd": 0}
    want = _loss_and_grad(uce.upsample_cross_entropy_reference, src, labels,
                          ignore_label=ignore_label)
    # the unfused backward's bilinear resize sums with atomics on the card,
    # so two calls agree to rounding, not bitwise
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5 * np.abs(want[1]).max())


# the band-tiled backward at odd shapes: (n, h, w, C, H, W, ignore_label, what)
UCE_BWD_SHAPES = {
    "scale4_c21": (2, 13, 11, 21, 52, 44, 255, None),
    "scale16_c19": (2, 5, 7, 19, 80, 112, 255, None),
    "scale32_c21": (1, 3, 4, 21, 96, 128, 255, None),
    "non_integer_33x47_to_512x700": (1, 33, 47, 21, 512, 700, 255, None),
    "h1_c64": (2, 1, 9, 64, 8, 72, 255, None),
    "c1": (2, 6, 5, 1, 24, 20, 255, None),
    "downsample_16_to_10": (2, 16, 16, 7, 10, 10, 255, None),
    "ignore_label_0_labels_beyond_c": (2, 7, 9, 21, 56, 72, 0, "beyond"),
    "all_ignored": (1, 5, 6, 19, 40, 48, 255, "all_ignored"),
}


def _uce_bwd_inputs(device, shape):
    n, h, w, c, hh, ww, ignore_label, what = UCE_BWD_SHAPES[shape]
    src, labels = _data(device, n, h, w, c, hh, ww, seed=4, ignore_label=ignore_label)
    if what == "beyond":
        labels[:, :5] = c + 2  # out of range, not ignored: no true class
    if what == "all_ignored":
        labels.fill_(ignore_label)
    return src, labels, ignore_label


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(UCE_BWD_SHAPES))
def test_cuda_upsample_ce_band_tiled_backward_matches_plain_version(cuda_device, shape, dtype):
    """The band-tiled backward at odd shapes (scales 4, 16 and 32, a
    non-integer scale, one source row, 1 and 64 classes, downsampling,
    ignore label 0 with labels >= C, every label ignored), against the plain
    version, and bitwise equal to itself on a second run."""
    src, labels, ignore_label = _uce_bwd_inputs(cuda_device, shape)
    src = src.to(dtype)
    uce.reset_launch_counts()
    k_loss, k_grad = _loss_and_grad(uce.upsample_cross_entropy, src, labels,
                                    ignore_label=ignore_label)
    again = _loss_and_grad(uce.upsample_cross_entropy, src, labels, ignore_label=ignore_label)
    assert uce.LAUNCH_COUNTS == {"fwd": 2, "bwd": 2}
    np.testing.assert_array_equal(k_grad, again[1])

    def plain(s, lab, ignore_label):
        loss_sum, valid = uce.fused_sums_plain(s, lab, ignore_label)
        return loss_sum / torch.clamp(valid, min=1.0)

    p_loss, p_grad = _loss_and_grad(plain, src, labels, ignore_label=ignore_label)
    np.testing.assert_allclose(k_loss, p_loss, rtol=1e-5)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(k_grad, p_grad, rtol=rtol, atol=1e-6)
    if UCE_BWD_SHAPES[shape][-1] == "all_ignored":
        np.testing.assert_array_equal(k_grad, 0.0)


# the row-premixed forward at the three paths' shapes: (n, h, classes) to
# n x 512 x 512, with labels in [C, bucket) that are not ignored
UCE_FWD_SHAPES = {"resnet": (16, 32, 21), "swin": (8, 128, 19), "intern": (8, 16, 19)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", sorted(UCE_FWD_SHAPES))
def test_cuda_upsample_ce_row_premixed_forward_at_main_path_shapes(cuda_device, path, dtype):
    """The forward's sums at the ResNet, Swin and InternImage shapes against
    the plain sums (loss rtol 1e-5, the valid count exactly), with a row of
    labels in [C, bucket): they have no true class, so their CE is the
    log-sum-exp, not a padded logit's. One launch per call, and bitwise equal
    to itself on a second call."""
    n, h, c = UCE_FWD_SHAPES[path]
    src, labels = _data(cuda_device, n, h, h, c, 512, 512, seed=5)
    src = src.to(dtype)
    bucket = next(b for b in (16, 24, 32, 64) if c <= b)
    labels[:, 7] = torch.arange(512, device=cuda_device, dtype=torch.int32) % (bucket - c) + c
    uce.reset_launch_counts()
    with torch.no_grad():
        got = uce._launch_fwd(src, labels, 255)
        again = uce._launch_fwd(src, labels, 255)
        want = uce.fused_sums_plain(src, labels, 255)
    assert uce.LAUNCH_COUNTS == {"fwd": 2, "bwd": 0}
    assert torch.equal(got, again)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert float(got[1]) == float(want[1])


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


def _wa_counts(dtype, n, d, backward=True):
    """The launch counts of one forward and (unless not ``backward``) one
    backward, by route."""
    counts = dict.fromkeys(wa.LAUNCH_COUNTS, 0)
    for which, route in (("fwd", wa.forward_route(dtype, n, d)),
                         ("bwd", wa.backward_route(dtype, n, d) if backward else None)):
        if route is not None:
            counts[which if route == "cuda_core" else f"{which}_{route}"] = 1
    return counts


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
    "n16_d16": (5, 2, 16, 16, 2),
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
    assert wa.LAUNCH_COUNTS == _wa_counts(dtype, n, d)
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


# Swin-L at 512x512 (stage: heads, windows per image at window 7 and at
# window 12); the tests run one image's windows
SWIN_L_STAGES = {"stage0": (6, 361, 121), "stage1": (12, 100, 36), "stage2": (24, 25, 9),
                 "stage3": (48, 9, 4)}


def _swin_inputs(device, stage, window, shifted, seed=0, dtype=torch.bfloat16):
    """The layouts the Swin block gives (q, k, v views of one packed
    projection, a token-major incoming gradient) and its shift mask."""
    from iseg_tpu_torch.backbones.swin import _shift_attn_mask

    heads, nw7, nw12 = SWIN_L_STAGES[stage]
    nw = nw7 if window == 7 else nw12
    n, d = window * window, 32
    rng = np.random.RandomState(seed)
    qkv = torch.tensor(rng.randn(nw, n, 3, heads, d).astype(np.float32), device=device)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.to(dtype).unbind(2))
    dout = torch.tensor(rng.randn(nw, n, heads, d).astype(np.float32), device=device)
    dout = dout.to(dtype).permute(0, 2, 1, 3)
    bias = torch.tensor((rng.randn(heads, n, n) * 0.1).astype(np.float32), device=device)
    side = int(np.sqrt(nw)) * window
    mask = (_shift_attn_mask(side, side, window, window // 2) if shifted
            else np.zeros((1, n, n), np.float32))
    return q, k, v, bias, torch.tensor(mask, device=device), dout


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
@pytest.mark.parametrize("stage", sorted(SWIN_L_STAGES))
def test_cuda_window_attention_tensor_core_backward_at_swin_l_stages(cuda_device, stage, window,
                                                                     shifted):
    """bf16 at Swin-L's stage shapes (one image's windows) takes the
    tensor-core backward, and is held to chip_smoke.py's WA_TOL: 1e-2 of
    max(1, max |plain|) for out, dq, dk, dv; 1e-3 for dbias."""
    args = _swin_inputs(cuda_device, stage, window, shifted)
    scale = 1.0 / np.sqrt(32)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, scale)
    assert wa.LAUNCH_COUNTS == {**dict.fromkeys(wa.LAUNCH_COUNTS, 0), "fwd_mma": 1, "bwd_mma": 1}
    want = _wa_run(wa.window_attention_reference, *args, scale)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(a).all(), name
        tol = (1e-3 if name == "dbias" else 1e-2) * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
def test_cuda_window_attention_tensor_core_backward_is_bitwise_repeatable(cuda_device, window):
    args = _swin_inputs(cuda_device, "stage2", window, shifted=True, seed=3)
    first = _wa_run(wa.window_attention, *args, 0.17)
    second = _wa_run(wa.window_attention, *args, 0.17)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,route", [(64, 128, "mma"), (144, 48, "stream")])
def test_cuda_window_attention_bf16_backward_at_the_route_limits(cuda_device, n, d, route):
    """The widest head dim the tensor-core backward takes at N <= 64 runs
    there; at N = 144 a head dim above 32 does not fit its tiles and takes
    the streaming kernel. Both hold to WA_TOL for bf16."""
    assert wa.backward_route(torch.bfloat16, n, d) == route
    args = _wa_inputs(cuda_device, 6, 2, n, d, 3, torch.bfloat16, packed=True)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, 0.125)
    assert wa.LAUNCH_COUNTS == _wa_counts(torch.bfloat16, n, d)
    assert wa.LAUNCH_COUNTS["bwd_mma"] == int(route == "mma")
    want = _wa_run(wa.window_attention_reference, *args, 0.125)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        tol = (1e-3 if name == "dbias" else 1e-2) * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
def test_cuda_window_attention_tensor_core_backward_takes_misaligned_views(cuda_device):
    """q, k, v, do whose base address or strides do not allow 16-byte loads
    are copied for the tensor-core kernel; the result is the same."""
    q, k, v, bias, mask, dout = _wa_inputs(cuda_device, 6, 3, 49, 32, 3, torch.bfloat16)
    storage = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    q_off = storage[1:].view(q.shape).copy_(q)  # 2 bytes off a 16-byte boundary
    assert q_off.data_ptr() % 16 == 2
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, q_off, k, v, bias, mask, dout, 0.2)
    assert wa.LAUNCH_COUNTS["bwd_mma"] == 1
    want = _wa_run(wa.window_attention, q, k, v, bias, mask, dout, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _wa_forward(fn, q, k, v, bias, mask, scale):
    with torch.no_grad():
        out = fn(q, k, v, bias, mask, scale)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed_qkv"])
@pytest.mark.parametrize("n,bnw,nw", [(49, 37, 4), (49, 613, 25), (144, 29, 4), (144, 131, 9)],
                         ids=["n49_bnw37", "n49_bnw613", "n144_bnw29", "n144_bnw131"])
def test_cuda_window_attention_tensor_core_forward_matches_plain_version(cuda_device, n, bnw,
                                                                         nw, packed):
    """The tensor-core forward at window 7 and 12, with window counts that
    are no multiple of the block's chunk of windows, on contiguous tensors
    and on views of a packed qkv projection: 1e-2 of max(1, max |plain|)."""
    assert wa.forward_route(torch.bfloat16, n, 32) == "mma"
    q, k, v, bias, mask, _ = _wa_inputs(cuda_device, bnw, 3, n, 32, nw, torch.bfloat16,
                                        packed=packed)
    wa.reset_launch_counts()
    got = _wa_forward(wa.window_attention, q, k, v, bias, mask, 0.17)
    assert wa.LAUNCH_COUNTS == _wa_counts(torch.bfloat16, n, 32, backward=False)
    want = _wa_forward(wa.window_attention_reference, q, k, v, bias, mask, 0.17).float()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
def test_cuda_window_attention_tensor_core_forward_is_bitwise_repeatable(cuda_device, window):
    q, k, v, bias, mask, _ = _swin_inputs(cuda_device, "stage1", window, shifted=True, seed=4)
    first = _wa_forward(wa.window_attention, q, k, v, bias, mask, 0.17)
    second = _wa_forward(wa.window_attention, q, k, v, bias, mask, 0.17)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_window_attention_tensor_core_forward_raises_where_tiles_do_not_fit(cuda_device):
    """N = 144 with D = 128: the tensor-core forward's tiles do not fit a
    block's shared memory, so its chunks query refuses the shape, and the
    router, which mirrors that rule, sends it to the streaming forward,
    which computes it (WA_TOL for bf16): no f32 or bf16 shape with D <= 128
    raises."""
    assert not wa._fwd_mma_fits(144, 128) and wa._fwd_mma_fits(144, 64)
    assert wa._tensor_core_chunks("fwd_mma", cuda_device.index or 0, 2, 1, 144, 128) == -1
    assert wa.forward_route(torch.bfloat16, 144, 128) == "stream"
    q, k, v, bias, mask, _ = _wa_inputs(cuda_device, 3, 2, 144, 128, 3, torch.bfloat16)
    wa.reset_launch_counts()
    got = _wa_forward(wa.window_attention, q, k, v, bias, mask, 0.09)
    assert wa.LAUNCH_COUNTS == {**dict.fromkeys(wa.LAUNCH_COUNTS, 0), "fwd_stream": 1}
    want = _wa_forward(wa.window_attention_reference, q, k, v, bias, mask, 0.09).float()
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * max(1.0, float(want.abs().max())), err


def _assert_within_wa_tol_f32(got, want):
    """chip_smoke.py's WA_TOL for float32: 1e-4 of max(1, max |plain|) for
    out, dq, dk, dv and dbias."""
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(a).all(), name
        tol = 1e-4 * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
@pytest.mark.parametrize("stage", sorted(SWIN_L_STAGES))
def test_cuda_window_attention_split_tf32_at_swin_l_stages(cuda_device, stage, window, shifted):
    """fp32 at Swin-L's stage shapes (one image's windows) takes the
    split-TF32 tensor-core forward and backward (at window 12 the backward
    that forms each warp's query rows, then its keys), within WA_TOL."""
    args = _swin_inputs(cuda_device, stage, window, shifted, dtype=torch.float32)
    scale = 1.0 / np.sqrt(32)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, scale)
    n = window * window
    assert wa.forward_route(torch.float32, n, 32) == "tf32x3"
    assert wa.backward_route(torch.float32, n, 32) == "tf32x3"
    assert wa.LAUNCH_COUNTS == _wa_counts(torch.float32, n, 32)
    want = _wa_run(wa.window_attention_reference, *args, scale)
    _assert_within_wa_tol_f32(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
def test_cuda_window_attention_split_tf32_is_bitwise_repeatable(cuda_device, window):
    args = _swin_inputs(cuda_device, "stage2", window, shifted=True, seed=5, dtype=torch.float32)
    first = _wa_run(wa.window_attention, *args, 0.17)
    second = _wa_run(wa.window_attention, *args, 0.17)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(64, 80), (16, 8), (20, 24), (144, 32), (144, 56), (65, 56),
                                 (100, 40)],
                         ids=["n64_d80", "n16_d8", "n20_d24", "n144_d32", "n144_d56", "n65_d56",
                              "n100_d40"])
def test_cuda_window_attention_split_tf32_at_the_route_limits(cuda_device, n, d):
    """The widest fp32 head dim the split-TF32 backward takes at N <= 64
    (80) and above (56: one set of k and v, no prefetch), the narrowest (8),
    a head dim that is no multiple of 16, N = 144 (Swin's window 12), the
    first N above 64 and a ragged N, on views of a packed qkv: WA_TOL."""
    args = _wa_inputs(cuda_device, 7, 2, n, d, 3, torch.float32, packed=True)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, 1.0 / np.sqrt(d))
    assert wa.LAUNCH_COUNTS == _wa_counts(torch.float32, n, d)
    assert wa.LAUNCH_COUNTS["fwd_tf32x3"] == 1
    want = _wa_run(wa.window_attention_reference, *args, 1.0 / np.sqrt(d))
    _assert_within_wa_tol_f32(got, want)


@pytest.mark.cuda
def test_cuda_window_attention_split_tf32_takes_misaligned_views(cuda_device):
    """fp32 q, k, v, do whose base address or token stride do not allow
    16-byte loads are copied for the split-TF32 kernels; a view at a
    4-element stride is taken as it is; the results are the same."""
    q, k, v, bias, mask, dout = _wa_inputs(cuda_device, 6, 3, 49, 32, 3, torch.float32)
    storage = torch.zeros(q.numel() + 1, dtype=torch.float32, device=cuda_device)
    q_off = storage[1:].view(q.shape).copy_(q)  # 4 bytes off a 16-byte boundary
    assert q_off.data_ptr() % 16 == 4
    wide = torch.zeros((6, 3, 49, 36), device=cuda_device)
    k_wide = wide[..., :32].copy_(k)  # token stride 36 floats: 144 bytes
    assert wa._aligned16(k_wide) is k_wide and wa._aligned16(q_off) is not q_off
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, q_off, k_wide, v, bias, mask, dout, 0.2)
    assert wa.LAUNCH_COUNTS["fwd_tf32x3"] == 1 and wa.LAUNCH_COUNTS["bwd_tf32x3"] == 1
    want = _wa_run(wa.window_attention, q, k, v, bias, mask, dout, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 96, 104, 128])
def test_cuda_window_attention_f32_forward_at_n144_wide_heads_takes_split_tf32(cuda_device, d):
    """fp32 at N = 144 with a head dim above 32 runs the N > 64 split-TF32
    forward (q in registers; two sets of k and v up to D = 96, one above)
    within WA_TOL, on views of a packed qkv."""
    assert wa.forward_route(torch.float32, 144, d) == "tf32x3"
    q, k, v, bias, mask, _ = _wa_inputs(cuda_device, 7, 2, 144, d, 3, torch.float32,
                                        packed=True)
    wa.reset_launch_counts()
    got = _wa_forward(wa.window_attention, q, k, v, bias, mask, 1.0 / np.sqrt(d))
    assert wa.LAUNCH_COUNTS == {**dict.fromkeys(wa.LAUNCH_COUNTS, 0), "fwd_tf32x3": 1}
    want = _wa_forward(wa.window_attention_reference, q, k, v, bias, mask, 1.0 / np.sqrt(d))
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [36, 44])
def test_cuda_window_attention_f32_at_n144_odd_head_dims_takes_the_cuda_cores(cuda_device, d):
    """fp32 at N = 144 with a head dim that is no multiple of 8 runs within
    WA_TOL: on the streaming forward and backward since they exist (the
    CUDA-core kernels keep only heads wider than 128)."""
    assert wa.forward_route(torch.float32, 144, d) == "stream"
    assert wa.backward_route(torch.float32, 144, d) == "stream"
    args = _wa_inputs(cuda_device, 5, 2, 144, d, 3, torch.float32, packed=True)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, 1.0 / np.sqrt(d))
    assert wa.LAUNCH_COUNTS == {**dict.fromkeys(wa.LAUNCH_COUNTS, 0), "fwd_stream": 1,
                                "bwd_stream": 1}
    want = _wa_run(wa.window_attention_reference, *args, 1.0 / np.sqrt(d))
    _assert_within_wa_tol_f32(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("which,n,d", [("fwd", 144, 136), ("bwd", 144, 64), ("bwd", 64, 88)],
                         ids=["fwd_n144_d136", "bwd_n144_d64", "bwd_n64_d88"])
def test_cuda_window_attention_split_tf32_raises_where_tiles_do_not_fit(cuda_device,
                                                                        monkeypatch, which, n, d):
    """A shape sent down a split-TF32 kernel past its limits (the forward
    above D = 128; the backward above D = 56 at N > 64 and above D = 80 at N
    <= 64, where its tiles do not fit a block; the route functions send them
    to the streaming kernels, or above D = 128 the CUDA cores) raises at
    launch: nothing falls back."""
    monkeypatch.setattr(wa, f"{'forward' if which == 'fwd' else 'backward'}_route",
                        lambda dtype, n, d: "tf32x3")
    q = torch.zeros((2, 1, n, d), device=cuda_device, requires_grad=which == "bwd")
    zeros = torch.zeros((1, n, n), device=cuda_device)
    wa.reset_launch_counts()
    with pytest.raises(ValueError, match="do not fit"):
        if which == "fwd":
            wa.window_attention(q, q, q, zeros, zeros, 1.0)
        else:
            wa.window_attention(q, q, q, zeros, zeros, 1.0).sum().backward()
    assert not wa.LAUNCH_COUNTS[f"{which}_tf32x3"]


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["stage0", "stage3"])
def test_cuda_window_attention_split_tf32_window12_backward_is_bitwise_repeatable(cuda_device,
                                                                                  stage):
    """The window-12 split-TF32 backward (several windows a chunk at stage
    0, so the dbias sums and the next window's k and v carry across windows)
    gives the same bits twice, dbias included."""
    args = _swin_inputs(cuda_device, stage, 12, shifted=True, seed=7, dtype=torch.float32)
    wa.reset_launch_counts()
    first = _wa_run(wa.window_attention, *args, 0.17)
    assert wa.LAUNCH_COUNTS["bwd_tf32x3"] == 1
    second = _wa_run(wa.window_attention, *args, 0.17)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_cuda_window_attention_split_tf32_window12_takes_misaligned_views(cuda_device):
    """At N = 144, fp32 q, k, v, do whose base address or token stride do
    not allow 16-byte loads are copied for the split-TF32 kernels; a view at
    a 4-element stride is taken as it is; the results are the same."""
    q, k, v, bias, mask, dout = _wa_inputs(cuda_device, 5, 2, 144, 32, 3, torch.float32)
    storage = torch.zeros(dout.numel() + 1, dtype=torch.float32, device=cuda_device)
    dout_off = storage[1:].view(dout.shape).copy_(dout)  # 4 bytes off a 16-byte boundary
    wide = torch.zeros((5, 2, 144, 36), device=cuda_device)
    v_wide = wide[..., :32].copy_(v)  # token stride 36 floats: 144 bytes
    assert wa._aligned16(v_wide) is v_wide and wa._aligned16(dout_off) is not dout_off
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, q, k, v_wide, bias, mask, dout_off, 0.2)
    assert wa.LAUNCH_COUNTS["fwd_tf32x3"] == 1 and wa.LAUNCH_COUNTS["bwd_tf32x3"] == 1
    want = _wa_run(wa.window_attention, q, k, v, bias, mask, dout, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [7, 12], ids=["n49", "n144"])
def test_cuda_window_attention_split_tf32_keeps_nan(cuda_device, window):
    """A NaN in q, made on the card (0 * inf), reaches out, dq, dk, dv and
    dbias where it reaches them in the plain version, and every other value
    stays within WA_TOL."""
    q, k, v, bias, mask, dout = _swin_inputs(cuda_device, "stage3", window, shifted=False,
                                             seed=6, dtype=torch.float32)
    q = q.clone()
    q[1, 2, 5, 7] = torch.zeros((), device=cuda_device) * torch.tensor(float("inf"),
                                                                       device=cuda_device)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, q, k, v, bias, mask, dout, 0.17)
    assert wa.LAUNCH_COUNTS["fwd_tf32x3"] == 1 and wa.LAUNCH_COUNTS["bwd_tf32x3"] == 1
    want = _wa_run(wa.window_attention_reference, q, k, v, bias, mask, dout, 0.17)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        nan = np.isnan(b)
        assert nan.any(), name
        np.testing.assert_array_equal(np.isnan(a), nan, err_msg=name)
        tol = 1e-4 * max(1.0, np.abs(b[~nan]).max())
        np.testing.assert_allclose(a[~nan], b[~nan], rtol=0, atol=tol, err_msg=name)


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
    # heads wider than 128 take the CUDA-core kernels, whose window at N = 400
    # fits no block (at D <= 128 the streaming kernels take any N)
    big = torch.zeros((1, 1, 400, 136), device=cuda_device)
    with pytest.raises(ValueError, match="do not fit"):
        wa.window_attention(big, big, big, torch.zeros((1, 400, 400), device=cuda_device),
                            torch.zeros((1, 400, 400), device=cuda_device), 1.0)


# ------------------------------------------------------- dense-local sampling

def _dl_inputs(device, b, h, w, groups, gc, k, x_dtype, map_dtypes, seed=0, spread=3.0,
               transposed=False):
    """x, off_dy, off_dx, modulation, g_out. Offsets are drawn in +-spread
    (beyond the clamp), with rows of exact zeros, exact +-r and exact
    integers, where the gradient conventions show."""
    rng = np.random.RandomState(seed)
    kk = k * k
    shape = (b, w, h, groups * gc) if transposed else (b, h, w, groups * gc)
    x = torch.tensor(rng.randn(*shape).astype(np.float32), device=device).to(x_dtype)
    if transposed:
        x = x.transpose(1, 2)
    maps = []
    for i, dtype in enumerate(map_dtypes):
        if i < 2:
            a = rng.uniform(-spread, spread, (b, h, w, groups * kk)).astype(np.float32)
            a[:, 0] = 0.0
            a[:, 1 % h] = 2.0 if i == 0 else -2.0
            a[:, 2 % h] = np.round(a[:, 2 % h])
        else:
            a = rng.rand(b, h, w, groups * kk).astype(np.float32)
        maps.append(torch.tensor(a, device=device).to(dtype))
    g_out = torch.tensor(rng.randn(b, h, w, groups * gc).astype(np.float32),
                         device=device).to(x_dtype)
    return (x, *maps, g_out)


def _dl_kernel(x, off_dy, off_dx, mod, g_out, groups, k, r):
    ins = [t.detach().requires_grad_(True) for t in (x, off_dy, off_dx, mod)]
    out = dl.deform_dense_local_flat(*ins, groups, k, r)
    grads = torch.autograd.grad(out, ins, g_out)
    torch.cuda.synchronize()
    return [out.detach(), *grads]


def _dl_plain(x, off_dy, off_dx, mod, g_out, groups, k, r):
    return [dl.deform_dense_local_flat_reference(x, off_dy, off_dx, mod, groups, k, r),
            *dl.deform_dense_local_flat_backward_reference(x, off_dy, off_dx, mod, g_out,
                                                           groups, k, r)]


DL_SHAPES = {
    # (B, H, W, groups, channels per group, K, r)
    "intern_t_stage3": (8, 16, 16, 32, 16, 3, 2),
    "intern_t_stage1_b2": (2, 64, 64, 8, 16, 3, 2),
    "one_group_non_square": (2, 9, 13, 1, 8, 3, 2),
    "odd_group_width_gc3": (2, 7, 5, 2, 3, 3, 2),
    "gc6_r1": (1, 6, 8, 4, 6, 3, 1),
    "gc48_three_chunks": (1, 5, 6, 2, 48, 3, 2),
    "k5_r1_gc32": (1, 8, 8, 2, 32, 5, 1),
    "tiny_map_2x2": (3, 2, 2, 2, 4, 3, 2),
}
F32, BF16 = torch.float32, torch.bfloat16
DL_TYPES = {
    "f32": (F32, (F32, F32, F32)),
    "autocast_ref_mix": (BF16, (F32, F32, BF16)),
    "autocast_centered_mix": (BF16, (BF16, BF16, BF16)),
    "f32_x_bf16_maps": (F32, (BF16, F32, BF16)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["contiguous", "transposed_view"])
@pytest.mark.parametrize("types", sorted(DL_TYPES))
@pytest.mark.parametrize("shape", sorted(DL_SHAPES))
def test_cuda_deform_local_matches_plain_version(cuda_device, shape, types, transposed):
    b, h, w, groups, gc, k, r = DL_SHAPES[shape]
    x_dtype, map_dtypes = DL_TYPES[types]
    args = _dl_inputs(cuda_device, b, h, w, groups, gc, k, x_dtype, map_dtypes,
                      transposed=transposed)
    dl.reset_launch_counts()
    got = _dl_kernel(*args, groups, k, r)
    assert dl.LAUNCH_COUNTS == {"fwd": 1, "bwd": 1}
    want = _dl_plain(*args, groups, k, r)
    for name, a, b_ in zip(("out", "d_x", "d_off_dy", "d_off_dx", "d_mod"), got, want):
        assert a.dtype == b_.dtype and a.shape == b_.shape, name
        assert a.is_contiguous(), name
        b_ = b_.float().cpu().numpy()
        tol = (2e-5 if a.dtype == torch.float32 else 1e-2) * max(1.0, np.abs(b_).max())
        np.testing.assert_allclose(a.float().cpu().numpy(), b_, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
def test_cuda_deform_local_gradient_conventions(cuda_device):
    """Integer displacements get no offset gradient (the hat's kink), the
    clamp passes the gradient at exactly +-r and blocks it beyond."""
    x, off_dy, off_dx, mod, g_out = _dl_inputs(cuda_device, 2, 8, 8, 2, 8, 3, F32, (F32,) * 3)
    off_dy[:, 3], off_dx[:, 3] = 2.5, -2.5  # beyond the clamp
    off_dy[:, 4], off_dx[:, 4] = 1.25, -0.75  # fractional, inside
    _, _, d_dy, d_dx, _ = _dl_kernel(x, off_dy, off_dx, mod, g_out, 2, 3, 2)
    for d in (d_dy, d_dx):
        assert float(d[:, 0].abs().max()) == 0.0  # offset 0: the kink
        assert float(d[:, 1].abs().max()) == 0.0  # offset +-r: an integer too
        assert float(d[:, 3].abs().max()) == 0.0  # beyond the clamp
        assert float(d[:, 4].abs().max()) > 0.0
    # at +-r the clamp itself passes the gradient: a fractional offset that
    # is clamped from outside gets none, the same value from inside gets it
    off_dy[:, 1] = 2.0
    off_dx[:, 1] = 0.5
    inside = _dl_kernel(x, off_dy, off_dx, mod, g_out, 2, 3, 2)
    want = _dl_plain(x, off_dy, off_dx, mod, g_out, 2, 3, 2)
    np.testing.assert_allclose(inside[3].cpu().numpy(), want[3].cpu().numpy(), atol=2e-5)
    assert float(inside[3][:, 1].abs().max()) > 0.0


@pytest.mark.cuda
def test_cuda_deform_local_zero_offsets_is_modulated_box_sum(cuda_device):
    x, off_dy, off_dx, mod, _ = _dl_inputs(cuda_device, 2, 8, 8, 1, 8, 3, F32, (F32,) * 3)
    off_dy.zero_()
    off_dx.zero_()
    mod.fill_(1.0)
    out = dl.deform_dense_local_flat(x, off_dy, off_dx, mod, 1, 3, 2)
    box = 9.0 * torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1,
                                               count_include_pad=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.cpu().numpy(), box.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
def test_cuda_deform_local_is_deterministic(cuda_device):
    args = _dl_inputs(cuda_device, 8, 32, 32, 16, 16, 3, BF16, (F32, F32, BF16), transposed=True)
    first = _dl_kernel(*args, 16, 3, 2)
    second = _dl_kernel(*args, 16, 3, 2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# InternImage-T at 512x512 (map side, groups) per stage, 16 channels per group
INTERN_T_STAGES = {"stage0": (128, 4), "stage1": (64, 8), "stage2": (32, 16), "stage3": (16, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "autocast_ref_mix"])
@pytest.mark.parametrize("stage", [*sorted(INTERN_T_STAGES), "odd_side_37x23"])
def test_cuda_deform_local_tiled_dx_at_intern_t_stages(cuda_device, stage, types):
    """The tiled d_x gather at InternImage-T's four stage geometries (one
    image) and at odd map sides, against the plain backward, in f32 and in
    the autocast mix on a transposed view."""
    side, groups = INTERN_T_STAGES.get(stage, (None, 8))
    h, w = (side, side) if side else (37, 23)
    x_dtype, map_dtypes = DL_TYPES[types]
    args = _dl_inputs(cuda_device, 1, h, w, groups, 16, 3, x_dtype, map_dtypes,
                      transposed=types != "f32")
    got = _dl_kernel(*args, groups, 3, 2)[1]
    want = dl.deform_dense_local_flat_backward_reference(*args, groups, 3, 2)[0]
    assert got.dtype == want.dtype and got.is_contiguous()
    tol = (2e-5 if got.dtype == torch.float32 else 1e-2) * max(1.0, float(want.abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "autocast_ref_mix"])
def test_cuda_deform_local_dx_is_bitwise_repeatable_at_an_odd_side(cuda_device, types):
    x_dtype, map_dtypes = DL_TYPES[types]
    args = _dl_inputs(cuda_device, 2, 29, 35, 4, 16, 3, x_dtype, map_dtypes, seed=6)
    first = _dl_kernel(*args, 4, 3, 2)
    second = _dl_kernel(*args, 4, 3, 2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "autocast_ref_mix"])
@pytest.mark.parametrize("stage", [*sorted(INTERN_T_STAGES), "odd_side_37x23", "map_5x3"])
def test_cuda_deform_local_halo_forward_at_intern_t_stages(cuda_device, stage, types):
    """The halo-tiled forward at InternImage-T's four stage geometries (two
    images), at an odd side and at a map smaller than the 8 x 8 tile, in f32
    and in the autocast mix on a transposed view, against the plain forward;
    one launch per call, and bitwise equal to itself on a second call."""
    side, groups = INTERN_T_STAGES.get(stage, (None, 8))
    h, w = (side, side) if side else {"odd_side_37x23": (37, 23), "map_5x3": (5, 3)}[stage]
    x_dtype, map_dtypes = DL_TYPES[types]
    x, off_dy, off_dx, mod, _ = _dl_inputs(cuda_device, 2, h, w, groups, 16, 3, x_dtype,
                                           map_dtypes, transposed=types != "f32")
    dl.reset_launch_counts()
    with torch.no_grad():
        got = dl.deform_dense_local_flat(x, off_dy, off_dx, mod, groups, 3, 2)
        again = dl.deform_dense_local_flat(x, off_dy, off_dx, mod, groups, 3, 2)
        want = dl.deform_dense_local_flat_reference(x, off_dy, off_dx, mod, groups, 3, 2)
    assert dl.LAUNCH_COUNTS == {"fwd": 2, "bwd": 0}
    assert torch.equal(got, again)
    assert got.dtype == want.dtype and got.is_contiguous()
    tol = (2e-5 if got.dtype == torch.float32 else 1e-2) * max(1.0, float(want.abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol


MAPS_SHAPES = {"13x21_g1": (2, 13, 21, 1, 16), "13x21_g4": (2, 13, 21, 4, 16),
               "13x21_g16": (1, 13, 21, 16, 16), "intern_t_stage2": (8, 32, 32, 16, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "autocast_ref_mix"])
@pytest.mark.parametrize("shape", sorted(MAPS_SHAPES))
def test_cuda_deform_local_halo_maps_match_plain_version(cuda_device, shape, types):
    """The halo-tiled map gradients at odd map sides and groups 1, 4, 16 (a
    transposed x view in the autocast mix), against the plain backward and
    bitwise equal to themselves on a second run."""
    b, h, w, groups, gc = MAPS_SHAPES[shape]
    x_dtype, map_dtypes = DL_TYPES[types]
    args = _dl_inputs(cuda_device, b, h, w, groups, gc, 3, x_dtype, map_dtypes,
                      transposed=types != "f32")
    got = _dl_kernel(*args, groups, 3, 2)[2:]
    again = _dl_kernel(*args, groups, 3, 2)[2:]
    want = dl.deform_dense_local_flat_backward_reference(*args, groups, 3, 2)[1:]
    for name, a, a2, b_ in zip(("d_off_dy", "d_off_dx", "d_mod"), got, again, want):
        assert torch.equal(a, a2), name
        assert a.dtype == b_.dtype and a.is_contiguous(), name
        tol = (2e-5 if a.dtype == torch.float32 else 1e-2) * max(1.0, float(b_.abs().max()))
        assert float((a.float() - b_.float()).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "autocast_ref_mix"])
def test_cuda_deform_local_nan_outside_the_map_stays_out_of_the_gradients(cuda_device, types):
    """x as a view into a larger buffer whose border, outside the map, is
    NaN: the halo outside the map is zero-filled, never read, so no NaN
    reaches any gradient (a corner outside the map contributes zero)."""
    b, h, w, groups, gc = 2, 13, 21, 4, 16
    x_dtype, map_dtypes = DL_TYPES[types]
    args = list(_dl_inputs(cuda_device, b, h, w, groups, gc, 3, x_dtype, map_dtypes))
    big = torch.full((b, h + 8, w + 8, groups * gc + 8), float("nan"), device=cuda_device,
                     dtype=x_dtype)
    big[:, 4:4 + h, 4:4 + w, :groups * gc] = args[0]
    args[0] = big[:, 4:4 + h, 4:4 + w, :groups * gc]
    got = _dl_kernel(*args, groups, 3, 2)
    want = _dl_plain(args[0].contiguous(), *args[1:], groups, 3, 2)
    for name, a, b_ in zip(("out", "d_x", "d_off_dy", "d_off_dx", "d_mod"), got, want):
        assert bool(torch.isfinite(a).all()), name
        tol = (2e-5 if a.dtype == torch.float32 else 1e-2) * max(1.0, float(b_.abs().max()))
        assert float((a.float() - b_.float()).abs().max()) <= tol, name


# the radii DCN calibration pins (r = 1 ... 6) and one beyond, at InternImage-T's
# stage 0 and stage 2 geometries (one image) and at an odd side
DL_RADII_SHAPES = {"stage0": (1, 128, 128, 4), "stage2": (2, 32, 32, 16),
                   "odd_side_37x23": (1, 37, 23, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "autocast_ref_mix"])
@pytest.mark.parametrize("r", [1, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("shape", sorted(DL_RADII_SHAPES))
def test_cuda_deform_local_matches_plain_version_at_calibrated_radii(cuda_device, shape, r,
                                                                     types):
    """The forward and all four gradients at every clamp radius calibration
    can pin, offsets drawn in +-(r + 1), against the plain versions; the
    d_x kernel holds only its tile's weights, so its tiles stay 4 x 16 or
    larger up to r = 7 (at r = 6 it ran 1 x 1 tiles before, 14 - 58 ms at
    InternImage-T's stages on an H100); bitwise equal to itself on a second
    run."""
    b, h, w, groups = DL_RADII_SHAPES[shape]
    x_dtype, map_dtypes = DL_TYPES[types]
    args = _dl_inputs(cuda_device, b, h, w, groups, 16, 3, x_dtype, map_dtypes,
                      spread=r + 1.0, transposed=types != "f32")
    dl.reset_launch_counts()
    got = _dl_kernel(*args, groups, 3, r)
    again = _dl_kernel(*args, groups, 3, r)
    assert dl.LAUNCH_COUNTS == {"fwd": 2, "bwd": 2}
    want = _dl_plain(*args, groups, 3, r)
    for name, a, a2, b_ in zip(("out", "d_x", "d_off_dy", "d_off_dx", "d_mod"), got, again,
                               want):
        assert torch.equal(a, a2), name
        assert a.dtype == b_.dtype and a.is_contiguous(), name
        tol = (2e-5 if a.dtype == torch.float32 else 1e-2) * max(1.0, float(b_.abs().max()))
        assert float((a.float() - b_.float()).abs().max()) <= tol, name


@pytest.mark.cuda
def test_cuda_deform_local_rejects_wrong_inputs(cuda_device):
    x, off_dy, off_dx, mod, _ = _dl_inputs(cuda_device, 2, 6, 6, 2, 8, 3, F32, (F32,) * 3)
    with pytest.raises(TypeError):
        dl.deform_dense_local_flat(x.half(), off_dy, off_dx, mod, 2, 3, 2)
    with pytest.raises(TypeError):
        dl.deform_dense_local_flat(x, off_dy.double(), off_dx, mod, 2, 3, 2)
    with pytest.raises(ValueError):  # channels not contiguous
        dl.deform_dense_local_flat(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                   off_dy, off_dx, mod, 2, 3, 2)
    with pytest.raises(ValueError):  # a map that is a strided view
        wide = torch.zeros((2, 6, 6, 36), device=cuda_device)
        dl.deform_dense_local_flat(x, wide[..., ::2], off_dx, mod, 2, 3, 2)
    with pytest.raises(ValueError):  # C % groups
        dl.deform_dense_local_flat(x, off_dy, off_dx, mod, 3, 3, 2)
    with pytest.raises(ValueError):  # map shape
        dl.deform_dense_local_flat(x, off_dy[..., :9], off_dx, mod, 2, 3, 2)
    with pytest.raises(ValueError):  # device
        dl.deform_dense_local_flat(x, off_dy.cpu(), off_dx, mod, 2, 3, 2)


# ------------------------------------------------------- beam cache gather

CACHE_GATHER_SHAPES = {
    "beam4_active_cache_bf16": ((2, 4, 18, 2, 64, 1, 256), torch.bfloat16),
    "beam2_f32": ((3, 2, 2, 2, 40, 2, 64), torch.float32),
    "odd_slab_35_floats": ((2, 3, 5, 7), torch.float32),  # 140 bytes: 4-byte copies
    "odd_slab_7_bf16": ((2, 3, 7), torch.bfloat16),  # 14 bytes: 2-byte copies
    "bytes_13": ((4, 5, 13), torch.uint8),  # 1-byte copies
    "int64_slab": ((2, 2, 3, 5), torch.int64),
    "piece_edge_bf16": ((1, 2, 8192 + 8), torch.bfloat16),  # one 16 KB piece and a short one
    "two_16k_pieces_and_16_bytes": ((2, 3, 16384 + 8), torch.bfloat16),
    "slab_16_bytes": ((64, 4, 8), torch.bfloat16),  # one 16-byte copy a slab
}


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("shape", sorted(CACHE_GATHER_SHAPES))
def test_cuda_cache_gather_matches_plain_version_bitwise(cuda_device, shape, index_dtype):
    from iseg_tpu_torch.ops.kernels import cache_gather as cg

    dims, dtype = CACHE_GATHER_SHAPES[shape]
    rng = np.random.RandomState(0)
    if dtype.is_floating_point:
        cache = torch.tensor(rng.randn(*dims).astype(np.float32), device=cuda_device).to(dtype)
    else:
        cache = torch.tensor(rng.randint(0, 200, dims), device=cuda_device).to(dtype)
    parent = torch.tensor(rng.randint(0, dims[1], dims[:2]), device=cuda_device).to(index_dtype)
    parent[0] = parent[0, 0]  # a parent repeated across a whole row
    cg.reset_launch_counts()
    got = cg.beam_cache_gather(cache, parent)
    spare = torch.empty_like(cache)
    assert cg.beam_cache_gather(cache, parent, out=spare) is spare
    torch.cuda.synchronize()
    assert cg.LAUNCH_COUNTS == {"gather": 2}
    want = cg.beam_cache_gather_reference(cache, parent)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(spare.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_cuda_cache_gather_misaligned_base_and_negative_parents(cuda_device):
    from iseg_tpu_torch.ops.kernels import cache_gather as cg

    storage = torch.randn(2 * 3 * 32 + 1, device=cuda_device)
    cache = storage[1:].view(2, 3, 32)  # base address 4 bytes off a 16-byte boundary
    assert cache.data_ptr() % 16 == 4 and cache.is_contiguous()
    parent = torch.tensor([[-1, 0, -3], [2, 2, 1]], device=cuda_device)
    got = cg.beam_cache_gather(cache, parent)
    torch.cuda.synchronize()
    assert torch.equal(got, cg.beam_cache_gather_reference(cache, parent))


@pytest.mark.cuda
def test_cuda_cache_gather_rejects_wrong_inputs_and_never_falls_back(cuda_device):
    from iseg_tpu_torch.ops.kernels import cache_gather as cg

    cache = torch.zeros((2, 3, 4, 8), device=cuda_device)
    parent = torch.zeros((2, 3), dtype=torch.int64, device=cuda_device)
    cg.reset_launch_counts()
    with pytest.raises(ValueError, match="overlaps"):
        cg.beam_cache_gather(cache, parent, out=cache)
    with pytest.raises(ValueError, match="contiguous"):
        cg.beam_cache_gather(cache.transpose(2, 3), parent)
    with pytest.raises(ValueError, match="contiguous"):
        cg.beam_cache_gather(cache, parent.t().contiguous().t())
    with pytest.raises(TypeError):
        cg.beam_cache_gather(cache, parent.to(torch.int16))
    with pytest.raises(ValueError, match="parent on"):
        cg.beam_cache_gather(cache, parent.cpu())
    assert cg.LAUNCH_COUNTS == {"gather": 0}
    assert cg.beam_cache_gather(cache[:, :, :0], parent).shape == (2, 3, 0, 8)
    assert cg.LAUNCH_COUNTS == {"gather": 0}  # nothing to copy, nothing launched


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("width", [256, 512])
@pytest.mark.parametrize("beams", [2, 4])
def test_cuda_cache_gather_at_gemma_shapes_bitwise(cuda_device, beams, width, index_dtype):
    """Gemma-2B's active cache [8, beams, 18, 2, W, 1, 256] bf16 (151-302 MB),
    with negative parents and one parent repeated in every row."""
    from iseg_tpu_torch.ops.kernels import cache_gather as cg

    gen = torch.Generator(device=cuda_device).manual_seed(beams * width)
    cache = torch.randn((8, beams, 18, 2, width, 1, 256), generator=gen, device=cuda_device)
    cache = cache.to(torch.bfloat16)
    parent = torch.randint(-beams, beams, (8, beams), generator=gen, device=cuda_device)
    parent[:, 1] = parent[:, 0]
    parent = parent.to(index_dtype)
    out = torch.empty_like(cache)
    cg.reset_launch_counts()
    cg.beam_cache_gather(cache, parent, out=out)
    torch.cuda.synchronize()
    assert cg.LAUNCH_COUNTS == {"gather": 1}
    assert torch.equal(out.view(torch.uint8),
                       cg.beam_cache_gather_reference(cache, parent).view(torch.uint8))


@pytest.mark.cuda
def test_cuda_gemma_beam_search_launches_one_gather_per_step(cuda_device):
    """The segmented beam search on the card: one kernel launch per decode
    step, none in the other programs, and the tokens of the monolithic
    search (which reorders by the plain gather)."""
    from iseg_tpu_torch.nlp.gemma import BeamSampler, ContrastiveSampler, GemmaCausalLM, get_preset
    from iseg_tpu_torch.ops.kernels import cache_gather as cg

    lm = GemmaCausalLM(get_preset("gemma_test"), device=cuda_device)
    lm.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompt = np.array([[5, 9, 3, 7], [11, 2, 0, 0]])
    lengths = np.array([4, 2])
    cg.reset_launch_counts()
    seg = lm.generate(prompt, lengths, max_length=20, sampler=BeamSampler(3), segment_len=4)
    assert cg.LAUNCH_COUNTS == {"gather": 20 - 2}
    mono = lm.generate(prompt, lengths, max_length=20, sampler=BeamSampler(3),
                       cache_policy="monolithic")
    lm.generate(prompt, lengths, max_length=20)
    lm.generate(prompt, lengths, max_length=20, sampler=ContrastiveSampler(3, 0.5))
    assert cg.LAUNCH_COUNTS == {"gather": 20 - 2}
    assert seg.device.type == "cuda" and torch.equal(seg, mono)
    assert torch.equal(seg[0, :4].cpu(), torch.tensor(prompt[0], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("with_end_token", [False, True])
def test_cuda_gemma_ragged_beam_request_gives_the_cpu_paths_tokens(cuda_device, with_end_token):
    """``samplers.top_k`` breaks exact ties by index on the CPU (the rule the
    CPU tests hold against JAX) and by ``torch.topk`` on the card. Exact ties
    arise only among continuations of dead or finished beams, which never
    reach the result: a ragged-prompt beam request with the same fp32 weights
    returns the same tokens on both devices, with the segmented and with the
    monolithic cache."""
    from iseg_tpu_torch.nlp.gemma import BeamSampler, GemmaCausalLM, get_preset

    cpu = GemmaCausalLM(get_preset("gemma_test"), device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    card = GemmaCausalLM(get_preset("gemma_test"), device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    prompt = np.array([[5, 9, 3, 7, 21, 4], [11, 2, 0, 0, 0, 0], [8, 8, 30, 1, 0, 0]])
    lengths = np.array([6, 2, 4])
    kw = dict(max_length=24, sampler=BeamSampler(4), segment_len=5)
    if with_end_token:
        # a token that the search without an end token really emits
        kw["end_token_id"] = int(cpu.generate(prompt, lengths, **kw)[1, 10])
    want = cpu.generate(prompt, lengths, **kw)
    if with_end_token:
        assert (want[:, 6:] == 0).any(), "no beam finished: the case tests nothing"
    for policy in ("segmented", "monolithic"):
        got = card.generate(prompt, lengths, cache_policy=policy, **kw)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want), policy


# The streaming kernels' rows (phase 2 of chip_smoke.py), at a few windows:
# (bnw, H, N, D, nW, dtype); the forward of the D = 64 rows is a tensor-core
# one (it writes the lse the streaming backward reads)
STREAM_SHAPES = {
    "f32_n144_d36": (9, 3, 144, 36, 3, torch.float32),
    "f32_n144_d64": (9, 3, 144, 64, 3, torch.float32),
    "bf16_n144_d64": (9, 3, 144, 64, 3, torch.bfloat16),
    "bf16_n144_d128": (9, 2, 144, 128, 3, torch.bfloat16),
    "f32_n256_d32": (8, 2, 256, 32, 4, torch.float32),
    "bf16_n256_d32": (8, 3, 256, 32, 4, torch.bfloat16),
    "bf16_n49_d24": (12, 3, 49, 24, 4, torch.bfloat16),
    "f32_n324_d20": (4, 2, 324, 20, 2, torch.float32),  # rows in rounds, unaligned rows
    "bf16_n5_d3": (5, 2, 5, 3, 1, torch.bfloat16),  # odd D: element copies and stores
}


def _assert_within_wa_tol(got, want, dtype):
    """chip_smoke.py's WA_TOL: 1e-4 of max(1, max |plain|) in f32; in bf16
    1e-2 for out, dq, dk, dv and 1e-3 for dbias."""
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(a).all(), name
        rel = 1e-4 if dtype == torch.float32 else 1e-3 if name == "dbias" else 1e-2
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(1.0, np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed_qkv"])
@pytest.mark.parametrize("shape", sorted(STREAM_SHAPES))
def test_cuda_window_attention_streaming_matches_plain_version(cuda_device, shape, packed):
    """The streaming backward (and forward where the tensor-core forwards
    do not take the shape) against the plain version, on contiguous tensors
    and on strided views of a packed qkv projection: WA_TOL."""
    bnw, h, n, d, nw, dtype = STREAM_SHAPES[shape]
    assert wa.backward_route(dtype, n, d) == "stream" and wa.keeps_lse(dtype, n, d)
    args = _wa_inputs(cuda_device, bnw, h, n, d, nw, dtype, packed=packed)
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, *args, 1.0 / np.sqrt(d))
    assert wa.LAUNCH_COUNTS == _wa_counts(dtype, n, d)
    want = _wa_run(wa.window_attention_reference, *args, 1.0 / np.sqrt(d))
    _assert_within_wa_tol(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["f32_n144_d36", "bf16_n256_d32", "f32_n324_d20"])
def test_cuda_window_attention_streaming_is_bitwise_repeatable(cuda_device, shape):
    """dbias from the sums in shared memory (N = 144) and from the chunk
    partials in device memory (N = 256, 324), and every other output, equal
    bit for bit from run to run."""
    bnw, h, n, d, nw, dtype = STREAM_SHAPES[shape]
    args = _wa_inputs(cuda_device, 3 * bnw, h, n, d, nw, dtype, seed=6, packed=True)
    first = _wa_run(wa.window_attention, *args, 0.17)
    second = _wa_run(wa.window_attention, *args, 0.17)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_window_attention_streaming_takes_misaligned_views(cuda_device, dtype):
    """q, k, v, do whose base address does not allow 16-byte copies are
    copied element by element into the same tiles: the result is the same,
    bit for bit."""
    q, k, v, bias, mask, dout = _wa_inputs(cuda_device, 8, 2, 256, 32, 4, dtype)
    storage = torch.zeros(q.numel() + 1, dtype=dtype, device=cuda_device)
    q_off = storage[1:].view(q.shape).copy_(q)
    assert q_off.data_ptr() % 16 != 0
    wa.reset_launch_counts()
    got = _wa_run(wa.window_attention, q_off, k, v, bias, mask, dout, 0.2)
    assert wa.LAUNCH_COUNTS["bwd_stream"] == 1
    want = _wa_run(wa.window_attention, q, k, v, bias, mask, dout, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------- global attention (no bias, no mask)

# (B, H, T, D, dtype): ViT-L's T (1024 patches and the class token) at its
# head dim, and an odd T, with few batch rows and heads
GLOBAL_SHAPES = {
    "f32_t1025_d64": (2, 4, 1025, 64, torch.float32),
    "bf16_t1025_d64": (2, 4, 1025, 64, torch.bfloat16),
    "f32_t37_d64": (3, 2, 37, 64, torch.float32),
    "bf16_t37_d64": (3, 2, 37, 64, torch.bfloat16),
}


def _global_run(fn, q, k, v, dout, scale, bias=None, mask=None):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    leaves = [q, k, v]
    if bias is not None:
        bias = bias.detach().clone().requires_grad_(True)
        leaves.append(bias)
    out = fn(q, k, v, bias, mask, scale)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


def _global_inputs(device, shape, seed=0):
    b, h, t, d, dtype = GLOBAL_SHAPES[shape]
    q, k, v, bias, _, dout = _wa_inputs(device, b, h, t, d, 1, dtype, seed=seed, packed=True)
    mask = torch.tensor(np.where(np.random.RandomState(seed).rand(b, t, t) > 0.8, -100.0, 0.0)
                        .astype(np.float32), device=device)
    return q, k, v, dout, bias, mask, dtype


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["no_bias_no_mask", "bias_only", "mask_only"])
@pytest.mark.parametrize("shape", sorted(GLOBAL_SHAPES))
def test_cuda_global_attention_streaming_matches_plain_version(cuda_device, shape, form):
    """Global attention on the window-attention kernels, one window per
    batch row, on views of a packed qkv projection: without a bias and a
    mask and with the bias alone through the streaming pair built with both
    operands (zero stand-ins for the missing ones), and a call with a mask
    alone (the windowed routes, a zero bias standing in): forward and
    backward against the plain version, WA_TOL."""
    q, k, v, dout, bias, mask, dtype = _global_inputs(cuda_device, shape)
    bias = bias if form == "bias_only" else None
    mask = mask if form == "mask_only" else None
    scale = 1.0 / np.sqrt(q.shape[-1])
    wa.reset_launch_counts()
    got = _global_run(wa.window_attention, q, k, v, dout, scale, bias, mask)
    n, d = q.shape[2:]
    assert wa.LAUNCH_COUNTS == (
        _wa_counts(dtype, n, d) if form == "mask_only" else
        {**dict.fromkeys(wa.LAUNCH_COUNTS, 0), "fwd_stream": 1, "bwd_stream": 1})
    want = _global_run(wa.window_attention_reference, q, k, v, dout, scale, bias, mask)
    if bias is None:  # no dbias: the tolerance check's fifth output
        got.append(np.zeros(1))
        want.append(np.zeros(1))
    _assert_within_wa_tol(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["f32_t1025_d64", "bf16_t1025_d64"])
def test_cuda_global_attention_streaming_is_bitwise_repeatable(cuda_device, shape):
    """The streaming pair's forward and backward without a bias and a mask
    (zero stand-ins for both) equal bit for bit from run to run (the fixed
    order the train steps' exact resume rests on)."""
    q, k, v, dout, _, _, _ = _global_inputs(cuda_device, shape, seed=7)
    first = _global_run(wa.window_attention, q, k, v, dout, 0.125)
    second = _global_run(wa.window_attention, q, k, v, dout, 0.125)
    for name, a, b in zip(("out", "dq", "dk", "dv"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_dot_product_attention_with_a_gradient_takes_the_kernels(cuda_device, masked):
    """``dot_product_attention`` on the card: with a gradient and no mask
    through the global-attention pair (no window-attention launch), or with
    a boolean per-batch mask through the window-attention pair built with
    both operands (the mask as its additive mask, a zero bias standing in),
    within WA_TOL of the plain version; without one, SDPA and no launch."""
    from iseg_tpu_torch.nn import attention as tattn

    rng = np.random.RandomState(8)
    q, k, v, w = (torch.tensor(rng.randn(2, 197, 4, 64).astype(np.float32),
                               device=cuda_device).to(torch.bfloat16) for _ in range(4))
    mask = torch.tensor(rng.rand(2, 1, 197, 197) < 0.8, device=cuda_device) if masked else None
    wa.reset_launch_counts()
    ga.reset_launch_counts()
    runs = []
    for fn in (tattn.dot_product_attention, tattn.dot_product_attention_reference):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask)
        runs.append([t.float().cpu().numpy()
                     for t in (out.detach(), *torch.autograd.grad(out, leaves, w))])
    if masked:
        assert wa.LAUNCH_COUNTS == {**dict.fromkeys(wa.LAUNCH_COUNTS, 0), "fwd_stream": 1,
                                    "bwd_stream": 1}
        assert not any(ga.LAUNCH_COUNTS.values())
    else:
        assert not any(wa.LAUNCH_COUNTS.values())
        assert ga.LAUNCH_COUNTS == _ga_counts("fwd", "bwd")
    _assert_within_wa_tol(runs[0] + [np.zeros(1)], runs[1] + [np.zeros(1)], torch.bfloat16)
    wa.reset_launch_counts()
    ga.reset_launch_counts()
    with torch.no_grad():
        tattn.dot_product_attention(q, k, v, mask)
    assert not any(wa.LAUNCH_COUNTS.values()) and not any(ga.LAUNCH_COUNTS.values())


# ------------------------------------- the global-attention kernel pair (bf16)

# (B, H, T, S, D): ViT-L's, EVA02-L's patch-dropped and MOAT-4 stage 2's
# shapes (phase 2 of chip_smoke.py's GA rows), ragged T against the 64-row
# tiles, T != S both ways, and head dims below their bucket and at 128
GA_SHAPES = {
    "vit_l_8x16x1025x64": (8, 16, 1025, 1025, 64),
    "eva02_l_4x16x769x64": (4, 16, 769, 769, 64),
    "moat4_2x32x1024x32": (2, 32, 1024, 1024, 32),
    "t65_d64": (3, 2, 65, 65, 64),
    "t130_d64": (3, 2, 130, 130, 64),
    "t130_d32": (2, 3, 130, 130, 32),
    "t1_d64": (2, 2, 1, 1, 64),
    "t70_s200_d64": (2, 2, 70, 200, 64),
    "t200_s70_d32": (2, 2, 200, 70, 32),
    "t97_d24": (2, 3, 97, 97, 24),
    "t97_d128": (2, 3, 97, 97, 128),
    "t97_d40": (2, 3, 97, 97, 40),
}


def _ga_counts(*forms):
    """The pair's launch counts with one launch of each of ``forms``
    (``"fwd"``, ``"bwd_bias_f32"``, ...)."""
    return {**dict.fromkeys(ga.LAUNCH_COUNTS, 0), **dict.fromkeys(forms, 1)}


def _ga_inputs(device, shape, seed=0):
    """q, k, v as views of packed projections ([B, T, H, D] each, as ViT's
    block gives them; k and v packed together where S != T) and the incoming
    gradient, bf16."""
    return _ga_tensors(device, *GA_SHAPES[shape], np.random.RandomState(seed))


def _ga_tensors(device, b, h, t, s, d, rng, dtype=torch.bfloat16):
    """``_ga_inputs``'s tensors at ``(B, H, T, S, D)`` in ``dtype``, drawn
    from ``rng``."""
    if s == t:
        q, k, v = torch.tensor(rng.randn(b, t, 3, h, d).astype(np.float32),
                               device=device).to(dtype).unbind(2)
    else:
        q = torch.tensor(rng.randn(b, t, h, d).astype(np.float32), device=device)
        k, v = torch.tensor(rng.randn(b, s, 2, h, d).astype(np.float32),
                            device=device).to(dtype).unbind(2)
        q = q.to(dtype)
    dout = torch.tensor(rng.randn(b, t, h, d).astype(np.float32), device=device)
    return q, k, v, dout.to(dtype)


def _ga_run(fn, q, k, v, dout):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GA_SHAPES))
def test_cuda_global_attention_kernels_match_plain_version(cuda_device, shape):
    """The global-attention pair against its plain version (fp32 inside),
    forward and backward, within WA_TOL[bfloat16] (1e-2 of max(1, max
    |plain|)): one forward and one backward of the pair, none of the
    window-attention kernels."""
    q, k, v, dout = _ga_inputs(cuda_device, shape)
    ga.reset_launch_counts()
    wa.reset_launch_counts()
    got = _ga_run(ga.global_attention, q, k, v, dout)
    assert ga.LAUNCH_COUNTS == _ga_counts("fwd", "bwd")
    assert not any(wa.LAUNCH_COUNTS.values())
    want = _ga_run(ga.global_attention_reference, q, k, v, dout)
    _assert_within_wa_tol(got + [np.zeros(1)], want + [np.zeros(1)], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["vit_l_8x16x1025x64", "t130_d32", "t70_s200_d64"])
def test_cuda_global_attention_kernels_are_bitwise_repeatable(cuda_device, shape):
    """Two runs of the pair's forward and backward equal bit for bit (no
    atomics: each output element is written by one block, each sum in one
    order)."""
    q, k, v, dout = _ga_inputs(cuda_device, shape, seed=3)
    first = _ga_run(ga.global_attention, q, k, v, dout)
    second = _ga_run(ga.global_attention, q, k, v, dout)
    for name, a, b in zip(("out", "dq", "dk", "dv"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_cuda_global_attention_kernels_lse_and_passes(cuda_device):
    """The forward's lse against the plain forward's, and the backward
    against the plain three passes fed the kernel's own out and lse."""
    q, k, v, dout = _ga_inputs(cuda_device, "t130_d64", seed=5)
    out, lse = ga._launch_fwd(q, k, v, 0.125)
    want_out, want_lse = ga.global_attention_forward_reference(q, k, v, 0.125)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _assert_within_wa_tol([out.float().cpu().numpy()] + [np.zeros(1)] * 4,
                          [want_out.float().cpu().numpy()] + [np.zeros(1)] * 4, torch.bfloat16)
    got = ga._launch_bwd(q, k, v, out, lse, dout, 0.125)
    want = ga.global_attention_backward_reference(q.float(), k.float(), v.float(), out, lse,
                                                  dout, 0.125)
    _assert_within_wa_tol([np.zeros(1)] + [x.float().cpu().numpy() for x in got] + [np.zeros(1)],
                          [np.zeros(1)] + [x.float().cpu().numpy() for x in want] + [np.zeros(1)],
                          torch.bfloat16)


@pytest.mark.cuda
def test_cuda_global_attention_kernels_raise_on_what_they_do_not_take(cuda_device):
    """float16, mixed types, a head dim of no whole 16-byte pieces, a
    misaligned view, a scale that is not positive: the wrapper raises, and
    launches nothing."""
    q, k, v, _ = _ga_inputs(cuda_device, "t65_d64")
    ga.reset_launch_counts()
    with pytest.raises(TypeError):
        ga.global_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ga.global_attention(q, k.float(), v)
    odd = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        ga.global_attention(odd, k, v)
    narrow = q[..., :60]
    with pytest.raises(ValueError):
        ga.global_attention(narrow, k[..., :60], v[..., :60])
    with pytest.raises(ValueError, match="positive"):
        ga.global_attention(q, k, v, scale=-0.125)
    assert not any(ga.LAUNCH_COUNTS.values())


# ------------------------------- the global-attention pair's bias form (bf16)

# (B, H, T, S, D): MOAT-4 stage 2 (phase 2's biased row and F1's MOAT-4
# step), a 1025-token tail at batch 1, T != S both ways at batch 2 and 3, a
# head dim below its bucket and the D = 128 build
GA_BIAS_SHAPES = {
    "moat4_2x32x1024x32": (2, 32, 1024, 1024, 32),
    "b1_t1025_d64": (1, 4, 1025, 1025, 64),
    "b3_t130_d32": (3, 2, 130, 130, 32),
    "b3_t65_d64": (3, 2, 65, 65, 64),
    "b2_t70_s200_d64": (2, 2, 70, 200, 64),
    "b3_t200_s70_d32": (3, 2, 200, 70, 32),
    "b2_t97_s33_d24": (2, 3, 97, 33, 24),
    "b2_t97_d128": (2, 3, 97, 97, 128),
}


def _ga_bias_inputs(device, shape, seed=0):
    """q, k, v as views of packed projections and the incoming gradient
    (bf16, as ``_ga_inputs``) and an fp32 ``[H, T, S]`` bias (0.5 x normal:
    sharper rows than MOAT's initial table)."""
    b, h, t, s, d = GA_BIAS_SHAPES[shape]
    rng = np.random.RandomState(seed)
    q, k, v, dout = _ga_tensors(device, b, h, t, s, d, rng)
    bias = torch.tensor((0.5 * rng.randn(h, t, s)).astype(np.float32), device=device)
    return q, k, v, dout, bias


def _ga_bias_run(fn, q, k, v, dout, bias, bias_grad=True):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    tb = bias.detach().clone().requires_grad_(bias_grad)
    out = fn(*leaves, bias=tb)
    grads = torch.autograd.grad(out, leaves + ([tb] if bias_grad else []), dout)
    torch.cuda.synchronize()
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GA_BIAS_SHAPES))
def test_cuda_global_attention_bias_form_matches_plain_version(cuda_device, shape):
    """The pair's bias form against its plain version (fp32 inside):
    out, dq, dk and dv within 1e-2 of max(1, max |plain|), dbias (summed
    over the batch rows) within 1e-3; one forward and one backward of the
    bias form, none of the bias-free form or the window-attention kernels."""
    q, k, v, dout, bias = _ga_bias_inputs(cuda_device, shape)
    ga.reset_launch_counts()
    wa.reset_launch_counts()
    got = _ga_bias_run(ga.global_attention, q, k, v, dout, bias)
    assert ga.LAUNCH_COUNTS == _ga_counts("fwd_bias", "bwd_bias")
    assert not any(wa.LAUNCH_COUNTS.values())
    want = _ga_bias_run(ga.global_attention_reference, q, k, v, dout, bias)
    for got_x in got:
        assert np.isfinite(got_x).all()
    _assert_within_wa_tol(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["moat4_2x32x1024x32", "b3_t200_s70_d32", "b1_t1025_d64"])
def test_cuda_global_attention_bias_form_is_bitwise_repeatable(cuda_device, shape):
    """Two runs of the bias form's forward and backward, dbias included,
    equal bit for bit (dbias: one block a tile, the batch rows added in
    increasing order, no atomics)."""
    q, k, v, dout, bias = _ga_bias_inputs(cuda_device, shape, seed=3)
    first = _ga_bias_run(ga.global_attention, q, k, v, dout, bias)
    second = _ga_bias_run(ga.global_attention, q, k, v, dout, bias)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_cuda_global_attention_bias_without_a_gradient_forms_no_dbias(cuda_device, monkeypatch):
    """A bias that records no gradient: the backward is asked for no dbias
    (no dbias kernel, no buffer), and out, dq, dk and dv equal those of the
    run that forms it bit for bit."""
    q, k, v, dout, bias = _ga_bias_inputs(cuda_device, "b3_t130_d32", seed=4)
    asked = []
    launch_bwd = ga._launch_bwd

    def record(*args, **kwargs):
        asked.append(kwargs.get("bias_grad"))
        return launch_bwd(*args, **kwargs)

    monkeypatch.setattr(ga, "_launch_bwd", record)
    without = _ga_bias_run(ga.global_attention, q, k, v, dout, bias, bias_grad=False)
    with_grad = _ga_bias_run(ga.global_attention, q, k, v, dout, bias)
    assert asked == [False, True] and len(without) == 4
    for name, a, b in zip(("out", "dq", "dk", "dv"), without, with_grad):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_cuda_global_attention_raises_on_a_batch_varying_bias_or_a_mask(cuda_device):
    """A bias that varies with the batch row, or of another shape or type,
    raises in ``global_attention``; a mask raises in
    ``global_kernel_attention``; nothing is launched."""
    from iseg_tpu_torch.nn import attention as tattn

    q, k, v, _, bias = _ga_bias_inputs(cuda_device, "b3_t65_d64")
    ga.reset_launch_counts()
    b = q.shape[0]
    for bad in (bias.expand(b, *bias.shape), bias[:, :, :64], bias.to(torch.bfloat16)):
        with pytest.raises(ValueError):
            ga.global_attention(q, k, v, bias=bad)
    mask = torch.ones(b, 1, 65, 65, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="no mask"):
        tattn.global_kernel_attention(q, k, v, mask, bias=bias[None])
    with pytest.raises(ValueError, match="does not vary with the batch row"):
        tattn.global_kernel_attention(q, k, v, bias=bias.expand(b, *bias.shape))
    assert not any(ga.LAUNCH_COUNTS.values())


@pytest.mark.cuda
def test_cuda_dot_product_attention_with_moats_bias_takes_the_bias_form(cuda_device):
    """``dot_product_attention`` with a gradient and MOAT's ``[1, H, S, S]``
    bias that records one, in bf16 on the card: one forward and one
    backward of the pair's bias form (no window-attention launch), within
    WA_TOL of the plain function on fp32 copies of the same values
    (``dot_product_attention_reference``; in bf16 it rounds the softmax to
    bf16 before p v, which the kernels do not), dbias included."""
    from iseg_tpu_torch.nn import attention as tattn

    q, k, v, dout, bias = _ga_bias_inputs(cuda_device, "b3_t130_d32", seed=6)
    ga.reset_launch_counts()
    wa.reset_launch_counts()
    runs = []
    for fn, dtype in ((tattn.dot_product_attention, torch.bfloat16),
                      (tattn.dot_product_attention_reference, torch.float32)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
        tb = bias[None].detach().clone().requires_grad_(True)
        out = fn(*leaves, bias=tb)
        grads = torch.autograd.grad(out, leaves + [tb], dout.to(dtype))
        runs.append([t.float().cpu().numpy() for t in (out.detach(), *grads)])
    assert ga.LAUNCH_COUNTS == _ga_counts("fwd_bias", "bwd_bias")
    assert not any(wa.LAUNCH_COUNTS.values())
    _assert_within_wa_tol(runs[0], runs[1], torch.bfloat16)


# ------------------------------ the global-attention pair's fp32 form

# (B, H, T, S, D, with a bias): ViT-L's, EVA02-L's patch-dropped and MOAT-4
# stage 2's shapes, a 1025-token tail at batch 1, B in {1, 2, 3}, T != S
# both ways, head dims 32 and 64 (and 24 and 128 without a bias)
GA_F32_SHAPES = {
    "vit_l_8x16x1025x64": (8, 16, 1025, 1025, 64, False),
    "eva02_l_4x16x769x64": (4, 16, 769, 769, 64, False),
    "moat4_2x32x1024x32_bias": (2, 32, 1024, 1024, 32, True),
    "b1_t1025_d64": (1, 4, 1025, 1025, 64, False),
    "b1_t1025_d64_bias": (1, 4, 1025, 1025, 64, True),
    "b3_t130_d32_bias": (3, 2, 130, 130, 32, True),
    "b2_t70_s200_d64": (2, 2, 70, 200, 64, False),
    "b2_t70_s200_d64_bias": (2, 2, 70, 200, 64, True),
    "b3_t200_s70_d32": (3, 2, 200, 70, 32, False),
    "b3_t200_s70_d32_bias": (3, 2, 200, 70, 32, True),
    "b2_t97_d24": (2, 3, 97, 97, 24, False),
    "b2_t97_d128": (2, 3, 97, 97, 128, False),
}


def _ga_f32_inputs(device, shape, seed=0):
    """fp32 q, k, v as views of packed projections, the incoming gradient,
    and an fp32 ``[H, T, S]`` bias (0.5 x normal) or None."""
    b, h, t, s, d, with_bias = GA_F32_SHAPES[shape]
    rng = np.random.RandomState(seed)
    q, k, v, dout = _ga_tensors(device, b, h, t, s, d, rng, torch.float32)
    bias = (torch.tensor((0.5 * rng.randn(h, t, s)).astype(np.float32), device=device)
            if with_bias else None)
    return q, k, v, dout, bias


def _ga_f32_run(fn, q, k, v, dout, bias, bias_grad=True):
    if bias is None:
        return _ga_run(fn, q, k, v, dout)
    return _ga_bias_run(fn, q, k, v, dout, bias, bias_grad)


def _assert_within_f32_tol(got, want):
    """1e-4 of max(1, max |plain|) for out, dq, dk, dv (and dbias)."""
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(1.0, np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GA_F32_SHAPES))
def test_cuda_global_attention_f32_form_matches_plain_version(cuda_device, shape):
    """The pair's fp32 form (split TF32) against its plain version (fp32):
    out, dq, dk, dv and dbias within 1e-4 of max(1, max |plain|); one
    forward and one backward of the fp32 form (with its bias where there is
    one), none of the bf16 forms or the window-attention kernels."""
    q, k, v, dout, bias = _ga_f32_inputs(cuda_device, shape)
    assert not k.is_contiguous()  # views of a packed projection
    ga.reset_launch_counts()
    wa.reset_launch_counts()
    got = _ga_f32_run(ga.global_attention, q, k, v, dout, bias)
    form = "" if bias is None else "_bias"
    assert ga.LAUNCH_COUNTS == _ga_counts(f"fwd{form}_f32", f"bwd{form}_f32")
    assert not any(wa.LAUNCH_COUNTS.values())
    assert all(x.dtype == np.float32 for x in got)
    want = _ga_f32_run(ga.global_attention_reference, q, k, v, dout, bias)
    _assert_within_f32_tol(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["vit_l_8x16x1025x64", "moat4_2x32x1024x32_bias",
                                   "b3_t200_s70_d32_bias", "b2_t70_s200_d64"])
def test_cuda_global_attention_f32_form_is_bitwise_repeatable(cuda_device, shape):
    """Two runs of the fp32 form's forward and backward, dbias included,
    equal bit for bit."""
    q, k, v, dout, bias = _ga_f32_inputs(cuda_device, shape, seed=3)
    first = _ga_f32_run(ga.global_attention, q, k, v, dout, bias)
    second = _ga_f32_run(ga.global_attention, q, k, v, dout, bias)
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), first, second):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_cuda_global_attention_f32_bias_without_a_gradient_forms_no_dbias(cuda_device,
                                                                         monkeypatch):
    """The fp32 bias form with a bias that records no gradient: no dbias is
    asked for, and out, dq, dk and dv equal those of the run that forms it
    bit for bit."""
    q, k, v, dout, bias = _ga_f32_inputs(cuda_device, "b3_t130_d32_bias", seed=4)
    asked = []
    launch_bwd = ga._launch_bwd

    def record(*args, **kwargs):
        asked.append(kwargs.get("bias_grad"))
        return launch_bwd(*args, **kwargs)

    monkeypatch.setattr(ga, "_launch_bwd", record)
    without = _ga_f32_run(ga.global_attention, q, k, v, dout, bias, bias_grad=False)
    with_grad = _ga_f32_run(ga.global_attention, q, k, v, dout, bias)
    assert asked == [False, True] and len(without) == 4
    for name, a, b in zip(("out", "dq", "dk", "dv"), without, with_grad):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_cuda_global_attention_f32_raises_where_its_build_does_not_take(cuda_device):
    """float16, a head dim of no multiple of 8, and an fp32 bias at D = 128
    (past the fp32 bias form's 64) raise in ``global_attention``; nothing is
    launched."""
    q, k, v, _, _ = _ga_f32_inputs(cuda_device, "b2_t97_d128")
    bias = torch.zeros(q.shape[2], q.shape[1], k.shape[1], device=cuda_device)
    ga.reset_launch_counts()
    with pytest.raises(TypeError):
        ga.global_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        ga.global_attention(q[..., :100], k[..., :100], v[..., :100])
    with pytest.raises(ValueError, match="no bias form"):
        ga.global_attention(q, k, v, bias=bias)
    assert not any(ga.LAUNCH_COUNTS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "moat_bias"])
def test_cuda_dot_product_attention_f32_takes_the_f32_form(cuda_device, with_bias):
    """``dot_product_attention`` with a gradient in fp32 on the card (TF32
    off or on), with no bias or MOAT's ``[1, H, S, S]`` one: one forward and
    one backward of the pair's fp32 form and no window-attention launch,
    within 1e-4 of the plain function; with a mask it takes the
    window-attention kernels instead."""
    from iseg_tpu_torch.nn import attention as tattn

    q, k, v, dout, bias = _ga_f32_inputs(
        cuda_device, "b3_t130_d32_bias" if with_bias else "b2_t97_d24", seed=6)
    ga.reset_launch_counts()
    wa.reset_launch_counts()
    runs = []
    for fn in (tattn.dot_product_attention, tattn.dot_product_attention_reference):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        tb = None if bias is None else bias[None].detach().clone().requires_grad_(True)
        out = fn(*leaves, bias=tb)
        grads = torch.autograd.grad(out, leaves + ([] if tb is None else [tb]), dout)
        runs.append([t.float().cpu().numpy() for t in (out.detach(), *grads)])
    form = "" if bias is None else "_bias"
    assert ga.LAUNCH_COUNTS == _ga_counts(f"fwd{form}_f32", f"bwd{form}_f32")
    assert not any(wa.LAUNCH_COUNTS.values())
    _assert_within_f32_tol(runs[0], runs[1])
    mask = torch.ones(q.shape[0], 1, q.shape[1], k.shape[1], dtype=torch.bool, device=cuda_device)
    ga.reset_launch_counts()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    tattn.dot_product_attention(*leaves, mask).sum().backward()
    assert not any(ga.LAUNCH_COUNTS.values()) and any(wa.LAUNCH_COUNTS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_dot_product_attention_whole_masked_row_is_uniform(cuda_device, dtype):
    """A boolean mask that masks rows whole (per batch row and per head),
    with a gradient on the card: the kernels' forward and q, k, v gradients
    are finite and within WA_TOL of the plain version, whose masked-whole
    rows attend uniformly."""
    from iseg_tpu_torch.nn import attention as tattn

    rng = np.random.RandomState(12)
    q, k, v, w = (torch.tensor(rng.randn(2, 197, 4, 64).astype(np.float32),
                               device=cuda_device).to(dtype) for _ in range(4))
    for shape in ((2, 1, 197, 197), (2, 4, 197, 197)):
        mask = rng.rand(*shape) < 0.8
        mask[0, 0, :5] = False  # rows masked whole
        mask[1, -1, 100] = False
        mask = torch.tensor(mask, device=cuda_device)
        runs = []
        for fn in (tattn.dot_product_attention, tattn.dot_product_attention_reference):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves, mask)
            runs.append([t.float().cpu().numpy()
                         for t in (out.detach(), *torch.autograd.grad(out, leaves, w))])
        for got in runs[0]:
            assert np.isfinite(got).all()
        _assert_within_wa_tol(runs[0] + [np.zeros(1)], runs[1] + [np.zeros(1)], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d136", "float64"])
def test_cuda_dot_product_attention_at_shapes_the_kernels_lack(cuda_device, case):
    """With a gradient on the card, a head dim above 128 and float64 take
    the plain version in one type (no kernel launch, no error), equal to the
    reference, and repeat bit for bit."""
    from iseg_tpu_torch.nn import attention as tattn

    d, dtype = (136, torch.float32) if case == "d136" else (64, torch.float64)
    rng = np.random.RandomState(13)
    q, k, v, w = (torch.tensor(rng.randn(2, 77, 4, d), dtype=dtype, device=cuda_device)
                  for _ in range(4))
    mask = torch.tensor(rng.rand(2, 1, 77, 77) < 0.8, device=cuda_device)
    wa.reset_launch_counts()
    runs = []
    for fn in (tattn.dot_product_attention, tattn.dot_product_attention,
               tattn.dot_product_attention_reference):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask)
        runs.append([t.cpu() for t in (out.detach(), *torch.autograd.grad(out, leaves, w))])
    assert not any(wa.LAUNCH_COUNTS.values())
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-5 * float(c.abs().max()))


# ------------------------------------------------------- W8A8 at any K, N

@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2730, 1001), (21, 13)])
def test_cuda_w8a8_at_any_k_and_n_equals_the_cpu_bitwise(cuda_device, k, n):
    """``int8_matmul`` (zero-padded to torch._int_mm's multiples of 8 on the
    card) and a W8A8 ``QuantDense`` forward at EVA02-L's SwiGLU width and at
    odd widths: equal to the CPU's results bit for bit."""
    from iseg_tpu_torch import convert
    from iseg_tpu_torch.ops import quant as tq

    rng = np.random.RandomState(k + n)
    x_q = torch.tensor(rng.randint(-127, 128, (8, k)).astype(np.int8))
    w_q = torch.tensor(rng.randint(-127, 128, (n, k)).astype(np.int8)).t()
    got = tq.int8_matmul(x_q.to(cuda_device), w_q.to(cuda_device))
    assert tuple(got.shape) == (8, n)
    assert torch.equal(got.cpu(), tq.int8_matmul(x_q, w_q))
    tree = tq.quantize_dense_tree({"kernel": torch.tensor(rng.randn(k, n).astype(np.float32)),
                                   "kernel_scale": torch.ones(n)})
    x = torch.tensor(rng.randn(3, 5, k).astype(np.float32))
    outs = []
    for device in ("cpu", cuda_device):
        dense = tq.QuantDense(k, n, dtype=torch.float32, device=device)
        convert.load_flax(dense, {"params": tree})
        assert dense.weight.dtype == torch.int8
        outs.append(dense(x.to(device)).cpu())
    assert torch.equal(outs[0], outs[1])
