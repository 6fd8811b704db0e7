"""The port's JPU head, the pyramid heads' sizing by resolution, and the
HRNet + JPU slice with an aux head against ``iseg_tpu``'s, with the same
weights (carried by ``iseg_tpu_torch.convert``), on the CPU.

Tolerances: the JPU alone in eval mode in fp32 to 1e-5 of the output's
largest magnitude; in train mode (float64 both sides) the output and every
gradient to 1e-9 of their largest magnitude. The slice (``HRNet(width=8,
stage_modules=(1, 1, 1, 1))`` + JPU(16), 5 classes, 64x64, batch 2, the aux
logits conv on the os32 branch, the fused upsample + CE loss on its plain
version here and on the JAX package's CPU path there) in float64 with the
JAX align-corners resize in float64 (see ``tests/test_torch_hrnet.py``):
eval logits of both outputs to 1e-5 of max in fp32; the loss and its two
parts rtol 1e-6 (the model casts logits to fp32 before the loss), every
gradient to 1e-5 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.hrnet import HRNet as JHRNet
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.nn.heads.jpu import JPU as JJPU
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones.hrnet import HRNet as THRNet
from iseg_tpu_torch.convert import flatten, load_flax, param_tree
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.examples.train_seg import build_head
from iseg_tpu_torch.nn.heads import JPU as TJPU
from iseg_tpu_torch.nn.heads import SemanticFPN
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints, select_pyramid_levels
from test_torch_hrnet import _align_corners_f64, _close_to_max, _init, _nhwc, _random_stats

torch.set_num_threads(1)

HW = 64
SMALL = dict(width=8, stage_modules=(1, 1, 1, 1))
# HRNet(width 8)'s endpoints at 64x64: b0..b3 and the os4 concat
SHAPES = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64), (2, 16, 16, 120)]


def _feats(dtype=np.float32):
    rng = np.random.RandomState(2)
    return [rng.randn(*s).astype(dtype) for s in SHAPES]


def _jpu_pair(feats):
    jmod = JJPU(filters=16)
    variables = _random_stats(_init(jmod, [jnp.asarray(f) for f in feats]))
    tmod = TJPU([16, 32, 64], filters=16)
    load_flax(tmod, variables)
    return jmod, tmod, variables


def test_torch_jpu_eval_matches_jax():
    feats = _feats()
    jmod, tmod, variables = _jpu_pair(feats)
    tmod.eval()
    with torch.no_grad():
        t = tmod([torch.tensor(f).permute(0, 3, 1, 2) for f in feats])
    j = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables,
                                                             [jnp.asarray(f) for f in feats])
    assert tmod.out_channels == 64 and t.shape == (2, 64, 8, 8)  # 4 x 16 wide at os8
    _close_to_max(_nhwc(t), j)
    params = flatten(variables["params"])
    # the depthwise 3x3 keeps its bias and has no activation; BN after it
    assert params["dw_conv4/kernel"].shape == (3, 3, 1, 48) and "dw_conv4/bias" in params
    assert "dw_norm8/scale" in params and "pw_conv2/conv/kernel" in params
    assert tmod.dw_conv8.dilation == (8, 8) and tmod.dw_conv8.groups == 48


def test_torch_jpu_train_output_and_grads_match_jax():
    feats = _feats(np.float64)
    jmod, tmod, variables = _jpu_pair([f.astype(np.float32) for f in feats])
    weight = np.random.RandomState(3).randn(2, 8, 8, 64)
    tmod.double().train()
    xs = [torch.tensor(f).permute(0, 3, 1, 2).requires_grad_(True) for f in feats]
    t = tmod(xs)
    (t.permute(0, 2, 3, 1) * torch.tensor(weight)).sum().backward()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def j_loss(params, xs):
            out, _ = jmod.apply({"params": params, "batch_stats": v64["batch_stats"]}, xs,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out * weight), out

        (_, j), (j_grads, j_xgrads) = jax.jit(jax.value_and_grad(j_loss, (0, 1), has_aux=True))(
            v64["params"], [jnp.asarray(f) for f in feats])
        j = np.asarray(j)
        j_grads = flatten(jax.tree_util.tree_map(np.asarray, j_grads))
        j_xgrads = [np.asarray(g) for g in j_xgrads]
    _close_to_max(_nhwc(t), j, tol=1e-9)
    for k, p in param_tree(tmod).items():
        g = p.grad.permute(2, 3, 1, 0) if p.grad.ndim == 4 else p.grad
        # the depthwise biases sit right before a train-mode BN: their
        # gradient is zero up to rounding (1e-14) on both sides
        atol = 1e-9 * max(float(np.abs(j_grads[k]).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), j_grads[k], atol=atol, rtol=0, err_msg=k)
    # only the three coarsest distinct levels are read; the os4 ones get none
    for i, (x, jg) in enumerate(zip(xs, j_xgrads)):
        if i in (1, 2, 3):
            _close_to_max(_nhwc(x.grad), jg, tol=1e-9, what=f"endpoint {i}")
        else:
            assert x.grad is None and not np.abs(jg).any()


# ------------------------------------------------------------ sizing by resolution

def test_torch_pyramid_levels_follow_the_forward_selection():
    """The helper picks the widths of the tensors ``select_pyramid_endpoints``
    hands the head: HRNet's os4 concat (last at os4) instead of its first
    branch, in fine -> coarse order."""
    eps = [torch.zeros(s).permute(0, 3, 1, 2) for s in SHAPES]
    strides = [4, 8, 16, 32, 4]
    widths = [s[-1] for s in SHAPES]
    for n in (3, 4):
        picked = [int(e.shape[1]) for e in select_pyramid_endpoints(eps, n)]
        assert select_pyramid_levels(widths, strides, n) == picked
    assert select_pyramid_levels(widths, strides, 4) == [120, 16, 32, 64]
    assert select_pyramid_levels(widths, strides, 3) == [16, 32, 64]
    # positional order still holds where the backbone lists fine -> coarse
    assert select_pyramid_levels([64, 96, 192, 384, 768], [4, 4, 8, 16, 32], 4) == [96, 192, 384,
                                                                                  768]
    with pytest.raises(ValueError):
        select_pyramid_levels([1, 2], [4], 2)


@pytest.mark.parametrize("head", ["fpn", "jpu"])
def test_torch_build_head_sizes_pyramid_heads_by_resolution(head):
    """``train_seg``'s ``build_head`` sizes the FPN and the JPU for the
    endpoints their forward selects, so HRNet + either runs (sized by
    position, the FPN was built for [2w, 4w, 8w, 15w] and fed
    [15w, 2w, 4w, 8w])."""
    bb = get_backbone("hrnet_w32", stage_modules=(1, 1, 1, 1))
    h = build_head(head, bb)
    assert isinstance(h, SemanticFPN if head == "fpn" else TJPU)
    model = TSegManaged(num_class=3, backbone=bb, head=h).eval()
    with torch.no_grad():
        out = model(torch.rand(1, 64, 64, 3))
    assert out.shape == (1, 64, 64, 3) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name,kw", [
    ("swin_tiny", {}), ("resnet50", dict(output_stride=32)),
    ("intern_image_tiny", dict(dcn_sampling="gather")),
], ids=["swin", "resnet_os32", "intern"])
def test_torch_pyramid_sizing_keeps_the_other_backbones_choice(name, kw):
    """Where a backbone lists its endpoints fine -> coarse with one endpoint
    a stride (Swin's two os4 ones aside, the last of which wins), sizing by
    resolution picks what sizing by position picked."""
    bb = get_backbone(name, **kw)
    levels = select_pyramid_levels(bb.endpoint_channels, bb.endpoint_strides, 4)
    assert levels == bb.endpoint_channels[-4:]


# ------------------------------------------------------------ the slice

NUM_CLASS, BATCH = 5, 2


def _slice_pair():
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JHRNet(**SMALL, w_fold=False),
                     head=JJPU(filters=16), num_aux_loss=1, use_aux_head_endpoints=True,
                     upsample_logits=False, fuse_upsample_loss=True)
    bb = THRNet(**SMALL)
    head = TJPU(select_pyramid_levels(bb.endpoint_channels, bb.endpoint_strides, 3), filters=16)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb, head=head, num_aux_loss=1,
                     use_aux_head_endpoints=True, upsample_logits=False,
                     fuse_upsample_loss=True)
    variables = _random_stats(_init(jm, jnp.zeros((1, HW, HW, 3))))
    load_flax(tm, variables)
    return jm, tm, variables


def _batch():
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
    label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
    return {"image": image, "label": label}


def test_torch_hrnet_jpu_aux_slice_matches_jax(monkeypatch):
    jm, tm, variables = _slice_pair()
    batch = _batch()
    j_out = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables,
                                                               jnp.asarray(batch["image"]))
    tm.eval()
    with torch.no_grad():
        t_out = tm(torch.tensor(batch["image"]))
    assert sorted(t_out) == sorted(j_out) == ["output_0", "output_1"]
    assert t_out["output_0"].shape == (BATCH, 8, 8, NUM_CLASS)  # JPU at os8
    assert t_out["output_1"].shape == (BATCH, 2, 2, NUM_CLASS)  # aux on the os32 branch
    for k in j_out:
        _close_to_max(t_out[k].numpy(), j_out[k], what=k)

    import iseg_tpu.backbones.hrnet as jhrnet

    monkeypatch.setattr(jhrnet, "resize_image", _align_corners_f64)
    j_loss_fn = jm.build_loss_fn()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def j_loss(params):
            out, _ = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                              jnp.asarray(batch["image"], jnp.float64), train=True,
                              mutable=["batch_stats"])
            return j_loss_fn(out, jnp.asarray(batch["label"]))

        (j_val, j_parts), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
            v64["params"])
        j_parts = {k: float(v) for k, v in j_parts.items()}
        j_flat = flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    tm.double().train()
    loss, parts = tm.build_loss_fn()(tm(torch.tensor(batch["image"], dtype=torch.float64)),
                                     torch.tensor(batch["label"]))
    loss.backward()
    assert sorted(parts) == sorted(j_parts) == ["loss", "output_0_loss", "output_1_loss"]
    for k in j_parts:
        np.testing.assert_allclose(float(parts[k].detach()), j_parts[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(j_parts["loss"], j_parts["output_0_loss"]
                               + 0.4 * j_parts["output_1_loss"], rtol=1e-6)
    t_params = param_tree(tm)
    assert sorted(t_params) == sorted(j_flat)
    for k, p in t_params.items():
        g = p.grad.permute(2, 3, 1, 0) if p.grad.ndim == 4 else p.grad
        atol = 1e-5 * max(float(np.abs(j_flat[k]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), j_flat[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("src,dst", [((4, 4), (16, 16)), ((2, 3), (16, 24)), ((5, 7), (12, 9)),
                                     ((16, 16), (4, 4)), ((1, 3), (4, 5))],
                         ids=["x4", "x8", "ragged", "down", "one_row"])
@pytest.mark.parametrize("align_corners", [False, True], ids=["half_pixel", "align_corners"])
def test_torch_matrix_resize_matches_interpolate_and_jax(src, dst, align_corners):
    """``resize_bilinear_matmul`` (the HRNet fuse and head resizes, the JPU's)
    gives ``F.interpolate``'s values and, where the JAX package resizes that
    way (every align-corners case; half-pixel upsampling by ``jax.image.resize``),
    the JAX package's, in fp32 to 1e-5 (values of order 1; the weights are
    rounded at other points); its gradient is the transposed products'."""
    import torch.nn.functional as F

    from iseg_tpu.ops.resize import resize_image as j_resize
    from iseg_tpu_torch.ops.resize import resize_bilinear_matmul, resize_nchw

    x = np.random.RandomState(4).randn(2, *src, 3).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    got = resize_bilinear_matmul(t, dst, align_corners)
    ref = F.interpolate(torch.tensor(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                        align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=1e-5, rtol=0)
    if align_corners or all(d >= s for d, s in zip(dst, src)):
        j = np.asarray(j_resize(jnp.asarray(x), dst, "bilinear", align_corners=align_corners))
        np.testing.assert_allclose(got.detach().numpy(), j, atol=1e-5, rtol=0)
    g = np.random.RandomState(5).randn(*got.shape).astype(np.float32)
    (got * torch.tensor(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: jax.image.resize(v, (2, *dst, 3), "linear")
                     if not align_corners else j_resize(v, dst, "bilinear", align_corners=True),
                     jnp.asarray(x))
    if align_corners or all(d >= s for d, s in zip(dst, src)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   atol=1e-5, rtol=0)
    nchw = resize_nchw(torch.tensor(x).permute(0, 3, 1, 2), dst, align_corners)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), got.detach().numpy())
