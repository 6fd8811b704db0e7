"""The port's MobileNetV2, SimpleDecoder and the MobileNetV2 + SimpleDecoder
slice against ``iseg_tpu``'s, with the same weights (carried by
``iseg_tpu_torch.convert``) and the same inputs, on the CPU.

Tolerances: eval-mode endpoints, the eval decoder and logits in fp32 to
1e-5 of the tensor's largest magnitude (the summation order differs
between XLA and PyTorch, about 20 conv + BN layers deep). Train mode runs
the network in float64 on both sides, because train-mode BN over the few
values per channel of the deepest blocks (2 x 4 x 4 at 64x64) magnifies
fp32 rounding: endpoints to 1e-9 of max, BN running stats rtol 1e-6 /
atol 1e-7 (read back as fp32), the train decoder to 1e-4 of max in fp32
(16 values per channel); the loss rtol 1e-6 (fp32 logits) and gradients
to 1e-5 of each tensor's largest magnitude; the 3 SGD steps (see
``tests/test_torch_train.py``): losses rtol 1e-6, params and batch_stats
rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.mobilenetv2 import MobileNetV2 as JMobileNetV2
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.nn.heads.simpledecoder import SimpleDecoder as JSimpleDecoder
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones.mobilenetv2 import MobileNetV2 as TMobileNetV2
from iseg_tpu_torch.backbones.mobilenetv2 import _make_divisible
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.nn.heads import SimpleDecoder as TSimpleDecoder

torch.set_num_threads(1)

TOL = 1e-5
HW = 64


def _random_stats(variables, seed=1):
    """Non-trivial running stats, so eval mode really reads them."""
    rng = np.random.RandomState(seed)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else 0.1 * rng.randn(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


def _init(jmod, x, **kw):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda v: jmod.init(jax.random.PRNGKey(0), v, train=False, **kw))(x))


def _close_to_max(t, j, tol=TOL, what=""):
    t = np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    assert np.abs(j).max() > 0, what
    np.testing.assert_allclose(t, j, atol=tol * np.abs(j).max(), rtol=0, err_msg=what)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- backbone

BACKBONES = {f"os{os_}_w{w}_{'top' if top else 'notop'}": dict(
    output_stride=os_, width_multiplier=w, include_top_conv=top)
    for os_ in (8, 16, 32) for w in (1.0, 0.35) for top in (True, False)}


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).rand(2, HW, HW, 3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_torch_mobilenetv2_eval_endpoints_match_jax(name, image):
    kw = BACKBONES[name]
    jmod, tmod = JMobileNetV2(**kw), TMobileNetV2(**kw)
    variables = _random_stats(_init(jmod, jnp.asarray(image)))
    load_flax(tmod, variables)
    tmod.eval()
    with torch.no_grad():
        t_eps = tmod(torch.tensor(image).permute(0, 3, 1, 2))
    j_eps = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(image))
    assert len(t_eps) == len(j_eps) == 5
    for i, (t, j) in enumerate(zip(t_eps, j_eps)):
        _close_to_max(_nhwc(t), j, what=f"endpoint {i}")
    assert tmod.endpoint_channels == [int(e.shape[-1]) for e in j_eps]
    # the endpoints' strides: 2, 4, 8, then capped at the output stride
    strides = [HW // int(e.shape[1]) for e in j_eps]
    os_ = kw["output_stride"]
    assert strides == [2, 4, 8, min(16, os_), os_]
    top = _make_divisible(1280 * max(1.0, kw["width_multiplier"]))
    assert tmod.out_channels == (top if kw["include_top_conv"] else
                                 _make_divisible(320 * kw["width_multiplier"]))


def test_torch_mobilenetv2_atrous_rewrite_blocks():
    """os16: the first 160-wide block keeps stride 1, dilates by 2 and has no
    residual (96 -> 160); later blocks keep the dilation and the residual."""
    m = TMobileNetV2(output_stride=16)  # blocks: 16 | 24 x2 | 32 x3 | 64 x4 | 96 x3 | 160 x3 | 320
    first160 = m.block_13
    assert first160.depthwise.conv.stride == (1, 1) and first160.depthwise.conv.dilation == (2, 2)
    assert not first160.residual and first160.out_channels == 160
    assert m.block_14.residual and m.block_14.depthwise.conv.dilation == (2, 2)
    assert m.block_16.depthwise.conv.dilation == (2, 2) and not m.block_16.residual
    assert m.block_12.depthwise.conv.dilation == (1, 1) and m.block_12.residual
    assert m.block_0.expand is None and m.block_0.depthwise.conv.groups == 32
    assert m.stem.norm.epsilon == 1e-3 and m.block_5.project.norm.epsilon == 1e-3
    m8 = TMobileNetV2(output_stride=8)
    assert m8.block_6.depthwise.conv.dilation == (2, 2) and m8.block_6.depthwise.conv.stride == (1, 1)
    assert m8.block_13.depthwise.conv.dilation == (4, 4)
    assert "mobilenetv2" in list_backbones()
    assert isinstance(get_backbone("mobilenetv2", output_stride=16), TMobileNetV2)


def test_torch_mobilenetv2_train_endpoints_and_stats_match_jax(image):
    """Train mode in float64 on both sides: over the 2 x 4 x 4 values per
    channel of the deepest blocks, train-mode BN magnifies fp32 rounding
    (the two fp32 runs part by 7e-4 of max at the last endpoint)."""
    kw = dict(output_stride=16, width_multiplier=0.35, include_top_conv=True)
    jmod, tmod = JMobileNetV2(**kw), TMobileNetV2(**kw)
    variables = _random_stats(_init(jmod, jnp.asarray(image)))
    load_flax(tmod, variables)
    tmod.double().train()
    t_eps = tmod(torch.tensor(image, dtype=torch.float64).permute(0, 3, 1, 2))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_eps, mutated = jax.jit(
            lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
            v64, jnp.asarray(image, jnp.float64))
        j_eps = [np.asarray(e) for e in j_eps]
        theirs = flatten(jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    for i, (t, j) in enumerate(zip(t_eps, j_eps)):
        _close_to_max(_nhwc(t), j, tol=1e-9, what=f"endpoint {i}")
    ours = flatten(to_flax(tmod)["batch_stats"])
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        # to_flax returns float32: compare at float32 resolution
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_torch_batch_norm_keeps_float64():
    """BN of a float64 input computes its moments in float64, as flax does
    (it promotes with fp32): moments rounded to fp32 moved the float64
    gradients of this slice by 1% of their largest value."""
    from iseg_tpu_torch.nn.norm import BatchNorm

    x = torch.tensor(np.random.RandomState(3).randn(4, 3, 5, 5) * 1e3 + 7.0)
    bn = BatchNorm(3).double().train()
    y = bn(x)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    assert y.dtype == torch.float64
    torch.testing.assert_close(y, (x - mean) / torch.sqrt(var + 1e-3), rtol=1e-12, atol=1e-12)


def test_torch_mobilenetv2_convert_round_trip(image):
    """Every flax leaf (depthwise kernels [3,3,1,C] included) maps by path
    and comes back unchanged."""
    kw = dict(output_stride=16, width_multiplier=0.35, include_top_conv=True)
    jm = JSegManaged(num_class=3, backbone=JMobileNetV2(**kw), head=JSimpleDecoder(16, 8))
    variables = _random_stats(_init(jm, jnp.asarray(image)))
    bb = TMobileNetV2(**kw)
    tm = TSegManaged(num_class=3, backbone=bb, head=TSimpleDecoder(bb.endpoint_channels, 16, 8))
    load_flax(tm, variables)
    back = to_flax(tm)
    for col in ("params", "batch_stats"):
        ours, theirs = flatten(back[col]), flatten(variables[col])
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    dw = flatten(variables["params"])["backbone/block_3/depthwise/conv/kernel"]
    assert dw.shape[:3] == (3, 3, 1)
    assert tuple(bb.block_3.depthwise.conv.weight.shape) == (dw.shape[3], 1, 3, 3)


# ---------------------------------------------------------------- decoder

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_torch_simpledecoder_matches_jax(train):
    rng = np.random.RandomState(2)
    shapes = [(2, 16, 16, 8), (2, 8, 8, 12), (2, 4, 4, 16), (2, 4, 4, 24)]
    feats = [rng.randn(*s).astype(np.float32) for s in shapes]
    jmod = JSimpleDecoder(filters=16, low_level_filters=8)
    variables = _random_stats(_init(jmod, [jnp.asarray(f) for f in feats]))
    tmod = TSimpleDecoder([s[-1] for s in shapes], filters=16, low_level_filters=8)
    load_flax(tmod, variables)
    tmod.train(train)
    t = tmod([torch.tensor(f).permute(0, 3, 1, 2) for f in feats])
    j = jax.jit(lambda v, x: jmod.apply(v, x, train=train, mutable=["batch_stats"])[0])(
        variables, [jnp.asarray(f) for f in feats])
    assert tmod.out_channels == 16
    _close_to_max(_nhwc(t), j, tol=1e-4 if train else TOL)  # stride-4 endpoint, at its size
    assert t.shape[2:] == (16, 16) or t.shape[2:] == (8, 8)


# ---------------------------------------------------------------- the slice

NUM_CLASS, BATCH = 5, 2
SLICE_BB = dict(output_stride=16, width_multiplier=0.35, include_top_conv=False)
OPT = dict(learning_rate=0.01, train_steps=1000, weight_decay=1e-4)


def _slice_pair(fused: bool):
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JMobileNetV2(**SLICE_BB),
                     head=JSimpleDecoder(filters=32, low_level_filters=8),
                     upsample_logits=not fused, fuse_upsample_loss=fused)
    bb = TMobileNetV2(**SLICE_BB)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                     head=TSimpleDecoder(bb.endpoint_channels, filters=32, low_level_filters=8),
                     upsample_logits=not fused, fuse_upsample_loss=fused)
    variables = _init(jm, jnp.zeros((1, HW, HW, 3)))
    load_flax(tm, variables)
    return jm, tm, variables


def _batch():
    rng = np.random.RandomState(0)
    image = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
    label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
    return {"image": image, "label": label}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_torch_mbv2_simpledecoder_logits_loss_and_grads_match_jax(fused):
    """Logits (eval, fp32), then the train-mode loss and every parameter's
    gradient with the network in float64 on both sides (the logits are cast
    to fp32 before the loss, as the model does); fused runs the loss
    kernel's plain version on the CPU (the JAX side its CPU path), unfused
    the full-resolution logits + CE. In fp32 the two sides' gradients part
    by up to 1% of max on this tiny model, as JAX's fp32 gradients part from
    its own float64 ones (train-mode BN over 32 values per channel)."""
    jm, tm, variables = _slice_pair(fused)
    batch = _batch()
    j_logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables,
                                                                 jnp.asarray(batch["image"]))
    t_logits = tm.inference(torch.tensor(batch["image"])).numpy()
    side = HW // 4 if fused else HW
    assert t_logits.shape == (BATCH, side, side, NUM_CLASS)
    _close_to_max(t_logits, j_logits, what="logits")

    j_loss_fn = jm.build_loss_fn()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def j_loss(params):
            out, _ = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                              jnp.asarray(batch["image"], jnp.float64), train=True,
                              mutable=["batch_stats"])
            return j_loss_fn(out, jnp.asarray(batch["label"]))[0]

        j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(v64["params"])
        j_val = float(j_val)
        j_flat = flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    tm.double().train()
    loss, _ = tm.build_loss_fn()(tm(torch.tensor(batch["image"], dtype=torch.float64)),
                                 torch.tensor(batch["label"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), j_val, rtol=1e-6)
    t_params = param_tree(tm)
    assert sorted(t_params) == sorted(j_flat)
    for k, p in t_params.items():
        g = p.grad.permute(2, 3, 1, 0) if p.grad.ndim == 4 else p.grad
        j = j_flat[k]
        # a BN bias before a train-mode BN has a zero gradient (1e-16 of noise)
        atol = 1e-5 * max(float(np.abs(j).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), j, atol=atol, rtol=0, err_msg=k)


def test_torch_mbv2_simpledecoder_three_train_steps_match_jax():
    """Fused loss, float64 network on both sides (the logits are cast to
    fp32 before the loss, as the model does)."""
    jm, tm, variables = _slice_pair(fused=True)
    batch = _batch()
    tm.double()
    t_tx, _ = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    t_state = create_train_state(tm, None, t_tx, initialized=True)
    t_step = make_train_step(tm.build_loss_fn())
    t_batch = {"image": torch.tensor(batch["image"], dtype=torch.float64),
               "label": torch.tensor(batch["label"])}
    t_losses = []
    for _ in range(3):
        t_state, t_parts = t_step(t_state, t_batch)
        t_losses.append(float(t_parts["loss"]))
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx, _ = jopt.get_optimizer(variables["params"], "sgd", **OPT)
        j_state = j_create_train_state(jm, jax.random.PRNGKey(0), (BATCH, HW, HW, 3), j_tx,
                                       variables=variables)
        j_step = j_make_train_step(jm.build_loss_fn(), donate=False)
        j_batch = {"image": jnp.asarray(batch["image"], jnp.float64),
                   "label": jnp.asarray(batch["label"])}
        j_losses = []
        for _ in range(3):
            j_state, j_parts = j_step(j_state, j_batch, jax.random.PRNGKey(1))
            j_losses.append(float(j_parts["loss"]))
        j_trees = {"params": flatten(jax.tree_util.tree_map(np.asarray, j_state.params)),
                   "batch_stats": flatten(jax.tree_util.tree_map(np.asarray,
                                                                 j_state.batch_stats))}
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
    assert t_state.step == int(j_state.step) == 3
    ours = to_flax(tm)
    for col, theirs in j_trees.items():
        mine = flatten(ours[col])
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{col}/{k}")
