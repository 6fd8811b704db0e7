"""The port's layers against ``iseg_tpu``'s, with the same weights (carried
by ``iseg_tpu_torch.convert``) and the same numpy inputs.

The port's modules are NCHW and the JAX ones NHWC, so inputs and outputs
are permuted at the comparison. fp32 on the CPU. Tolerances: single layers
agree to atol 1e-5 / rtol 1e-5 (conv sums run in another order); resizes
to 1e-6 (the same interpolation, float32 throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nn import blocks as jblocks
from iseg_tpu.nn import conv as jconv
from iseg_tpu.nn import norm as jnorm
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu.ops import resize as jresize
from iseg_tpu_torch.convert import load_flax, to_flax
from iseg_tpu_torch.nn import blocks as tblocks
from iseg_tpu_torch.nn import conv as tconv
from iseg_tpu_torch.nn import norm as tnorm
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP
from iseg_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize_norms(variables, seed=1):
    """Non-trivial BN scale/bias/mean/var, so the test sees them used."""
    rng = np.random.RandomState(seed)

    def fix(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean",) or (name == "bias" and path[-2].key.endswith("norm")):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, variables)


def _pair(jmod, tmod, x, seed=0):
    """Init the JAX module, randomize its norms, load into the torch one."""
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, variables))
    load_flax(tmod, variables)
    return variables


def _compare(jmod, tmod, x, train, atol=ATOL, rtol=RTOL):
    variables = _pair(jmod, tmod, x)
    tmod.train(train)
    t_out = tmod(_nchw(x))
    if train:
        j_out, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        j_stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
        t_stats = to_flax(tmod)["batch_stats"]
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=atol, rtol=rtol),
            t_stats, j_stats)
    else:
        j_out = jmod.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(_nhwc(t_out), np.asarray(j_out), atol=atol, rtol=rtol)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("size", [(11, 13), (3, 4), (5, 7), (16, 4)],
                         ids=["up", "down", "same", "mixed"])
def test_torch_resize_bilinear_matches_jax(size):
    x = _x((2, 5, 7, 3))
    t = tresize.resize_image(torch.tensor(x), size, "bilinear").numpy()
    j = np.asarray(jresize.resize_image(jnp.asarray(x), size, "bilinear"))
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("size", [(13, 17), (3, 5), (512, 512)], ids=["up", "down", "x16"])
def test_torch_resize_nearest_int_labels_matches_jax(size):
    src_hw = (5, 7) if size != (512, 512) else (32, 32)
    y = np.random.RandomState(0).randint(0, 21, (2, *src_hw, 1)).astype(np.int32)
    t = tresize.resize_image(torch.tensor(y), size).numpy()
    j = np.asarray(jresize.resize_image(jnp.asarray(y), size))
    np.testing.assert_array_equal(t, j)


def test_torch_resize_align_corners_matches_jax():
    x = _x((2, 5, 7, 3))
    t = tresize.resize_image(torch.tensor(x), (9, 4), align_corners=True).numpy()
    j = np.asarray(jresize.resize_image(jnp.asarray(x), (9, 4), align_corners=True))
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)


def test_torch_scaled_size_matches_jax():
    for hw, s in [((512, 512), 0.75), ((375, 500), 1.25), ((3, 3), 0.1)]:
        assert tresize.scaled_size(*hw, s) == jresize.scaled_size(*hw, s)


# ------------------------------------------------------------------ conv


CONV_CASES = {
    "k3_s2_even": dict(kernel_size=3, strides=2, size=8),
    "k3_s2_odd": dict(kernel_size=3, strides=2, size=9),
    "k5_s2_odd": dict(kernel_size=5, strides=2, size=7),
    "k1_s2_odd": dict(kernel_size=1, strides=2, size=7),
    "k3_d2": dict(kernel_size=3, dilation=2, size=9),
    "k3_d3_s2": dict(kernel_size=3, dilation=3, strides=2, size=10),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_torch_conv_norm_act_same_padding_matches_jax(case, train):
    kw = dict(CONV_CASES[case])
    size = kw.pop("size")
    x = _x((2, size, size + 1, 4))
    jmod = jconv.ConvNormAct(filters=6, **kw)
    tmod = tconv.ConvNormAct(4, 6, **kw)
    _compare(jmod, tmod, x, train)


def test_torch_conv_with_bias_no_norm_gelu_matches_jax():
    x = _x((2, 6, 6, 4))
    _compare(jconv.ConvNormAct(filters=5, norm=None, act="gelu"),
             tconv.ConvNormAct(4, 5, norm=None, act="gelu"), x, train=False)


@pytest.mark.parametrize("act", ["relu", "relu6", "gelu", "silu", "sigmoid", "tanh",
                                 "hard_swish", "hard_sigmoid"])
def test_torch_activations_match_jax(act):
    x = 4.0 * _x((64,))
    t = tconv._resolve_act(act)(torch.tensor(x)).numpy()
    j = np.asarray(jconv._resolve_act(act)(jnp.asarray(x)))
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_torch_sep_conv_norm_act_matches_jax(train):
    x = _x((2, 9, 9, 4))
    _compare(jconv.SepConvNormAct(filters=6, dilation=2, depth_multiplier=2),
             tconv.SepConvNormAct(4, 6, dilation=2, depth_multiplier=2), x, train)


def test_torch_norm_conv_act_matches_jax():
    x = _x((2, 6, 6, 4))
    _compare(jconv.NormConvAct(filters=5), tconv.NormConvAct(4, 5), x, train=True)


# ------------------------------------------------------------------ norm


def test_torch_batch_norm_two_train_updates_match_jax():
    x1, x2 = 2.0 + 3.0 * _x((4, 5, 5, 3), 0), -1.0 + 0.5 * _x((4, 5, 5, 3), 1)
    jmod = jnorm.BatchNorm(use_running_average=False)
    variables = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x1)))
    tmod = tnorm.BatchNorm(3)
    load_flax(tmod, variables)
    tmod.train()
    for x in (x1, x2):
        j_out, mutated = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        t_out = tmod(_nchw(x))
        np.testing.assert_allclose(_nhwc(t_out), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    stats = to_flax(tmod)["batch_stats"]
    np.testing.assert_allclose(stats["mean"], variables["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(stats["var"], variables["batch_stats"]["var"], rtol=1e-6)


def test_torch_bn_momentum_override_is_read_at_construction():
    tnorm.set_bn_momentum(0.9)
    try:
        assert tconv.ConvNormAct(3, 4).norm.momentum == 0.9
    finally:
        tnorm.set_bn_momentum(None)
    assert tconv.ConvNormAct(3, 4).norm.momentum == 0.99


def test_torch_unported_norms_raise():
    with pytest.raises(NotImplementedError):
        tnorm.normalization("group_norm")
    with pytest.raises(ValueError):
        tnorm.normalization("nope")


# ------------------------------------------------------------------ blocks + heads


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_torch_image_level_block_batch_of_one_matches_jax(train):
    x = _x((1, 5, 6, 4))
    _compare(jblocks.ImageLevelBlock(filters=6), tblocks.ImageLevelBlock(4, 6), x, train)


def test_torch_common_end_block_matches_jax():
    x = _x((2, 6, 6, 4))
    _compare(jblocks.CommonEndBlock(filters=5, dropout_rate=0.0),
             tblocks.CommonEndBlock(4, 5, dropout_rate=0.0), x, train=True)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [dict(), dict(use_separable_conv=True, use_projection=False)],
                         ids=["default", "separable_no_projection"])
def test_torch_aspp_matches_jax(kw, train):
    x = _x((2, 7, 7, 8))
    _compare(JASPP(filters=6, atrous_rates=(1, 2, 3), dropout_rate=0.0, **kw),
             TASPP(8, filters=6, atrous_rates=(1, 2, 3), dropout_rate=0.0, **kw),
             x, train, atol=1e-4, rtol=1e-4)


def test_torch_dropout_uses_its_generator_and_scales():
    drop = tblocks.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(1000)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(drop(x).numpy(), a.numpy())
    assert set(np.unique(a.numpy())) <= {0.0, 2.0}
    drop.eval()
    assert drop(x) is x
