"""The port's FPN heads against ``iseg_tpu.nn.heads.fpn``, with the same
weights (carried by ``iseg_tpu_torch.convert``, BN scale/bias/mean/var
randomized so the test sees them used) and the same numpy inputs.

The port's modules are NCHW and the JAX ones NHWC; inputs and outputs are
permuted at the comparison. fp32 on the CPU, eval and train mode (in train
mode the BN batch statistics too). Tolerance atol 1e-4 / rtol 1e-4: conv
sums run in another order and pass through up to five ConvNormActs. The
pyramid's sizes are not powers of two of each other (13, 7, 4, 2), so the
resizes take their sizes from the inputs. Also ``select_pyramid_endpoints``
and ``replace_non_finite`` against their JAX counterparts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nn.heads import fpn as jfpn
from iseg_tpu.nn.heads.common import select_pyramid_endpoints as j_select
from iseg_tpu.ops.numerics import replace_non_finite as j_replace_non_finite
from iseg_tpu_torch.convert import load_flax, to_flax
from iseg_tpu_torch.nn.heads import fpn as tfpn
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints as t_select
from iseg_tpu_torch.ops.numerics import replace_non_finite as t_replace_non_finite

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
SIZES = [(13, 13), (7, 7), (4, 4), (2, 2)]


def _pyramid(channels, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, h, w, c).astype(np.float32) for (h, w), c in zip(SIZES, channels)]


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize_norms(variables, seed=1):
    rng = np.random.RandomState(seed)

    def fix(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "mean" or (name == "bias" and path[-2].key.endswith("norm")):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, variables)


def _compare(jmod, tmod, feats, train):
    j_in = [jnp.asarray(f) for f in feats]
    variables = jmod.init(jax.random.PRNGKey(0), j_in, train=False)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, variables))
    load_flax(tmod, variables)  # raises unless every leaf is consumed
    tmod.train(train)
    t_out = tmod([_nchw(f) for f in feats])
    if train:
        j_out, mutated = jmod.apply(variables, j_in, train=True, mutable=["batch_stats"])
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL),
            to_flax(tmod)["batch_stats"],
            jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    else:
        j_out = jmod.apply(variables, j_in, train=False)
    if isinstance(j_out, (list, tuple)):
        assert len(t_out) == len(j_out)
        for t, j in zip(t_out, j_out):
            np.testing.assert_allclose(_nhwc(t), np.asarray(j), atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(_nhwc(t_out), np.asarray(j_out), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_torch_feature_pyramid_network_matches_jax(train):
    channels = [5, 6, 7, 8]  # the coarsest passes through raw: 8 == filters
    feats = _pyramid(channels)
    feats[1][0, 0, 0, 0] = np.nan  # skips pass replace_non_finite first
    if not train:  # inf becomes the dtype's max, which overflows a batch variance
        feats[0][1, 2, 3, 1] = np.inf
    _compare(jfpn.FeaturePyramidNetwork(filters=8, num_levels=4),
             tfpn.FeaturePyramidNetwork(channels, filters=8), feats, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("version", [1, 2])
def test_torch_semantic_pyramid_block_matches_jax(version, train):
    channels = [8, 8, 8, 6]
    jcls = (jfpn.SemanticPyramidNetworkBlockV1 if version == 1
            else jfpn.SemanticPyramidNetworkBlockV2)
    tcls = (tfpn.SemanticPyramidNetworkBlockV1 if version == 1
            else tfpn.SemanticPyramidNetworkBlockV2)
    tmod = tcls(channels, filters=4)
    assert tmod.out_channels == (16 if version == 1 else 4)
    _compare(jcls(filters=4), tmod, _pyramid(channels), train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("version", [1, 2])
def test_torch_semantic_fpn_matches_jax(version, train):
    # five endpoints, the first two at one resolution (as Swin gives them):
    # the head takes the four coarsest distinct ones, and projects the last
    channels = [5, 5, 6, 7, 12]
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, 13, 13, 5).astype(np.float32)] + _pyramid(channels[1:])
    tmod = tfpn.SemanticFPN(channels[-4:], filters=8, fuse_filters=4, version=version)
    assert tmod.coarse_project is not None
    _compare(jfpn.SemanticFPN(filters=8, fuse_filters=4, version=version), tmod, feats, train)


def test_torch_semantic_fpn_without_projection_matches_jax():
    channels = [5, 6, 7, 8]
    tmod = tfpn.SemanticFPN(channels, filters=8, fuse_filters=4)
    assert tmod.coarse_project is None
    _compare(jfpn.SemanticFPN(filters=8, fuse_filters=4), tmod, _pyramid(channels), False)


def test_torch_select_pyramid_endpoints_matches_jax():
    shapes = [(13, 13), (13, 13), (7, 7), (4, 4), (4, 4), (13, 13)]  # an os4 map last
    j_eps = [np.full((1, h, w, 2), i, np.float32) for i, (h, w) in enumerate(shapes)]
    t_eps = [_nchw(e) for e in j_eps]
    for n in (1, 2, 3):
        picked = t_select(t_eps, n)
        assert [float(t[0, 0, 0, 0]) for t in picked] == \
            [float(j[0, 0, 0, 0]) for j in j_select(j_eps, n)]
    assert [float(t[0, 0, 0, 0]) for t in t_select(t_eps, 3)] == [5.0, 2.0, 4.0]
    assert [float(t[0, 0, 0, 0]) for t in t_select(t_eps, 4)] == [2.0, 3.0, 4.0, 5.0]  # fallback
    single = torch.zeros(1, 2, 3, 3)
    assert t_select(single, 4)[0] is single


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_replace_non_finite_matches_jax(dtype):
    x = np.array([1.5, np.nan, np.inf, -np.inf, -2.0], np.float32)
    t = t_replace_non_finite(torch.tensor(x).to(dtype), value=0.25)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = j_replace_non_finite(jnp.asarray(x).astype(jdtype), value=0.25)
    assert t.dtype == dtype
    np.testing.assert_array_equal(t.double().numpy(), np.asarray(j, np.float64))
