"""The weight bridge ``iseg_tpu_torch.convert``: flax trees of ``iseg_tpu``
models into the port's modules and back, every leaf consumed on both
sides, and the full-size slice (ResNet-50 os16 + ASPP(256), 21 classes)
laid out leaf for leaf like the JAX model."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import get_backbone as jax_get_backbone
from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones.resnet import ResNet as TResNet
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP

torch.set_num_threads(1)

SMALL_RESNET = dict(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True,
                    slim_stack=True, output_stride=16, multi_grid=(1, 2, 4))


def _small_pair():
    jm = JSegManaged(num_class=5, backbone=JResNet(**SMALL_RESNET),
                     head=JASPP(filters=8, use_separable_conv=True, dropout_rate=0.0))
    bb = TResNet(**SMALL_RESNET)
    tm = TSegManaged(num_class=5, backbone=bb,
                     head=TASPP(bb.out_channels, filters=8, use_separable_conv=True,
                                dropout_rate=0.0))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    rng = np.random.RandomState(0)
    # distinct random values in every leaf, so a swapped leaf cannot pass
    variables = jax.tree_util.tree_map(
        lambda v: rng.randn(*np.shape(v)).astype(np.float32), variables)
    return tm, variables


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def test_torch_convert_round_trip_consumes_every_leaf():
    tm, variables = _small_pair()
    load_flax(tm, variables)
    _assert_trees_equal(to_flax(tm), variables)


def test_torch_convert_missing_leaf_raises():
    tm, variables = _small_pair()
    del variables["params"]["head"]["project"]["norm"]["scale"]
    with pytest.raises(KeyError, match="project/norm/scale"):
        load_flax(tm, variables)


def test_torch_convert_extra_leaf_raises():
    tm, variables = _small_pair()
    variables["params"]["head"]["extra"] = {"kernel": np.zeros((1, 1, 8, 8), np.float32)}
    with pytest.raises(KeyError, match="head/extra/kernel"):
        load_flax(tm, variables)


def test_torch_convert_shape_mismatch_raises():
    tm, variables = _small_pair()
    variables["params"]["logits_conv"]["kernel"] = np.zeros((1, 1, 8, 6), np.float32)
    with pytest.raises(ValueError, match="logits_conv/kernel"):
        load_flax(tm, variables)


def test_torch_convert_dense_layout_matches_flax():
    dense = fnn.Dense(3)
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, dense.init(jax.random.PRNGKey(0), x))
    lin = torch.nn.Linear(5, 3)
    load_flax(lin, variables)
    np.testing.assert_allclose(lin(torch.tensor(x)).detach().numpy(),
                               np.asarray(dense.apply(variables, x)), atol=1e-6, rtol=1e-6)
    _assert_trees_equal(to_flax(lin), variables)


def test_torch_full_size_slice_has_the_jax_layout():
    """Every leaf path and shape of the headline model matches flax's."""
    jm = JSegManaged(num_class=21, backbone=jax_get_backbone("resnet50", output_stride=16),
                     head=JASPP(filters=256), upsample_logits=False, fuse_upsample_loss=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3)), train=False))
    bb = get_backbone("resnet50", output_stride=16)
    tm = TSegManaged(num_class=21, backbone=bb, head=TASPP(bb.out_channels, filters=256),
                     upsample_logits=False, fuse_upsample_loss=True)
    ours = {f"{col}/{k}": tuple(v.shape)
            for col, tree in to_flax(tm).items() for k, v in flatten(tree).items()}
    theirs = {f"{col}/{k}": tuple(v.shape)
              for col, tree in shapes.items() for k, v in flatten(tree).items()}
    assert ours == theirs
    assert len(param_tree(tm)) == len(flatten(shapes["params"]))
