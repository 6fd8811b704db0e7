"""The port's ResNet against ``iseg_tpu``'s at reduced depth, with the same
weights (carried by ``iseg_tpu_torch.convert``) and the same inputs, in
eval and train mode (endpoints and BN running stats), plus the registry.

fp32 on the CPU. Endpoints agree to rtol 1e-4 and to atol 1e-4 of the
endpoint's largest magnitude: a dozen conv + BN layers deep, the summation
order differs between XLA and PyTorch, and train-mode BN over a few values
per channel (2 x 4 x 4 at the last stage) magnifies it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import list_backbones as jax_list_backbones
from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones.resnet import ResNet as TResNet
from iseg_tpu_torch.convert import load_flax, to_flax

torch.set_num_threads(1)

TOL = 1e-4

CONFIGS = {
    # the slice's ResNet-50 recipe at depth 1 per stage
    "bottleneck_deepstem_slim_os16_multigrid": (
        dict(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True, slim_stack=True,
             output_stride=16, multi_grid=(1, 2, 4)), 64),
    # odd spatial sizes after the stem: asymmetric SAME pads, counted
    # zero-padding in the slim avg-pool identity, -inf in the max-pool
    "bottleneck_slim_os32_odd_input": (
        dict(depths=(1, 2, 1, 1), use_bottleneck=True, deep_stem=True, slim_stack=True,
             output_stride=32), 66),
    "basic_7x7_stem_keras_stacks_os8": (
        dict(depths=(1, 1, 1, 1), use_bottleneck=False, deep_stem=False, slim_stack=False,
             output_stride=8, multi_grid=(1, 2)), 48),
}


def _models(name):
    kw, hw = CONFIGS[name]
    jmod, tmod = JResNet(**kw), TResNet(**kw)
    x = np.random.RandomState(0).rand(2, hw, hw, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    # non-trivial running stats, so eval mode really reads them
    rng = np.random.RandomState(1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else 0.1 * rng.randn(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    load_flax(tmod, variables)
    return jmod, tmod, variables, x


def _check_endpoints(t_eps, j_eps):
    assert len(t_eps) == len(j_eps)
    for t, j in zip(t_eps, j_eps):
        t = t.detach().permute(0, 2, 3, 1).numpy()
        j = np.asarray(j)
        assert t.shape == j.shape and np.abs(j).max() > 0
        np.testing.assert_allclose(t, j, atol=TOL * np.abs(j).max(), rtol=TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_resnet_eval_endpoints_match_jax(name):
    jmod, tmod, variables, x = _models(name)
    tmod.eval()
    with torch.no_grad():
        t_eps = tmod(torch.tensor(x).permute(0, 3, 1, 2))
    _check_endpoints(t_eps, jmod.apply(variables, jnp.asarray(x), train=False))
    assert tmod.endpoint_channels == [int(e.shape[-1]) for e in
                                      jmod.apply(variables, jnp.asarray(x), train=False)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_resnet_train_endpoints_and_stats_match_jax(name):
    jmod, tmod, variables, x = _models(name)
    tmod.train()
    t_eps = tmod(torch.tensor(x).permute(0, 3, 1, 2))
    j_eps, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    _check_endpoints(t_eps, j_eps)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL),
        to_flax(tmod)["batch_stats"], mutated["batch_stats"])


def test_torch_registry_has_the_jax_resnets():
    jax_resnets = {n for n in jax_list_backbones() if n.startswith("resnet")}
    assert {n for n in list_backbones() if n.startswith("resnet")} == jax_resnets
    # every ported name is one of the JAX package's
    assert set(list_backbones()) <= set(jax_list_backbones())


def test_torch_get_backbone_resnet50_os16_layout():
    bb = get_backbone("resnet50", output_stride=16)
    assert bb.endpoint_channels == [128, 256, 512, 1024, 2048]
    assert bb.out_channels == 2048
    # multi-grid (1, 2, 4) on the dilated last stage: rates 2, 4, 8
    assert [bb._modules[f"stage3_block{i}"].conv2.conv.dilation for i in range(3)] == [
        (2, 2), (4, 4), (8, 8)]
    assert bb._modules["stage2_block5"].stride == 1  # de-strided at os16


def test_torch_get_backbone_unknown_name_raises():
    with pytest.raises(KeyError):
        get_backbone("resnet51")
