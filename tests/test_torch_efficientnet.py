"""The port's EfficientNet (``iseg_tpu_torch/backbones/efficientnet.py``)
against ``iseg_tpu.backbones.efficientnet``, with the same weights (carried
by ``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

* the width and repeat tables (``round_filters``, ``round_repeats``) of all
  nine registered variants, equal to the JAX package's;
* a reduced EfficientNet (width 0.25, depth 0.3; squeeze-excite on every
  block, strided "SAME" depthwise 3x3 and 5x5 convs) on a 2 x 44 x 60
  input at output strides 32, 16 and 8: every endpoint in fp32 eval to
  1e-5 of max |ref|, and in float64 train mode every endpoint, every
  parameter's gradient, the input's gradient and the updated BN statistics
  to 1e-9 (drop-connect at 0);
* ``endpoint_channels`` / ``endpoint_strides``, the linear drop-connect
  schedule, the SE width taken from the block's input, the full-width
  parameter shapes of ``efficientnetb0`` and ``efficientnetb7`` against
  ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import efficientnet as jeff
from iseg_tpu.backbones.registry import get_backbone as j_get_backbone
from iseg_tpu_torch.backbones import efficientnet as teff
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.convert import flatten, param_tree
from torch_zoo_helpers import check_eval, check_train_f64, pair

torch.set_num_threads(1)

SMALL = dict(width_coefficient=0.25, depth_coefficient=0.3, drop_connect_rate=0.0)
HW = (44, 60)


def test_torch_efficientnet_tables_match_jax():
    for name, (w, d, _) in jeff._VARIANTS.items():
        assert teff._VARIANTS[name][:2] == (w, d)
        for stage in jeff._B0_STAGES:
            assert teff.round_filters(stage[3], w) == jeff._round_filters(stage[3], w), name
            assert teff.round_repeats(stage[1], d) == jeff._round_repeats(stage[1], d), name
        for f in (32, 1280):
            assert teff.round_filters(f, w) == jeff._round_filters(f, w)
    assert teff._B0_STAGES == jeff._B0_STAGES
    # spot values: B7's stem and top widths, L2's repeats of the 4-block stage
    assert (teff.round_filters(32, 2.0), teff.round_filters(1280, 2.0)) == (64, 2560)
    assert teff.round_repeats(4, 5.3) == 22


def _setup(output_stride):
    x = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    jm = jeff.EfficientNet(**SMALL, output_stride=output_stride)
    tm = teff.EfficientNet(**SMALL, output_stride=output_stride)
    return jm, tm, pair(jm, tm, x), x


@pytest.mark.parametrize("output_stride", [32, 16, 8])
def test_torch_efficientnet_eval_endpoints_match_jax(output_stride):
    jm, tm, variables, x = _setup(output_stride)
    out = check_eval(jm, tm, variables, x)
    strides = [2, 4, 8, min(16, output_stride), min(32, output_stride)]
    assert tm.endpoint_strides == strides
    assert [int(e.shape[1]) for e in out] == tm.endpoint_channels
    for e, s in zip(out, strides):
        assert tuple(e.shape[2:]) == (-(-HW[0] // s), -(-HW[1] // s))


@pytest.mark.parametrize("output_stride", [32, 8])
def test_torch_efficientnet_train_grads_match_jax(output_stride):
    jm, tm, variables, x = _setup(output_stride)
    check_train_f64(jm, tm, variables, x)


def test_torch_efficientnet_block_details():
    tm = teff.EfficientNet(width_coefficient=1.0, depth_coefficient=1.0, drop_connect_rate=0.2)
    # SE width from the block's input: block_1_0 takes 16 channels, expands to 96
    se = tm.block_1_0.se
    assert se.reduce.out_channels == 4 and se.reduce.in_channels == 96
    assert tm.block_1_0.depthwise.conv.stride == (2, 2)
    rates = [m.drop_path.rate for m in tm.modules()
             if isinstance(m, teff.MBConv) and m.drop_path is not None]
    blocks = [m for m in tm.modules() if isinstance(m, teff.MBConv)]
    idx = [i for i, m in enumerate(blocks) if m.drop_path is not None]
    np.testing.assert_allclose(rates, [0.2 * i / 16 for i in idx])
    assert tm.stem.norm.epsilon == 1e-3


@pytest.mark.parametrize("name", ["efficientnetb0", "efficientnetb7"])
def test_torch_efficientnet_variants_match_jax_shapes(name):
    jm = j_get_backbone(name)
    want = flatten(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                  jnp.zeros((1, 64, 64, 3)))["params"])
    with torch.device("meta"):
        tm = get_backbone(name)
    got = {}
    for k, p in param_tree(tm).items():
        s = tuple(p.shape)
        got[k] = (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
    assert got == {k: tuple(v.shape) for k, v in want.items()}
