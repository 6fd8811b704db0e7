"""The port's Xception-65 (``iseg_tpu_torch/backbones/xception.py``) against
``iseg_tpu.backbones.xception``, with the same weights (carried by
``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

A reduced Xception (2 middle blocks; every other width as in Xception-65)
on a 2 x 40 x 56 input at output strides 32, 16 and 8 (the atrous rewrite
keeps a de-strided block's rate and doubles it after): every endpoint in
fp32 eval to 1e-5 of max |ref|; in float64 train mode every endpoint,
every parameter's gradient, the input's gradient and the updated BN
statistics to 1e-9. Also the endpoints' widths and strides, and the
full-width ``xception65`` parameter shapes against ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import xception as jxc
from iseg_tpu.backbones.registry import get_backbone as j_get_backbone
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones import xception as txc
from iseg_tpu_torch.convert import flatten, param_tree
from torch_zoo_helpers import check_eval, check_train_f64, pair

torch.set_num_threads(1)

HW = (40, 56)


def _setup(output_stride, middle_blocks=2):
    x = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    jm = jxc.Xception(middle_blocks=middle_blocks, output_stride=output_stride)
    tm = txc.Xception(middle_blocks=middle_blocks, output_stride=output_stride)
    return jm, tm, pair(jm, tm, x), x


@pytest.mark.parametrize("output_stride,strides,channels", [
    (32, [2, 2, 4, 8, 16, 32], [32, 64, 128, 256, 728, 2048]),
    (16, [2, 2, 4, 8, 16], [32, 64, 128, 256, 2048]),
    (8, [2, 2, 4, 8], [32, 64, 128, 2048]),
])
def test_torch_xception_eval_endpoints_match_jax(output_stride, strides, channels):
    jm, tm, variables, x = _setup(output_stride)
    out = check_eval(jm, tm, variables, x)
    assert tm.endpoint_strides == strides and tm.endpoint_channels == channels
    for e, s, ch in zip(out, strides, channels):
        assert tuple(e.shape[1:]) == (ch, -(-HW[0] // s), -(-HW[1] // s))


def test_torch_xception_train_grads_match_jax():
    jm, tm, variables, x = _setup(16, middle_blocks=1)
    check_train_f64(jm, tm, variables, x)


def test_torch_xception65_matches_jax_shapes():
    jm = j_get_backbone("xception65", output_stride=16)
    want = flatten(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                  jnp.zeros((1, 64, 64, 3)))["params"])
    with torch.device("meta"):
        tm = get_backbone("xception65", output_stride=16)
    got = {}
    for k, p in param_tree(tm).items():
        s = tuple(p.shape)
        got[k] = (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert tm.exit_sepconv0.depthwise.dilation == (2, 2)
