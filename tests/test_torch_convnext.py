"""The port's ConvNeXt V1 and V2 (``iseg_tpu_torch/backbones/convnext.py``)
against ``iseg_tpu.backbones.convnext``, with the same weights (carried by
``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

A small ConvNeXt (depths (1, 1, 2, 1), widths (16, 32, 48, 64)), its
layer scale (V1) or GRN (V2) set to random values (flax starts them at
1e-6 and 0, where a block would barely move its input), on a 2 x 52 x 76
input (no multiple of 32: the 4x4/4 stem and the 2x2/2 downsamples pad by
"SAME"), at output strides 32, 16 and 8 (the 2x2/1 "SAME" downsample and
the dilated depthwise convs):

* every endpoint, the leading ``None`` included, in fp32 eval to 1e-5 of
  max |ref|;
* in float64 train mode every endpoint, every parameter's gradient and the
  input's gradient to 1e-9 (the JAX GRN rounds to fp32 inside a float64
  run: ``keep_float64`` swaps in float64 there);
* ``endpoint_channels`` / ``endpoint_strides`` and their use by
  ``select_pyramid_levels``, the ``to_flax`` round trip of the layer-scale
  ``gamma`` and the GRN's ``gamma`` / ``beta``, the registered variants'
  full-width parameter shapes against ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import convnext as jconvnext
from iseg_tpu.nn import blocks as jblocks
from iseg_tpu_torch.backbones import convnext as tconvnext
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.nn.heads.common import select_pyramid_endpoints, select_pyramid_levels
from torch_zoo_helpers import check_eval, check_train_f64, keep_float64, pair, randomize

torch.set_num_threads(1)

SMALL = dict(depths=(1, 1, 2, 1), dims=(16, 32, 48, 64))
HW = (52, 76)


def _models(v2, output_stride):
    kw = dict(SMALL, layer_scale_init=None if v2 else 1e-6, use_grn=v2,
              output_stride=output_stride)
    return jconvnext.ConvNeXt(**kw), tconvnext.ConvNeXt(**kw)


def _setup(v2, output_stride):
    x = np.random.RandomState(0).randn(2, *HW, 3).astype(np.float32)
    jm, tm = _models(v2, output_stride)
    variables = pair(jm, tm, x)
    # random layer scales / GRN parameters, so every block moves its input
    names = [k.rsplit("/", 1)[0] for k in flatten(variables["params"])
             if k.endswith("/gamma") or k.endswith("/beta")]
    variables = randomize(variables, sorted(set(names)), 0.5, seed=2)
    load_flax(tm, variables)
    return jm, tm, variables, x


@pytest.mark.parametrize("output_stride", [32, 16, 8])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_torch_convnext_eval_endpoints_match_jax(v2, output_stride):
    jm, tm, variables, x = _setup(v2, output_stride)
    out = check_eval(jm, tm, variables, x)
    assert out[0] is None and len(out) == 5
    want = {32: (4, 8, 16, 32), 16: (4, 8, 16, 16), 8: (4, 8, 8, 8)}[output_stride]
    # the SAME stem and downsamples round each side up
    sides = [(-(-HW[0] // s), -(-HW[1] // s)) for s in (4, 8, 16, 32)]
    for e, s in zip(out[1:], want):
        assert e.shape[2:] == sides[(4, 8, 16, 32).index(s)], (e.shape, s)
    assert tm.endpoint_strides == [None, 4, 8, want[2], want[3]]
    assert tm.endpoint_channels == [None, 16, 32, 48, 64]


@pytest.mark.parametrize("v2,output_stride", [(False, 32), (True, 8)], ids=["v1_os32", "v2_os8"])
def test_torch_convnext_train_grads_match_jax(v2, output_stride, monkeypatch):
    jm, tm, variables, x = _setup(v2, output_stride)
    keep_float64(monkeypatch, jblocks)
    check_train_f64(jm, tm, variables, x)


def test_torch_convnext_pyramid_levels_skip_the_placeholder():
    _, tm, _, x = _setup(False, 32)
    tm.eval()
    with torch.no_grad():
        eps = tm(torch.tensor(x).permute(0, 3, 1, 2))
    picked = [int(e.shape[1]) for e in select_pyramid_endpoints(eps, 4)]
    assert select_pyramid_levels(tm.endpoint_channels, tm.endpoint_strides, 4) == picked
    assert picked == [16, 32, 48, 64]


def test_torch_convnext_convert_round_trip():
    for v2 in (False, True):
        _, tm, variables, _ = _setup(v2, 16)
        back = flatten(to_flax(tm)["params"])
        want = flatten(variables["params"])
        assert sorted(back) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        leaves = {k.rsplit("/", 1)[1] for k in back if "/block" in k or "_block" in k}
        assert ("grn" in " ".join(back)) == v2 and ("gamma" in leaves)
        if not v2:
            assert not any("/grn/" in k for k in back)


@pytest.mark.parametrize("name", ["convnext_tiny", "convnext_large", "convnext_v2_atto",
                                  "convnext_v2_large"])
def test_torch_convnext_variants_match_jax_shapes(name):
    from iseg_tpu.backbones.registry import get_backbone as j_get_backbone

    jm = j_get_backbone(name)
    shapes = flatten(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                    jnp.zeros((1, 64, 64, 3)))["params"])
    with torch.device("meta"):
        tm = get_backbone(name)
    mine = {k: tuple(v.shape) for k, v in to_flax_shapes(tm).items()}
    assert mine == {k: tuple(v.shape) for k, v in shapes.items()}
    v2 = "_v2_" in name
    assert (tm.stage0_block0.gamma is None) == v2 and (tm.stage0_block0.grn is None) != v2


def to_flax_shapes(tm):
    """The flax-layout shapes of the module's params (a meta-device module
    holds no data)."""
    out = {}
    for k, p in param_tree(tm).items():
        s = tuple(p.shape)
        out[k] = np.empty((s[2], s[3], s[1], s[0]) if len(s) == 4 else
                          (s[1], s[0]) if len(s) == 2 else s, dtype=np.uint8)
    return out


def test_torch_convnext_drop_path_schedule_matches_jax():
    """The drop-path rate grows linearly from 0 to ``drop_path_rate`` over
    the blocks, as the JAX module sets it."""
    tm = tconvnext.ConvNeXt(**SMALL, drop_path_rate=0.4)
    rates = [tm._modules[f"stage{s}_block{i}"].drop_path.rate
             for s, d in enumerate(SMALL["depths"]) for i in range(d)]
    np.testing.assert_allclose(rates, [0.4 * i / 4 for i in range(5)])
