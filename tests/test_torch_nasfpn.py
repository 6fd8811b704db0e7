"""The port's NAS-FPN head (``iseg_tpu_torch/nn/heads/nasfpn.py``) against
``iseg_tpu.nn.heads.nasfpn``, with the same weights (carried by
``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

Three pyramid levels (2 x 16 x 16 x 8, 8 x 8 x 16 and 4 x 4 x 16, after
an os2 map the selection skips) into ``filters`` 16 (so the 8-wide level
gets its 1x1 projection and the 16-wide ones pass as they are), two cell
repeats, with ``use_sum_for_combination`` on (every combine a sum) and off
(the cell's global-attention combines): P3 and every level in fp32 eval to
1e-5 of max |ref|; in float64 train mode the outputs, every parameter's
gradient, the inputs' gradients and the updated BN statistics to 1e-9.
Also the -inf padding of the "SAME" max pool on odd sizes, the nearest
repeat, the ``to_flax`` round trip, and the full-width head's widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from iseg_tpu.nn.heads import nasfpn as jnas
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.convert import flatten, to_flax
from iseg_tpu_torch.examples.train_seg import build_head
from iseg_tpu_torch.nn.heads import nasfpn as tnas
from torch_zoo_helpers import check_eval, check_train_f64, close, nhwc, pair

torch.set_num_threads(1)

SHAPES = [(2, 32, 32, 4), (2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 16)]
FILTERS = 16


def _setup(use_sum, return_all_levels=False):
    rng = np.random.RandomState(0)
    feats = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    kw = dict(filters=FILTERS, num_repeats=2, use_sum_for_combination=use_sum,
              return_all_levels=return_all_levels)
    jm, tm = jnas.NASFPN(**kw), tnas.NASFPN([8, 16, 16], **kw)
    return jm, tm, pair(jm, tm, feats), feats


class _Levels(torch.nn.Module):
    """The port's level dict as a list, P3 .. P7, for the helpers."""

    def __init__(self, head):
        super().__init__()
        self.head = head

    def forward(self, feats):
        out = self.head(feats)
        return [out[lvl] for lvl in range(3, 8)]


class _JLevels(fnn.Module):
    use_sum: bool

    @fnn.compact
    def __call__(self, feats, train=False):
        out = jnas.NASFPN(filters=FILTERS, num_repeats=2, use_sum_for_combination=self.use_sum,
                          return_all_levels=True, name="head")(feats, train=train)
        return [out[lvl] for lvl in range(3, 8)]


@pytest.mark.parametrize("use_sum", [True, False], ids=["sum", "attention"])
def test_torch_nasfpn_eval_matches_jax(use_sum):
    jm, tm, variables, feats = _setup(use_sum)
    out = check_eval(jm, tm, variables, feats)
    assert tuple(out.shape) == (2, FILTERS, 16, 16) and tm.out_channels == FILTERS
    params = variables["params"]
    assert "resample_l3" in params and "resample_l4" not in params
    assert sum(k.startswith("cell") for k in params) == 2 * 7


@pytest.mark.parametrize("use_sum", [True, False], ids=["sum", "attention"])
def test_torch_nasfpn_train_all_levels_match_jax(use_sum):
    rng = np.random.RandomState(1)
    feats = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jm = _JLevels(use_sum)
    tm = _Levels(tnas.NASFPN([8, 16, 16], filters=FILTERS, num_repeats=2,
                             use_sum_for_combination=use_sum, return_all_levels=True))
    variables = pair(jm, tm, feats)
    outs = check_eval(jm, tm, variables, feats)
    assert [tuple(o.shape[2:]) for o in outs] == [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    check_train_f64(jm, tm, variables, feats)


def test_torch_nasfpn_resampling_matches_jax():
    x = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32) - 3.0  # all < 0 mostly
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    for s in (2, 4):
        j = fnn.max_pool(jnp.asarray(x), (s, s), strides=(s, s), padding="SAME")
        close(nhwc(tnas.max_pool_same(xt, s)), j)
    for lo, hi in ((3, 5), (5, 3), (4, 4)):
        np.testing.assert_array_equal(nhwc(tnas._resample_by_level(xt, lo, hi)),
                                      np.asarray(jnas._resample_by_level(jnp.asarray(x), lo, hi)))
    assert tnas.NASFPN_BLOCK_SPECS == jnas.NASFPN_BLOCK_SPECS


def test_torch_nasfpn_convert_round_trip_and_full_width():
    _, tm, variables, _ = _setup(False)
    back = flatten(to_flax(tm)["params"])
    want = flatten(variables["params"])
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with torch.device("meta"):
        bb = get_backbone("efficientnetb7", output_stride=32)
        head = build_head("nasfpn", bb)
    assert isinstance(head, tnas.NASFPN) and head.out_channels == 256
    # P3..P5 are B7's os8, os16 and os32 levels: 80, 224 and its 2560-wide top conv
    assert [head._modules[f"resample_l{i}"].conv.in_channels for i in (3, 4, 5)] == [80, 224,
                                                                                   2560]
