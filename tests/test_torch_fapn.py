"""The port's FaPN head (``iseg_tpu_torch/nn/heads/fapn.py``) against
``iseg_tpu.nn.heads.fapn``, with the same weights (carried by
``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

A four-level pyramid (2 x 16 x 24 x 8 down to 2 x 2 x 3 x 32, plus an os2
map and a ``None`` the selection skips), ``filters`` 16, with the coarsest
level raw and warped (``warp_coarse_feature``): the head's finest output
and every level in fp32 eval to 1e-5 of max |ref|, with the DCNv2 offset
convs set to random values (flax starts them at zero, where every tap
would sample its integer grid point). In float64 train mode, with the
offset convs at flax's zeros (integer sampling points), the outputs, the
inputs' gradients and every parameter's gradient hold at 1e-9 but for the
offset convs' own: 1e-6, as both packages take the sampling coordinates
and corner weights in fp32 (``bilinear_gather``), and the two round the
coordinates of a fractional point apart by an fp32 ulp. With random offsets
every output and gradient passes that path, and all hold at 1e-6. The JAX
DCNv2 takes its tap product with ``preferred_element_type=jnp.float32``,
which rounds it to fp32 inside a float64 run: ``keep_float64`` swaps in
float64 there. Also the ``to_flax`` round trip and the widths of the
full-width ``FAPN`` on ConvNeXt-L's levels.
"""

import numpy as np
import pytest
import torch

from iseg_tpu.nn import dcn as jdcn
from iseg_tpu.nn.heads import fapn as jfapn
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.convert import flatten, load_flax, to_flax
from iseg_tpu_torch.examples.train_seg import build_head
from iseg_tpu_torch.nn.heads import fapn as tfapn
from torch_zoo_helpers import check_eval, check_train_f64, keep_float64, pair, randomize

torch.set_num_threads(1)

SHAPES = [(2, 32, 48, 4), (2, 16, 24, 8), (2, 8, 12, 16), (2, 4, 6, 24), (2, 2, 3, 32)]
FILTERS = 16
COORD_TOL = 1e-6


def _feats():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _setup(warp, random_offsets=True, return_all_levels=False):
    feats = _feats()
    jm = jfapn.FAPN(filters=FILTERS, warp_coarse_feature=warp,
                    return_all_levels=return_all_levels)
    tm = tfapn.FAPN([8, 16, 24, 32], filters=FILTERS, warp_coarse_feature=warp,
                    return_all_levels=return_all_levels)
    variables = pair(jm, tm, feats, stats=False)
    if random_offsets:
        offset_convs = sorted({k.rsplit("/", 1)[0] for k in flatten(variables["params"])
                               if "depack_l2/offset_conv" in k})
        variables = randomize(variables, offset_convs, 0.05, seed=3)
        load_flax(tm, variables)
    return jm, tm, variables, feats


@pytest.mark.parametrize("warp", [False, True], ids=["raw", "warp"])
@pytest.mark.parametrize("all_levels", [False, True], ids=["finest", "all"])
def test_torch_fapn_eval_matches_jax(warp, all_levels):
    jm, tm, variables, feats = _setup(warp, return_all_levels=all_levels)
    out = check_eval(jm, tm, variables, feats)
    if all_levels:
        assert [int(o.shape[1]) for o in out] == tm.out_channels == [16, 16, 16,
                                                                    16 if warp else 32]
    else:
        assert tuple(out.shape) == (2, FILTERS, 16, 24) and tm.out_channels == FILTERS
    assert ("coarse_warp_conv" in variables["params"]) == warp


@pytest.mark.parametrize("warp,random_offsets", [(False, True), (True, False)],
                         ids=["raw_random_offsets", "warp_zero_offsets"])
def test_torch_fapn_train_grads_match_jax(warp, random_offsets, monkeypatch):
    jm, tm, variables, feats = _setup(warp, random_offsets)
    keep_float64(monkeypatch, jdcn)
    if random_offsets:
        check_train_f64(jm, tm, variables, feats, tol=COORD_TOL)
    else:
        tols = {f"align{i}/depack_l2/offset_conv": COORD_TOL for i in range(3)}
        check_train_f64(jm, tm, variables, feats, grad_tols=tols)


def test_torch_fapn_convert_round_trip_and_full_width():
    _, tm, variables, _ = _setup(True)
    back = flatten(to_flax(tm)["params"])
    want = flatten(variables["params"])
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with torch.device("meta"):
        bb = get_backbone("convnext_large")
        head = build_head("fapn", bb)
    # the coarsest (os32) level enters raw: the first DCNv2 gathers 9 x 1536
    assert isinstance(head, tfapn.FAPN) and head.out_channels == 128
    assert tuple(head.align2.depack_l2.kernel.shape) == (9 * 1536, 128)
    assert head.align2.offset_conv.in_channels == 128 + 1536
    assert head.align0.lateral_conv.down_conv.in_channels == 192
