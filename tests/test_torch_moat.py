"""The port's MOAT (``iseg_tpu_torch/backbones/moat.py``) against
``iseg_tpu.backbones.moat``, with the same weights (carried by
``iseg_tpu_torch.convert``) and seeded numpy inputs, on the CPU.

A reduced MOAT (stem 16, widths (16, 32, 64, 64), depths (1, 1, 2, 1),
heads ``C // 32``) on a 2 x 64 x 96 input, with whole-map windows (the
default), with 2 x 3 windows (the os16 map of 4 x 6 pads to none; the os32
map of 2 x 3 is one window), and with ``use_pos_emb`` (the relative bias
tables at sizes (4, 3), resized by ``jax.image.resize``'s antialiased
bilinear both down and up): every endpoint in fp32 eval to 1e-5 of max
|ref|; in float64 train mode every endpoint, every parameter's gradient,
the input's gradient and the updated BN statistics to 1e-9, with the
survival probability at None (no drop path). The JAX module takes its
softmax and its shortcut pool in fp32 inside a float64 run:
``keep_float64`` swaps in float64 there. Also ``rel_pos_index`` against the
JAX table, the survival schedule, a window that pads the map (5 x 7 windows
of a 4 x 6 map), the ``to_flax`` round trip of ``rel_pos_embed`` and the
full-width ``moat4`` parameter shapes against ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import moat as jmoat
from iseg_tpu.backbones.registry import get_backbone as j_get_backbone
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones import moat as tmoat
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax, unflatten
from torch_zoo_helpers import check_eval, check_train_f64, keep_float64, pair

torch.set_num_threads(1)

SMALL = dict(stem_filters=16, dims=(16, 32, 64, 64), depths=(1, 1, 2, 1), survival_prob=None)
HW = (64, 96)
CASES = {"global": {}, "windows": dict(window_size=(2, 3)),
         "rel_pos": dict(use_pos_emb=True, pos_emb_sizes=(None, None, 4, 3)),
         "padded": dict(window_size=(5, 7), use_pos_emb=True, pos_emb_sizes=(None, None, 4, 3))}


def _setup(case, x_seed=0):
    kw = dict(SMALL, **CASES[case])
    x = np.random.RandomState(x_seed).randn(2, *HW, 3).astype(np.float32)
    jm, tm = jmoat.MOAT(**kw), tmoat.MOAT(**kw)
    variables = pair(jm, tm, x)
    if "use_pos_emb" in kw:  # flax draws the tables at std 0.02: make them count
        tables = sorted({k.rsplit("/", 1)[0] for k in flatten(variables["params"])
                         if k.endswith("rel_pos_embed")})
        params = flatten(variables["params"])
        rng = np.random.RandomState(4)
        for t in tables:
            params[t + "/rel_pos_embed"] = rng.randn(
                *params[t + "/rel_pos_embed"].shape).astype(np.float32)
        variables = {**variables, "params": unflatten(params)}
        load_flax(tm, variables)
    return jm, tm, variables, x


@pytest.mark.parametrize("case", list(CASES))
def test_torch_moat_eval_endpoints_match_jax(case):
    jm, tm, variables, x = _setup(case)
    out = check_eval(jm, tm, variables, x)
    assert tm.endpoint_strides == [2, 4, 8, 16, 32]
    assert [int(e.shape[1]) for e in out] == tm.endpoint_channels == [16, 16, 32, 64, 64]


@pytest.mark.parametrize("case", ["windows", "rel_pos"])
def test_torch_moat_train_grads_match_jax(case, monkeypatch):
    jm, tm, variables, x = _setup(case)
    keep_float64(monkeypatch, jmoat)
    check_train_f64(jm, tm, variables, x)


def test_torch_moat_tables_and_schedule():
    for h, w in ((2, 3), (4, 4), (1, 5)):
        np.testing.assert_array_equal(tmoat.rel_pos_index(h, w), jmoat._rel_pos_index(h, w))
    tm = tmoat.MOAT(**dict(SMALL, survival_prob=0.7))
    rates = {name: m.dp_mbconv.rate for name, m in tm.named_children()
             if isinstance(m, tmoat.MOATBlock)}
    # MBConv blocks: 1 - (1 - 0.7) * id / 5; MOAT blocks: the base 0.3
    np.testing.assert_allclose([rates["stage0_block0"], rates["stage1_block0"]],
                               [0.0, 0.3 * 1 / 5])
    np.testing.assert_allclose([rates["stage2_block0"], rates["stage2_block1"],
                                rates["stage3_block0"]], [0.3, 0.3, 0.3])
    assert tm.stage2_block0.attn.num_heads == 2 and tm.stage0_block0.se is not None
    assert tm.stage2_block0.se is None and not tm.stage1_block0.use_attention


def test_torch_moat_convert_round_trip():
    _, tm, variables, _ = _setup("rel_pos")
    back = flatten(to_flax(tm)["params"])
    want = flatten(variables["params"])
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert back["stage2_block0/attn/rel_pos_embed"].shape == (2, 7, 7)
    assert "stage3_block0/attn/rel_pos_embed" in back


def test_torch_moat4_matches_jax_shapes():
    jm = j_get_backbone("moat4")
    want = flatten(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                  jnp.zeros((1, 64, 64, 3)))["params"])
    with torch.device("meta"):
        tm = get_backbone("moat4")
    got = {}
    for k, p in param_tree(tm).items():
        s = tuple(p.shape)
        got[k] = (s[2], s[3], s[1], s[0]) if len(s) == 4 else (s[1], s[0]) if len(s) == 2 else s
    assert got == {k: tuple(v.shape) for k, v in want.items()}
