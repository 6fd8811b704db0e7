"""The port's Swin backbone against ``iseg_tpu.backbones.swin``.

* window partition/reverse, the relative-position index and the shift mask
  are equal to the JAX module's (exact);
* ``DropPath`` keeps or drops whole samples and scales by 1/keep;
* a small ``SwinTransformer`` (``embed_dim=32, depths=(1,1,2,1),
  heads=(1,2,4,8)``, window 7), flax weights carried over by
  ``convert.load_flax``: all five endpoints in eval mode at 56x56 and at
  50x45 (no multiple of the patch or the window: both paddings and the
  shifted mask on a padded map), the ``to_flax`` round trip, the
  weight-decay mask, and the seven registered variants.

On the CPU, fp32. Tolerance of the endpoints: atol 2e-4 / rtol 2e-4. The
port's attention is the plain version of its kernel (softmax in another
order than ``jax.nn.dot_product_attention``) and LayerNorm sums in another
order; the errors grow through four stages to about 2e-5 on values of
order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import swin as jswin
from iseg_tpu.core import optimizer as jopt
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones import swin as tswin
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.nn.blocks import DropPath, set_dropout_generator

torch.set_num_threads(1)

SMALL = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=7)


def test_torch_window_partition_reverse_match_jax():
    x = np.random.RandomState(0).randn(2, 14, 21, 3).astype(np.float32)
    t = tswin.window_partition(torch.tensor(x), 7)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 7)))
    back = tswin.window_reverse(t, 7, 14, 21)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin.window_reverse(jnp.asarray(t.numpy()), 7, 14, 21)))


@pytest.mark.parametrize("ws", [7, 12])
def test_torch_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(tswin._relative_position_index(ws),
                                  jswin._relative_position_index(ws))
    attn = tswin.WindowAttention(dim=8, num_heads=2, window_size=ws)
    assert attn.relative_position_bias_table.shape == ((2 * ws - 1) ** 2, 2)
    assert attn.relative_position_bias().shape == (2, ws * ws, ws * ws)


@pytest.mark.parametrize("hw", [(14, 14), (7, 21), (28, 14)])
def test_torch_shift_attn_mask_matches_jax(hw):
    t = tswin._shift_attn_mask(*hw, 7, 3)
    np.testing.assert_array_equal(t, jswin._shift_attn_mask(*hw, 7, 3))
    assert t.shape == (hw[0] * hw[1] // 49, 49, 49) and set(np.unique(t)) <= {-100.0, 0.0}
    block = tswin.SwinBlock(8, 2, window_size=7, shift=3)
    np.testing.assert_array_equal(block._mask(*hw, torch.device("cpu")).numpy(), t)
    assert block._mask(*hw, torch.device("cpu")) is block._mask(*hw, torch.device("cpu"))
    plain = tswin.SwinBlock(8, 2, window_size=7, shift=0)._mask(*hw, torch.device("cpu"))
    assert plain.shape == (1, 49, 49) and not plain.any()


def test_torch_drop_path_drops_whole_samples():
    dp = DropPath(0.5)
    set_dropout_generator(dp, torch.Generator().manual_seed(0))
    x = torch.ones(64, 3, 2, 2)
    y = dp(x)
    per_sample = y.reshape(64, -1)
    assert all(len(set(row.tolist())) == 1 for row in per_sample)  # whole samples
    assert set(per_sample[:, 0].tolist()) == {0.0, 2.0}  # kept ones scaled by 1/keep
    set_dropout_generator(dp, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(dp(x).numpy(), y.numpy())
    assert DropPath(0.0)(x) is x
    dp.eval()
    assert dp(x) is x


def _pair():
    jm = jswin.SwinTransformer(**SMALL)
    # jitted: flax's eager init and apply dispatch op by op and take 10x as long
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    variables = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3))))
    tm = load_flax(tswin.SwinTransformer(**SMALL), variables)
    return jm, tm, variables


@pytest.mark.parametrize("hw", [(56, 56), (50, 45)], ids=["56x56", "50x45_padded"])
def test_torch_small_swin_endpoints_match_jax(hw):
    jm, tm, variables = _pair()
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    j_eps = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        t_eps = tm(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(t_eps) == len(j_eps) == 5
    assert [e.shape[1] for e in t_eps] == tm.endpoint_channels == [32, 32, 64, 128, 256]
    for i, (t, j) in enumerate(zip(t_eps, j_eps)):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   atol=2e-4, rtol=2e-4, err_msg=f"endpoint {i}")


def test_torch_small_swin_to_flax_round_trip():
    _, tm, variables = _pair()
    ours = to_flax(tm)
    assert ours["batch_stats"] == {}
    mine, theirs = flatten(ours["params"]), flatten(variables["params"])
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert "stage2_block1/attn/relative_position_bias_table" in mine
    # a tree with a leaf too many, or one missing, raises
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((1, 1))})}
    with pytest.raises(KeyError, match="stray"):
        load_flax(tswin.SwinTransformer(**SMALL), extra)
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "patch_norm"}}
    with pytest.raises(KeyError, match="patch_norm"):
        load_flax(tswin.SwinTransformer(**SMALL), missing)


def test_torch_swin_weight_decay_mask_matches_jax():
    _, tm, variables = _pair()
    j_mask = flatten(jopt.weight_decay_mask(variables["params"]))
    t_mask = topt.weight_decay_mask(param_tree(tm))
    assert t_mask == j_mask
    assert not t_mask["stage0_block0/attn/relative_position_bias_table"]
    assert not t_mask["stage0_block0/norm1/scale"] and not t_mask["merge1/norm/bias"]
    assert not t_mask["stage0_block0/attn/qkv/bias"]
    assert t_mask["stage0_block0/attn/qkv/kernel"] and t_mask["merge1/reduction/kernel"]


def test_torch_swin_variants_registered():
    names = [n for n in list_backbones() if n.startswith("swin")]
    assert sorted(names) == sorted(jswin._VARIANTS)
    assert tswin._VARIANTS == jswin._VARIANTS
    tiny = get_backbone("swin_tiny", drop_path_rate=0.1)
    assert tiny.endpoint_channels == [96, 96, 192, 384, 768] and tiny.out_channels == 768
    rates = [m.rate for m in tiny.modules() if isinstance(m, DropPath)][::2]
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.1, 12))
    assert tiny.stage2_block1.shift == 3 and tiny.stage2_block0.shift == 0
