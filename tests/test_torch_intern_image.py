"""The InternImage backbone of the port against
``iseg_tpu.backbones.intern_image``: a narrow backbone (16 channels, depths
1/1/2/1, groups 1/2/4/8) in the pre-norm and the post-norm order, weights
carried by ``convert.load_flax`` (which consumes every leaf or raises),
every endpoint in fp32 at atol 1e-4 (four stages of projections, depthwise
convs, LayerNorms and samplers, each summing in another order). flax starts
DCNv3's offset and modulation heads at zero; the tests overwrite them with
random values so the samplers leave the integer grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import get_backbone as j_get_backbone
from iseg_tpu.backbones.intern_image import InternImage as JInternImage
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones.intern_image import _VARIANTS, InternImage
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax, unflatten
from iseg_tpu_torch.nn.blocks import set_dropout_generator
from iseg_tpu_torch.nn.initializers import initialize

torch.set_num_threads(1)

SMALL = dict(channels=16, depths=(1, 1, 2, 1), groups=(1, 2, 4, 8), drop_path_rate=0.0)
HW = 64


def _randomize_heads(params, scale=0.3, seed=1):
    """Random offset and modulation heads in every block (flax zeros them)."""
    rng = np.random.RandomState(seed)
    flat = flatten(params)
    for path, a in flat.items():
        if "/offset_head/" in path or "/mask_head/" in path:
            flat[path] = (scale * rng.randn(*np.shape(a))).astype(np.float32)
    return unflatten(flat)


def _pair(**kwargs):
    cfg = dict(SMALL, **kwargs)
    jm = JInternImage(**cfg)
    tm = InternImage(**cfg)
    x = np.random.RandomState(0).rand(2, HW, HW, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k, a: jm.init(k, a, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))
    variables = {"params": _randomize_heads(variables["params"])}
    load_flax(tm, variables)
    return jm, tm, variables, x


@pytest.mark.parametrize("order,sampling", [("pre_norm", "auto"), ("post_norm", "dense_local"),
                                            ("post_norm", "gather")])
def test_torch_intern_image_endpoints_match_flax(order, sampling):
    jm, tm, variables, x = _pair(use_post_norm=order == "post_norm", layer_scale=0.5,
                                 dcn_sampling=sampling)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    tm.eval()
    got = tm(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    assert [e.shape[1] for e in got] == tm.endpoint_channels == [8, 16, 32, 64, 128]
    assert tm.out_channels == 128
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.permute(0, 2, 3, 1).detach().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0, err_msg=f"endpoint {i}")
    assert ("stage2_norm/scale" in param_tree(tm)) == (order == "pre_norm")


def test_torch_intern_image_convert_round_trip_and_leaf_kinds():
    _, tm, variables, _ = _pair(layer_scale=1.0)
    tree = param_tree(tm)
    assert tree["stage0_block0/gamma1"] is tm.stage0_block0.gamma1
    assert "downsample1/bias" not in tree and "downsample1/kernel" in tree  # bias-free conv
    assert tuple(tm.stage1_block0.dcn.dw_conv.weight.shape) == (32, 1, 3, 3)  # depthwise
    back = to_flax(tm)
    assert back["batch_stats"] == {}
    mine, theirs = flatten(back["params"]), flatten(variables["params"])
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    # without layer scale the block has no gamma leaves, and a tree that
    # brings them is refused: every leaf on both sides is consumed
    bare = InternImage(**SMALL)
    assert "stage0_block0/gamma1" not in param_tree(bare)
    with pytest.raises(KeyError, match="gamma"):
        load_flax(bare, variables)
    stripped = {k: v for k, v in theirs.items() if not k.endswith("gamma2")}
    with pytest.raises(KeyError, match="gamma2"):
        load_flax(tm, {"params": unflatten(stripped)})


@pytest.mark.parametrize("name", sorted(_VARIANTS))
def test_torch_intern_image_variants_have_the_jax_parameter_count(name):
    assert name in list_backbones()
    tm = get_backbone(name, dcn_sampling="auto")
    jm = j_get_backbone(name)  # the sampling mode adds no parameter, and "gather" traces fast
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, train=False), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == want
    channels, depths, _, layer_scale, post_norm = _VARIANTS[name]
    assert tm.out_channels == channels * 8 and tm.depths == depths
    assert hasattr(tm.stage0_block0, "gamma1") == (layer_scale is not None)
    assert tm.use_post_norm == post_norm


def _loss_and_grads(tm, x, seed):
    set_dropout_generator(tm, torch.Generator().manual_seed(seed))
    tm.train()
    out = tm(x)
    loss = sum((e.float() ** 2).mean() for e in out)
    params = list(tm.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), [g if g is not None else torch.zeros_like(p)
                         for g, p in zip(grads, params)]


def test_torch_intern_image_remat_draws_the_same_drop_path_masks():
    """Recomputing the blocks in the backward gives the loss and gradients
    of the plain run, drop-path on: the recompute rewinds the drop-path
    generator, and leaves it where the forward left it."""
    cfg = dict(SMALL, drop_path_rate=0.5, layer_scale=1.0, dcn_sampling="auto")
    plain = initialize(InternImage(**cfg), torch.Generator().manual_seed(0))
    remat = InternImage(**cfg, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.tensor(np.random.RandomState(0).rand(4, 3, HW, HW).astype(np.float32))
    for seed in (0, 1):
        loss_a, grads_a = _loss_and_grads(plain, x, seed)
        loss_b, grads_b = _loss_and_grads(remat, x, seed)
        assert loss_a == loss_b
        for (name, _), a, b in zip(plain.named_parameters(), grads_a, grads_b):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-8, err_msg=name)
    # the masks matter: another seed gives another loss
    assert _loss_and_grads(plain, x, 2)[0] != loss_a
    # two steps in a row from one generator: the second step's masks are
    # the stream's next draws in both models
    gen_a, gen_b = (torch.Generator().manual_seed(7) for _ in range(2))
    set_dropout_generator(plain, gen_a)
    set_dropout_generator(remat, gen_b)
    for _ in range(2):
        for model in (plain, remat):
            model.train()
            loss = sum((e ** 2).mean() for e in model(x))
            torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        assert torch.equal(gen_a.get_state(), gen_b.get_state())


def test_torch_intern_image_dcn_overrides_and_initialization():
    tm = InternImage(**dict(SMALL, dcn_sampling="auto", layer_scale=0.25),
                     dcn_overrides={"stage2_block1": ("gather", 3)})
    assert tm.stage2_block1.dcn.sampling == "gather"
    assert tm.stage2_block1.dcn.max_local_offset == 3
    assert tm.stage2_block0.dcn.sampling == "auto"
    initialize(tm, torch.Generator().manual_seed(0))
    assert float(tm.stage0_block0.gamma1.detach().min()) == 0.25
    assert float(tm.stage3_block0.gamma2.detach().max()) == 0.25
    assert float(tm.stage1_block0.dcn.offset_head.weight.abs().max()) == 0.0
    assert float(tm.stem_norm1.weight.min()) == 1.0
    assert np.isclose([tm.stage0_block0.dp1.rate, tm.stage3_block0.dp2.rate], [0.0, 0.0]).all()
    rates = [InternImage(**dict(SMALL, drop_path_rate=0.2))._modules[n].dp1.rate
             for n in ("stage0_block0", "stage1_block0", "stage2_block0", "stage2_block1",
                       "stage3_block0")]
    np.testing.assert_allclose(rates, [0.0, 0.05, 0.1, 0.15, 0.2])
