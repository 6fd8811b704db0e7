"""The port's EVA02 (``iseg_tpu_torch/backbones/eva.py``) against
``iseg_tpu.backbones.eva``, with the same weights (carried by
``iseg_tpu_torch.convert``) and inputs made from numpy seeds, on the CPU.

* ``build_rope_2d`` (exact), ``apply_rope`` with shared and per-batch
  tables, ``SwiGLU`` with and without its sub-LayerNorm;
* ``PatchDropout``: the port's gather of the kept tokens on JAX's kept
  indices; its own draw (sorted, distinct, as many as JAX keeps, the same
  for the same generator state, off in eval and at rate 0);
* a small ``Eva`` (width 64, depth 2, 4 heads, patch 16, a 3x3 pretrain
  grid resampled to the 4x6 grid of a 64x96 input), with and without
  ``scale_mlp``: all four endpoints, every parameter's gradient and the
  input's; in train mode with patch dropout, both packages on JAX's kept
  indices (the draws of two frameworks cannot match); the ``to_flax``
  round trip; the refusal of an input that is not a multiple of the patch;
* ``layerwise_decay_multipliers`` over ``Eva.layer_name_pattern``, equal to
  the JAX package's for every leaf; the class token in
  ``endpoint_strides``, ``select_pyramid_levels`` and ``SegManaged``'s aux
  routing;
* the registered variants, and the full-width parameter shapes of
  ``eva02_large_patch16_512_coco`` against ``jax.eval_shape``.

Tolerances: fp32 forwards to 1e-5 of max(1, max |ref|); float64 gradients
to 1e-9 of each gradient's largest magnitude. Inside a float64 run the JAX
package takes the attention softmax (``iseg_tpu/backbones/eva.py:164``) and
the pos-embed resize in fp32, where the port computes in
``promote_types(dtype, float32)``: the float64 comparisons swap in float64
there (``keep_float64``); the fp32 ones run the JAX package unchanged. The
RoPE tables are fp32 in both packages.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import eva as jeva
from iseg_tpu.backbones import registry as jregistry
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.ops import resize as jresize
from iseg_tpu_torch.backbones import eva as teva
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.model import SegManaged
from iseg_tpu_torch.nn.blocks import set_dropout_generator
from iseg_tpu_torch.nn.heads import ASPP
from iseg_tpu_torch.nn.heads.common import select_pyramid_levels

torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-5, 1e-9
SMALL = dict(patch_size=16, dim=64, depth=2, num_heads=4, pretrain_grid=3)
HW = (64, 96)
GRID = (HW[0] // 16, HW[1] // 16)


class KeepFloat64:
    """``jnp`` as a module of the JAX package sees it, with ``float32``
    meaning float64, so that module's fp32 casts keep float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def keep_float64(monkeypatch):
    monkeypatch.setattr(jeva, "jnp", KeepFloat64())
    monkeypatch.setattr(jresize, "jnp", KeepFloat64())


def close_f32(t, j, what=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=F32_TOL * max(1.0, np.abs(j).max()),
                               err_msg=what)


def close_f64(t, j, what=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    assert np.abs(j).max() > 0, what
    np.testing.assert_allclose(t, j, rtol=0, atol=F64_TOL * np.abs(j).max(), err_msg=what)


def flax_layout(g: torch.Tensor) -> np.ndarray:
    """A parameter-shaped tensor in the flax layout (conv OIHW -> HWIO,
    linear [out, in] -> [in, out])."""
    if g.ndim == 4:
        g = g.permute(2, 3, 1, 0)
    elif g.ndim == 2:
        g = g.t()
    return g.detach().numpy()


def _layout_shape(p: torch.Tensor) -> tuple:
    s = tuple(p.shape)
    return (s[2], s[3], s[1], s[0]) if len(s) == 4 else (s[1], s[0]) if len(s) == 2 else s


@pytest.mark.parametrize("gh,gw,d", [(4, 6, 16), (3, 3, 8), (32, 32, 64)])
def test_torch_build_rope_2d_equals_jax(gh, gw, d):
    t, j = teva.build_rope_2d(gh, gw, d), jeva.build_rope_2d(gh, gw, d)
    for a, b in zip(t, j):
        assert a.dtype == np.float32 and a.shape == (gh * gw, d)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("per_batch", [False, True], ids=["shared", "per_batch"])
def test_torch_apply_rope_matches_jax(per_batch):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 8)
    sin, cos = teva.build_rope_2d(1, 5, 8)
    if per_batch:
        idx = np.array([[0, 2, 4, 1, 3], [4, 3, 2, 1, 0]])
        sin, cos = sin[idx], cos[idx]
    w = rng.randn(*x.shape)
    close_f32(teva.apply_rope(torch.tensor(x, dtype=torch.float32), torch.tensor(sin),
                              torch.tensor(cos)).numpy(),
              jeva.apply_rope(jnp.asarray(x, jnp.float32), jnp.asarray(sin), jnp.asarray(cos)))
    with jax.enable_x64(True):
        j_g = jax.grad(lambda a: jnp.sum(jeva.apply_rope(a, jnp.asarray(sin),
                                                          jnp.asarray(cos)) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (teva.apply_rope(xt, torch.tensor(sin), torch.tensor(cos)) * torch.tensor(w)).sum().backward()
    close_f64(xt.grad.numpy(), j_g)


@pytest.mark.parametrize("use_norm", [True, False])
def test_torch_swiglu_matches_jax(use_norm):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 16).astype(np.float32)
    jm = jeva.SwiGLU(hidden_dim=int(16 * 8 / 3), out_dim=16, use_norm=use_norm)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    variables = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(0.5 * rng.randn(*a.shape), np.float32), variables["params"])}
    tm = load_flax(teva.SwiGLU(16, 42, 16, use_norm=use_norm), variables)
    assert ("norm" in variables["params"]) == use_norm
    with torch.no_grad():
        close_f32(tm(torch.tensor(x)).numpy(), jm.apply(variables, x))
    w = rng.randn(2, 7, 16)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_gp, j_gx = jax.grad(lambda v, a: jnp.sum(jm.apply(v, a) * w), (0, 1))(
            v64, jnp.asarray(x, jnp.float64))
        j_gp = flatten(jax.tree_util.tree_map(np.asarray, j_gp["params"]))
    tm.double()
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    (tm(xt) * torch.tensor(w)).sum().backward()
    close_f64(xt.grad.numpy(), j_gx)
    for path, p in param_tree(tm).items():
        close_f64(flax_layout(p.grad), j_gp[path], path)


def test_torch_patch_dropout_keeps_jax_indices_and_draws_its_own():
    x = np.random.RandomState(2).randn(3, 1 + 24, 8).astype(np.float32)
    jm = jeva.PatchDropout(0.25, num_prefix_tokens=1, return_indices=True)
    j_out, j_keep = jm.apply({}, jnp.asarray(x), train=True,
                             rngs={"dropout": jax.random.PRNGKey(3)})
    j_keep = np.asarray(j_keep)
    np.testing.assert_array_equal(
        teva.keep_tokens(torch.tensor(x), torch.tensor(j_keep), 1).numpy(), np.asarray(j_out))

    pd = teva.PatchDropout(0.25, num_prefix_tokens=1)
    set_dropout_generator(pd, torch.Generator().manual_seed(0))
    out, keep = pd(torch.tensor(x))
    assert keep.shape == j_keep.shape == (3, 18)  # int(24 * 0.75)
    assert all(torch.equal(row, torch.unique(row)) for row in keep)  # sorted and distinct
    assert int(keep.max()) < 24
    np.testing.assert_array_equal(out.numpy(), teva.keep_tokens(torch.tensor(x), keep, 1).numpy())
    set_dropout_generator(pd, torch.Generator().manual_seed(0))
    assert torch.equal(pd(torch.tensor(x))[1], keep)
    assert not torch.equal(pd(torch.tensor(x))[1], keep)  # the generator moved on
    pd.eval()
    same, none = pd(torch.tensor(x))
    assert none is None and torch.equal(same, torch.tensor(x))
    assert teva.PatchDropout(0.0).train()(torch.tensor(x))[1] is None
    assert teva.PatchDropout(0.99).train().keep_indices(1, 24, "cpu").shape == (1, 1)


def _eva_pair(**kwargs):
    cfg = dict(SMALL, **kwargs)
    jm = jeva.Eva(**cfg)
    x = np.random.RandomState(3).rand(2, *HW, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(jnp.asarray(x)))
    params = dict(variables["params"])  # the class token starts at zero: draw it
    params["cls_token"] = np.random.RandomState(4).randn(1, 1, cfg["dim"]).astype(np.float32)
    variables = {"params": params}
    tm = load_flax(teva.Eva(**cfg), variables).eval()
    return jm, tm, variables, x


def _nhwc(endpoints):
    return [e.permute(0, 2, 3, 1) if e.ndim == 4 else e for e in endpoints]


def _jax_keep_idx(jm, variables, x, rng):
    """The kept indices of the JAX model's patch dropout for ``rng``."""
    _, state = jm.apply(variables, jnp.asarray(x), train=True, rngs={"dropout": rng},
                        capture_intermediates=lambda mdl, _: isinstance(mdl, jeva.PatchDropout),
                        mutable=["intermediates"])
    return np.asarray(state["intermediates"]["patch_dropout"]["__call__"][0][1])


@pytest.mark.parametrize("mode", ["eval", "eval_no_scale_mlp", "train_patch_dropout"])
def test_torch_small_eva_matches_jax(mode, monkeypatch):
    kwargs = {"scale_mlp": False} if mode == "eval_no_scale_mlp" else {}
    train = mode == "train_patch_dropout"
    if train:
        kwargs["patch_dropout_rate"] = 0.25
    jm, tm, variables, x = _eva_pair(**kwargs)
    assert ("norm" in variables["params"]["block0"]["mlp"]) == (mode != "eval_no_scale_mlp")
    rngs = {"dropout": jax.random.PRNGKey(7)}
    if train:
        keep = _jax_keep_idx(jm, variables, x, rngs["dropout"])
        assert keep.shape == (2, 18)
        tm.train()
        monkeypatch.setattr(tm.patch_dropout, "keep_indices",
                            lambda *_: torch.tensor(keep, dtype=torch.long))
    j_out = jax.jit(lambda v, a: jm.apply(v, a, train=train, rngs=rngs))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        t_out = _nhwc(tm(torch.tensor(x).permute(0, 3, 1, 2)))
    assert len(t_out) == len(j_out) == 2 + SMALL["depth"]
    assert [tuple(e.shape) for e in t_out] == [(2, 1, 64)] + [(2, *GRID, 64)] * 3
    for i, (t, j) in enumerate(zip(t_out, j_out)):
        close_f32(t.numpy(), j, f"endpoint {i}")
    if train:  # dropped positions are zeros in the spatial endpoints
        dropped = np.ones((2, GRID[0] * GRID[1]), bool)
        np.put_along_axis(dropped, keep, False, axis=1)
        assert not t_out[-1].reshape(2, -1, 64)[torch.tensor(dropped)].any()
        assert t_out[1].abs().min() >= 0 and t_out[1].reshape(2, -1, 64).abs().sum(-1).min() > 0
    mine, theirs = flatten(to_flax(tm)["params"]), flatten(variables["params"])
    assert sorted(mine) == sorted(theirs)
    assert "block0/k_proj/kernel" in mine and "block0/k_proj/bias" not in mine
    assert "block0/q_proj/bias" in mine and "block0/v_proj/bias" in mine

    keep_float64(monkeypatch)
    w = [np.random.RandomState(10 + i).randn(*np.shape(j)) for i, j in enumerate(j_out)]
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        if train:  # under x64 JAX draws its noise in float64: other kept indices
            keep = _jax_keep_idx(jm, v64, np.asarray(x, np.float64), rngs["dropout"])
            monkeypatch.setattr(tm.patch_dropout, "keep_indices",
                                lambda *_: torch.tensor(keep, dtype=torch.long))

        def loss(v, a):
            eps = jm.apply(v, a, train=train, rngs=rngs)
            return sum(jnp.sum(e * wi) for e, wi in zip(eps, w))

        j_gp, j_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v64, jnp.asarray(x, jnp.float64))
        j_gp = flatten(jax.tree_util.tree_map(np.asarray, j_gp["params"]))
    tm.double()
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    eps = _nhwc(tm(xt.permute(0, 3, 1, 2)))
    sum((e * torch.tensor(wi)).sum() for e, wi in zip(eps, w)).backward()
    close_f64(xt.grad.numpy(), np.asarray(j_gx), "d input")
    for path, p in param_tree(tm).items():
        close_f64(flax_layout(p.grad), j_gp[path], f"d {path}")


def test_torch_eva_refuses_input_not_multiple_of_patch():
    jm, tm, variables, _ = _eva_pair()
    x = np.zeros((1, 72, 96, 3), np.float32)
    with pytest.raises(ValueError, match="multiple of patch_size"):
        jm.apply(variables, jnp.asarray(x), train=False)
    with pytest.raises(ValueError, match="multiple of patch_size"):
        tm(torch.tensor(x).permute(0, 3, 1, 2))


def test_torch_eva_layerwise_decay_equals_jax():
    _, tm, variables, _ = _eva_pair(depth=3)
    pattern = re.compile(teva.Eva.layer_name_pattern)
    assert pattern.pattern == jeva.Eva.layer_name_pattern

    def layer(path):
        m = pattern.search(path)
        return int(m.group(1)) + 1 if m else None

    j = flatten(jopt.layerwise_decay_multipliers(variables["params"], 0.9, layer, 3))
    t = topt.layerwise_decay_multipliers(param_tree(tm), 0.9, layer, 3)
    assert t == j
    assert t["block0/q_proj/kernel"] == pytest.approx(0.81) and t["pos_embed"] == 1.0
    assert t["block2/mlp/fc2/kernel"] == 1.0
    assert topt.weight_decay_mask(param_tree(tm)) == flatten(
        jopt.weight_decay_mask(variables["params"]))


def test_torch_eva_class_token_endpoint_routing():
    bb = teva.Eva(**SMALL)
    assert bb.endpoint_channels == [64] * 4 and bb.endpoint_strides == [None, 16, 16, 16]
    assert select_pyramid_levels(bb.endpoint_channels, bb.endpoint_strides, 3) == [64] * 3
    # an aux logits conv on the backbone's second-last endpoint (block 0's map)
    model = SegManaged(num_class=3, backbone=bb, head=ASPP(bb.out_channels, filters=8),
                       num_aux_loss=1, use_aux_head_endpoints=True)
    model.eval()
    x = torch.rand(2, *HW, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(x)
        endpoints = bb(x.permute(0, 3, 1, 2))
    assert set(out) == {"output_0", "output_1"}
    assert tuple(out["output_1"].shape) == (2, *HW, 3)
    with torch.no_grad():
        aux = model.logits_conv_1(endpoints[-2])
    close_f32(out["output_1"].numpy(), torch.nn.functional.interpolate(
        aux, size=HW, mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy())


def test_torch_eva_variants_and_full_width_shapes():
    j_names = {n for n in jregistry.list_backbones() if n.startswith("eva")}
    t_names = {n for n in list_backbones() if n.startswith("eva")}
    assert t_names == j_names and len(t_names) == 9
    for name in ("eva02_large_patch16_512_coco", "eva02_tiny"):
        with torch.device("meta"):
            tm = get_backbone(name, output_stride=8)
        jm = jregistry.get_backbone(name, output_stride=8)
        side = 512 if "patch16" in name else 448
        shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                                jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32))
        want = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
        assert {k: _layout_shape(p) for k, p in param_tree(tm).items()} == want
        if name == "eva02_large_patch16_512_coco":
            assert want["block23/mlp/fc1_g/kernel"] == (1024, 2730)
            assert want["pos_embed"] == (1, 32 * 32 + 1, 1024)
            assert "block0/mlp/norm/scale" in want
    assert "block0/mlp/norm/scale" not in want  # eva02_tiny: no sub-LayerNorm
