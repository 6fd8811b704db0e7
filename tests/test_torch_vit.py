"""The port's ViT (``iseg_tpu_torch/backbones/vit.py``) and its positional
embedding resampling (``iseg_tpu_torch/ops/resize.py``) against
``iseg_tpu``, with the same weights (carried by ``iseg_tpu_torch.convert``)
and inputs made from numpy seeds, on the CPU.

* ``resample_abs_pos_embed``: up- and downsampling, non-square grids, 0 and
  1 prefix tokens, the 24 -> 32 grid of ``vit_large_patch16`` at 512², the
  square grid inferred; ``resize_image(method="bicubic")``;
* a small ``VisionTransformer`` (width 64, depth 2, 4 heads, patch 16, a
  3x3 pretrain grid resampled to the 4x6 grid of a 64x96 input): with the
  class token, without it (the SAM variants) and with the final norm;
  its endpoint, every parameter's gradient and the input's, the ``to_flax``
  round trip and the weight-decay mask; the refusal of an input that is
  not a multiple of the patch;
* the registered variants, and the full-width parameter shapes of
  ``vit_large_patch16`` against ``jax.eval_shape`` of the JAX init.

Tolerances: fp32 forwards to 1e-5 of max(1, max |ref|); float64 gradients
of a weighted sum of the output to 1e-9 of each gradient's largest
magnitude. The JAX package rounds to fp32 inside a float64 run where the
port computes in ``promote_types(dtype, float32)``: the pos-embed resize
(``iseg_tpu/ops/resize.py:162``) and the softmax of
``jax.nn.dot_product_attention``. The float64 comparisons swap in the same
arithmetic in float64 (``keep_float64``); the fp32 ones run the JAX package
unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import registry as jregistry
from iseg_tpu.backbones import vit as jvit
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.ops import resize as jresize
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones import vit as tvit
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.nn.initializers import initialize
from iseg_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)

F32_TOL, F64_TOL = 1e-5, 1e-9
SMALL = dict(patch_size=16, dim=64, depth=2, num_heads=4, pretrain_grid=3)
HW = (64, 96)


class KeepFloat64:
    """``jnp`` as a module of the JAX package sees it, with ``float32``
    meaning float64, so that module's fp32 casts keep float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def attention_f64(query, key, value, mask=None):
    """``jax.nn.dot_product_attention``'s XLA path with its softmax in the
    logits' type."""
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) / np.sqrt(query.shape[-1])
    if mask is not None:
        logits = jnp.where(mask, logits, -0.7 * jnp.finfo(logits.dtype).max)
    return jnp.einsum("BNTS,BSNH->BTNH", jax.nn.softmax(logits, axis=-1), value)


def keep_float64(monkeypatch):
    monkeypatch.setattr(jresize, "jnp", KeepFloat64())
    monkeypatch.setattr(jax.nn, "dot_product_attention", attention_f64)


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


@pytest.mark.parametrize("old_hw,new_hw,prefix", [
    ((24, 24), (32, 32), 1),   # vit_large_patch16 at 512²
    ((6, 6), (3, 3), 1),       # downsampling
    ((4, 6), (3, 9), 0),       # non-square, one axis down, one up, no class token
    ((3, 5), (7, 4), 1),
])
def test_torch_resample_abs_pos_embed_matches_jax(old_hw, new_hw, prefix, monkeypatch):
    pe = np.random.RandomState(0).randn(1, old_hw[0] * old_hw[1] + prefix, 8)
    pe32 = pe.astype(np.float32)
    j = jresize.resample_abs_pos_embed(jnp.asarray(pe32), new_hw, old_hw, num_prefix_tokens=prefix)
    t = tresize.resample_abs_pos_embed(torch.tensor(pe32), new_hw, old_hw, num_prefix_tokens=prefix)
    close_f32(t.numpy(), j)
    if prefix:
        np.testing.assert_array_equal(t[:, :prefix].numpy(), pe32[:, :prefix])
    keep_float64(monkeypatch)
    w = np.random.RandomState(1).randn(1, new_hw[0] * new_hw[1] + prefix, 8)
    with jax.enable_x64(True):
        j_g = jax.grad(lambda p: jnp.sum(jresize.resample_abs_pos_embed(
            p, new_hw, old_hw, num_prefix_tokens=prefix) * w))(jnp.asarray(pe))
    tp = torch.tensor(pe, requires_grad=True)
    out = tresize.resample_abs_pos_embed(tp, new_hw, old_hw, num_prefix_tokens=prefix)
    assert out.dtype == torch.float64
    (out * torch.tensor(w)).sum().backward()
    close_f64(tp.grad.numpy(), j_g)


def test_torch_resample_abs_pos_embed_infers_square_grids():
    pe = torch.randn(1, 1 + 16, 4, generator=torch.Generator().manual_seed(0))
    j = jresize.resample_abs_pos_embed(jnp.asarray(pe.numpy()), (2, 6))
    close_f32(tresize.resample_abs_pos_embed(pe, (2, 6)).numpy(), j)
    assert tresize.resample_abs_pos_embed(pe, (4, 4)) is pe
    with pytest.raises(ValueError, match="square"):
        tresize.resample_abs_pos_embed(torch.zeros(1, 1 + 12, 4), (3, 3))
    with pytest.raises(ValueError, match=r"\[1, N, C\]"):
        tresize.resample_abs_pos_embed(torch.zeros(17, 4), (3, 3))


@pytest.mark.parametrize("size", [(5, 13), (12, 3)])
@pytest.mark.parametrize("hwc", [False, True], ids=["nhwc", "hwc"])
def test_torch_resize_image_bicubic_matches_jax(size, hwc):
    x = np.random.RandomState(2).randn(2, 9, 7, 3).astype(np.float32)
    x = x[0] if hwc else x
    j = jresize.resize_image(jnp.asarray(x), size, "bicubic")
    close_f32(tresize.resize_image(torch.tensor(x), size, "bicubic").numpy(), j)
    j = jresize.resize_image(jnp.asarray(x), size, "bicubic", antialias=True)
    close_f32(tresize.resize_image(torch.tensor(x), size, "bicubic", antialias=True).numpy(), j)
    j = jresize.resize_image(jnp.asarray(x), size, "lanczos3")
    close_f32(tresize.resize_image(torch.tensor(x), size, "lanczos3").numpy(), j)


def _vit_pair(**kwargs):
    cfg = dict(SMALL, **kwargs)
    jm = jvit.VisionTransformer(**cfg)
    x = np.random.RandomState(3).rand(2, *HW, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(jnp.asarray(x)))
    # the class token starts at zero: draw it so it carries signal
    params = dict(variables["params"])
    if "cls_token" in params:
        params["cls_token"] = np.random.RandomState(4).randn(1, 1, cfg["dim"]).astype(np.float32)
    variables = {"params": params}
    tm = load_flax(tvit.VisionTransformer(**cfg), variables).eval()
    return jm, tm, variables, x


@pytest.mark.parametrize("kwargs", [{}, {"use_class_token": False}, {"use_final_norm": True}],
                         ids=["class_token", "sam_no_class_token", "final_norm"])
def test_torch_small_vit_matches_jax(kwargs, monkeypatch):
    jm, tm, variables, x = _vit_pair(**kwargs)
    j_out = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        t_out = tm(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(t_out) == len(j_out) == 1
    assert tm.endpoint_channels == [64] and tm.endpoint_strides == [16] and tm.out_channels == 64
    close_f32(t_out[0].permute(0, 2, 3, 1).numpy(), j_out[0])
    mine, theirs = flatten(to_flax(tm)["params"]), flatten(variables["params"])
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert ("cls_token" in mine) == ("use_class_token" not in kwargs)
    assert ("norm/scale" in mine) == ("use_final_norm" in kwargs)

    keep_float64(monkeypatch)
    w = np.random.RandomState(5).randn(2, HW[0] // 16, HW[1] // 16, 64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss(v, a):
            return jnp.sum(jm.apply(v, a, train=False)[0] * w)

        j_gp, j_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v64, jnp.asarray(x, jnp.float64))
        j_gp = flatten(jax.tree_util.tree_map(np.asarray, j_gp["params"]))
    tm.double()
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    (tm(xt.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1) * torch.tensor(w)).sum().backward()
    close_f64(xt.grad.numpy(), np.asarray(j_gx), "d input")
    for path, p in param_tree(tm).items():
        close_f64(flax_layout(p.grad), j_gp[path], f"d {path}")


def test_torch_vit_refuses_input_not_multiple_of_patch():
    jm, tm, variables, _ = _vit_pair()
    x = np.zeros((1, 64, 88, 3), np.float32)
    with pytest.raises(ValueError, match="multiple of patch_size"):
        jm.apply(variables, jnp.asarray(x), train=False)
    with pytest.raises(ValueError, match="multiple of patch_size"):
        tm(torch.tensor(x).permute(0, 3, 1, 2))


def test_torch_vit_weight_decay_mask_and_init():
    _, tm, variables, _ = _vit_pair()
    assert topt.weight_decay_mask(param_tree(tm)) == flatten(
        jopt.weight_decay_mask(variables["params"]))
    initialize(tm, torch.Generator().manual_seed(0))
    assert 0.015 < float(tm.pos_embed.detach().std()) < 0.025
    assert not tm.cls_token.detach().any() and float(tm.block0.norm1.weight.detach().min()) == 1.0


def _layout_shape(p: torch.Tensor) -> tuple:
    s = tuple(p.shape)
    if len(s) == 4:
        return (s[2], s[3], s[1], s[0])
    if len(s) == 2:
        return (s[1], s[0])
    return s


def test_torch_vit_variants_and_full_width_shapes():
    j_names = {n for n in jregistry.list_backbones() if n.startswith("vit")}
    t_names = {n for n in list_backbones() if n.startswith("vit")}
    assert t_names == j_names and len(t_names) == 5
    for name in ("vit_large_patch16", "vit_base_patch16_sam"):
        with torch.device("meta"):
            tm = get_backbone(name, output_stride=8)
        jm = jregistry.get_backbone(name, output_stride=8)
        shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                                jax.ShapeDtypeStruct((1, 512, 512, 3), jnp.float32))
        want = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
        assert {k: _layout_shape(p) for k, p in param_tree(tm).items()} == want
    assert want["pos_embed"] == (1, 64 * 64, 768) and "cls_token" not in want  # SAM
    assert tm.endpoint_strides == [16]
