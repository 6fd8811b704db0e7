"""The port's HRNet against ``iseg_tpu``'s, with the same weights (carried by
``iseg_tpu_torch.convert``) and the same inputs, on the CPU.

``HRNet(width=8, stage_modules=(1, 1, 1, 1))`` at 64x64 keeps every kind of
layer of HRNet-W48 (the bottleneck stage, the three transitions, two-,
three- and four-branch modules, every down path of up to three strided
convs, every up path) at a small size. The JAX model is built both with
``w_fold=True`` (its default: the thin branches run in the W-folded
domain) and with ``w_fold=False``; the port runs the plain blocks and loads
the same weights from either.

Tolerances: eval-mode endpoints in fp32 to 1e-5 of each tensor's largest
magnitude (about 40 conv + BN layers deep). Train mode runs in float64 on
both sides (train-mode BN over the 2 x 2 x 2 values a channel of the os32
branch magnifies fp32 rounding). Two parts of the JAX model stay fp32 under
float64: the align-corners resize rounds float64 input to fp32
(``iseg_tpu/ops/resize.py:54``), and the W-folded blocks take their BN
moments in fp32 (``iseg_tpu/nn/wfold.py:118``). Against the plain JAX model
the float64 run therefore swaps in the same interpolation matrices in
float64 (its fuse and head resizes only), and endpoints and every gradient
agree to 1e-9 of their largest magnitude; against the W-folded model,
unchanged, to 1e-5. BN running stats rtol 1e-6 / atol 1e-7 (read back as
fp32) in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.hrnet import HRNet as JHRNet
from iseg_tpu.backbones.registry import get_backbone as j_get_backbone
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones.hrnet import HRNet as THRNet
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax

torch.set_num_threads(1)

TOL = 1e-5
HW = 64
SMALL = dict(width=8, stage_modules=(1, 1, 1, 1))


def _random_stats(variables, seed=1):
    """Non-trivial running stats, so eval mode really reads them."""
    rng = np.random.RandomState(seed)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else 0.1 * rng.randn(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


def _init(jmod, x):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda v: jmod.init(jax.random.PRNGKey(0), v, train=False))(x))


def _close_to_max(t, j, tol=TOL, what=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    assert np.abs(j).max() > 0, what
    np.testing.assert_allclose(t, j, atol=tol * np.abs(j).max(), rtol=0, err_msg=what)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).rand(2, HW, HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def variables(image):
    """One set of weights, from the plain JAX model (the folded one has the
    same tree: ``test_torch_hrnet_folded_and_plain_trees_agree``)."""
    return _random_stats(_init(JHRNet(**SMALL, w_fold=False), jnp.asarray(image)))


def test_torch_hrnet_folded_and_plain_trees_agree(image):
    plain = _init(JHRNet(**SMALL, w_fold=False), jnp.asarray(image))
    folded = _init(JHRNet(**SMALL, w_fold=True), jnp.asarray(image))
    for col in ("params", "batch_stats"):
        a, b = flatten(plain[col]), flatten(folded[col])
        assert sorted(a) == sorted(b)
        assert all(a[k].shape == b[k].shape for k in a)
    tmod = THRNet(**SMALL)
    load_flax(tmod, folded)  # every leaf maps by path


@pytest.mark.parametrize("w_fold", [True, False], ids=["jax_w_fold", "jax_plain"])
def test_torch_hrnet_eval_endpoints_match_jax(w_fold, image, variables):
    jmod, tmod = JHRNet(**SMALL, w_fold=w_fold), THRNet(**SMALL)
    load_flax(tmod, variables)
    tmod.eval()
    with torch.no_grad():
        t_eps = tmod(torch.tensor(image).permute(0, 3, 1, 2))
    j_eps = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, jnp.asarray(image))
    assert len(t_eps) == len(j_eps) == 5
    for i, (t, j) in enumerate(zip(t_eps, j_eps)):
        _close_to_max(_nhwc(t), j, what=f"endpoint {i}")
    assert tmod.endpoint_channels == [int(e.shape[-1]) for e in j_eps] == [8, 16, 32, 64, 120]
    assert tmod.endpoint_strides == [HW // int(e.shape[1]) for e in j_eps] == [4, 8, 16, 32, 4]
    assert tmod.out_channels == 120


def _align_corners_f64(x, size, method="bilinear", align_corners=False):
    """``iseg_tpu.ops.resize.resize_bilinear_align_corners`` with its
    interpolation matrices in float64 (it rounds float64 input to fp32)."""
    assert method == "bilinear" and align_corners and x.dtype == jnp.float64

    def matrix(out_len, in_len):
        src = np.arange(out_len) * (in_len - 1) / (out_len - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_len - 1)
        m = np.zeros((out_len, in_len))
        m[np.arange(out_len), lo] += 1.0 - (src - lo)
        m[np.arange(out_len), hi] += src - lo
        return jnp.asarray(m)

    y = jnp.einsum("oh,nhwc->nowc", matrix(size[0], x.shape[1]), x)
    return jnp.einsum("pw,nowc->nopc", matrix(size[1], x.shape[2]), y)


@pytest.mark.parametrize("w_fold", [True, False], ids=["jax_w_fold", "jax_plain"])
def test_torch_hrnet_train_endpoints_stats_and_grads_match_jax(w_fold, image, variables,
                                                               monkeypatch):
    """Train mode in float64 on both sides: endpoints, the BN running stats
    it writes, and the gradient of a weighted sum of all five endpoints
    with respect to every parameter."""
    tol = 1e-5 if w_fold else 1e-9
    if not w_fold:
        import iseg_tpu.backbones.hrnet as jhrnet

        monkeypatch.setattr(jhrnet, "resize_image", _align_corners_f64)
    jmod, tmod = JHRNet(**SMALL, w_fold=w_fold), THRNet(**SMALL)
    load_flax(tmod, variables)
    rng = np.random.RandomState(5)
    shapes = [(2, HW // s, HW // s, c) for s, c in zip(tmod.endpoint_strides,
                                                       tmod.endpoint_channels)]
    weights = [rng.randn(*s) for s in shapes]

    tmod.double().train()
    t_eps = tmod(torch.tensor(image, dtype=torch.float64).permute(0, 3, 1, 2))
    t_loss = sum((_e.permute(0, 2, 3, 1) * torch.tensor(w)).sum()
                 for _e, w in zip(t_eps, weights))
    t_loss.backward()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        x64 = jnp.asarray(image, jnp.float64)

        def j_loss(params):
            eps, mutated = jmod.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                      x64, train=True, mutable=["batch_stats"])
            return sum(jnp.sum(e * w) for e, w in zip(eps, weights)), (eps, mutated)

        (_, (j_eps, mutated)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
            v64["params"])
        j_eps = [np.asarray(e) for e in j_eps]
        stats = flatten(jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
        j_grads = flatten(jax.tree_util.tree_map(np.asarray, j_grads))
    for i, (t, j) in enumerate(zip(t_eps, j_eps)):
        _close_to_max(_nhwc(t), j, tol=tol, what=f"endpoint {i}")
    ours = flatten(to_flax(tmod)["batch_stats"])
    assert sorted(ours) == sorted(stats)
    for k in stats:
        np.testing.assert_allclose(ours[k], stats[k], rtol=1e-6, atol=1e-7, err_msg=k)
    t_params = param_tree(tmod)
    assert sorted(t_params) == sorted(j_grads)
    for k, p in t_params.items():
        g = p.grad.permute(2, 3, 1, 0) if p.grad.ndim == 4 else p.grad
        j = j_grads[k]
        # a BN bias right before a train-mode BN has a zero gradient (noise)
        atol = tol * max(float(np.abs(j).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), j, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["hrnet_w32", "hrnet_w48"])
def test_torch_hrnet_registry_and_parameter_counts_match_jax(name):
    """The published widths build in both packages with the same number of
    parameters, leaf for leaf (JAX shapes from ``jax.eval_shape``)."""
    assert name in list_backbones()
    tmod = get_backbone(name)
    assert isinstance(tmod, THRNet)
    jmod = j_get_backbone(name)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3)), train=False))
    j_params = flatten(shapes["params"])
    t_params = param_tree(tmod)
    assert sorted(t_params) == sorted(j_params)
    assert sum(p.numel() for p in t_params.values()) == sum(
        int(np.prod(s.shape)) for s in j_params.values())
    w = 48 if name == "hrnet_w48" else 32
    assert tmod.endpoint_channels == [w, 2 * w, 4 * w, 8 * w, 15 * w]


def test_torch_hrnet_convert_round_trip(variables):
    """Every branch, fuse path and transition leaf maps by path and comes
    back unchanged."""
    tmod = THRNet(**SMALL)
    load_flax(tmod, variables)
    back = to_flax(tmod)
    for col in ("params", "batch_stats"):
        ours, theirs = flatten(back[col]), flatten(variables[col])
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    params = flatten(variables["params"])
    # a three-step down path (os4 -> os32: two inner convs at the source
    # width, then the projection), an up path, a transition
    assert params["stage4_module0/fuse/down0_3_1/conv/kernel"].shape == (3, 3, 8, 8)
    assert params["stage4_module0/fuse/down0_3_2/conv/kernel"].shape == (3, 3, 8, 64)
    assert params["stage4_module0/fuse/up3_0/conv/kernel"].shape == (1, 1, 64, 8)
    assert params["transition3_3/conv/kernel"].shape == (3, 3, 32, 64)
    assert tmod.stage4_module0.fuse.down0_3_0.norm is not None
    assert tmod.stage2_module0.branch0_block0.conv1.norm.epsilon == 1e-3
