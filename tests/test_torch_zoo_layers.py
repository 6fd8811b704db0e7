"""The layers the backbone zoo brings to the port, against ``iseg_tpu``'s, with
the same weights (carried by ``iseg_tpu_torch.convert``) and seeded numpy
inputs, on the CPU:

* the norm factory's ``group_norm``, ``layer_norm`` and ``rms_norm`` kinds
  (alone and inside ``ConvNormAct``), ``SqueezeExcite``, ``DenseExt``,
  ``GlobalResponseNorm``: fp32 eval outputs to 1e-5 of max |ref|; float64
  outputs, parameter and input gradients to 1e-9 (the JAX GRN rounds to
  fp32 inside a float64 run, so that test swaps in float64 there:
  ``keep_float64``);
* ``scale_grads`` (the value, and the gradient scaled), adaptive average
  pooling (divisible and not), pixel shuffle and unshuffle (``oc > 1``,
  both round trips, and where ``F.pixel_shuffle``'s channel order parts
  from them), the global pools: exact or to float rounding;
* ``HookPoint`` / ``get_taps``: the same keys as the flax
  ``intermediates`` collection, the same tensors, nothing kept outside a
  capture.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu.nn import blocks as jblocks
from iseg_tpu.nn import common_layers as jcl
from iseg_tpu.nn import hooks as jhooks
from iseg_tpu.nn.conv import ConvNormAct as JConvNormAct
from iseg_tpu.nn.norm import normalization as j_normalization
from iseg_tpu_torch.convert import load_flax, to_flax
from iseg_tpu_torch.nn import blocks as tblocks
from iseg_tpu_torch.nn import common_layers as tcl
from iseg_tpu_torch.nn import hooks as thooks
from iseg_tpu_torch.nn.conv import ConvNormAct as TConvNormAct
from iseg_tpu_torch.nn.norm import normalization as t_normalization
from torch_zoo_helpers import (F64_TOL, check_eval, check_train_f64, close, keep_float64,
                               nhwc, pair, randomize)

torch.set_num_threads(1)

C = 64  # a multiple of GroupNorm's 32 groups


def _x(shape=(2, 5, 6, C), seed=0, offset=0.0):
    return (np.random.RandomState(seed).randn(*shape) + offset).astype(np.float32)


# ------------------------------------------------------------------ norms

class _JNorm(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, x, train=False):
        return j_normalization(self.kind)(name="norm")(x)


class _TNorm(nn.Module):
    def __init__(self, kind):
        super().__init__()
        self.norm = t_normalization(kind)(C)

    def forward(self, x):
        return self.norm(x)


@pytest.mark.parametrize("kind", ["group_norm", "layer_norm", "rms_norm", "gn", "ln", "rmsn"])
def test_torch_norm_kinds_match_jax(kind):
    # an offset mean: the fast variance E[x^2] - E[x]^2 then cancels in part
    x = _x(offset=1.5)
    jm, tm = _JNorm(kind), _TNorm(kind)
    variables = randomize(pair(jm, tm, x), ["norm"], 0.5, seed=3)
    load_flax(tm, variables)
    check_eval(jm, tm, variables, x)
    check_train_f64(jm, tm, variables, x)


@pytest.mark.parametrize("kind", ["group_norm", "layer_norm", "rms_norm"])
def test_torch_norm_kinds_in_conv_norm_act(kind):
    x = _x((2, 6, 6, 8), seed=1)
    jm = JConvNormAct(filters=C, kernel_size=3, norm=kind, act="relu")
    tm = TConvNormAct(8, C, kernel_size=3, norm=kind, act="relu")
    variables = pair(jm, tm, x)
    assert "batch_stats" not in variables
    check_eval(jm, tm, variables, x)
    leaves = to_flax(tm)["params"]["norm"]
    assert sorted(leaves) == (["scale"] if kind == "rms_norm" else ["bias", "scale"])


def test_torch_norm_kind_dtypes_and_errors():
    x = torch.tensor(_x()).permute(0, 3, 1, 2).to(torch.bfloat16)
    for kind in ("group_norm", "layer_norm", "rms_norm"):
        assert t_normalization(kind)(C)(x).dtype == torch.bfloat16
    gn = t_normalization("group_norm")(C)
    assert (gn.num_groups, gn.epsilon) == (32, 1e-5)
    assert t_normalization("layer_norm")(C).epsilon == 1e-6
    assert t_normalization("rms_norm")(C).bias is None
    with pytest.raises(ValueError, match="does not divide"):
        t_normalization("group_norm")(48 + 8)
    with pytest.raises(ValueError, match="unknown normalization"):
        t_normalization("instance_norm")


# ------------------------------------------------------------ SE, dense, GRN

class _JSE(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return jblocks.SqueezeExcite(reduction_filters=4, name="se")(x)


class _TSE(nn.Module):
    def __init__(self):
        super().__init__()
        self.se = tblocks.SqueezeExcite(16, 4)

    def forward(self, x):
        return self.se(x)


def test_torch_squeeze_excite_matches_jax():
    x = _x((2, 5, 7, 16), seed=2)
    jm, tm = _JSE(), _TSE()
    variables = pair(jm, tm, x)
    assert sorted(variables["params"]["se"]) == ["expand", "reduce"]
    check_eval(jm, tm, variables, x)
    check_train_f64(jm, tm, variables, x)


def test_torch_dense_ext_matches_jax():
    x = np.random.RandomState(3).randn(3, 5, 12).astype(np.float32)
    jm = jblocks.DenseExt(features=7)
    tm = tblocks.DenseExt(12, 7)
    variables = pair(jm, tm, x, stats=False)
    assert list(variables["params"]) == ["Dense_0"]
    j = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        close(tm(torch.tensor(x)).numpy(), j)
    nb = jblocks.DenseExt(features=7, use_bias=False)
    tnb = tblocks.DenseExt(12, 7, use_bias=False)
    pair(nb, tnb, x, stats=False)
    assert tnb.Dense_0.bias is None


class _JGRN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return jblocks.GlobalResponseNorm(name="grn")(x)


class _TGRN(nn.Module):
    """The GRN works on NHWC: the helpers feed NCHW, so permute around it."""

    def __init__(self):
        super().__init__()
        self.grn = tblocks.GlobalResponseNorm(C)

    def forward(self, x):
        return self.grn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def test_torch_global_response_norm_matches_jax(monkeypatch):
    x = _x(seed=4)
    jm, tm = _JGRN(), _TGRN()
    variables = randomize(pair(jm, tm, x), ["grn"], 0.5, seed=5)
    load_flax(tm, variables)
    check_eval(jm, tm, variables, x)
    keep_float64(monkeypatch, jblocks)
    check_train_f64(jm, tm, variables, x)
    assert sorted(to_flax(tm)["params"]["grn"]) == ["beta", "gamma"]


# ----------------------------------------------------- grads, pools, shuffles

def test_torch_scale_grads_value_and_gradient():
    x = _x((2, 3, 4, 5), seed=6)
    w = np.random.RandomState(7).randn(*x.shape)
    with jax.enable_x64(True):
        j_val = jblocks.scale_grads(jnp.asarray(x, jnp.float64), 0.25)
        j_grad = jax.grad(lambda a: jnp.sum(jblocks.scale_grads(a, 0.25) * w))(
            jnp.asarray(x, jnp.float64))
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    out = tblocks.scale_grads(xt, 0.25)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_val))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_grad), rtol=F64_TOL, atol=0)
    np.testing.assert_allclose(xt.grad.numpy(), 0.25 * w, rtol=F64_TOL, atol=0)


@pytest.mark.parametrize("hw,size", [((8, 12), (4, 3)), ((8, 12), 2), ((7, 10), (3, 4))],
                         ids=["divisible", "int", "resized"])
def test_torch_adaptive_average_pooling_matches_jax(hw, size):
    x = _x((2, *hw, 3), seed=8)
    j = jblocks.adaptive_average_pooling_2d(jnp.asarray(x), size)
    t = tblocks.adaptive_average_pooling_2d(torch.tensor(x).permute(0, 3, 1, 2), size)
    close(nhwc(t), j)


@pytest.mark.parametrize("r,oc", [(2, 3), (3, 2), (2, 1)])
def test_torch_pixel_shuffle_matches_jax(r, oc):
    x = _x((2, 4, 5, r * r * oc), seed=9)
    j = np.asarray(jcl.pixel_shuffle(jnp.asarray(x), r))
    t = tcl.pixel_shuffle(torch.tensor(x).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(nhwc(t), j)
    # and back: unshuffle is its inverse in both packages
    back = tcl.pixel_unshuffle(t, r)
    np.testing.assert_array_equal(nhwc(back), x)
    np.testing.assert_array_equal(np.asarray(jcl.pixel_unshuffle(jnp.asarray(j), r)), x)
    if oc > 1:  # torch's own channel order is (oc, r, r): another map
        assert not np.array_equal(nhwc(F.pixel_shuffle(torch.tensor(x).permute(0, 3, 1, 2), r)),
                                  j)


def test_torch_pixel_unshuffle_matches_jax_and_checks_sizes():
    x = _x((2, 6, 9, 2), seed=10)
    j = np.asarray(jcl.pixel_unshuffle(jnp.asarray(x), 3))
    t = tcl.pixel_unshuffle(torch.tensor(x).permute(0, 3, 1, 2), 3)
    np.testing.assert_array_equal(nhwc(t), j)
    np.testing.assert_array_equal(nhwc(tcl.pixel_shuffle(t, 3)), x)
    with pytest.raises(ValueError, match="not divisible"):
        tcl.pixel_unshuffle(torch.zeros(1, 2, 5, 6), 2)
    with pytest.raises(ValueError, match="not divisible"):
        tcl.pixel_shuffle(torch.zeros(1, 6, 2, 2), 2)


@pytest.mark.parametrize("keepdims", [False, True])
def test_torch_global_pools_match_jax(keepdims):
    x = _x((2, 5, 6, 7), seed=11)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    for jf, tf in ((jcl.global_average_pooling_2d, tcl.global_average_pooling_2d),
                   (jcl.global_max_pooling_2d, tcl.global_max_pooling_2d)):
        j = np.asarray(jf(jnp.asarray(x), keepdims=keepdims))
        t = tf(xt, keepdims=keepdims)
        t = nhwc(t) if keepdims else t.numpy()
        close(t, j)


# ------------------------------------------------------------------ hooks

class _JTapped(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = jhooks.HookPoint(name="backbone_out")(x)
        x = fnn.relu(x)
        inner = _JInner(name="head")
        x = inner(x)
        return inner(x * 2.0)  # the head's tap records twice


class _JInner(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jhooks.HookPoint(name="hp")(x) + 1.0


class _TInner(nn.Module):
    def __init__(self):
        super().__init__()
        self.hp = thooks.HookPoint()

    def forward(self, x):
        return self.hp(x) + 1.0


class _TTapped(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone_out = thooks.HookPoint()
        self.head = _TInner()

    def forward(self, x):
        x = torch.relu(self.backbone_out(x))
        x = self.head(x)
        return self.head(x * 2.0)


def test_torch_hook_point_taps_match_flax_intermediates():
    x = _x((2, 3, 4, 5), seed=12)
    jm = _JTapped()
    out, mutated = jm.apply({}, jnp.asarray(x), mutable=["intermediates"])
    j_taps = jhooks.get_taps(mutated)
    tm = _TTapped()
    with thooks.capture_intermediates(tm) as collections:
        t_out = tm(torch.tensor(x))
    t_taps = thooks.get_taps(collections)
    assert sorted(t_taps) == sorted(j_taps) == ["backbone_out/tap", "head/hp/tap"]
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(out))
    np.testing.assert_array_equal(t_taps["backbone_out/tap"].numpy(),
                                  np.asarray(j_taps["backbone_out/tap"]))
    assert len(t_taps["head/hp/tap"]) == len(j_taps["head/hp/tap"]) == 2
    for a, b in zip(t_taps["head/hp/tap"], j_taps["head/hp/tap"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # outside a capture nothing is recorded or kept
    tm(torch.tensor(x))
    assert all(m._store is None for m in tm.modules() if isinstance(m, thooks.HookPoint))
    assert thooks.get_taps({}) == {}
