"""Aux outputs, head input routing and the default metric set of the
port's ``SegManaged`` against ``iseg_tpu``'s, with the same weights
(``convert`` carries ``logits_conv_1``, ...), on the CPU.

Tolerances: logits of every output to 1e-5 of their largest magnitude in
fp32 (eval mode); the loss parts rtol 1e-5; mIoU per output equal to the
JAX metric's to 1e-6 on the same logits and labels.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from iseg_tpu.backbones.mobilenetv2 import MobileNetV2 as JMobileNetV2
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.nn.heads.simpledecoder import SimpleDecoder as JSimpleDecoder
from iseg_tpu_torch.backbones.mobilenetv2 import MobileNetV2 as TMobileNetV2
from iseg_tpu_torch.convert import flatten, load_flax, to_flax
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.nn.heads import SimpleDecoder as TSimpleDecoder

torch.set_num_threads(1)

HW, NC = 64, 4
BB = dict(output_stride=32, width_multiplier=0.5, include_top_conv=False)


def _init(jm, x):
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda v: jm.init(jax.random.PRNGKey(0), v, train=False))(x))


def _close_to_max(t, j, tol=1e-5, what=""):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, atol=tol * np.abs(j).max(), rtol=0, err_msg=what)


def _image(n=2):
    return np.random.RandomState(0).rand(n, HW, HW, 3).astype(np.float32)


def _pair(num_aux=1, use_endpoints=True, head=True, **kw):
    jbb, tbb = JMobileNetV2(**BB), TMobileNetV2(**BB)
    jm = JSegManaged(num_class=NC, backbone=jbb,
                     head=JSimpleDecoder(filters=16, low_level_filters=8) if head else None,
                     num_aux_loss=num_aux, use_aux_head_endpoints=use_endpoints, **kw)
    tm = TSegManaged(num_class=NC, backbone=tbb,
                     head=(TSimpleDecoder(tbb.endpoint_channels, 16, 8) if head else None),
                     num_aux_loss=num_aux, use_aux_head_endpoints=use_endpoints, **kw)
    variables = _init(jm, jnp.asarray(_image(1)))
    load_flax(tm, variables)
    return jm, tm.eval(), variables


@pytest.mark.parametrize("num_aux,head", [(1, True), (2, True), (2, False)],
                         ids=["one_aux", "two_aux", "two_aux_no_head"])
def test_torch_aux_outputs_match_jax(num_aux, head):
    """Aux output k reads backbone endpoint -(k + 1); each output has its
    own logits conv, and the model returns ``output_0`` .. ``output_k``."""
    jm, tm, variables = _pair(num_aux, head=head)
    x = _image()
    j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        t = tm(torch.tensor(x))
    assert sorted(t) == sorted(j) == [f"output_{i}" for i in range(1 + num_aux)]
    for k in j:
        assert t[k].shape == (2, HW, HW, NC) and t[k].dtype == torch.float32
        _close_to_max(t[k].numpy(), j[k], what=k)
    widths = [tm._modules[f"logits_conv_{i}" if i else "logits_conv"].in_channels
              for i in range(1 + num_aux)]
    ch = tm.backbone.endpoint_channels
    want = ([16] if head else [ch[-1]]) + [ch[-(k + 1)] for k in range(1, 1 + num_aux)]
    assert widths == want
    # inference takes the main output
    with torch.no_grad():
        _close_to_max(tm.inference(torch.tensor(x)).numpy(), j["output_0"])


def test_torch_aux_without_head_endpoints_keeps_one_output():
    """``num_aux_loss`` without ``use_aux_head_endpoints`` and a one-output
    head: one logits conv and a bare tensor, as the JAX model returns."""
    jm, tm, variables = _pair(1, use_endpoints=False)
    assert "logits_conv_1" not in flatten(variables["params"])
    with torch.no_grad():
        t = tm(torch.tensor(_image()))
    assert isinstance(t, torch.Tensor)
    assert tm.custom_losses_weights() == [1.0, 0.4]


def test_torch_aux_loss_and_converter_round_trip():
    """The loss weights output_1 by ``aux_loss_rate``; the logits_conv_N
    leaves map by path and come back unchanged."""
    jm, tm, variables = _pair(2, aux_loss_rate=0.25)
    back = to_flax(tm)
    for col in ("params", "batch_stats"):
        ours, theirs = flatten(back[col]), flatten(variables[col])
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert {"logits_conv_1/kernel", "logits_conv_2/bias"} <= set(flatten(variables["params"]))
    labels = np.random.RandomState(1).randint(0, NC, (2, HW, HW)).astype(np.int32)
    x = _image()
    j_out = jm.apply(variables, jnp.asarray(x), train=False)
    _, j_parts = jm.build_loss_fn()(j_out, jnp.asarray(labels))
    with torch.no_grad():
        _, t_parts = tm.build_loss_fn()(tm(torch.tensor(x)), torch.tensor(labels))
    assert sorted(t_parts) == sorted(j_parts)
    for k in j_parts:
        np.testing.assert_allclose(float(t_parts[k]), float(j_parts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(t_parts["loss"]), float(
        t_parts["output_0_loss"] + 0.25 * (t_parts["output_1_loss"] + t_parts["output_2_loss"])),
        rtol=1e-6)


def test_torch_custom_metrics_match_jax():
    jm, tm, variables = _pair(1)
    jb, tb = jm.custom_metrics(), tm.custom_metrics()
    assert list(tb.build()) == list(jb.build()) == ["output_0", "output_1"]
    x = _image()
    labels = np.random.RandomState(1).randint(0, NC, (2, HW, HW)).astype(np.int32)
    labels[:, :4] = 255
    with torch.no_grad():
        t_out = tm(torch.tensor(x))
    jb.update_state(jnp.asarray(labels), {k: jnp.asarray(v.numpy()) for k, v in t_out.items()})
    tb.update_state(torch.tensor(labels), t_out)
    j_res, t_res = jb.results(), tb.results()
    assert sorted(t_res) == sorted(j_res) == ["output_0_miou", "output_1_miou"]
    for k in j_res:
        np.testing.assert_allclose(float(t_res[k]), float(j_res[k]), rtol=1e-6, err_msg=k)


# ------------------------------------------------------------ input routing

class JRoutedHead(fnn.Module):
    """A head that reads the label map and the image besides the endpoints."""

    @fnn.compact
    def __call__(self, endpoints, train=False, label=None, image=None):
        h = fnn.Conv(6, (1, 1), name="proj")(endpoints[-1])
        h = h + jnp.mean(image, axis=(1, 2, 3))[:, None, None, None]
        if label is not None:
            h = h + jnp.mean((label == 1).astype(h.dtype), axis=(1, 2))[:, None, None, None]
        return h


class TRoutedHead(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.proj = Conv2d(in_channels, 6, 1)
        self.out_channels = 6

    def forward(self, endpoints, label=None, image=None):
        h = self.proj(endpoints[-1])
        h = h + image.mean(dim=(1, 2, 3))[:, None, None, None]  # NCHW view of the image
        if label is not None:
            h = h + (label == 1).to(h.dtype).mean(dim=(1, 2))[:, None, None, None]
        return h


@pytest.mark.parametrize("form", ["dict", "tuple", "image_only"])
def test_torch_head_input_routing_matches_jax(form):
    """``head_use_label_input`` / ``head_use_image_input`` with dict,
    tuple or bare-image input."""
    tbb = TMobileNetV2(**BB)
    kw = dict(num_class=NC, head_use_label_input=True, head_use_image_input=True)
    jm = JSegManaged(backbone=JMobileNetV2(**BB), head=JRoutedHead(), **kw)
    tm = TSegManaged(backbone=tbb, head=TRoutedHead(tbb.endpoint_channels[-1]), **kw).eval()
    x = _image()
    labels = np.random.RandomState(1).randint(0, NC, (2, HW, HW)).astype(np.int32)
    variables = _init(jm, {"image": jnp.asarray(x[:1]), "label": jnp.asarray(labels[:1])})
    load_flax(tm, variables)
    j_in = {"dict": {"image": jnp.asarray(x), "label": jnp.asarray(labels)},
            "tuple": (jnp.asarray(x), jnp.asarray(labels)), "image_only": jnp.asarray(x)}[form]
    t_in = {"dict": {"image": torch.tensor(x), "label": torch.tensor(labels)},
            "tuple": (torch.tensor(x), torch.tensor(labels)), "image_only": torch.tensor(x)}[form]
    j = jm.apply(variables, j_in, train=False)
    with torch.no_grad():
        t = tm(t_in)
    _close_to_max(t.numpy(), j)
    if form == "dict":  # the label really reaches the head
        with torch.no_grad():
            other = tm({"image": torch.tensor(x), "label": torch.zeros_like(torch.tensor(labels))})
        assert not torch.allclose(other, t)


def test_torch_aux_endpoint_beyond_the_backbone_raises():
    tbb = TMobileNetV2(**BB)
    with pytest.raises(ValueError, match="endpoint"):
        TSegManaged(num_class=NC, backbone=tbb, num_aux_loss=len(tbb.endpoint_channels),
                    use_aux_head_endpoints=True)
