"""``DCNv3`` and ``DCNv2`` of the port against ``iseg_tpu.nn.dcn``: the flax
weights go over with ``convert.load_flax``, the same input goes through
both, forward in fp32 at atol 1e-4 (projections, a depthwise conv, a
LayerNorm and the sampler, each summing in another order). flax starts the
offset and modulation heads at zero, so the tests overwrite them with
random values: otherwise every mode would sample the same integer grid.
On the CPU the dense-local modes run the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.nn import dcn as jdcn
from iseg_tpu_torch.convert import load_flax, to_flax
from iseg_tpu_torch.nn import dcn as tdcn
from iseg_tpu_torch.nn.initializers import initialize

torch.set_num_threads(1)

ATOL = 1e-4
C, GROUPS = 16, 4


def _randomize(params, names, scale, seed):
    """Overwrite the zero-initialized layers ``names`` with normal values."""
    rng = np.random.RandomState(seed)
    params = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    for name in names:
        params[name] = {leaf: (scale * rng.randn(*np.shape(a))).astype(np.float32)
                        for leaf, a in params[name].items()}
    return params


def _dcnv3_pair(sampling, hw=(8, 8), stride=1, head_scale=0.5, r=2, offset_scale=1.0):
    jm = jdcn.DCNv3(filters=C, groups=GROUPS, stride=stride, sampling=sampling,
                    max_local_offset=r, offset_scale=offset_scale)
    x = np.random.RandomState(0).randn(2, *hw, C).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = {"params": _randomize(variables["params"], ("offset_head", "mask_head"),
                                      head_scale, seed=1)}
    tm = tdcn.DCNv3(C, C, groups=GROUPS, stride=stride, sampling=sampling, max_local_offset=r,
                    offset_scale=offset_scale)
    load_flax(tm, variables)
    return jm, tm, variables, x


@pytest.mark.parametrize("sampling", tdcn.DCNV3_SAMPLING_MODES)
def test_torch_dcnv3_forward_matches_jax(sampling):
    jm, tm, variables, x = _dcnv3_pair(sampling, offset_scale=1.5)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = tm(torch.tensor(x))
    assert tuple(got.shape) == want.shape == (2, 8, 8, C)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("sampling,hw,stride,resolved", [
    ("auto", (8, 12), 1, "gather"),  # non-square map
    ("auto", (8, 8), 2, "gather"),
    ("dense_local", (8, 8), 2, "gather_centered"),
    ("dense_local_ref", (6, 8), 1, "gather"),
])
def test_torch_dcnv3_mode_resolution_matches_jax(sampling, hw, stride, resolved):
    jm, tm, variables, x = _dcnv3_pair(sampling, hw=hw, stride=stride)
    assert tm.resolve_sampling(*hw) == resolved
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = tm(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    # and it is the resolved mode's own result
    tm.sampling = resolved
    np.testing.assert_array_equal(tm(torch.tensor(x)).detach().numpy(), got)


def test_torch_dcnv3_unknown_mode_and_bad_groups_raise():
    with pytest.raises(ValueError, match="unknown DCNv3 sampling mode"):
        tdcn.DCNv3(C, C, groups=GROUPS, sampling="dense")(torch.zeros(1, 4, 4, C))
    with pytest.raises(ValueError, match="not divisible"):
        tdcn.DCNv3(C, C, groups=3)


def test_torch_dcnv3_dense_local_ref_equals_gather_in_range():
    """With the offset head scaled down every effective offset stays inside
    the clamp, and the two reference-semantics paths agree."""
    _, tm, _, x = _dcnv3_pair("gather", head_scale=0.02)
    exact = tm(torch.tensor(x))
    tm.sampling = "auto"
    assert tm.resolve_sampling(8, 8) == "dense_local_ref"
    np.testing.assert_allclose(tm(torch.tensor(x)).detach().numpy(), exact.detach().numpy(),
                               atol=2e-5, rtol=0)
    # with a large head some taps clamp: the paths differ, by design
    _, tm, _, x = _dcnv3_pair("gather", head_scale=2.0)
    exact = tm(torch.tensor(x))
    tm.sampling = "auto"
    assert float((tm(torch.tensor(x)) - exact).detach().abs().max()) > 1e-3


def test_torch_dcnv3_softmax_in_fp32_and_types_under_autocast():
    _, tm, _, x = _dcnv3_pair("auto")
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = tm(torch.tensor(x))
    assert out.dtype == torch.bfloat16
    full = tm(torch.tensor(x))
    np.testing.assert_allclose(out.float().detach().numpy(), full.detach().numpy(),
                               atol=0.15, rtol=0.1)


@pytest.mark.parametrize("sampling", ["gather", "dense_local"])
def test_torch_dcnv2_forward_matches_jax(sampling):
    jm = jdcn.DCNv2(filters=6, sampling=sampling)
    x = np.random.RandomState(4).randn(2, 8, 7, 5).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = {"params": _randomize(variables["params"], ("offset_conv",), 0.3, seed=2)}
    tm = tdcn.DCNv2(5, 6, sampling=sampling)
    load_flax(tm, variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = tm(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # custom offset input (feature alignment) and the round trip of the bare kernel
    other = np.random.RandomState(5).randn(2, 8, 7, 5).astype(np.float32)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, offset_input=b))(
        variables, jnp.asarray(x), jnp.asarray(other))
    got = tm(torch.tensor(x), offset_input=torch.tensor(other))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    back = to_flax(tm)["params"]
    np.testing.assert_array_equal(back["kernel"], variables["params"]["kernel"])
    np.testing.assert_array_equal(back["offset_conv"]["kernel"],
                                  variables["params"]["offset_conv"]["kernel"])


def test_torch_dcn_initialization_follows_flax():
    """Offset and modulation layers start at zero, so a fresh DCNv3 in
    dense_local mode samples the integer grid; the rest is lecun-normal."""
    gen = torch.Generator().manual_seed(0)
    v3 = initialize(tdcn.DCNv3(C, C, groups=GROUPS, sampling="dense_local"), gen)
    for layer in (v3.offset_head, v3.mask_head):
        assert float(layer.weight.abs().max()) == 0.0 and float(layer.bias.abs().max()) == 0.0
    assert 0.1 < float(v3.value_proj.weight.std()) * np.sqrt(C) < 2.0
    v2 = initialize(tdcn.DCNv2(5, 6), gen)
    assert float(v2.offset_conv.weight.abs().max()) == 0.0
    assert 0.5 < float(v2.kernel.std()) * np.sqrt(45) < 1.5 and float(v2.bias.abs().max()) == 0.0
    x = torch.tensor(np.random.RandomState(0).randn(1, 6, 6, C).astype(np.float32))
    v3.sampling = "gather_centered"
    centered = v3(x)
    v3.sampling = "dense_local"
    np.testing.assert_allclose(v3(x).detach().numpy(), centered.detach().numpy(), atol=1e-5)


def test_torch_calibrate_dcn_sampling_matches_jax_report():
    jm, tm, variables, x = _dcnv3_pair("auto", head_scale=0.05)
    want = jdcn.calibrate_dcn_sampling(jm, variables, jnp.asarray(x), train=None)
    got = tdcn.calibrate_dcn_sampling(tm, torch.tensor(x))
    assert len(got) == len(want) == 1
    (mine,), (theirs,) = got.values(), want.values()
    np.testing.assert_allclose(mine["max_offset_mag"], theirs["max_offset_mag"], rtol=1e-5)
    assert mine["recommended_r"] == theirs["recommended_r"]
    assert mine["recommended_sampling"] == theirs["recommended_sampling"] == "dense_local_ref"
    assert tm.offset_magnitudes is None  # the tap is off again
    with torch.no_grad():
        tm.offset_head.bias += 50.0
    big = tdcn.calibrate_dcn_sampling(tm, torch.tensor(x))
    (stats,) = big.values()
    assert stats["max_offset_mag"] > mine["max_offset_mag"]
    assert stats["recommended_sampling"] == "gather"
    # a non-square map records nothing
    wide = torch.zeros(1, 4, 6, C)
    assert tdcn.calibrate_dcn_sampling(tm, wide) == {}
