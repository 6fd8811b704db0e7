"""Pretrained backbones in the port (``iseg_tpu_torch/backbones/pretrained.py``)
and the drivers' ingest flags, against the JAX package.

* DCN calibration on the ``doctored`` tiny InternImage of
  ``tests/test_dcn_autocalib.py`` (stage 0's offset heads biased to 3 px,
  beyond the default clamp of 2): the port's report equals JAX's (same
  layers, same mode and r, magnitudes within 1e-5) and so do the pinned
  overrides; the calibrated forward equals JAX's calibrated forward and
  the port's own gather-sampled forward (rtol / atol 1e-5), while the
  uncalibrated r = 2 model parts from it; the rebuild carries the weights
  and drop-path generators and leaves the original model as it was;
* ``load_pretrained_backbone``: a user's map and a user's resolver address
  the backbone's own (unwrapped) paths; the full InternImage-T ingests a
  seeded flat dict by its family map with no parameter left, calibrates
  every DCNv3 block, and draws its default probe from ``seed + 1``;
* ``name_map_for`` picks the JAX package's map for every registered name;
* ``train_seg --pretrained`` fills the backbone as the JAX driver's ingest
  does (bit for bit), refuses a file that leaves a backbone parameter
  unmatched, and trains a step otherwise;
* ``eval_seg --weights_h5`` loads a full-model ``.h5`` saved by the JAX
  package, and the model it builds gives JAX's logits (1e-5 of max |logit|).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import get_backbone as j_get_backbone
from iseg_tpu.backbones import pretrained as jpre
from iseg_tpu.backbones.intern_image import InternImage as JInternImage
from iseg_tpu.core import h5_ingest as jh5
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.nn import heads as jheads
from iseg_tpu_torch.backbones import get_backbone, list_backbones
from iseg_tpu_torch.backbones import pretrained as tpre
from iseg_tpu_torch.backbones.intern_image import InternImage
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import weight_maps as tmaps
from iseg_tpu_torch.examples import eval_seg, train_seg
from iseg_tpu_torch.nn.blocks import DropPath

torch.set_num_threads(1)

TINY = dict(channels=16, depths=(1, 1), groups=(2, 4), layer_scale=1.0, drop_path_rate=0.0,
            return_endpoints=False)


@pytest.fixture(scope="module")
def doctored():
    # JAX measures offsets in every sampling mode alike, and its gather
    # compiles and runs faster than its dense-local sampler here
    jm = JInternImage(**TINY, dcn_sampling="gather")
    x = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = copy.deepcopy(jax.tree_util.tree_map(np.asarray, variables))
    head = variables["params"]["stage0_block0"]["dcn"]["offset_head"]
    head["bias"] = np.full_like(head["bias"], 3.0)
    tm = load_flax(InternImage(**TINY, dcn_sampling="auto"), variables).eval()
    jcal, jreport = jpre.auto_calibrate_dcn(jm, variables, jnp.asarray(x))
    return jcal, jreport, variables, tm, x


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def test_torch_calibration_report_equals_jax(doctored):
    jcal, jreport, variables, tm, x = doctored
    tcal, treport = tpre.auto_calibrate_dcn(tm, _nchw(x))
    assert sorted(treport) == sorted(jreport) == ["stage0_block0/dcn", "stage1_block0/dcn"]
    for layer, want in jreport.items():
        got = treport[layer]
        assert got["recommended_sampling"] == want["recommended_sampling"]
        assert got["recommended_r"] == want["recommended_r"]
        assert abs(got["max_offset_mag"] - want["max_offset_mag"]) <= 1e-5
    assert tcal.dcn_overrides == jcal.dcn_overrides
    mode, r = tcal.dcn_overrides["stage0_block0"]
    assert mode == "dense_local_ref" and r > 2


def test_torch_calibrated_forward_equals_jax_and_gather(doctored):
    jcal, _, variables, tm, x = doctored
    out_jax = np.asarray(jax.jit(lambda v, a: jcal.apply(v, a, train=False))(variables, x))
    tcal, _ = tpre.auto_calibrate_dcn(tm, _nchw(x))
    gather = tm.clone(dcn_sampling="gather", dcn_overrides=None)
    with torch.no_grad():
        out_cal = tcal(_nchw(x)).permute(0, 2, 3, 1).numpy()
        out_gather = gather(_nchw(x)).permute(0, 2, 3, 1).numpy()
        out_raw = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out_cal, out_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_cal, out_gather, rtol=1e-5, atol=1e-5)
    assert np.abs(out_raw - out_gather).max() > 1e-3  # the r = 2 clamp parts from it

    # the rebuild holds copies of the weights, shares the drop-path
    # generators, and leaves the original model as it was
    assert tm.dcn_overrides is None and tcal is not tm and not tcal.training
    mine, theirs = param_tree(tcal), param_tree(tm)
    assert all(torch.equal(mine[k], theirs[k]) and mine[k] is not theirs[k] for k in mine)
    gens = [(a.generator, b.generator) for a, b in zip(tcal.modules(), tm.modules())
            if isinstance(a, DropPath)]
    assert gens and all(a is b for a, b in gens)


def test_torch_name_map_for_matches_jax():
    for name in list_backbones():
        jfn, tfn = jpre.name_map_for(name), tpre.name_map_for(name)
        assert (jfn is None) == (tfn is None), name
        if tfn is not None:
            assert tfn is getattr(tmaps, jfn.__name__), name
    assert tpre.name_map_for("placeholder") is None
    assert tpre.name_map_for("mlp_mixer_b16") is tmaps.mlp_mixer_name_map


def test_torch_load_pretrained_user_maps_address_unwrapped_paths():
    kw = dict(input_size=(32, 32), calibrate_dcn=False, width_multiplier=0.35, device="cpu")
    paths = list(flatten(to_flax(get_backbone("mobilenetv2", width_multiplier=0.35))))
    vis_path = paths[0]
    assert vis_path.split("/")[0] in ("params", "batch_stats")
    shape = flatten(to_flax(get_backbone("mobilenetv2", width_multiplier=0.35)))[vis_path].shape
    weights = {"my/custom/name": np.full(shape, 7.0, np.float32)}
    for name_map in ({vis_path: "my/custom/name"},
                     lambda p: "my/custom/name" if p == vis_path else None):
        model, report = tpre.load_pretrained_backbone("mobilenetv2", weights,
                                                      name_map=name_map, **kw)
        got = flatten(to_flax(model))[vis_path]
        np.testing.assert_array_equal(got, 7.0)
        assert "params/backbone/" + vis_path.split("/", 1)[1] in report["weights"]["loaded"] or (
            "batch_stats/backbone/" + vis_path.split("/", 1)[1] in report["weights"]["loaded"])


def _family_dict(model_tree, map_fn, seed=0) -> dict:
    """A flat dict under the family map's stored names, from ``seed``: each
    value in its leaf's layout, depthwise kernels in Keras's (the maps of
    these families have no other transform)."""
    rng = np.random.RandomState(seed)
    flat = flatten(model_tree)
    out = {}
    for path, spec in sorted(map_fn(model_tree).items()):
        value = rng.uniform(0.5, 1.5, flat[path].shape) if path.endswith("/var") else \
            0.1 * rng.standard_normal(flat[path].shape)
        if isinstance(spec, tuple):
            spec, fn = spec
            assert fn is tmaps.depthwise_to_flax, spec
            value = fn(value)  # its own inverse
        out[spec] = np.ascontiguousarray(value, np.float32)
    return out


def test_torch_load_pretrained_intern_image_tiny_ingests_and_calibrates():
    bb = get_backbone("intern_image_tiny")
    wrapped = {"params": {"backbone": to_flax(bb)["params"]}}
    weights = _family_dict(wrapped, tmaps.intern_image_name_map)
    for name in weights:  # stage 3's offsets beyond any clamp (its map is 2 x 2)
        if name.startswith("block.3/") and name.endswith("dcn/offset/bias"):
            weights[name] = np.full_like(weights[name], 20.0)
    model, report = tpre.load_pretrained_backbone("intern_image_tiny", weights,
                                                  input_size=(64, 64), device="cpu")
    assert not report["weights"]["missing"] and not report["weights"]["heuristic_fallback"]
    calib = report["dcn_calibration"]
    assert len(calib) == 30
    modes = {block: mode for block, (mode, _) in model.dcn_overrides.items()}
    assert {b for b, m in modes.items() if m == "gather"} == {f"stage3_block{i}" for i in range(4)}
    assert all(m == "dense_local_ref" for b, m in modes.items() if not b.startswith("stage3"))
    np.testing.assert_array_equal(
        flatten(to_flax(model))["params/stage0_block0/dcn/offset_head/bias"],
        weights["block.0/layer.0/dcn/offset/bias"])
    # the default probe comes from seed + 1: a second call measures the same
    _, again = tpre.load_pretrained_backbone("intern_image_tiny", weights,
                                             input_size=(64, 64), device="cpu")
    assert again["dcn_calibration"] == calib


SMALL = ["--device", "cpu", "--crop", "32", "--batch", "2", "--num_class", "3",
         "--backbone", "mobilenetv2", "--backbone_kwargs",
         '{"width_multiplier": 0.35, "include_top_conv": false}']


def test_torch_train_seg_pretrained_ingests_as_jax_and_trains(tmp_path):
    h5py = pytest.importorskip("h5py")
    model = train_seg.build_model("mobilenetv2", "simpledecoder", 3, 16,
                                  {"width_multiplier": 0.35, "include_top_conv": False}, "cpu")
    weights = _family_dict(to_flax(model), tmaps.keras_mobilenetv2_name_map)
    path = tmp_path / "mbv2.h5"
    with h5py.File(path, "w") as f:
        for name, value in weights.items():
            f.create_dataset(name, data=value)

    report = train_seg.ingest_pretrained(model, "mobilenetv2", str(path))
    jm = JSegManaged(num_class=3, backbone=j_get_backbone(
        "mobilenetv2", output_stride=16, width_multiplier=0.35, include_top_conv=False),
        head=jheads.SimpleDecoder())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    jvars = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    jvars, jreport = jh5.load_h5_weights_by_name(
        jvars, str(path), name_map=jpre.name_map_for("mobilenetv2")(jvars))
    assert set(report["loaded"]) == set(jreport["loaded"])
    mine, theirs = flatten(to_flax(model)), flatten(jax.tree_util.tree_map(np.asarray, jvars))
    backbone = [p for p in mine if "/backbone/" in p]
    assert len(backbone) > 100
    for p in backbone:
        assert np.array_equal(mine[p], theirs[p]), p

    out = train_seg.main(SMALL + ["--pretrained", str(path), "--epochs", "1",
                                  "--steps_per_epoch", "1", "--ckpt_dir", str(tmp_path / "c")])
    assert out["step"] == 1 and np.isfinite(out["history"][0]["loss"])
    partial = tmp_path / "partial.h5"
    with h5py.File(partial, "w") as f:
        for name in list(weights)[:-1]:
            f.create_dataset(name, data=weights[name])
    with pytest.raises(SystemExit, match="unmatched backbone params"):
        train_seg.main(SMALL + ["--pretrained", str(partial), "--ckpt_dir",
                                str(tmp_path / "d")])


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    (d / "images").mkdir()
    (d / "labels").mkdir()
    rng = np.random.RandomState(0)
    for i, hw in enumerate([(32, 48), (48, 32)]):
        Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(d / "images" / f"{i}.png")
        Image.fromarray(rng.randint(0, 3, hw).astype(np.uint8)).save(d / "labels" / f"{i}.png")
    return d


def test_torch_eval_seg_weights_h5_from_jax_gives_jax_logits(png_dir, tmp_path):
    pytest.importorskip("h5py")
    jm = JSegManaged(num_class=3, backbone=j_get_backbone("resnet9", output_stride=16),
                     head=jheads.ASPP())
    x = np.random.RandomState(1).rand(1, 32, 48, 3).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    path = str(tmp_path / "full.h5")
    jh5.save_h5_weights(variables, path)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))

    args = ["--data_dir", str(png_dir), "--device", "cpu", "--backbone", "resnet9", "--head",
            "aspp", "--num_class", "3", "--weights_h5", path]
    out = eval_seg.main(args)
    assert out["images"] == 2 and 0.0 <= out["miou"] <= 1.0
    model = eval_seg.build_model("resnet9", "aspp", 3, 16, {}, "cpu")
    from iseg_tpu_torch.core.h5_ingest import load_h5_weights_by_name
    _, report = load_h5_weights_by_name(model, path)
    assert not report["missing"]
    with torch.no_grad():
        got = model.eval()(torch.tensor(x)).numpy()  # NHWC in, NHWC logits out
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
