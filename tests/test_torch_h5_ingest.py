"""The port's name-based weight ingest (``iseg_tpu_torch/core/h5_ingest.py``)
against the JAX package's (``iseg_tpu/core/h5_ingest.py``).

* ``normalize_weight_name``, ``canonical_ref_name`` (both ``drop_root``)
  and ``resolve_ref_name`` give the JAX functions' results on every name of
  the 14 published inventories in ``tests/data/ref_weights``;
* a full-model ``.h5`` written by the JAX ``save_h5_weights`` loads into
  the port's module, and one written by the port loads into the JAX
  variables, each bit for bit with no parameter unmatched (ResNet-9 + ASPP);
* a ``.keras`` archive path goes through the format dispatch;
* the port's counterparts of ``tests/test_ccl_h5.py``'s ingest cases, each
  with the JAX result beside it: heuristic ties rejected at any score,
  Keras-2 names (``layer/layer/weight:0``, ``gamma``/``moving_mean``), a
  shape mismatch reported as missing, ``strict`` raises.
"""

from __future__ import annotations

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones import get_backbone as j_get_backbone
from iseg_tpu.core import h5_ingest as jh5
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.nn.heads import ASPP as JASPP
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.convert import flatten, to_flax
from iseg_tpu_torch.core import h5_ingest as th5
from iseg_tpu_torch.core.model import SegManaged
from iseg_tpu_torch.nn.heads import ASPP

torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")

DATA = os.path.join(os.path.dirname(__file__), "data", "ref_weights")
INVENTORIES = sorted(f[:-4] for f in os.listdir(DATA) if f.endswith(".txt"))


def _names(family):
    with open(os.path.join(DATA, family + ".txt")) as f:
        return [line.rsplit(" ", 1)[0] for line in f]


@pytest.mark.parametrize("family", INVENTORIES)
def test_torch_name_functions_equal_jax_on_inventory(family):
    names = _names(family)
    for name in names:
        assert th5.normalize_weight_name(name) == jh5.normalize_weight_name(name)
        for drop_root in (False, True):
            assert (th5.canonical_ref_name(name, drop_root=drop_root)
                    == jh5.canonical_ref_name(name, drop_root=drop_root))
    index = {jh5.canonical_ref_name(n): n for n in names}
    # every published name by its root-free canonical form (what the family
    # maps ask for), and by its last two segments (the suffix rule, which
    # finds one, several or none)
    targets = [jh5.canonical_ref_name(n, drop_root=True) for n in names]
    targets += ["/".join(t.split("/")[-2:]) for t in targets[::7]]
    for target in targets:
        assert th5.resolve_ref_name(target, index) == jh5.resolve_ref_name(target, index)


def _models():
    """ResNet-9 (os16) + ASPP(16), 3 classes, in both packages; the JAX
    variables from ``jax.eval_shape`` of its init, filled from seed 0."""
    jm = JSegManaged(num_class=3, backbone=j_get_backbone("resnet9", output_stride=16),
                     head=JASPP(filters=16, dropout_rate=0.0))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.RandomState(0)
    jvars = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), dict(shapes))
    bb = get_backbone("resnet9", output_stride=16)
    tm = SegManaged(num_class=3, backbone=bb, head=ASPP(bb.out_channels, filters=16,
                                                        dropout_rate=0.0))
    return jvars, tm


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for path in fa:
        assert np.array_equal(np.asarray(fa[path]), np.asarray(fb[path])), path


def test_torch_h5_round_trip_both_ways(tmp_path):
    jvars, tm = _models()
    jpath = str(tmp_path / "jax.h5")
    jh5.save_h5_weights(jvars, jpath)
    assert sorted(th5.read_h5_weights(jpath)) == sorted(jh5.read_h5_weights(jpath))
    model, report = th5.load_h5_weights_by_name(tm, jpath, strict=True)
    assert model is tm and not report["missing"] and not report["heuristic_fallback"]
    _assert_trees_equal(to_flax(tm), jvars)

    # the port writes, JAX reads: the module's weights moved off JAX's first
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(-0.5)
    tpath = str(tmp_path / "port.h5")
    th5.save_h5_weights(tm, tpath)
    template = jax.tree_util.tree_map(np.zeros_like, jvars)
    restored, jreport = jh5.load_h5_weights_by_name(template, tpath, strict=True)
    assert not jreport["missing"]
    _assert_trees_equal(to_flax(tm), jax.tree_util.tree_map(np.asarray, restored))
    # and a tree in, a tree out, as the JAX function
    tree, treport = th5.load_h5_weights_by_name(
        jax.tree_util.tree_map(np.zeros_like, jvars), tpath)
    _assert_trees_equal(tree, to_flax(tm))
    assert set(treport["loaded"]) == set(jreport["loaded"])


def test_torch_keras_archive_path_dispatches(tmp_path):
    variables = {"params": {"stem": {"conv": {"kernel": np.ones((3, 3, 3, 4), np.float32)}}}}
    inner = str(tmp_path / "model.weights.h5")
    th5.save_h5_weights(variables, inner)
    archive = str(tmp_path / "m.keras")
    with zipfile.ZipFile(archive, "w") as z:
        z.write(inner, "model.weights.h5")
    template = {"params": {"stem": {"conv": {"kernel": np.zeros((3, 3, 3, 4), np.float32)}}}}
    restored, report = th5.load_h5_weights_by_name(template, archive)
    jrestored, jreport = jh5.load_h5_weights_by_name(template, archive)
    assert report == jreport and not report["missing"]
    np.testing.assert_array_equal(restored["params"]["stem"]["conv"]["kernel"], 1.0)
    np.testing.assert_array_equal(np.asarray(jrestored["params"]["stem"]["conv"]["kernel"]), 1.0)


def _both(template, weights, **kwargs):
    """The port's and the JAX ingest of ``weights`` into ``template``."""
    mine = th5.load_h5_weights_by_name(template, weights, **kwargs)
    theirs = jh5.load_h5_weights_by_name(template, weights, **kwargs)
    _assert_trees_equal(mine[0], jax.tree_util.tree_map(np.asarray, theirs[0]))
    assert mine[1] == theirs[1]
    return mine


def test_torch_heuristic_rejects_positive_score_ties():
    weights = {"block1/bn1/gamma": np.full((4,), 1.0, np.float32),
               "block1/bn2/gamma": np.full((4,), 2.0, np.float32)}
    template = {"params": {"block1": {"bn": {"scale": np.zeros((4,), np.float32)}}}}
    restored, report = _both(template, weights)
    assert report["missing"] == ["params/block1/bn/scale"]
    np.testing.assert_array_equal(restored["params"]["block1"]["bn"]["scale"], 0.0)


def test_torch_h5_keras_style_names(tmp_path):
    path = str(tmp_path / "keras.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("conv1")
        g.create_dataset("conv1/kernel:0", data=np.full((3, 3, 3, 4), 2.0, np.float32))
        b = f.create_group("bn1")
        b.create_dataset("bn1/gamma:0", data=np.full((4,), 3.0, np.float32))
        b.create_dataset("bn1/moving_mean:0", data=np.full((4,), 4.0, np.float32))
    template = {"params": {"conv1": {"kernel": np.zeros((3, 3, 3, 4), np.float32)},
                           "bn1": {"scale": np.zeros((4,), np.float32)}},
                "batch_stats": {"bn1": {"mean": np.zeros((4,), np.float32)}}}
    restored, report = _both(template, path)
    assert not report["missing"]
    np.testing.assert_array_equal(restored["params"]["conv1"]["kernel"], 2.0)
    np.testing.assert_array_equal(restored["batch_stats"]["bn1"]["mean"], 4.0)


def test_torch_h5_shape_mismatch_reported_and_strict_raises(tmp_path):
    path = str(tmp_path / "w.h5")
    th5.save_h5_weights({"params": {"fc": {"kernel": np.ones((4, 4), np.float32)}}}, path)
    template = {"params": {"fc": {"kernel": np.zeros((8, 8), np.float32)}}}
    _, report = _both(template, path)
    assert report["missing"] == ["params/fc/kernel"]
    with pytest.raises(ValueError, match="unmatched parameters"):
        th5.load_h5_weights_by_name(template, path, strict=True)


def test_torch_name_map_specs_and_resolver():
    """The three spec forms of a map (a name, ``(name, transform)``,
    ``((names...), combine)``) and a ``str -> str`` resolver, each against
    the JAX ingest; a mapped module keeps its dtype and device."""
    weights = {"root/a/kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
               "root/q": np.ones((2,), np.float32), "root/k": np.full((2,), 2.0, np.float32)}
    template = {"params": {"x": {"kernel": np.zeros((3, 4), np.float32)},
                           "y": {"kernel": np.zeros((4, 3), np.float32)},
                           "z": {"bias": np.zeros((4,), np.float32)}}}
    mapping = {"params/x/kernel": "a/kernel", "params/y/kernel": ("a/kernel", np.transpose),
               "params/z/bias": (("q", "k"), lambda q, k: np.concatenate([q, k]))}
    restored, report = _both(template, weights, name_map=mapping)
    assert not report["missing"] and not report["heuristic_fallback"]
    np.testing.assert_array_equal(restored["params"]["z"]["bias"], [1, 1, 2, 2])
    resolver = {"params/x/kernel": "root/a/kernel"}.get
    restored, report = _both({"params": {"x": template["params"]["x"]}}, weights,
                             name_map=resolver)
    assert report["loaded"] == ["params/x/kernel"]

    lin = torch.nn.Linear(4, 3).double()
    out, report = th5.load_h5_weights_by_name(lin, {"weights/kernel": weights["root/a/kernel"].T,
                                                    "weights/bias": np.ones(3, np.float32)})
    assert out.weight.dtype == torch.float64 and not report["missing"]
    torch.testing.assert_close(out.weight, torch.tensor(weights["root/a/kernel"],
                                                        dtype=torch.float64))
