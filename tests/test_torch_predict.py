"""The port's ``default_image_predict`` and ``predict_with_dir`` against
``iseg_tpu``'s, and its ``VisualizationManager``, on the CPU.

Both sides run a MobileNetV2 (0.35, with the top conv) + SimpleDecoder with
the same weights (carried by ``convert.py``) in float32. Class maps and the
written PNG files are compared exactly: the logits of the two differ by
less than every top-two gap of these inputs (checked on the predicted
batch: the gaps of this random-weight model go down to about 3e-7, the
differences stay below that), so no argmax parts, and PIL encodes equal
pixels to equal bytes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.mobilenetv2 import MobileNetV2 as JMobileNetV2
from iseg_tpu.core import evaluation as jeval
from iseg_tpu.core import predict as jpredict
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.model import SegModelInferenceConfig as JConfig
from iseg_tpu.nn.heads.simpledecoder import SimpleDecoder as JSimpleDecoder
from iseg_tpu_torch.backbones.mobilenetv2 import MobileNetV2 as TMobileNetV2
from iseg_tpu_torch.convert import load_flax
from iseg_tpu_torch.core import predict as tpredict
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.model import SegModelInferenceConfig as TConfig
from iseg_tpu_torch.nn.heads import SimpleDecoder as TSimpleDecoder
from iseg_tpu_torch.utils.vis import VisualizationManager, get_visualization_manager

torch.set_num_threads(1)

NUM_CLASS = 5
BB = dict(output_stride=16, width_multiplier=0.35, include_top_conv=True)
CONFIG = dict(scale_rates=(0.75, 1.0), flip=True)


@pytest.fixture(scope="module")
def models():
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JMobileNetV2(**BB),
                     head=JSimpleDecoder(filters=16, low_level_filters=8))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, 32, 32, 3))))
    bb = TMobileNetV2(**BB)
    tm = TSegManaged(num_class=NUM_CLASS, backbone=bb,
                     head=TSimpleDecoder(bb.endpoint_channels, filters=16, low_level_filters=8))
    load_flax(tm, variables)
    return jm, tm, variables


def test_torch_default_image_predict_matches_jax(models):
    jm, tm, variables = models
    images = np.random.RandomState(0).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    ours = tpredict.default_image_predict(tm, torch.tensor(images), TConfig(**CONFIG))
    theirs = np.asarray(jpredict.default_image_predict(jm.apply, variables, jnp.asarray(images),
                                                       JConfig(**CONFIG)))
    assert ours.dtype == torch.int32 and tuple(ours.shape) == (2, 40, 56)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # the rule behind the equal maps: the logits differ by less than every top-two gap
    logits = tm.inference(torch.tensor(images), TConfig(**CONFIG)).numpy()
    j_logits = np.asarray(jeval.make_eval_step(jm.apply, variables, JConfig(**CONFIG))(
        jnp.asarray(images)))
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    assert float(np.abs(logits - j_logits).max()) < float((top2[..., 1] - top2[..., 0]).min())
    assert len(np.unique(theirs)) > 1
    # without a config: one forward at scale 1
    np.testing.assert_array_equal(
        tpredict.default_image_predict(tm, torch.tensor(images)).numpy(),
        np.asarray(jpredict.default_image_predict(jm.apply, variables, jnp.asarray(images))))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("predict_in")
    rng = np.random.RandomState(0)
    # mixed sizes over two 32-buckets, png and jpg, 5 images: a partial last batch
    for name, hw in [("a.png", (40, 52)), ("b.jpg", (30, 44)), ("c.png", (64, 30)),
                     ("d.png", (33, 33)), ("e.png", (20, 70))]:
        Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(d / name)
    return d


PALETTE = [v for k in range(256) for v in (k * 37 % 256, k * 91 % 256, k * 53 % 256)]
DIR_CASES = {
    "directory_max_bucket": dict(batch_size=2),
    "per_image_buckets": dict(batch_size=2, per_image_buckets=True),
    "palette_batch_3": dict(batch_size=3, palette=PALETTE, inference_config="multi"),
}


@pytest.mark.parametrize("case", sorted(DIR_CASES))
def test_torch_predict_with_dir_writes_jax_bytes(models, image_dir, tmp_path, case):
    from PIL import Image

    jm, tm, variables = models
    kw = dict(DIR_CASES[case])
    multi = kw.pop("inference_config", None) == "multi"
    ours = tpredict.predict_with_dir(tm, str(image_dir), str(tmp_path / "t"), verbose=False,
                                     inference_config=TConfig(**CONFIG) if multi else None, **kw)
    theirs = jpredict.predict_with_dir(jm, variables, str(image_dir), str(tmp_path / "j"),
                                       verbose=False,
                                       inference_config=JConfig(**CONFIG) if multi else None,
                                       **kw)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert sorted(os.path.basename(p) for p in ours) == ["a.png", "b.png", "c.png", "d.png",
                                                          "e.png"]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
        with Image.open(a) as im:
            assert im.mode == ("P" if "palette" in kw else "L")
            assert np.asarray(im).max() < NUM_CLASS
    sizes = {}
    for p in ours:
        with Image.open(p) as im:
            sizes[os.path.basename(p)] = (im.height, im.width)
    assert sizes == {"a.png": (40, 52), "b.png": (30, 44), "c.png": (64, 30),
                     "d.png": (33, 33), "e.png": (20, 70)}  # cropped back to each image


def test_torch_predict_with_dir_empty_dir(models, tmp_path):
    _, tm, _ = models
    (tmp_path / "empty").mkdir()
    assert tpredict.predict_with_dir(tm, str(tmp_path / "empty"), str(tmp_path / "o"),
                                     verbose=False) == []


def test_torch_visualization_manager():
    vm = get_visualization_manager()
    assert vm is get_visualization_manager()
    local = VisualizationManager()
    x = torch.arange(4.0, requires_grad=True) * 2
    assert local.record("h", x) is x  # disabled: passthrough, nothing stored
    assert local.names() == [] and local.get("h") == []
    local.enabled = True
    assert local.record("h", x) is x
    local.record("h", x + 1)
    local.record("n", np.ones(2))
    assert local.names() == ["h", "n"]
    np.testing.assert_array_equal(local.get("h")[0], [0.0, 2.0, 4.0, 6.0])
    np.testing.assert_array_equal(local.get("h")[1], [1.0, 3.0, 5.0, 7.0])
    assert isinstance(local.get("h")[0], np.ndarray)
    local.enabled = False
    local.record("h", x)
    assert len(local.get("h")) == 2
    local.clear()
    assert local.names() == []
