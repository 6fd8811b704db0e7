"""The port's ``evaluate`` and the metric builder and wrapper against
``iseg_tpu``.

``evaluate`` on a reduced ResNet + ASPP with weights carried by
``convert.py``, scales (0.75, 1.0) + flip + a sliding window, both sides in
float32 (the JAX sliding window indexes in int32 and does not trace under
x64; batch 8 over the JAX package's 8-device CPU mesh): the confusion
matrices are equal (both take the first index among equal logits, and the
logits of the two agree to about 1e-6, far inside every top-two gap of
this data), so are mIoU and per-class IoU, and the ``log_dir`` scalars read
back by ``read_event_scalars`` (the eval loss to 1e-5, relative). On the
CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core import evaluation as jeval
from iseg_tpu.core.env import EnvConfig as JEnvConfig
from iseg_tpu.core.env import common_env_setup as j_common_env_setup
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.model import SegModelInferenceConfig as JConfig
from iseg_tpu.metrics import builder as jbuilder
from iseg_tpu.metrics import wrapper as jwrapper
from iseg_tpu.metrics.mean_iou import MeanIoU as JMeanIoU
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu.utils.summary import read_event_scalars
from iseg_tpu_torch.backbones.resnet import ResNet as TResNet
from iseg_tpu_torch.convert import batch_stats_tree, load_flax, param_tree
from iseg_tpu_torch.core import evaluation as teval
from iseg_tpu_torch.core.env import common_env_setup
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.model import SegModelInferenceConfig as TConfig
from iseg_tpu_torch.metrics import MeanIoU, SegMetricBuilder, SegMetricWrapper
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP

torch.set_num_threads(1)

SMALL_RESNET = dict(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True,
                    slim_stack=True, output_stride=16, multi_grid=(1, 2, 4))
NUM_CLASS, HW, BATCH = 4, 32, 8
CONFIG = dict(scale_rates=(0.75, 1.0), flip=True, sliding_window_crop_size=(24, 24))


def _dataset(dtype=np.float32, n_batches=2):
    rng = np.random.RandomState(0)
    for _ in range(n_batches):
        label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
        label = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
        yield {"image": rng.rand(BATCH, HW, HW, 3).astype(dtype), "label": label}


def _port_model():
    bb = TResNet(**SMALL_RESNET)
    return TSegManaged(num_class=NUM_CLASS, backbone=bb,
                       head=TASPP(bb.out_channels, filters=16, dropout_rate=0.0))


def _rows(log_dir):
    (name,) = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
    return read_event_scalars(os.path.join(log_dir, name))


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evaluation")
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JResNet(**SMALL_RESNET),
                     head=JASPP(filters=16, dropout_rate=0.0))
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
    tm = _port_model()
    load_flax(tm, variables)
    t_metric = MeanIoU(NUM_CLASS)
    env = common_env_setup(device="cpu", mixed_precision=False)
    t_out = teval.evaluate(env, tm, None, _dataset(), inference_config=TConfig(**CONFIG),
                           verbose=False, compute_loss=True, log_dir=str(tmp / "t"),
                           log_step=7, metric=t_metric)

    metrics = []

    class Recording(JMeanIoU):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            metrics.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeval, "MeanIoU", Recording)
        j_env = j_common_env_setup(JEnvConfig(random_seed=0, mixed_precision=False))
        j_out = jeval.evaluate(j_env, jm, variables, _dataset(), inference_config=JConfig(**CONFIG),
                               verbose=False, compute_loss=True, log_dir=str(tmp / "j"),
                               log_step=7)
    return dict(t_out=t_out, j_out=j_out, t_cm=t_metric.total_cm, j_cm=metrics[0].total_cm,
                t_rows=_rows(tmp / "t"), j_rows=_rows(tmp / "j"), tm=tm, jm=jm,
                variables=variables)


def test_torch_eval_logits_match_jax_inside_top_two_gaps(evaluated):
    """The tie rule behind the equal confusion matrices: the two eval steps'
    logits differ by less than the smallest gap between a pixel's two
    largest logits, so no argmax can part."""
    batch = next(_dataset())
    ours = teval.make_eval_step(evaluated["tm"], TConfig(**CONFIG))(
        torch.tensor(batch["image"])).numpy()
    theirs = np.asarray(jeval.make_eval_step(evaluated["jm"].apply, evaluated["variables"],
                                             JConfig(**CONFIG))(jnp.asarray(batch["image"])))
    assert ours.shape == theirs.shape == (BATCH, HW, HW, NUM_CLASS)
    top2 = np.sort(theirs, axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    err = float(np.abs(ours - theirs).max())
    assert err < 1e-4 and err < gap, (err, gap)


def test_torch_evaluate_confusion_matrix_matches_jax(evaluated):
    np.testing.assert_array_equal(evaluated["t_cm"], evaluated["j_cm"])
    labels = np.concatenate([b["label"] for b in _dataset()])
    assert evaluated["t_cm"].sum() == (labels != 255).sum()  # every labelled pixel, once


def test_torch_evaluate_miou_matches_jax(evaluated):
    (t_miou, t_per), (j_miou, j_per) = evaluated["t_out"], evaluated["j_out"]
    assert t_miou == j_miou and 0.0 < t_miou < 1.0
    np.testing.assert_array_equal(t_per, j_per)


def test_torch_evaluate_log_dir_matches_jax(evaluated):
    t_rows, j_rows = evaluated["t_rows"], evaluated["j_rows"]
    assert [(s, t) for s, t, _ in t_rows] == [(s, t) for s, t, _ in j_rows]
    assert {t for _, t, _ in t_rows} == {"eval/mean_iou", "eval/loss",
                                         *(f"eval/iou_class_{i}" for i in range(NUM_CLASS))}
    for (step, tag, a), (_, _, b) in zip(t_rows, j_rows):
        assert step == 7
        if tag == "eval/loss":
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            assert a == b, tag


def test_torch_evaluate_variables_and_images_as_stored(evaluated):
    """Path-keyed variables (as ``restore_latest_variables`` gives them) are
    used without being written into the model; uint8 images become 0-255
    floats; the eval step restores the training flag."""
    tm = evaluated["tm"]
    other = _port_model()
    variables = {"params": {k: v.clone() for k, v in param_tree(tm).items()},
                 "batch_stats": {k: v.clone() for k, v in batch_stats_tree(tm).items()}}
    before = {k: v.clone() for k, v in param_tree(other).items()}
    env = common_env_setup(device="cpu", mixed_precision=False)
    out = teval.evaluate(env, other, variables, _dataset(), inference_config=TConfig(**CONFIG),
                         verbose=False)
    assert out[0] == evaluated["t_out"][0]
    for k, v in param_tree(other).items():
        assert torch.equal(v, before[k])
    stored = [{"image": (b["image"] * 255).astype(np.uint8), "label": b["label"]}
              for b in _dataset(n_batches=1)]
    floats = [{"image": b["image"].astype(np.float32), "label": b["label"]} for b in stored]
    a = teval.evaluate(env, tm, None, stored, verbose=False)
    b = teval.evaluate(env, tm, None, floats, verbose=False)
    assert a[0] == b[0]
    step = teval.make_eval_step(tm)
    tm.train()
    step(torch.zeros(1, HW, HW, 3))
    assert tm.training
    with pytest.raises(KeyError, match="params paths differ"):
        teval.variables_by_module_name(tm, {"params": {"nope": torch.zeros(1)}})


def test_torch_eval_config_still_refuses_cpu_cache_and_buckets(evaluated):
    """The CPU cache and bucketing are ported now, and honoured by
    ``evaluate`` only: ``SegBase.inference`` ignores them, as JAX's does, and
    a bucketed, cached evaluate of this already-aligned data equals the
    plain one (tests/test_torch_buckets.py holds them against JAX)."""
    config = TConfig(**CONFIG, use_cpu_cache=True, bucket_multiple=32)
    assert config.use_cpu_cache and config.bucket_multiple == 32
    image = torch.tensor(next(_dataset())["image"])
    tm = evaluated["tm"]
    torch.testing.assert_close(tm.inference(image, config), tm.inference(image, TConfig(**CONFIG)),
                               rtol=0, atol=0)
    env = common_env_setup(device="cpu", mixed_precision=False)
    out = teval.evaluate(env, tm, None, _dataset(), inference_config=config, verbose=False)
    assert out[0] == evaluated["t_out"][0]
    assert teval.evaluate.last_num_programs == 1


def _labels_logits(seed=0, n=2, hw=8, c=3):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, c, (n, hw, hw)).astype(np.int32)
    labels[:, 0] = 255
    return labels, rng.randn(n, hw, hw, c).astype(np.float32)


def test_torch_metric_builder_matches_jax():
    t_b = SegMetricBuilder(3).add().add("output_1")
    j_b = jbuilder.SegMetricBuilder(3).add().add("output_1")
    assert sorted(t_b.build()) == sorted(j_b.build()) == ["output_0", "output_1"]
    for seed in range(2):
        labels, logits = _labels_logits(seed)
        _, other = _labels_logits(seed + 10)
        t_b.update_state(torch.tensor(labels), {"output_0": torch.tensor(logits),
                                                "output_1": torch.tensor(other),
                                                "output_2": torch.tensor(other)})
        j_b.update_state(jnp.asarray(labels), {"output_0": jnp.asarray(logits),
                                               "output_1": jnp.asarray(other)})
    assert t_b.results() == j_b.results()
    assert set(t_b.results()) == {"output_0_miou", "output_1_miou"}
    t_b.reset_state()
    assert all(v == 0.0 for v in t_b.results().values())


class _Confusion:
    """A raw accumulator with a sample-weight argument, for either package."""

    name = "raw"

    def __init__(self):
        self.cm = np.zeros((3, 3))

    def update_state(self, labels, preds, weights):
        np.add.at(self.cm, (np.asarray(labels).ravel(), np.asarray(preds).ravel()),
                  np.asarray(weights).ravel())

    def result(self):
        return self.cm.trace() / self.cm.sum()

    def reset_state(self):
        self.cm[:] = 0


@pytest.mark.parametrize("ignore_label", [255, 0])
def test_torch_metric_wrapper_matches_jax(ignore_label):
    labels, logits = _labels_logits(3)
    labels = np.where(labels == 255, ignore_label, labels)

    def shift(lb, pr):
        return lb, pr * 2.0

    t_w = SegMetricWrapper(_Confusion(), ignore_label=ignore_label, pre_compute_fn=shift)
    j_w = jwrapper.SegMetricWrapper(_Confusion(), ignore_label=ignore_label, pre_compute_fn=shift)
    t_w.update_state(torch.tensor(labels), torch.tensor(logits))
    j_w.update_state(jnp.asarray(labels), jnp.asarray(logits))
    np.testing.assert_array_equal(t_w.metric.cm, j_w.metric.cm)
    assert t_w.result() == j_w.result() and t_w.name == "raw"
    t_w.reset_state()
    assert t_w.metric.cm.sum() == 0
