"""The port's shape buckets, the bucketed ``evaluate`` and the CPU logit
cache against ``iseg_tpu``'s, on the CPU.

``utils/buckets.py`` is a numpy copy: every function gives what JAX's gives
(arrays equal exactly) over a sweep of sizes and multiples. ``evaluate``
with ``bucket_multiple`` runs a MobileNetV2 (0.35, no top conv) +
SimpleDecoder with weights carried by ``convert.py`` over variable-size
batches in float32 on both sides (batch 8, the JAX package's 8-device CPU
mesh), scales (0.75, 1.0) + flip: the padded batches' logits differ by
less than every top-two gap of the padded pixels (the rule of
``tests/test_torch_evaluation.py``), so the confusion matrices, mIoU and
per-class IoU are equal, and so is ``last_num_programs``. The port's CPU
cache equals its plain sweep bit for bit (the same fp32 sums in the same
order), and JAX's cached logits to 1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.mobilenetv2 import MobileNetV2 as JMobileNetV2
from iseg_tpu.core import evaluation as jeval
from iseg_tpu.core.env import EnvConfig as JEnvConfig
from iseg_tpu.core.env import common_env_setup as j_common_env_setup
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.model import SegModelInferenceConfig as JConfig
from iseg_tpu.metrics.mean_iou import MeanIoU as JMeanIoU
from iseg_tpu.nn.heads.simpledecoder import SimpleDecoder as JSimpleDecoder
from iseg_tpu.utils import buckets as jb
from iseg_tpu_torch.backbones.mobilenetv2 import MobileNetV2 as TMobileNetV2
from iseg_tpu_torch.convert import load_flax
from iseg_tpu_torch.core import evaluation as teval
from iseg_tpu_torch.core.env import common_env_setup
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.model import SegModelInferenceConfig as TConfig
from iseg_tpu_torch.metrics import MeanIoU
from iseg_tpu_torch.nn.heads import SimpleDecoder as TSimpleDecoder
from iseg_tpu_torch.utils import buckets as tb

torch.set_num_threads(1)

# ------------------------------------------------------------- the functions

SIZES = [(1, 1), (31, 32), (32, 32), (33, 95), (100, 150), (375, 500), (500, 333),
         (512, 1024), (1025, 2049)]
MULTIPLES = [8, 32, 128]


@pytest.mark.parametrize("multiple", MULTIPLES)
def test_torch_bucket_hw_matches_jax(multiple):
    for h, w in SIZES:
        assert tb.bucket_hw(h, w, multiple) == jb.bucket_hw(h, w, multiple)
        for max_hw in ((64, 64), (512, 512), (h, w), (h + 1, w - 1 if w > 1 else 1)):
            got = tb.bucket_hw(h, w, multiple, max_hw=max_hw)
            assert got == jb.bucket_hw(h, w, multiple, max_hw=max_hw)
            assert got[0] >= h and got[1] >= w  # the cap never cuts the image


@pytest.mark.parametrize("multiple", MULTIPLES)
def test_torch_pad_crop_and_stats_match_jax(multiple):
    rng = np.random.RandomState(multiple)
    for h, w in SIZES[:7]:
        img = rng.rand(h, w, 3).astype(np.float32)
        lab = rng.randint(0, 5, (h, w)).astype(np.int32)
        for t, j in zip(tb.pad_to_bucket(img, lab, multiple, mean_pixel=0.25, ignore_label=9),
                        jb.pad_to_bucket(img, lab, multiple, mean_pixel=0.25, ignore_label=9)):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
        t_img, t_lab, hw = tb.pad_to_bucket(img, None, multiple)
        assert t_lab is None and hw == (h, w)
        imgs = rng.rand(2, h, w, 3).astype(np.float32)
        labs = rng.randint(0, 5, (2, h, w)).astype(np.int32)
        t = tb.pad_batch_to_bucket(imgs, labs, multiple, image_pad_value=-1.0, ignore_label=7)
        j = jb.pad_batch_to_bucket(imgs, labs, multiple, image_pad_value=-1.0, ignore_label=7)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        logits = rng.rand(2, *t[0].shape[1:3], 4)
        np.testing.assert_array_equal(tb.crop_logits(logits, (h, w)), jb.crop_logits(logits, (h, w)))
    assert tb.bucket_stats(SIZES, multiple) == jb.bucket_stats(SIZES, multiple)


# ------------------------------------------------------------- evaluate

NUM_CLASS, BATCH, MULTIPLE = 3, 8, 16
BATCH_HW = ((20, 28), (33, 17), (30, 30), (40, 44))  # buckets (32,32) (48,32) (32,32) (48,48)
CONFIG = dict(scale_rates=(0.75, 1.0), flip=True)
BB = dict(output_stride=16, width_multiplier=0.35, include_top_conv=False)


def _dataset():
    rng = np.random.RandomState(0)
    for h, w in BATCH_HW:
        label = rng.randint(0, NUM_CLASS, (BATCH, h, w))
        label = np.where(rng.rand(BATCH, h, w) < 0.1, 255, label).astype(np.int32)
        yield {"image": rng.rand(BATCH, h, w, 3).astype(np.float32), "label": label}


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


@pytest.fixture(scope="module")
def evaluated(models):
    jm, tm, variables = models
    t_metric = MeanIoU(NUM_CLASS)
    env = common_env_setup(device="cpu", mixed_precision=False)
    t_out = teval.evaluate(env, tm, None, _dataset(),
                           inference_config=TConfig(**CONFIG, bucket_multiple=MULTIPLE),
                           verbose=False, metric=t_metric)
    t_programs = teval.evaluate.last_num_programs
    metrics = []

    class Recording(JMeanIoU):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            metrics.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeval, "MeanIoU", Recording)
        j_env = j_common_env_setup(JEnvConfig(random_seed=0, mixed_precision=False))
        j_out = jeval.evaluate(j_env, jm, variables, _dataset(),
                               inference_config=JConfig(**CONFIG, bucket_multiple=MULTIPLE),
                               verbose=False)
    return dict(t_out=t_out, j_out=j_out, t_cm=t_metric.total_cm, j_cm=metrics[0].total_cm,
                t_programs=t_programs, j_programs=jeval.evaluate.last_num_programs)


def test_torch_bucketed_eval_logits_inside_top_two_gaps(models):
    """The tie rule behind the equal confusion matrices, on each padded batch."""
    jm, tm, variables = models
    t_step = teval.make_eval_step(tm, TConfig(**CONFIG))
    j_step = jeval.make_eval_step(jm.apply, variables, JConfig(**CONFIG))
    for batch in _dataset():
        image, _, _ = tb.pad_batch_to_bucket(batch["image"], batch["label"], MULTIPLE)
        ours = t_step(torch.tensor(image)).numpy()
        theirs = np.asarray(j_step(jnp.asarray(image)))
        assert ours.shape == theirs.shape == image.shape[:3] + (NUM_CLASS,)
        top2 = np.sort(theirs, axis=-1)[..., -2:]
        gap = float((top2[..., 1] - top2[..., 0]).min())
        err = float(np.abs(ours - theirs).max())
        assert err < 1e-4 and err < gap, (err, gap)


def test_torch_bucketed_evaluate_matches_jax(evaluated):
    np.testing.assert_array_equal(evaluated["t_cm"], evaluated["j_cm"])
    labels = [b["label"] for b in _dataset()]
    assert evaluated["t_cm"].sum() == sum((lb != 255).sum() for lb in labels)  # pads ignored
    (t_miou, t_per), (j_miou, j_per) = evaluated["t_out"], evaluated["j_out"]
    assert t_miou == j_miou and 0.0 < t_miou < 1.0
    np.testing.assert_array_equal(t_per, j_per)


def test_torch_bucketed_evaluate_counts_programs_like_jax(evaluated):
    want = len(tb.bucket_stats(BATCH_HW, MULTIPLE))
    assert evaluated["t_programs"] == evaluated["j_programs"] == want == 3


@pytest.mark.parametrize("sliding", [None, (24, 24)], ids=["direct", "sliding"])
def test_torch_cpu_cache_matches_plain_sweep_and_jax(models, sliding):
    jm, tm, variables = models
    cfg = dict(CONFIG, sliding_window_crop_size=sliding)
    image = next(_dataset())["image"]
    plain = teval.make_eval_step(tm, TConfig(**cfg))(torch.tensor(image))
    cached_step = teval.make_eval_step(tm, TConfig(**cfg, use_cpu_cache=True))
    cached = cached_step(torch.tensor(image))
    assert cached.device.type == "cpu" and cached.dtype == torch.float32
    torch.testing.assert_close(cached, plain, rtol=0, atol=0)
    assert cached_step.seen_shapes == {tuple(image.shape)}
    theirs = np.asarray(jeval.make_eval_step(jm.apply, variables,
                                             JConfig(**cfg, use_cpu_cache=True))(
        jnp.asarray(image)))
    np.testing.assert_allclose(cached.numpy(), theirs, rtol=0, atol=1e-5 * np.abs(theirs).max())


def test_torch_cpu_cache_evaluate_matches_plain(models, evaluated):
    _, tm, _ = models
    env = common_env_setup(device="cpu", mixed_precision=False)
    metric = MeanIoU(NUM_CLASS)
    out = teval.evaluate(env, tm, None, _dataset(), verbose=False, metric=metric,
                         inference_config=TConfig(**CONFIG, bucket_multiple=MULTIPLE,
                                                  use_cpu_cache=True))
    np.testing.assert_array_equal(metric.total_cm, evaluated["t_cm"])
    assert out[0] == evaluated["t_out"][0]
    assert teval.evaluate.last_num_programs == 3
