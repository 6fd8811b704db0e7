"""The port's data modules against ``iseg_tpu.data``.

``augments``, ``pipeline``, ``input_norm``, ``datasets``, ``loader`` and
``shards`` are numpy copies: each augment class, the standard pipeline,
the normalization modes, the directory loader with its batching (serial
and threaded), and the shard format (written by either package, read by
the other) must give the same arrays bit for bit. ``device_prefetch`` is
the port's own (pinned memory and a ``non_blocking`` copy on a card); on
the CPU it must hand over the same batches, ``size`` ahead. On the CPU.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from iseg_tpu.data import augments as ja
from iseg_tpu.data import datasets as jdatasets
from iseg_tpu.data import input_norm as jnorm
from iseg_tpu.data import loader as jloader
from iseg_tpu.data import pipeline as jpipe
from iseg_tpu.data import shards as jshards
from iseg_tpu_torch.data import augments as ta
from iseg_tpu_torch.data import datasets as tdatasets
from iseg_tpu_torch.data import input_norm as tnorm
from iseg_tpu_torch.data import loader as tloader
from iseg_tpu_torch.data import pipeline as tpipe
from iseg_tpu_torch.data import shards as tshards

torch.set_num_threads(1)

AUGMENTS = {
    "resize": ("ResizeAugment", dict(size=(21, 30))),
    "resize_max": ("ResizeMaxSizeAugment", dict(max_size=24)),
    "random_scale": ("RandomScaleAugment", dict()),
    "random_scale_uniform": ("RandomScaleAugment", dict(step_size=0.0)),
    "random_scale_break_aspect": ("RandomScaleAugment", dict(break_aspect_ratio=True)),
    "pad": ("PadAugment", dict(target_hw=(48, 50), mean_pixel=(127.5, 120.0, 110.0))),
    "pad_center": ("PadAugment", dict(target_hw=(48, 50), center=True, ignore_label=0)),
    "random_crop": ("RandomCropAugment", dict(crop_size=(20, 17))),
    "random_flip": ("RandomFlipAugment", dict()),
    "random_rotate": ("RandomRotateAugment", dict(max_angle=15.0)),
    "pad_to_odd": ("PadToOddAugment", dict()),
    "brightness": ("RandomBrightnessAugment", dict()),
    "contrast": ("RandomContrastAugment", dict()),
    "saturation": ("RandomSaturationAugment", dict()),
    "hue": ("RandomHueAugment", dict(max_delta=0.3)),
    "photometric": ("PhotoMetricDistortionAugment", dict()),
    "erasing_noise": ("RandomErasingAugment", dict(prob=1.0)),
    "erasing_zero": ("RandomErasingAugment", dict(prob=1.0, fill_noise=False)),
    "jpeg": ("JpegQualityAugment", dict()),
    "noisy_eval": ("NoisyEvalAugment", dict(stddev=5.0)),
    "with_prob": ("RandomBrightnessAugment", dict(prob=0.5)),
}


def _sample(seed=0, h=33, w=40):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    label = rng.randint(0, 21, (h, w)).astype(np.int32)
    return image, label


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_torch_augment_matches_jax(name):
    cls, kw = AUGMENTS[name]
    for seed in range(4):
        image, label = _sample(seed)
        j = getattr(ja, cls)(**kw)(np.random.default_rng(seed), image.copy(), label.copy())
        t = getattr(ta, cls)(**kw)(np.random.default_rng(seed), image.copy(), label.copy())
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_torch_lambda_augment_and_resize_helpers_match_jax():
    image, label = _sample()
    fn = lambda im, lb: (im * 0.5, lb + 1)  # noqa: E731
    for a, b in zip(ta.LambdaAugment(fn)(None, image, label), ja.LambdaAugment(fn)(None, image, label)):
        np.testing.assert_array_equal(a, b)
    for hw in ((10, 12), (70, 81)):
        for a, b in zip(ta.resize_image_label(image, label, hw),
                        ja.resize_image_label(image, label, hw)):
            np.testing.assert_array_equal(a, b)


PIPELINES = {
    "train": dict(training=True, crop_size=(24, 24)),
    "train_all": dict(training=True, crop_size=(24, 28), max_resize_value=36,
                      random_brightness=True, photo_metric_distortion=True, random_erasing=True,
                      jpeg_quality=True, flip_prob=0.7, seed=3),
    "train_keras_scale": dict(training=True, crop_size=(40, 44),
                              norm=tnorm.InputNormTypes.KERAS_SCALE),
    "eval": dict(training=False, crop_size=(48, 48)),
    "eval_noise": dict(training=False, eval_crop_size=(36, 48), eval_noise_stddev=4.0,
                       norm=tnorm.InputNormTypes.KERAS),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_torch_standard_pipeline_matches_jax(name):
    kw = dict(PIPELINES[name])
    t_pipe = tpipe.StandardAugmentationsPipeline(**kw)
    if "norm" in kw:
        kw["norm"] = jnorm.InputNormTypes(kw["norm"].value)
    j_pipe = jpipe.StandardAugmentationsPipeline(**kw)
    assert [type(a).__name__ for a in t_pipe.augments] == [type(a).__name__ for a in j_pipe.augments]
    for i in range(4):
        image, label = _sample(i)
        for a, b in zip(t_pipe(image, label, sample_index=i), j_pipe(image, label, sample_index=i)):
            np.testing.assert_array_equal(a, b)
    samples = [_sample(i) for i in range(3)]
    for (a_img, a_lab), (b_img, b_lab) in zip(t_pipe.map(samples, 5), j_pipe.map(samples, 5)):
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_lab, b_lab)


@pytest.mark.parametrize("mode", [m.value for m in tnorm.InputNormTypes])
def test_torch_input_norm_matches_jax(mode):
    image, _ = _sample()
    t_mode, j_mode = tnorm.InputNormTypes(mode), jnorm.InputNormTypes(mode)
    np.testing.assert_array_equal(tnorm.normalize_input(image, t_mode),
                                  jnorm.normalize_input(image, j_mode))
    np.testing.assert_array_equal(tnorm.inverse_normalize_input(image / 255.0, t_mode),
                                  jnorm.inverse_normalize_input(image / 255.0, j_mode))
    np.testing.assert_array_equal(tnorm.get_mean_pixel(t_mode), jnorm.get_mean_pixel(j_mode))


def test_torch_datasets_match_jax():
    assert tdatasets.voc_palette() == jdatasets.voc_palette()
    assert tdatasets.VOC_CLASSES == jdatasets.VOC_CLASSES
    assert tdatasets.CITYSCAPES_TRAIN_CLASSES == jdatasets.CITYSCAPES_TRAIN_CLASSES
    raw = np.random.RandomState(0).randint(0, 40, (17, 23))
    np.testing.assert_array_equal(tdatasets.cityscapes_to_train_ids(raw),
                                  jdatasets.cityscapes_to_train_ids(raw))


def _write_pngs(root, n=10):
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    for i in range(n):
        image, label = _sample(i, h=30 + i, w=34)
        Image.fromarray(image.astype(np.uint8)).save(images / f"img_{i:03d}.png")
        Image.fromarray(label.astype(np.uint8)).save(labels / f"img_{i:03d}.png")
    return str(images), str(labels)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_torch_directory_batches_match_jax(tmp_path, num_workers):
    image_dir, label_dir = _write_pngs(tmp_path)
    t_ds = tloader.SegDirectoryDataset(image_dir, label_dir)
    j_ds = jloader.SegDirectoryDataset(image_dir, label_dir)
    assert len(t_ds) == len(j_ds) == 10 and t_ds.image_paths == j_ds.image_paths
    t_pipe = tpipe.StandardAugmentationsPipeline(training=True, crop_size=(24, 24))
    j_pipe = jpipe.StandardAugmentationsPipeline(training=True, crop_size=(24, 24))
    for epoch in range(2):
        kw = dict(batch_size=4, shuffle=True, seed=1, epoch=epoch, num_workers=num_workers)
        t_batches = list(tloader.batched_dataset(t_ds, pipeline=t_pipe, **kw))
        j_batches = list(jloader.batched_dataset(j_ds, pipeline=j_pipe, **kw))
        assert len(t_batches) == len(j_batches) == 2  # drop_remainder
        for a, b in zip(t_batches, j_batches):
            assert sorted(a) == sorted(b) == ["image", "label"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    ragged = list(tloader.batched_dataset(t_ds, batch_size=4, pipeline=t_pipe,
                                          drop_remainder=False, num_workers=num_workers))
    assert [len(b["image"]) for b in ragged] == [4, 4, 2]


def test_torch_directory_loader_without_pil_raises(monkeypatch):
    monkeypatch.setattr(tloader, "_HAS_PIL", False)
    with pytest.raises(ImportError):
        tloader.load_image("any.png")
    with pytest.raises(ImportError):
        tloader.load_label("any.png")


class _Blobs:
    def __init__(self, n, h, w):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return _sample(i, self.h, self.w)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("source_hw", [(32, 32), (50, 41)])  # stored as is; resized to fit
def test_torch_shards_read_by_either_package(tmp_path, writer, source_hw):
    write = jshards.write_shards if writer == "jax" else tshards.write_shards
    d = str(tmp_path / "shards")
    index = write(_Blobs(11, *source_hw), d, store_size=(32, 32), samples_per_shard=4)
    assert index["num_samples"] == 11 and len(index["shards"]) == 3
    t_reader, j_reader = tshards.ShardReader(d), jshards.ShardReader(d)
    assert len(t_reader) == len(j_reader) == 11 and t_reader.store_size == (32, 32)
    idx = np.array([10, 0, 5, 3, 3])
    for a, b in zip(t_reader.gather(idx), j_reader.gather(idx)):
        np.testing.assert_array_equal(a, b)
    for epoch in range(2):
        t_b = list(tshards.shard_batches(t_reader, 4, seed=2, epoch=epoch))
        j_b = list(jshards.shard_batches(j_reader, 4, seed=2, epoch=epoch))
        assert len(t_b) == len(j_b) == 2
        for a, b in zip(t_b, j_b):
            for k in ("image", "label"):
                np.testing.assert_array_equal(a[k], b[k])
    t_fn = tshards.make_shard_dataset_fn(d, 3, seed=4)
    j_fn = jshards.make_shard_dataset_fn(d, 3, seed=4, process_index=0, num_processes=1)
    for a, b in zip(t_fn(1), j_fn(1)):
        np.testing.assert_array_equal(a["image"], b["image"])


def test_torch_shards_written_alike(tmp_path):
    """The same source through either writer gives the same files."""
    for name, write in (("t", tshards.write_shards), ("j", jshards.write_shards)):
        write(_Blobs(6, 50, 41), str(tmp_path / name), store_size=(32, 32), samples_per_shard=4)
    for f in ("images-00000.npy", "labels-00001.npy", "index.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def test_torch_device_prefetch_on_cpu():
    batches = [{"image": np.full((2, 4, 4, 3), i, np.uint8), "label": np.full((2, 4, 4), i)}
               for i in range(5)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(int(b["image"][0, 0, 0, 0]))
            yield b

    it = tloader.device_prefetch(source(), "cpu", size=2,
                                 transform=lambda b: {**b, "label": b["label"] + 1})
    first = next(it)
    assert pulled == [0, 1]  # size batches ahead, no more
    assert isinstance(first["image"], torch.Tensor) and first["image"].dtype == torch.uint8
    out = [first] + list(it)
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b["image"].device.type == "cpu"
        np.testing.assert_array_equal(b["image"].numpy(), batches[i]["image"])
        np.testing.assert_array_equal(b["label"].numpy(), batches[i]["label"] + 1)
    assert list(tloader.device_prefetch(iter([]), "cpu")) == []
