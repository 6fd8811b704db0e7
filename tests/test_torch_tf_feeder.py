"""The port's copy of the tf.data feeder against ``iseg_tpu``'s, on the CPU:
tuple and dict elements, ``map_fn``, and variable-size TFRecords batched
with ``pad_to`` (these need TensorFlow and skip without it). Batches are
compared exactly (the same tf.data program feeds both)."""

import numpy as np
import pytest

from iseg_tpu.data import tf_feeder as jfeeder
from iseg_tpu_torch.data import tf_feeder as tfeeder


class FakeTFDataset:
    """Stub exposing the ``as_numpy_iterator()`` surface the adapter uses."""

    def __init__(self, elements):
        self._elements = elements

    def as_numpy_iterator(self):
        return iter(self._elements)


def _same(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["image", "label"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_torch_iterate_tuple_elements_match_jax():
    rng = np.random.RandomState(0)
    elements = [(rng.randint(0, 255, (2, 4, 4, 3)).astype(np.uint8),
                 rng.randint(0, 5, (2, 4, 4, 1)).astype(np.uint8)) for _ in range(2)]
    ours = list(tfeeder.iterate_tf_dataset(FakeTFDataset(elements)))
    _same(ours, list(jfeeder.iterate_tf_dataset(FakeTFDataset(elements))))
    assert ours[0]["image"].dtype == np.float32 and ours[0]["label"].shape == (2, 4, 4)
    assert ours[0]["label"].dtype == np.int32


def test_torch_iterate_dict_elements_with_map_fn_match_jax():
    elements = [{"img": np.full((1, 2, 2, 3), 255.0), "lab": np.ones((1, 2, 2))}]

    def map_fn(i, l):
        return i / 255.0, l + 1

    kw = dict(image_key="img", label_key="lab", map_fn=map_fn)
    ours = list(tfeeder.iterate_tf_dataset(FakeTFDataset(elements), **kw))
    _same(ours, list(jfeeder.iterate_tf_dataset(FakeTFDataset(elements), **kw)))
    np.testing.assert_allclose(ours[0]["image"], 1.0)
    assert (ours[0]["label"] == 2).all()


def _write_records(tf, path, sizes, seed=0):
    def encode(img, lab):
        feats = {
            "image/encoded": tf.train.Feature(bytes_list=tf.train.BytesList(
                value=[tf.io.encode_png(img).numpy()])),
            "image/segmentation/class/encoded": tf.train.Feature(
                bytes_list=tf.train.BytesList(value=[tf.io.encode_png(lab).numpy()])),
        }
        return tf.train.Example(features=tf.train.Features(feature=feats)).SerializeToString()

    rng = np.random.RandomState(seed)
    with tf.io.TFRecordWriter(path) as w:
        for hw in sizes:
            img = rng.randint(0, 255, (*hw, 3)).astype(np.uint8)
            lab = rng.randint(0, 20, (*hw, 1)).astype(np.uint8)
            w.write(encode(img, lab))


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_torch_tfrecord_variable_size_with_pad_to_matches_jax(tmp_path, shuffle):
    """Records of different sizes batch with ``pad_to`` (shrink to fit, then
    mean/ignore padding); a larger record is shrunk, a smaller one sits
    top-left unscaled."""
    tf = pytest.importorskip("tensorflow")
    _write_records(tf, str(tmp_path / "data-00000.tfrecord"), ((6, 9), (12, 5), (20, 16), (8, 8)))
    kw = dict(batch_size=2, shuffle=shuffle, seed=3, pad_to=(12, 12), ignore_label=255,
              mean_pixel=(1.0, 2.0, 3.0))
    ours = list(tfeeder.tfrecord_seg_dataset(str(tmp_path / "data-*"), **kw))
    theirs = list(jfeeder.tfrecord_seg_dataset(str(tmp_path / "data-*"), **kw))
    _same(ours, theirs)
    assert len(ours) == 2 and ours[0]["image"].shape == (2, 12, 12, 3)
    if not shuffle:
        assert (ours[0]["label"][0, 6:, :] == 255).all()
        np.testing.assert_allclose(ours[0]["image"][0, -1, -1], [1.0, 2.0, 3.0])
