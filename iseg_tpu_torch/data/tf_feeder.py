"""tf.data-as-feeder adapter (a copy of ``iseg_tpu/data/tf_feeder.py``).

Users with tf.data pipelines (TFRecords, etc.) drain them into the
framework's host-batch format ({"image": np.float32, "label": np.int32});
tf.data stays a CPU feeder, and the batches go to the device through the
port's loaders like any other host batch.

TensorFlow is imported lazily, inside the functions only.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional


def iterate_tf_dataset(
    dataset,
    image_key: str = "image",
    label_key: str = "label",
    map_fn: Optional[Callable] = None,
) -> Iterator[dict]:
    """Yield host batches from a (batched) tf.data.Dataset.

    ``dataset`` elements may be (image, label) tuples or dicts. ``map_fn``
    optionally post-processes the numpy pair per batch."""
    import numpy as np

    for element in dataset.as_numpy_iterator():
        if isinstance(element, dict):
            image, label = element[image_key], element[label_key]
        else:
            image, label = element
        if map_fn is not None:
            image, label = map_fn(image, label)
        if label is not None and label.ndim == 4 and label.shape[-1] == 1:
            label = label[..., 0]
        yield {
            "image": np.asarray(image, np.float32),
            "label": np.asarray(label, np.int32),
        }


def tfrecord_seg_dataset(
    file_pattern: str,
    batch_size: int,
    image_feature: str = "image/encoded",
    label_feature: str = "image/segmentation/class/encoded",
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    pad_to: Optional[tuple] = None,
    ignore_label: int = 255,
    mean_pixel: tuple = (127.5, 127.5, 127.5),
    per_sample_map_fn: Optional[Callable] = None,
):
    """Build a DeepLab-style TFRecord segmentation dataset feeder.

    Variable-size records (the normal VOC/Cityscapes case) cannot be
    batched raw — pass ``pad_to=(H, W)`` to shrink-to-fit + pad each
    sample (image with ``mean_pixel``, label with ``ignore_label`` —
    the reference's pad semantics, ``data_process/utils.py:374``), or
    ``per_sample_map_fn`` for a custom pre-batch tf transform. Leave both
    unset only when every record already has identical dimensions.

    Returns an iterator of host batches (decode + batch on CPU via
    tf.data; augmentation happens in iseg_tpu_torch.data pipelines afterwards
    or via ``map_fn`` on :func:`iterate_tf_dataset`)."""
    import tensorflow as tf

    features = {
        image_feature: tf.io.FixedLenFeature((), tf.string),
        label_feature: tf.io.FixedLenFeature((), tf.string),
    }

    def parse(record):
        parsed = tf.io.parse_single_example(record, features)
        image = tf.cast(tf.io.decode_image(parsed[image_feature], channels=3,
                                           expand_animations=False), tf.float32)
        label = tf.cast(tf.io.decode_image(parsed[label_feature], channels=1,
                                           expand_animations=False), tf.int32)
        return image, label[..., 0]

    def shrink_and_pad(image, label):
        th, tw = int(pad_to[0]), int(pad_to[1])
        h = tf.cast(tf.shape(image)[0], tf.float32)
        w = tf.cast(tf.shape(image)[1], tf.float32)
        scale = tf.minimum(tf.minimum(th / h, tw / w), 1.0)  # never upscale
        nh = tf.cast(tf.round(h * scale), tf.int32)
        nw = tf.cast(tf.round(w * scale), tf.int32)
        image = tf.image.resize(image, (nh, nw), method="bilinear")
        label = tf.image.resize(label[..., None], (nh, nw),
                                method="nearest")[..., 0]
        mean = tf.constant(mean_pixel, tf.float32)
        image = tf.pad(image - mean, [[0, th - nh], [0, tw - nw], [0, 0]]) + mean
        label = tf.pad(label, [[0, th - nh], [0, tw - nw]],
                       constant_values=ignore_label)
        image.set_shape((th, tw, 3))
        label.set_shape((th, tw))
        return image, label

    ds = tf.data.Dataset.list_files(file_pattern, shuffle=shuffle, seed=seed)
    ds = ds.interleave(tf.data.TFRecordDataset, num_parallel_calls=tf.data.AUTOTUNE)
    if shuffle:
        ds = ds.shuffle(1024, seed=seed)
    ds = ds.map(parse, num_parallel_calls=tf.data.AUTOTUNE)
    if per_sample_map_fn is not None:
        ds = ds.map(per_sample_map_fn, num_parallel_calls=tf.data.AUTOTUNE)
    elif pad_to is not None:
        ds = ds.map(shrink_and_pad, num_parallel_calls=tf.data.AUTOTUNE)
    ds = ds.batch(batch_size, drop_remainder=drop_remainder)
    ds = ds.prefetch(tf.data.AUTOTUNE)
    return iterate_tf_dataset(ds)
