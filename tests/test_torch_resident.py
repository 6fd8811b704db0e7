"""The port's ``DeviceResidentDataset`` against ``iseg_tpu.data.resident``
and ``shard_batches``: the same epoch orders and the same batches, from a
``ShardReader`` and from raw arrays. On the CPU (single process)."""

import numpy as np
import pytest
import torch

from iseg_tpu.data import resident as jres
from iseg_tpu.data import shards as jshards
from iseg_tpu_torch.data import resident as tres
from iseg_tpu_torch.data import shards as tshards

torch.set_num_threads(1)


class _Blobs:
    def __len__(self):
        return 13

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return (rng.randint(0, 256, (24, 24, 3)).astype(np.float32),
                rng.randint(0, 21, (24, 24)))


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("resident") / "shards")
    tshards.write_shards(_Blobs(), d, store_size=(24, 24), samples_per_shard=5)
    return d


@pytest.mark.parametrize("chunk", [4, 512])
def test_torch_resident_uploads_the_shards(shard_dir, chunk):
    reader = tshards.ShardReader(shard_dir)
    ds = tres.DeviceResidentDataset(reader, device="cpu", chunk_samples=chunk)
    images, labels = reader.gather(np.arange(13))
    assert ds.num_samples == 13 and ds.images.dtype == ds.labels.dtype == torch.uint8
    np.testing.assert_array_equal(ds.images.numpy(), images)
    np.testing.assert_array_equal(ds.labels.numpy(), labels)
    assert ds.nbytes() == images.nbytes + labels.nbytes


@pytest.mark.parametrize("shuffle", [True, False])
def test_torch_resident_batches_match_jax_and_shard_batches(shard_dir, shuffle):
    t_ds = tres.DeviceResidentDataset(tshards.ShardReader(shard_dir), device="cpu")
    j_ds = jres.DeviceResidentDataset(jshards.ShardReader(shard_dir))
    for epoch in range(3):
        np.testing.assert_array_equal(t_ds.epoch_indices(epoch, seed=5, shuffle=shuffle),
                                      j_ds.epoch_indices(epoch, seed=5, shuffle=shuffle))
        ours = list(t_ds.batches(4, epoch=epoch, seed=5, shuffle=shuffle))
        theirs = list(j_ds.batches(4, epoch=epoch, seed=5, shuffle=shuffle))
        host = list(jshards.shard_batches(jshards.ShardReader(shard_dir), 4, shuffle=shuffle,
                                          seed=5, epoch=epoch))
        assert len(ours) == len(theirs) == len(host) == 3
        for a, b, c in zip(ours, theirs, host):
            for k in ("image", "label"):
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
                np.testing.assert_array_equal(a[k].numpy(), c[k])
        j_idx = [b["index"] for b in j_ds.index_dataset_fn(4, seed=5, shuffle=shuffle)(epoch)]
        t_idx = [b["index"] for b in t_ds.index_dataset_fn(4, seed=5, shuffle=shuffle)(epoch)]
        for a, b in zip(t_idx, j_idx):
            np.testing.assert_array_equal(a, b)
    ragged = list(t_ds.index_batches(4, drop_remainder=False))
    assert [len(b) for b in ragged] == [4, 4, 4, 1]
    first = next(iter(t_ds.dataset_fn(4, seed=5, shuffle=shuffle)(2)))
    np.testing.assert_array_equal(first["image"].numpy(), ours[0]["image"].numpy())


def test_torch_resident_from_arrays_matches_jax():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (9, 8, 10, 3)).astype(np.uint8)
    labels = rng.randint(0, 5, (9, 8, 10)).astype(np.uint8)
    t_ds = tres.DeviceResidentDataset((images, labels), device="cpu")
    j_ds = jres.DeviceResidentDataset((images, labels))
    for a, b in zip(t_ds.batches(3, epoch=1), j_ds.batches(3, epoch=1)):
        np.testing.assert_array_equal(a["image"].numpy(), np.asarray(b["image"]))
        np.testing.assert_array_equal(a["label"].numpy(), np.asarray(b["label"]))
    image, label = t_ds.gather(np.array([8, 0]))
    np.testing.assert_array_equal(image.numpy(), images[[8, 0]])
    np.testing.assert_array_equal(label.numpy(), labels[[8, 0]])


def test_torch_resident_refuses_what_is_not_ported(shard_dir):
    # pod partitions and mesh= are ported (tests/test_torch_parallel_data.py),
    # and so are meshes with a model axis (tests/test_torch_lm_tp.py); what
    # stays refused: a mesh without a process group, of any shape
    from iseg_tpu_torch.parallel.mesh import create_mesh

    with pytest.raises(RuntimeError, match="process group"):
        create_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(model_parallelism=2)
    reader = tshards.ShardReader(shard_dir)
    ds = tres.DeviceResidentDataset(reader, device="cpu", process_index=1, num_processes=2)
    assert ds.num_samples == len(reader) // 2


def test_torch_resident_capacity_check(shard_dir):
    reader = tshards.ShardReader(shard_dir)
    need = 13 * 24 * 24 * 4
    with pytest.raises(ValueError, match="resident data needs"):
        tres.DeviceResidentDataset(reader, device="cpu", hbm_free_bytes=need, hbm_safety=0.5)
    tres.DeviceResidentDataset(reader, device="cpu", hbm_free_bytes=2 * need, hbm_safety=0.6)
    assert tres.free_device_bytes(torch.device("cpu")) is None
