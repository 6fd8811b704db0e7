"""The port's distributed data and evaluation against ``iseg_tpu``.

Without a process group:

* pod partitions of ``DeviceResidentDataset`` (``process_index`` /
  ``num_processes``): the same rows and epoch batches as the JAX package's;
* ``ChunkRotatingResidentDataset``: the same batch stream as
  ``DeviceResidentDataset``'s and as the JAX package's rotating dataset,
  for several window sizes and a process partition.

On two gloo ranks (one spawn for the file, ``torch_parallel_jobs.job_data``):

* ``DeviceResidentDataset(mesh=)``: each rank holds its contiguous half;
  the gather of a global index vector gives the global batch on both
  ranks, exactly; one resident DP step (with and without the device
  augment, whose draws are the rank's rows of the global batch's) gives the
  world-size-1 step's loss (float32, rtol 1e-5);
* sharded ``evaluate`` (float32, scales (0.75, 1.0) + flip + sliding
  window, batch 8 over the two ranks) against the JAX package's
  ``evaluate`` on a two-device mesh: the ranks' logits differ from JAX's by
  less than every top-two gap, so the confusion matrices are equal; a
  batch the ranks do not divide raises; with ignore pixels spread unevenly
  over the ranks the logged loss is JAX's global valid-pixel mean (rtol
  1e-5), written by rank 0 alone;
* ``inference_with_sliding_window_sharded`` on one 80x112 image (48x48
  windows at stride 2/3) within 1e-5 of max |logit| of the JAX package's
  on the mesh (float32: the JAX window does not trace under x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_jobs as jobs
from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core import evaluation as jeval
from iseg_tpu.core.inference import inference_with_sliding_window_sharded as j_window
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.model import SegModelInferenceConfig as JConfig
from iseg_tpu.data import resident as jres
from iseg_tpu.losses import cross_entropy as jce
from iseg_tpu.metrics.mean_iou import MeanIoU as JMeanIoU
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu.parallel.mesh import MeshEnv, create_mesh
from iseg_tpu_torch.data import resident as tres
from torch_parallel_helpers import spawn

torch.set_num_threads(1)

PARTITIONS = [(0, 2), (1, 2), (2, 3), (0, 1)]


@pytest.mark.parametrize("pi,k", PARTITIONS, ids=[f"{p}of{k}" for p, k in PARTITIONS])
def test_torch_resident_partition_matches_jax(pi, k):
    images, labels = jobs.make_resident_arrays()
    t_ds = tres.DeviceResidentDataset((images, labels), device="cpu", process_index=pi,
                                      num_processes=k)
    j_ds = jres.DeviceResidentDataset((images, labels), process_index=pi, num_processes=k)
    assert t_ds.num_samples == j_ds.num_samples
    np.testing.assert_array_equal(t_ds.images.numpy(), np.asarray(j_ds.images))
    for epoch in (0, 1):
        pairs = list(zip(t_ds.batches(2, epoch=epoch, seed=4), j_ds.batches(2, epoch=epoch,
                                                                            seed=4)))
        assert len(pairs) == j_ds.num_samples // 2
        for a, b in pairs:
            np.testing.assert_array_equal(a["image"].numpy(), np.asarray(b["image"]))
            np.testing.assert_array_equal(a["label"].numpy(), np.asarray(b["label"]))


WINDOWS = [(4, 3, (0, 1)), (5, 3, (0, 1)), (100, 3, (0, 1)), (4, 2, (1, 2)), (6, 4, (0, 1))]


@pytest.mark.parametrize("window,batch,part", WINDOWS,
                         ids=[f"w{w}_b{b}_p{p[0]}of{p[1]}" for w, b, p in WINDOWS])
def test_torch_chunk_rotating_stream_matches(window, batch, part):
    images, labels = jobs.make_resident_arrays()
    pi, k = part
    rot = tres.ChunkRotatingResidentDataset((images, labels), window_samples=window,
                                            device="cpu", process_index=pi, num_processes=k)
    res = tres.DeviceResidentDataset((images, labels), device="cpu", process_index=pi,
                                     num_processes=k)
    j_rot = jres.ChunkRotatingResidentDataset((images, labels), window_samples=window,
                                              process_index=pi, num_processes=k)
    for epoch in (0, 2):
        got = list(rot.batches(batch, epoch=epoch, seed=1))
        want = list(res.batches(batch, epoch=epoch, seed=1))
        theirs = list(j_rot.batches(batch, epoch=epoch, seed=1))
        assert len(got) == len(want) == len(theirs) > 0
        for a, b, c in zip(got, want, theirs):
            np.testing.assert_array_equal(a["image"].numpy(), b["image"].numpy())
            np.testing.assert_array_equal(a["label"].numpy(), np.asarray(c["label"]))
            np.testing.assert_array_equal(a["image"].numpy(), np.asarray(c["image"]))


def _jax_eval_model():
    return JSegManaged(num_class=jobs.EVAL_CLASSES, backbone=JResNet(**jobs.SMALL_RESNET),
                       head=JASPP(filters=16, dropout_rate=0.0))


@pytest.fixture(scope="module")
def eval_variables():
    jm = _jax_eval_model()
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(3), x, train=False))(
        jnp.zeros((1, jobs.EVAL_HW, jobs.EVAL_HW, 3)))
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def loss_variables(eval_variables):
    """The eval model with its classifier's kernel scaled by 30: logits far
    from uniform, so a weighting of the pixels moves the mean loss."""
    def scale(path, leaf):
        if path[-1].key == "kernel" and leaf.shape[-1] == jobs.EVAL_CLASSES:
            return leaf * np.float32(30.0)
        return leaf

    return jax.tree_util.tree_map_with_path(scale, eval_variables)


@pytest.fixture(scope="module")
def ranks(eval_variables, loss_variables, tmp_path_factory):
    from test_torch_parallel import _jax_variables

    tmp = tmp_path_factory.mktemp("parallel_data")
    return spawn(jobs.job_data, tmp, variables=_jax_variables(),
                 eval_variables=eval_variables, loss_variables=loss_variables,
                 log_dir=str(tmp / "eval_log"))


def test_torch_resident_mesh_partition_and_gather(ranks):
    images, labels = jobs.make_resident_arrays()
    n = len(images) - len(images) % 2
    idx = np.array([12, 0, 5, 7, 1, 11, 6, 3])
    for r, got in enumerate(ranks):
        assert got["num_samples"] == n and got["local_rows"] == n // 2
        assert got["row_start"] == r * n // 2
        np.testing.assert_array_equal(got["local_images"],
                                      images[r * n // 2:(r + 1) * n // 2])
        # index 12 is past the truncated dataset: nobody holds it, zeros
        want_image = np.where((idx < n)[:, None, None, None], images[np.minimum(idx, n - 1)], 0)
        np.testing.assert_array_equal(got["gather_image"], want_image)
        np.testing.assert_array_equal(got["gather_label"],
                                      np.where((idx < n)[:, None, None],
                                               labels[np.minimum(idx, n - 1)], 0))


@pytest.mark.parametrize("name", ["plain", "augment"])
def test_torch_resident_mesh_step_matches_world_size_1(ranks, name):
    sharded, single = ranks[0]["losses"][name]
    assert ranks[1]["losses"][name][0] == sharded
    np.testing.assert_allclose(sharded, single, rtol=1e-5)


def test_torch_sharded_evaluate_matches_jax_mesh(ranks, eval_variables):
    from iseg_tpu_torch.metrics.mean_iou import iou_from_confusion

    jm = _jax_eval_model()
    env = MeshEnv(mesh=create_mesh(jax.devices()[:2]), seed=0, compute_dtype=jnp.float32,
                  param_dtype=jnp.float32)
    batches = jobs.make_eval_batches()
    config = JConfig(**jobs.EVAL_CONFIG)
    step = jeval.make_eval_step(jm.apply, eval_variables, config)
    metric = JMeanIoU(jobs.EVAL_CLASSES, 255)
    for i, b in enumerate(batches):
        want = np.asarray(step(jnp.asarray(b["image"])))
        got = np.concatenate([ranks[0]["logits"][i], ranks[1]["logits"][i]])
        top2 = np.sort(want, axis=-1)
        gap = (top2[..., -1] - top2[..., -2])[b["label"] != 255]
        assert np.abs(got - want).max() < gap.min(), "a logit moved past a top-two gap"
        metric.update_state(jnp.asarray(b["label"]), jnp.asarray(want))
    j_miou, j_per_class = jeval.evaluate(env, jm, eval_variables, batches,
                                         inference_config=config, verbose=False)
    want_cm = np.asarray(metric.total_cm)
    for r in ranks:
        np.testing.assert_array_equal(r["cm"], want_cm)
        assert r["cm"].sum() == sum((b["label"] != 255).sum() for b in batches)
        per_class, miou = iou_from_confusion(r["cm"])
        np.testing.assert_allclose(miou, float(j_miou), rtol=1e-6)
        np.testing.assert_allclose(per_class, np.asarray(j_per_class), rtol=1e-6)
        assert r["indivisible_raises"]


def _logged(csv_text: str, tag: str) -> float:
    rows = [line.split(",") for line in csv_text.splitlines()[1:]]
    (value,) = [float(r[2]) for r in rows if r[1] == tag]
    return value


def test_torch_sharded_evaluate_loss_is_global_mean(ranks, loss_variables, tmp_path):
    jm = _jax_eval_model()
    env = MeshEnv(mesh=create_mesh(jax.devices()[:2]), seed=0, compute_dtype=jnp.float32,
                  param_dtype=jnp.float32)
    batches = jobs.make_eval_batches(uneven=True)
    config = JConfig(**jobs.EVAL_CONFIG)
    jeval.evaluate(env, jm, loss_variables, batches, inference_config=config, verbose=False,
                   compute_loss=True, log_dir=str(tmp_path))
    want = _logged(open(tmp_path / "scalars.csv").read(), "eval/loss")
    assert ranks[1]["log"] is None  # rank 0 alone writes
    got = _logged(ranks[0]["log"], "eval/loss")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the case tells the two apart: each half's own mean loss, averaged
    step = jeval.make_eval_step(jm.apply, loss_variables, config)
    half = jobs.EVAL_BATCH // 2
    halves = []
    for b in batches:
        logits = step(jnp.asarray(b["image"]))
        halves.append(np.mean([float(jce.cross_entropy_ignore_label(
            logits[i:i + half], jnp.asarray(b["label"][i:i + half]))) for i in (0, half)]))
    assert abs(np.mean(halves) - want) > 1e-3 * want


def test_torch_sharded_sliding_window_matches_jax_mesh(ranks, eval_variables):
    jm = _jax_eval_model()
    mesh = create_mesh(jax.devices()[:2])
    image = jnp.asarray(jobs.make_window_image())
    want = np.asarray(j_window(lambda w: jm.apply(eval_variables, w, train=False), image,
                               (48, 48), mesh, stride_rate=2.0 / 3.0))
    for r in ranks:
        assert r["window"].shape == want.shape
        np.testing.assert_allclose(r["window"], want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(ranks[0]["window"], ranks[1]["window"])
