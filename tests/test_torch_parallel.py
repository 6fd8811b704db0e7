"""The port's data parallelism on two gloo ranks against ``iseg_tpu`` on a
two-device mesh (``create_mesh(jax.devices()[:2])``).

One spawn of two CPU ranks runs every job of ``torch_parallel_jobs`` for
this file (module fixture); each test compares one job's results:

* the explicit collectives (sum, mean, all-gather, reduce-scatter, the
  global batch, any-rank, the global draw rows), exactly, and the identity
  without a group;
* SyncBatchNorm over the global batch: forward, input / scale / bias
  gradients and running stats against flax's BatchNorm over the whole
  batch, float64, within 1e-10;
* two train steps of a narrow ResNet + ASPP with the fused loss (its plain
  version on the CPU), ignore pixels spread unevenly over the ranks,
  against ``iseg_tpu``'s ``make_train_step`` on the mesh (the JAX side takes
  the same loss through its plain reference, ``upsample_cross_entropy_reference``),
  float64 on both sides: losses rtol 1e-10, params and BN statistics within
  1e-9 of max |param|, the two ranks' params equal bit for bit;
* OHEM's kept mask over the global batch, both selectors, exactly, and the
  loss (rtol 1e-12);
* the FSDP step against the DP step, within 1e-12 of max |param|;
* CoreTrain on the group: a checkpoint written by rank 0, restored on both
  ranks, resumes exactly; a SIGTERM on one rank stops both after the same
  step;
* CoreTrain on the group reading ``make_shard_dataset_fn`` with its
  defaults (each rank its partition, its local batch taken as it is)
  against world size 1 on the union of the partitions, float64, params and
  BN statistics within 1e-9 of max |value|.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_jobs as jobs
from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core import model as jmodel_module
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import create_train_state as j_create_train_state
from iseg_tpu.core.train import make_train_step as j_make_train_step
from iseg_tpu.losses import base as jloss_base
from iseg_tpu.losses import cross_entropy as jce
from iseg_tpu.losses.ohem import get_ohem_fn as j_get_ohem_fn
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu.nn.norm import BatchNorm as JBatchNorm
from iseg_tpu.ops import resize as jresize
from iseg_tpu.ops.pallas import upsample_ce as jupsample
from iseg_tpu.parallel.mesh import create_mesh, replicated_sharding, shard_batch
from iseg_tpu_torch.convert import flatten
from iseg_tpu_torch.data.shards import write_shards
from torch_parallel_helpers import spawn
from torch_zoo_helpers import keep_float64

torch.set_num_threads(1)


def _jax_variables():
    jm = _jax_model()
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, jobs.HW, jobs.HW, 3)))
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_model():
    return JSegManaged(num_class=jobs.NUM_CLASS, backbone=JResNet(**jobs.SMALL_RESNET),
                       head=JASPP(filters=32, dropout_rate=0.0), upsample_logits=False,
                       fuse_upsample_loss=True)


@pytest.fixture(scope="module")
def variables():
    return _jax_variables()


@pytest.fixture(scope="module")
def ranks(variables, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    shard_dir = tmp / "shards"
    write_shards(jobs.make_shard_samples(), str(shard_dir), store_size=(jobs.HW, jobs.HW),
                 samples_per_shard=5)
    results = spawn(jobs.job_suite, tmp, variables=variables, ckpt_dir=str(ckpt),
                    shard_dir=str(shard_dir))
    shutil.rmtree(ckpt)
    shutil.rmtree(shard_dir)
    return results


def test_torch_parallel_collectives(ranks):
    x = [np.arange(6, dtype=np.float64).reshape(3, 2) + 10 * r for r in (0, 1)]
    for r, got in enumerate(r["collectives"] for r in ranks):
        np.testing.assert_array_equal(got["sum"], x[0] + x[1])
        np.testing.assert_array_equal(got["mean"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(got["gather"], np.concatenate(x))
        both = [np.concatenate([a, a + 1]) for a in x]
        np.testing.assert_array_equal(got["scatter"], (both[0] + both[1])[3 * r:3 * (r + 1)])
        assert got["global_batch"] == 16 and got["any"] == (True, False)
        assert got["rows"] == (6, slice(3 * r, 3 * (r + 1)))
        assert got["staged"] == {"all_gather": 0, "reduce_scatter": 0,
                                 "ppermute": 0}  # CPU tensors
        world, rank, batch, summed, gathered = got["alone"]
        assert (world, rank, batch) == (1, 0, 8)
        np.testing.assert_array_equal(summed, x[r])
        np.testing.assert_array_equal(gathered, x[r])


def test_torch_parallel_syncbn_matches_global_batchnorm(ranks):
    x, g, scale, bias = jobs.make_bn_inputs()
    with jax.enable_x64(True):
        bn = JBatchNorm(use_running_average=False, axis=1)
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        # float64 running stats (flax makes them fp32, and then takes the
        # momentum product in fp32)
        v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                   v["batch_stats"])}

        def fwd(params, xx):
            y, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                              mutable=["batch_stats"])
            return jnp.sum(y * jnp.asarray(g)), (y, upd)

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(fwd, argnums=(0, 1), has_aux=True)(
            v["params"], jnp.asarray(x))
        want = {"y": np.asarray(y), "dx": np.asarray(gx), "dscale": np.asarray(gp["scale"]),
                "dbias": np.asarray(gp["bias"]),
                "mean": np.asarray(upd["batch_stats"]["mean"]),
                "var": np.asarray(upd["batch_stats"]["var"])}
    got = [r["syncbn"] for r in ranks]
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in got]), want[key],
                                   rtol=0, atol=1e-10 * np.abs(want[key]).max(), err_msg=key)
    for key in ("dscale", "dbias"):  # each rank's share of the parameter gradient
        np.testing.assert_allclose(got[0][key] + got[1][key], want[key], rtol=0,
                                   atol=1e-10 * np.abs(want[key]).max(), err_msg=key)
    for key in ("mean", "var"):
        for r in got:
            np.testing.assert_array_equal(r[key], got[0][key])
            np.testing.assert_allclose(r[key], want[key], rtol=1e-10, err_msg=key)


def _jax_train(variables, monkeypatch, steps=2):
    keep_float64(monkeypatch, jmodel_module, jupsample, jce, jloss_base, jresize)
    mesh = create_mesh(jax.devices()[:2])
    jm = _jax_model()

    def loss_fn(outputs, labels):
        loss = jupsample.upsample_cross_entropy_reference(outputs, labels)
        return loss, {"loss": loss, "output_0_loss": loss}

    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx, _ = jopt.get_optimizer(v["params"], "sgd", **jobs.OPT)
        state = j_create_train_state(jm, jax.random.PRNGKey(0), (2, jobs.HW, jobs.HW, 3), tx,
                                     variables=v)
        state = jax.device_put(state, replicated_sharding(mesh))
        step = j_make_train_step(loss_fn, donate=False)
        losses, trail = [], []
        for batch in jobs.make_train_batch(steps):
            sharded = shard_batch(mesh, {"image": np.asarray(batch["image"], np.float64),
                                         "label": batch["label"]})
            state, parts = step(state, sharded, jax.random.PRNGKey(1))
            losses.append(float(parts["loss"]))
            trail.append({"params": flatten(jax.tree_util.tree_map(np.asarray, state.params)),
                          "batch_stats": flatten(jax.tree_util.tree_map(
                              np.asarray, state.batch_stats))})
    return losses, trail


def test_torch_parallel_train_steps_match_jax_mesh(ranks, variables, monkeypatch):
    j_losses, j_trail = _jax_train(variables, monkeypatch)
    got = [r["train"] for r in ranks]
    assert got[0]["losses"] == got[1]["losses"]
    # the two ranks hold the same state bit for bit after every step
    assert got[0]["digests"] == got[1]["digests"]
    np.testing.assert_allclose(got[0]["losses"], j_losses, rtol=1e-10)
    for step, want in enumerate(j_trail):
        mine = got[0]["trail"][step]
        for col in ("params", "batch_stats"):
            assert sorted(mine[col]) == sorted(want[col])
            top = max(np.abs(v).max() for v in want[col].values())
            for k, v in want[col].items():
                np.testing.assert_allclose(mine[col][k], v, rtol=0, atol=1e-9 * top,
                                           err_msg=f"step {step} {col}/{k}")


def test_torch_parallel_mean_of_rank_means_differs(ranks):
    """The uneven ignore pixels make the per-rank mean losses' average
    another number than the global loss the step reports."""
    logits, label = jobs.make_ohem_inputs()
    from iseg_tpu_torch.losses import cross_entropy_ignore_label

    lg, lb = torch.tensor(logits), torch.tensor(label)
    whole = float(cross_entropy_ignore_label(lg, lb))
    halves = [float(cross_entropy_ignore_label(lg[i:i + 2], lb[i:i + 2])) for i in (0, 2)]
    assert abs(np.mean(halves) - whole) > 1e-3 * whole


@pytest.mark.parametrize("case", sorted(jobs.OHEM_CASES))
def test_torch_parallel_ohem_selects_over_global_batch(ranks, case):
    logits, label = jobs.make_ohem_inputs()
    with jax.enable_x64(True):
        seen = {}
        fn = j_get_ohem_fn(**jobs.OHEM_CASES[case])

        def spy(losses, probs, mask):
            seen["kept"] = fn(losses, probs, mask)
            return seen["kept"]

        loss = jce.cross_entropy_ignore_label(jnp.asarray(logits), jnp.asarray(label),
                                              ohem_fn=spy)
        want_kept = np.asarray(seen["kept"])
    got = [r["ohem"][case] for r in ranks]
    kept = np.concatenate([r["kept"] for r in got])
    np.testing.assert_array_equal(kept, want_kept)
    valid = label != 255
    assert 0 < kept[valid].sum() < valid.sum()  # the selector chose
    # each rank returns 2x its share of the global loss: their mean is it
    np.testing.assert_allclose(np.mean([r["loss"] for r in got]), float(loss), rtol=1e-6)


def test_torch_parallel_fsdp_step_equals_dp_step(ranks):
    for r in ranks:
        got = r["fsdp"]
        assert got["sharded"] and len(got["sharded"]) < got["n_params"]
        np.testing.assert_allclose(got["losses"], got["dp_losses"], rtol=1e-12)
        assert got["max_rel"] <= 1e-12  # max |FSDP - DP| over max |param|


def test_torch_parallel_checkpoint_resume_is_exact(ranks):
    for r in ranks:
        got = r["checkpoint"]
        assert got["restored_step"] == 2 and got["steps"] == (3, 3)
        assert got["resume_equal"]  # every param and BN statistic bit for bit
        assert got["full_digest"] == ranks[0]["checkpoint"]["full_digest"]
    stopped = [r["checkpoint"]["stopped_step"] for r in ranks]
    assert stopped[0] == stopped[1] < jobs.STOP_STEPS
    assert stopped[0] in ranks[0]["checkpoint"]["ckpt_steps"]


def test_torch_parallel_coretrain_reads_its_shard_partition(ranks):
    """Each rank trains on its own partition (3 steps of 2), and the result
    is world size 1's on the union of the partitions (3 steps of 4)."""
    got = [r["shards"] for r in ranks]
    assert got[0]["steps"] == got[1]["steps"] == got[0]["steps_one"] == (
        jobs.SHARD_SAMPLES // (2 * jobs.SHARD_BATCH))
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["max_rel"] <= 1e-9 and got[0]["max_rel_stats"] <= 1e-9
