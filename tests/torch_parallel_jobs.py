"""What each rank runs in the two-rank tests (``torch_parallel_helpers.spawn``).

Imports torch and the port only. Inputs are made from numpy seeds by the
``make_*`` functions, which the tests call too, so parent and children
build the same global batches; each rank then takes its slice.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from iseg_tpu_torch.parallel.mesh import axis_rank, shard_batch

# basic blocks: a few MB of weights, so the ranks' results and checkpoints stay small
SMALL_RESNET = dict(depths=(1, 1, 1, 1), use_bottleneck=False, deep_stem=True,
                    slim_stack=True, output_stride=16, multi_grid=(1, 2, 4))
NUM_CLASS, HW, BATCH = 5, 64, 4
STOP_STEPS = 5  # the epoch a SIGTERM on one rank cuts short
SHARD_SAMPLES, SHARD_BATCH = 12, 2  # the shards CoreTrain reads: 3 steps of 2 a rank
OPT = dict(learning_rate=0.05, train_steps=1000, weight_decay=1e-4)
BN_SHAPE = (4, 6, 5, 7)  # NCHW, the global batch


class Float64Torch:
    """``torch`` as a module of the port sees it, with ``float32`` meaning
    float64: the model's fp32 logits cast and the loss's fp32 math keep
    float64 (the tests patch the JAX package's ``jnp`` the same way)."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def keep_float64() -> None:
    from iseg_tpu_torch.core import model
    from iseg_tpu_torch.ops.kernels import upsample_ce

    for module in (model, upsample_ce):
        module.torch = Float64Torch()


def make_bn_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(*BN_SHAPE) * 2.0 + 0.5
    g = rng.randn(*BN_SHAPE)
    scale = 1.0 + 0.1 * rng.randn(BN_SHAPE[1])
    bias = 0.1 * rng.randn(BN_SHAPE[1])
    return x, g, scale, bias


def make_train_batch(steps: int = 2):
    """``steps`` global batches of BATCH images; the first half of each
    batch (rank 0's) has half its pixels ignored, the second half 5%, so a
    mean of the ranks' means is not the global mean."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        image = rng.rand(BATCH, HW, HW, 3)
        label = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
        share = np.where(np.arange(BATCH) < BATCH // 2, 0.5, 0.05)[:, None, None]
        label = np.where(rng.rand(BATCH, HW, HW) < share, 255, label).astype(np.int32)
        out.append({"image": image, "label": label})
    return out


def make_shard_samples():
    """SHARD_SAMPLES (image, label) pairs at HW x HW, uint8, some pixels
    ignored (255)."""
    rng = np.random.RandomState(4)
    out = []
    for _ in range(SHARD_SAMPLES):
        label = rng.randint(0, NUM_CLASS, (HW, HW))
        label = np.where(rng.rand(HW, HW) < rng.choice([0.05, 0.5]), 255, label)
        out.append((rng.randint(0, 256, (HW, HW, 3)).astype(np.uint8), label.astype(np.uint8)))
    return out


def make_ohem_inputs():
    rng = np.random.RandomState(5)
    logits = rng.randn(BATCH, 16, 16, NUM_CLASS) * 2.0
    label = rng.randint(0, NUM_CLASS, (BATCH, 16, 16))
    share = np.where(np.arange(BATCH) < BATCH // 2, 0.4, 0.0)[:, None, None]
    label = np.where(rng.rand(BATCH, 16, 16) < share, 255, label).astype(np.int32)
    return logits, label


OHEM_CASES = {"default": dict(thresh=0.7, min_kept=300, ref_exact=False),
              "default_min_kept_wins": dict(thresh=0.05, min_kept=400, ref_exact=False),
              "ref_exact": dict(thresh=0.7, min_kept=100, ref_exact=True),
              "ref_exact_no_thresh": dict(thresh=None, min_kept=100, ref_exact=True)}


def build_slice_model(variables=None, upsample_logits=False):
    from iseg_tpu_torch.backbones.resnet import ResNet
    from iseg_tpu_torch.convert import load_flax
    from iseg_tpu_torch.core.model import SegManaged
    from iseg_tpu_torch.nn.heads.aspp import ASPP

    bb = ResNet(**SMALL_RESNET)
    model = SegManaged(num_class=NUM_CLASS, backbone=bb,
                       head=ASPP(bb.out_channels, filters=32, dropout_rate=0.0),
                       upsample_logits=upsample_logits,
                       fuse_upsample_loss=not upsample_logits)
    if variables is not None:
        load_flax(model, variables)
    return model


def _np(t):
    return t.detach().cpu().numpy().copy()


@torch.no_grad()
def _state_arrays(state):
    """The model's params and BN statistics in the flax layout, in their
    own dtype (``convert.to_flax`` rounds to float32)."""
    from iseg_tpu_torch.convert import _leaves

    out = {"params": {}, "batch_stats": {}}
    for col, path, tensor, to_flax_fn, _ in _leaves(state.model):
        out[col][path] = to_flax_fn(tensor.detach()).contiguous().numpy().copy()
    return out


def _digest(arrays: dict) -> str:
    """sha256 of a state's arrays, in path order."""
    h = hashlib.sha256()
    for col in sorted(arrays):
        for k in sorted(arrays[col]):
            h.update(np.ascontiguousarray(arrays[col][k]).tobytes())
    return h.hexdigest()


def _max_rel(got: dict, want: dict) -> float:
    top = max(np.abs(v).max() for v in want.values())
    return max(float(np.abs(got[k] - v).max()) for k, v in want.items()) / top


def _train(env, model, steps, batches, mesh, keep_trail=True):
    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core import optimizer as topt
    from iseg_tpu_torch.core.train import create_train_state, make_train_step

    tx, _ = topt.get_optimizer(param_tree(model), "sgd", **OPT)
    state = create_train_state(model, None, tx, initialized=True)
    step = make_train_step(model.build_loss_fn(), mesh=mesh)
    losses, trail = [], []
    for batch in batches[:steps]:
        local = shard_batch(mesh, {"image": torch.tensor(batch["image"]),
                                   "label": torch.tensor(batch["label"])})
        state, parts = step(state, local)
        losses.append(float(parts["loss"]))
        if keep_trail:
            trail.append(_state_arrays(state))
    return state, losses, trail


# ------------------------------------------------------------------ jobs


def job_syncbn(env):
    from iseg_tpu_torch.nn.norm import SyncBatchNorm
    from iseg_tpu_torch.parallel.collectives import data_parallel

    x, g, scale, bias = make_bn_inputs()
    bn = SyncBatchNorm(BN_SHAPE[1]).double()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
    xs, gs = shard_batch(env.mesh, [torch.tensor(x), torch.tensor(g)])
    xs.requires_grad_(True)
    with data_parallel(env.mesh):
        y = bn(xs)
        (y * gs).sum().backward()
    return {"y": _np(y), "dx": _np(xs.grad), "dscale": _np(bn.weight.grad),
            "dbias": _np(bn.bias.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}


def job_train(env, variables):
    """Two DP steps of the narrow ResNet + ASPP with the fused loss (its
    plain version) in float64, every step's params kept."""
    keep_float64()
    model = build_slice_model(variables).double()
    _, losses, trail = _train(env, model, 2, make_train_batch(), env.mesh)
    # rank 0's states for the comparison with JAX; every rank's digests
    return {"losses": losses, "digests": [_digest(t) for t in trail],
            "trail": trail if axis_rank(env.mesh) == 0 else None}


def job_ohem(env):
    from iseg_tpu_torch.losses import cross_entropy_ignore_label, get_ohem_fn
    from iseg_tpu_torch.parallel.collectives import data_parallel

    logits, label = make_ohem_inputs()
    lg, lb = shard_batch(env.mesh, [torch.tensor(logits), torch.tensor(label)])
    out = {}
    for name, case in OHEM_CASES.items():
        fn = get_ohem_fn(**case)
        seen = {}

        def spy(losses, probs, mask, fn=fn, seen=seen):
            seen["kept"] = fn(losses, probs, mask)
            return seen["kept"]

        with data_parallel(env.mesh):
            loss = cross_entropy_ignore_label(lg, lb, ohem_fn=spy)
            mean = float(torch.tensor(float(loss), dtype=torch.float64))
        out[name] = {"kept": _np(seen["kept"]), "loss": mean}
    return out


def job_fsdp(env, variables):
    """The same two float64 steps with the model FSDP-sharded (leaves of
    1024 elements and more sharded, the rest replicated), against the DP
    step; the FSDP params gathered whole."""
    from iseg_tpu_torch.parallel.fsdp import shard_fsdp

    keep_float64()
    batches = make_train_batch()
    dp_state, dp_losses, _ = _train(env, build_slice_model(variables).double(), 2, batches,
                                    env.mesh)
    model = build_slice_model(variables).double()
    shard_fsdp(model, env.mesh, min_size=1024)
    state, losses, _ = _train(env, model, 2, batches, env.mesh, keep_trail=False)
    from torch.distributed.tensor import Shard

    sharded = sorted(k for k, v in state.params.items()
                     if any(isinstance(p, Shard) for p in v.placements))
    full = {k: _np(v.full_tensor()) for k, v in state.params.items()}
    return {"losses": losses, "dp_losses": dp_losses, "sharded": sharded,
            "n_params": len(full), "max_rel": _max_rel(
                full, {k: _np(v) for k, v in dp_state.params.items()})}


def job_checkpoint(env, variables, ckpt_dir):
    """CoreTrain on the group, each rank's dataset yielding its part of the
    global batches: 3 uninterrupted steps; 2 steps with a checkpoint (rank
    0 writes), a fresh trainer on each rank restoring it and stepping to 3;
    and a SIGTERM sent on rank 1 alone, in an epoch of STOP_STEPS, stopping
    both ranks after the same step."""
    import os
    import signal

    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core import optimizer as topt
    from iseg_tpu_torch.core.checkpoint import ModelHelper
    from iseg_tpu_torch.core.train import CoreTrain

    keep_float64()
    batches = make_train_batch(STOP_STEPS)
    rank = axis_rank(env.mesh)

    def dataset_fn(epoch, kill_at=None):
        for i, b in enumerate(batches[epoch:epoch + 1] if kill_at is None else batches):
            if kill_at is not None and i == kill_at and rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield shard_batch(env.mesh, {"image": b["image"], "label": b["label"]})

    def trainer(ckpt=None):
        model = build_slice_model(variables).double()
        tx, _ = topt.get_optimizer(param_tree(model), "sgd", **OPT)
        return CoreTrain(env, model, tx, initialized=True, log_every=0, prefetch_to_device=1,
                         checkpoint_manager=None if ckpt is None else ModelHelper(
                             ckpt, max_to_keep=1))

    full = trainer()
    full.train(dataset_fn, epochs=3, steps_per_epoch=1)
    first = trainer(os.path.join(ckpt_dir, "a"))
    first.train(dataset_fn, epochs=2, steps_per_epoch=1)
    resumed = trainer(os.path.join(ckpt_dir, "a"))
    restored_step = resumed.restore()
    resumed.train(dataset_fn, epochs=3, steps_per_epoch=1, initial_epoch=-1)
    stopped = trainer(os.path.join(ckpt_dir, "b"))
    stopped.train(lambda epoch: dataset_fn(epoch, kill_at=1), epochs=1)
    full_state, resumed_state = _state_arrays(full.state), _state_arrays(resumed.state)
    equal = all(np.array_equal(resumed_state[col][k], v)
                for col in full_state for k, v in full_state[col].items())
    return {"resume_equal": equal, "full_digest": _digest(full_state),
            "restored_step": restored_step, "steps": (full.state.step, resumed.state.step),
            "stopped_step": stopped.state.step,
            "ckpt_steps": ModelHelper(os.path.join(ckpt_dir, "b")).all_steps()}


def job_shards(env, variables, shard_dir):
    """CoreTrain with ``make_shard_dataset_fn``'s defaults (each rank reads
    its partition of the shards) for one epoch, and on rank 0 the same
    epoch at world size 1 (no group) on the union of the two partitions,
    each step's batch rank 0's then rank 1's; float64."""
    import dataclasses

    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core import optimizer as topt
    from iseg_tpu_torch.core.train import CoreTrain
    from iseg_tpu_torch.data.shards import ShardReader, make_shard_dataset_fn, shard_batches

    keep_float64()

    def to_float(b):
        return {"image": b["image"].astype(np.float64) / 255.0,
                "label": b["label"].astype(np.int32)}

    def train(env_, dataset_fn):
        model = build_slice_model(variables).double()
        tx, _ = topt.get_optimizer(param_tree(model), "sgd", **OPT)
        trainer = CoreTrain(env_, model, tx, initialized=True, log_every=0,
                            prefetch_to_device=1, inputs_process=to_float)
        history = trainer.train(dataset_fn, epochs=1)
        return trainer.state, history[0]["steps"]

    state, steps = train(env, make_shard_dataset_fn(shard_dir, SHARD_BATCH))
    arrays = _state_arrays(state)
    out = {"steps": steps, "digest": _digest(arrays)}
    if axis_rank(env.mesh) == 0:
        reader = ShardReader(shard_dir)

        def union(epoch):
            parts = [shard_batches(reader, SHARD_BATCH, seed=0, epoch=epoch, process_index=p,
                                   num_processes=2) for p in (0, 1)]
            for a, b in zip(*parts):
                yield {k: np.concatenate([a[k], b[k]]) for k in a}

        one, out["steps_one"] = train(dataclasses.replace(env, mesh=None), union)
        out["max_rel"] = _max_rel(arrays["params"], _state_arrays(one)["params"])
        out["max_rel_stats"] = _max_rel(arrays["batch_stats"],
                                        _state_arrays(one)["batch_stats"])
    return out


def job_collectives(env):
    """The explicit collectives over the data axis of ``env.mesh``, and the
    identity without a group."""
    from iseg_tpu_torch.parallel import collectives as c

    group = env.mesh.get_group("data")
    r = axis_rank(env.mesh)
    x = torch.arange(6, dtype=torch.float64).reshape(3, 2) + 10 * r
    out = {"sum": _np(c.all_reduce_values(x, group=group)),
           "mean": _np(c.all_reduce_values(x, "mean", group=group)),
           "gather": _np(c.all_gather(x, group=group)),
           "scatter": _np(c.reduce_scatter(torch.cat([x, x + 1]), group=group)),
           "global_batch": c.global_batch_size(8, group=group),
           "any": tuple(vote.result() for vote in (c.AnyRankVote(r == 1, group=group),
                                                   c.AnyRankVote(False, group=group))),
           "rows": c.global_rows(3, group=group),
           "staged": dict(c.HOST_STAGED)}
    c.barrier(group=group)
    with c.data_parallel(None):  # no group: one rank
        out["alone"] = (c.world_size(), c.rank(), c.global_batch_size(8),
                        _np(c.all_reduce_values(x)), _np(c.all_gather(x)))
    return out


def job_suite(env, variables, ckpt_dir, shard_dir):
    """Every job of ``tests/test_torch_parallel.py``, in one spawn."""
    return {"collectives": job_collectives(env), "syncbn": job_syncbn(env), "ohem": job_ohem(env),
            "train": job_train(env, variables), "fsdp": job_fsdp(env, variables),
            "checkpoint": job_checkpoint(env, variables, ckpt_dir),
            "shards": job_shards(env, variables, shard_dir)}


# ------------------------------------------------------------------ data, eval

EVAL_CLASSES, EVAL_HW, EVAL_BATCH = 4, 32, 8
EVAL_CONFIG = dict(scale_rates=(0.75, 1.0), flip=True, sliding_window_crop_size=(24, 24))
WINDOW_IMAGE = (1, 80, 112)  # one image for the sharded sliding window, (N, H, W)


def make_resident_arrays(n: int = 13, hw: int = 24):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    labels = rng.randint(0, NUM_CLASS, (n, hw, hw)).astype(np.uint8)
    return images, labels


def make_eval_batches(n_batches: int = 2, uneven: bool = False):
    """Eval batches, 10% of the pixels ignored; with ``uneven`` the first
    half of each batch (rank 0's) has 60% ignored and classes 0 and 1, the
    second half classes 2 and 3, so the halves' losses differ and a mean of
    the ranks' mean losses is not the global loss."""
    rng = np.random.RandomState(1 if uneven else 0)
    share = np.full((EVAL_BATCH, 1, 1), 0.1)
    if uneven:
        share[:EVAL_BATCH // 2] = 0.6
    out = []
    for _ in range(n_batches):
        if uneven:
            label = rng.randint(0, 2, (EVAL_BATCH, EVAL_HW, EVAL_HW)) + 2 * (
                np.arange(EVAL_BATCH) >= EVAL_BATCH // 2)[:, None, None]
        else:
            label = rng.randint(0, EVAL_CLASSES, (EVAL_BATCH, EVAL_HW, EVAL_HW))
        label = np.where(rng.rand(EVAL_BATCH, EVAL_HW, EVAL_HW) < share, 255, label)
        out.append({"image": rng.rand(EVAL_BATCH, EVAL_HW, EVAL_HW, 3).astype(np.float32),
                    "label": label.astype(np.int32)})
    return out


def make_window_image():
    return np.random.RandomState(7).rand(*WINDOW_IMAGE, 3).astype(np.float32)


def build_eval_model(variables):
    from iseg_tpu_torch.backbones.resnet import ResNet
    from iseg_tpu_torch.convert import load_flax
    from iseg_tpu_torch.core.model import SegManaged
    from iseg_tpu_torch.nn.heads.aspp import ASPP

    bb = ResNet(**SMALL_RESNET)
    model = SegManaged(num_class=EVAL_CLASSES, backbone=bb,
                       head=ASPP(bb.out_channels, filters=16, dropout_rate=0.0))
    load_flax(model, variables)
    return model.eval()


def _resident_step_loss(env, mesh, ds, augment, variables):
    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core import optimizer as topt
    from iseg_tpu_torch.core.train import create_train_state, make_resident_train_step

    model = build_slice_model(variables)
    tx, _ = topt.get_optimizer(param_tree(model), "sgd", **OPT)
    state = create_train_state(model, None, tx, initialized=True)
    step = make_resident_train_step(model.build_loss_fn(), ds.images, ds.labels,
                                    augment_fn=augment, seed=3, mesh=mesh,
                                    row_start=ds.row_start)
    # the global batch's rows (both datasets hold them: the sharded one
    # truncates 13 samples to 12)
    _, parts = step(state, np.array([3, 7, 0, 11]))
    return float(parts["loss"])


def job_data(env, variables, eval_variables, loss_variables, log_dir):
    """The mesh-sharded resident dataset (its partition, the gather of a
    global batch, one resident DP step with and without the device augment,
    and the same step at world size 1 in this process), sharded evaluate
    (with its loss logged under ``log_dir/rank<r>``) and the sharded sliding
    window."""
    import os

    from iseg_tpu_torch.core.evaluation import evaluate, make_eval_step
    from iseg_tpu_torch.core.inference import inference_with_sliding_window_sharded
    from iseg_tpu_torch.core.model import SegModelInferenceConfig
    from iseg_tpu_torch.data.device_augment import DeviceAugmentConfig, make_device_augment
    from iseg_tpu_torch.data.resident import DeviceResidentDataset
    from iseg_tpu_torch.metrics import MeanIoU

    images, labels = make_resident_arrays()
    ds = DeviceResidentDataset((images, labels), device="cpu", mesh=env.mesh)
    idx = np.array([12, 0, 5, 7, 1, 11, 6, 3])
    g_image, g_label = ds.gather(idx)
    augment = make_device_augment(DeviceAugmentConfig(crop_size=(16, 16), min_scale_factor=0.75,
                                                      max_scale_factor=1.25, scale_step_size=0.25))
    single = DeviceResidentDataset((images, labels), device="cpu", process_index=0,
                                   num_processes=1)
    out = {"row_start": ds.row_start, "num_samples": ds.num_samples,
           "local_rows": len(ds.images), "local_images": _np(ds.images),
           "gather_image": _np(g_image), "gather_label": _np(g_label),
           "losses": {}}
    for name, aug in (("plain", None), ("augment", augment)):
        out["losses"][name] = (_resident_step_loss(env, env.mesh, ds, aug, variables),
                               _resident_step_loss(env, None, single, aug, variables))

    model = build_eval_model(eval_variables)
    config = SegModelInferenceConfig(**EVAL_CONFIG)
    metric = MeanIoU(EVAL_CLASSES, 255)
    batches = make_eval_batches()
    evaluate(env, model, None, batches, inference_config=config, verbose=False, metric=metric)
    out["cm"] = metric.total_cm
    mine = os.path.join(log_dir, f"rank{axis_rank(env.mesh)}")
    evaluate(env, build_eval_model(loss_variables), None, make_eval_batches(uneven=True),
             inference_config=config, verbose=False, compute_loss=True, log_dir=mine)
    out["log"] = open(os.path.join(mine, "scalars.csv")).read() if os.path.exists(mine) else None
    step = make_eval_step(model, config)
    out["logits"] = [_np(step(torch.tensor(shard_batch(env.mesh, b)["image"])))
                     for b in batches]
    try:
        evaluate(env, model, None, [{k: v[:3] for k, v in batches[0].items()}],
                 inference_config=config, verbose=False)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    with torch.inference_mode():
        image = torch.tensor(make_window_image())
        out["window"] = _np(inference_with_sliding_window_sharded(
            model, image, (48, 48), env.mesh, stride_rate=2.0 / 3.0))
    return out
