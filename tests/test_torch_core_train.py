"""The port's ``CoreTrain`` against ``iseg_tpu.core.train.CoreTrain``.

* a reduced ResNet + ASPP (dropout 0, the fused loss, low-res logits),
  weights carried by ``convert.py``, trained by both loops for 2 epochs x 2
  steps in float64 on both sides (batch 8, 32^2; the JAX loop shards the
  batch over the 8-device CPU mesh): params and BN statistics within 1e-6,
  per-epoch losses within 1e-6 (relative), the same history keys, the
  same callback order and the same scalar tags in the event file;
* inside the port: exact-step resume after a mid-epoch preemption (in
  this process and, by SIGTERM, in a child process), the resident step
  equal to the separate gather + augment + step, the profiler window, and
  what is not ported raising. With dropout on: the masks are drawn from
  ``(seed, step)``, so a resumed run equals the uninterrupted one bit for
  bit on the CPU.
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iseg_tpu.backbones.resnet import ResNet as JResNet
from iseg_tpu.core import callbacks as jcb
from iseg_tpu.core import optimizer as jopt
from iseg_tpu.core.env import EnvConfig as JEnvConfig
from iseg_tpu.core.env import common_env_setup as j_common_env_setup
from iseg_tpu.core.model import SegManaged as JSegManaged
from iseg_tpu.core.train import CoreTrain as JCoreTrain
from iseg_tpu.nn.heads.aspp import ASPP as JASPP
from iseg_tpu.utils.summary import read_event_scalars
from iseg_tpu_torch.backbones.resnet import ResNet as TResNet
from iseg_tpu_torch.convert import flatten, load_flax, param_tree, to_flax
from iseg_tpu_torch.core import callbacks as tcb
from iseg_tpu_torch.core import optimizer as topt
from iseg_tpu_torch.core.checkpoint import ModelHelper
from iseg_tpu_torch.core.env import common_env_setup
from iseg_tpu_torch.core.model import SegManaged as TSegManaged
from iseg_tpu_torch.core.train import CoreTrain
from iseg_tpu_torch.data.device_augment import DeviceAugmentConfig, make_device_augment
from iseg_tpu_torch.data.resident import DeviceResidentDataset
from iseg_tpu_torch.nn.heads.aspp import ASPP as TASPP

torch.set_num_threads(1)

SMALL_RESNET = dict(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True,
                    slim_stack=True, output_stride=16, multi_grid=(1, 2, 4))
NUM_CLASS, CROP, BATCH, EPOCHS, SPE = 5, 32, 8, 2, 2
OPT = dict(learning_rate=0.02, train_steps=100, weight_decay=1e-4, warmup_steps=1)


def _batches(epoch, n=3, dtype=np.float64, hw=CROP):
    """Three batches an epoch (the loops stop at SPE), seeded by epoch."""
    rng = np.random.RandomState(100 + epoch)
    for _ in range(n):
        label = rng.randint(0, NUM_CLASS, (BATCH, hw, hw))
        label = np.where(rng.rand(BATCH, hw, hw) < 0.1, 255, label).astype(np.int32)
        yield {"image": rng.rand(BATCH, hw, hw, 3).astype(dtype), "label": label}


def _port_model(dropout=0.0):
    bb = TResNet(**SMALL_RESNET)
    return TSegManaged(num_class=NUM_CLASS, backbone=bb,
                       head=TASPP(bb.out_channels, filters=16, dropout_rate=dropout),
                       upsample_logits=False, fuse_upsample_loss=True)


class _Recorder:
    def __init__(self, cb_module):
        self.events = []
        rec = self.events

        class Rec(cb_module.Callback):
            def on_epoch_begin(self, epoch, state):
                rec.append(("begin", epoch, int(state.step)))

            def on_epoch_end(self, epoch, state, logs=None):
                rec.append(("end", epoch, int(state.step), sorted(logs)))

            def on_train_end(self, state):
                rec.append(("train_end", int(state.step)))

        self.callbacks = [Rec(), cb_module.LambdaCallback(
            on_epoch_end=lambda e, s, logs: rec.append(("lambda_end", e)),
            on_train_end=lambda s: rec.append(("lambda_train_end",)))]


def _event_rows(log_dir):
    (name,) = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
    return read_event_scalars(os.path.join(log_dir, name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both loops over the same batches from the same weights, in float64."""
    tmp = tmp_path_factory.mktemp("core_train")
    jm = JSegManaged(num_class=NUM_CLASS, backbone=JResNet(**SMALL_RESNET),
                     head=JASPP(filters=16, dropout_rate=0.0), upsample_logits=False,
                     fuse_upsample_loss=True)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)), train=False))

    tm = _port_model()
    load_flax(tm, variables)
    tm.double()
    t_tx, t_sched = topt.get_optimizer(param_tree(tm), "sgd", **OPT)
    t_rec = _Recorder(tcb)
    env = common_env_setup(device="cpu", mixed_precision=False)
    trainer = CoreTrain(env, tm, t_tx, initialized=True, log_every=1,
                        log_dir=str(tmp / "t_log"), lr_schedule=t_sched,
                        callbacks=t_rec.callbacks)
    t_hist = trainer.train(_batches, epochs=EPOCHS, steps_per_epoch=SPE)
    t_trees = {col: flatten(tree) for col, tree in to_flax(tm).items()}

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        j_tx, j_sched = jopt.get_optimizer(v64["params"], "sgd", **OPT)
        j_rec = _Recorder(jcb)
        j_env = j_common_env_setup(JEnvConfig(random_seed=0, mixed_precision=False))
        j_trainer = JCoreTrain(j_env, jm, j_tx, input_shape=(1, CROP, CROP, 3), variables=v64,
                               log_every=1, log_dir=str(tmp / "j_log"), lr_schedule=j_sched,
                               callbacks=j_rec.callbacks)
        j_hist = j_trainer.train(_batches, epochs=EPOCHS, steps_per_epoch=SPE)
        j_trees = {"params": flatten(jax.tree_util.tree_map(np.asarray,
                                                            j_trainer.state.params)),
                   "batch_stats": flatten(jax.tree_util.tree_map(
                       np.asarray, j_trainer.state.batch_stats))}
        j_step = int(j_trainer.state.step)
    return dict(t_hist=t_hist, j_hist=j_hist, t_trees=t_trees, j_trees=j_trees,
                t_step=trainer.state.step, j_step=j_step, t_events=t_rec.events,
                j_events=j_rec.events, t_rows=_event_rows(tmp / "t_log"),
                j_rows=_event_rows(tmp / "j_log"))


def test_torch_core_train_params_match_jax(runs):
    assert runs["t_step"] == runs["j_step"] == EPOCHS * SPE
    for col, theirs in runs["j_trees"].items():
        mine = runs["t_trees"][col]
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            # to_flax returns float32: compare at float32 resolution and 1e-6
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{col}/{k}")


def test_torch_core_train_history_matches_jax(runs):
    t_hist, j_hist = runs["t_hist"], runs["j_hist"]
    assert len(t_hist) == len(j_hist) == EPOCHS
    for a, b in zip(t_hist, j_hist):
        assert sorted(a) == sorted(b)
        assert (a["epoch"], a["steps"]) == (b["epoch"], b["steps"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)


def test_torch_core_train_callback_order_matches_jax(runs):
    assert runs["t_events"] == runs["j_events"]
    assert runs["t_events"][0] == ("begin", 0, 0)
    assert runs["t_events"][-2:] == [("train_end", 4), ("lambda_train_end",)]


def test_torch_core_train_scalar_log_matches_jax(runs):
    t_rows, j_rows = runs["t_rows"], runs["j_rows"]
    assert [(s, t) for s, t, _ in t_rows] == [(s, t) for s, t, _ in j_rows]
    for (_, tag, a), (_, _, b) in zip(t_rows, j_rows):
        if tag in ("train/loss", "train/output_0_loss", "train/learning_rate", "epoch/loss"):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=tag)


# ------------------------------------------------------------ port behaviour

AUGMENT = DeviceAugmentConfig(crop_size=(CROP, CROP), random_brightness=True)


def _trainer(ckpt=None, resident=None, augment=True, **kw):
    """A float32 port trainer with dropout and the device augment on."""
    model = _port_model(dropout=0.3)
    tx, sched = topt.get_optimizer(param_tree(model), "sgd", **OPT)
    env = common_env_setup(device="cpu", mixed_precision=False)
    return CoreTrain(env, model, tx, seed=3, log_every=0,
                     checkpoint_manager=ModelHelper(ckpt) if ckpt else None,
                     device_augment=make_device_augment(AUGMENT) if augment else None,
                     resident_dataset=resident, **kw)


def _u8_batches(epoch):
    rng = np.random.RandomState(epoch)
    for _ in range(3):
        yield {"image": rng.randint(0, 256, (4, 40, 36, 3)).astype(np.uint8),
               "label": rng.randint(0, NUM_CLASS, (4, 40, 36)).astype(np.uint8)}


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_torch_core_train_resumes_mid_epoch_exactly(tmp_path):
    full = _trainer()
    full.train(_u8_batches, epochs=2, steps_per_epoch=3)

    def preempting(epoch):
        # the loop keeps two batches in flight: batch 2 of epoch 1 is drawn
        # once step 4 has run, and the loop stops after step 5
        for i, batch in enumerate(_u8_batches(epoch)):
            if (epoch, i) == (1, 2):
                os.kill(os.getpid(), signal.SIGTERM)  # handled by the loop
            yield batch

    first = _trainer(str(tmp_path))
    first.train(preempting, epochs=2, steps_per_epoch=3)
    assert first.state.step == 5 and first.checkpoint_manager.all_steps() == [3, 5]
    resumed = _trainer(str(tmp_path))
    assert resumed.restore() == 5
    history = resumed.train(_u8_batches, epochs=2, steps_per_epoch=3, initial_epoch=-1)
    assert [(h["epoch"], h["steps"]) for h in history] == [(1, 3)]
    assert resumed.state.step == 6
    _assert_same(_params(resumed), _params(full))
    for a, b in zip(resumed.state.opt_state.trace, full.state.opt_state.trace):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        resumed.train(_u8_batches, epochs=3, initial_epoch=-1)


def test_torch_core_train_restores_the_previous_sigterm_handler():
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda *a: seen.append("mine"))
    try:
        _trainer().train(_u8_batches, epochs=1, steps_per_epoch=1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == ["mine"]
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_torch_resident_step_matches_separate_gather_augment_step():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (12, 40, 36, 3)).astype(np.uint8)
    labels = rng.randint(0, NUM_CLASS, (12, 40, 36)).astype(np.uint8)
    ds = DeviceResidentDataset((images, labels), device="cpu")
    fused = _trainer(resident=ds)
    fused.train(ds.index_dataset_fn(4, seed=1), epochs=2, steps_per_epoch=3)
    separate = _trainer()
    separate.train(ds.dataset_fn(4, seed=1), epochs=2, steps_per_epoch=3)
    assert fused.state.step == separate.state.step == 6
    _assert_same(_params(fused), _params(separate))
    # without augment both hand the model raw 0-255 floats
    plain = [_trainer(resident=ds, augment=False), _trainer(augment=False)]
    plain[0].train(ds.index_dataset_fn(4), epochs=1, steps_per_epoch=2)
    plain[1].train(ds.dataset_fn(4), epochs=1, steps_per_epoch=2)
    _assert_same(_params(plain[0]), _params(plain[1]))


def test_torch_core_train_profiler_window(tmp_path):
    trainer = _trainer(use_profiler=True, profiler_dir=str(tmp_path), profile_steps=2)
    trainer.train(_u8_batches, epochs=1, steps_per_epoch=3)
    assert len([f for f in os.listdir(tmp_path) if f.startswith("trace.")]) == 1


def test_torch_core_train_refuses_what_is_not_ported():
    # grad_accum_every is ported (tests/test_torch_grad_accum.py)
    assert _trainer(grad_accum_every=2).grad_accum_every == 2
    with pytest.raises(ValueError, match="profiler_dir"):
        _trainer(use_profiler=True)


_CHILD = textwrap.dedent(
    """
    import sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from iseg_tpu_torch.backbones.resnet import ResNet
    from iseg_tpu_torch.convert import param_tree
    from iseg_tpu_torch.core.checkpoint import ModelHelper
    from iseg_tpu_torch.core.env import common_env_setup
    from iseg_tpu_torch.core.model import SegManaged
    from iseg_tpu_torch.core.optimizer import get_optimizer
    from iseg_tpu_torch.core.train import CoreTrain
    from iseg_tpu_torch.data.device_augment import DeviceAugmentConfig, make_device_augment
    from iseg_tpu_torch.nn.heads.aspp import ASPP

    ckpt, mode, out = sys.argv[1], sys.argv[2], sys.argv[3]
    bb = ResNet(depths=(1, 1, 1, 1), use_bottleneck=True, deep_stem=True, slim_stack=True,
                output_stride=16, multi_grid=(1, 2, 4))
    model = SegManaged(num_class=5, backbone=bb,
                       head=ASPP(bb.out_channels, filters=16, dropout_rate=0.3),
                       upsample_logits=False, fuse_upsample_loss=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.02, train_steps=100,
                          warmup_steps=1)
    trainer = CoreTrain(common_env_setup(device="cpu", mixed_precision=False), model, tx,
                        seed=3, log_every=1, checkpoint_manager=ModelHelper(ckpt),
                        device_augment=make_device_augment(DeviceAugmentConfig(crop_size=(32, 32))))
    start = trainer.restore()
    print(f"START step={start}", flush=True)

    def data(epoch):
        rng = np.random.RandomState(epoch)
        for i in range(3):
            if mode == "fresh" and (epoch, i) == (1, 2):
                # drawn after step 4 (two batches in flight): hold it until
                # the parent's SIGTERM has arrived; the loop stops after step 5
                deadline = time.time() + 120
                while not trainer._preempt_requested and time.time() < deadline:
                    time.sleep(0.01)
            yield {"image": rng.randint(0, 256, (4, 40, 36, 3)).astype(np.uint8),
                   "label": rng.randint(0, 5, (4, 40, 36)).astype(np.uint8)}

    trainer.train(data, epochs=3, steps_per_epoch=3, initial_epoch=-1)
    print(f"FINAL step={trainer.state.step}", flush=True)
    torch.save({k: v.detach() for k, v in trainer.state.params.items()}, out)
    """
)


def test_torch_core_train_sigterm_in_child_resumes_at_exact_step(tmp_path):
    """A child trains the port alone (dropout and the device augment on);
    the parent sends SIGTERM once step 4 is logged."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo_root)

    def run(ckpt, mode, out):
        return [sys.executable, str(script), str(tmp_path / ckpt), mode, str(tmp_path / out)]

    p = subprocess.Popen(run("ckpt", "fresh", "fresh.pt"), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env, cwd=repo_root)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.startswith("epoch 1 step 1:"):
                p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
    out = "".join(lines)
    assert rc == 0, out[-3000:]
    assert "preempted: checkpoint durable at step=5" in out, out[-3000:]
    assert "FINAL step=5" in out
    resumed = subprocess.run(run("ckpt", "resume", "resumed.pt"), capture_output=True,
                             text=True, env=env, cwd=repo_root, timeout=300)
    assert resumed.returncode == 0, resumed.stdout[-3000:] + resumed.stderr[-3000:]
    assert "START step=5" in resumed.stdout and "FINAL step=9" in resumed.stdout
    full = subprocess.run(run("ckpt_full", "full", "full.pt"), capture_output=True, text=True,
                          env=env, cwd=repo_root, timeout=300)
    assert full.returncode == 0, full.stdout[-3000:] + full.stderr[-3000:]
    _assert_same(torch.load(tmp_path / "resumed.pt"), torch.load(tmp_path / "full.pt"))


def test_torch_train_from_shards_example_modes_agree(tmp_path, monkeypatch):
    """``python -m iseg_tpu_torch.examples.train_from_shards`` on the CPU:
    ``--prepare`` writes shards; the resident and stream modes then train
    on the same batches with the same augment draws, so their losses agree."""
    from iseg_tpu_torch.examples import train_from_shards as example
    from iseg_tpu_torch.nn import norm

    monkeypatch.setattr(norm, "_BN_MOMENTUM_OVERRIDE", None)  # the example sets it
    shards = str(tmp_path / "shards")
    assert example.main(["--prepare", "--shard_dir", shards, "--store_size", "40"]) is None
    assert os.path.exists(os.path.join(shards, "index.json"))
    args = ["--shard_dir", shards, "--device", "cpu", "--backbone", "resnet18", "--crop", "32",
            "--batch", "4", "--epochs", "2", "--steps_per_epoch", "2"]
    resident = example.main(args + ["--mode", "resident", "--log_dir", str(tmp_path / "log")])
    stream = example.main(args + ["--mode", "stream"])
    assert [h["loss"] for h in resident] == [h["loss"] for h in stream]
    assert all(np.isfinite(h["loss"]) for h in resident)
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "log"))
    with pytest.raises(ValueError, match="not ported"):
        example.build_model("resnet18", "simple_decoder", 4, "cpu")
