"""Training loop (counterpart of ``iseg_tpu/core/train.py``):
``TrainState``, ``create_train_state``, ``make_train_step``,
``make_resident_train_step`` and the host loop ``CoreTrain`` (checkpoints,
SIGTERM, exact-step resume, callbacks, scalar logs, a profiler window).

PyTorch runs eagerly, so there is no jit: a step is one forward (under
bf16 autocast when the compute dtype is bf16), one backward, the optimizer
update applied in place, and the BN running-stat update, which the
forward makes in training mode.

Data parallelism (``mesh=``, one process a card over a process group)
follows the JAX package's one GSPMD program over the global batch: each
rank steps its slice of it, SyncBN and the losses take their moments and
denominators over the global batch (``parallel.collectives``), and the
gradients are averaged over the ranks by flat all-reduces of fixed buckets
in the parameters' order, so every rank applies the same update and holds
the same parameters bit for bit. FSDP (``parallel.fsdp.shard_fsdp``) is
the same step: FSDP2 reduces the sharded parameters' gradients and the
step averages the replicated ones (the state holds those as replicated
``DTensor`` views, ``fsdp.replicated_view``). Without a mesh nothing of
this runs.

Randomness is a function of the step, as in the JAX package's
``fold_in(rng, state.step)``: with a ``seed``, the step re-seeds the
model's dropout generator from ``(seed, dropout stream, step)`` and the
augment's from ``(seed, augment stream, step)`` before it draws, so step
``k`` draws the same masks and augment whether or not the run was
interrupted and resumed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from iseg_tpu_torch.convert import batch_stats_tree, param_tree
from iseg_tpu_torch.data.loader import device_prefetch, to_device
from iseg_tpu_torch.data.resident import sharded_gather
from iseg_tpu_torch.nn.blocks import set_dropout_generator
from iseg_tpu_torch.nn.initializers import initialize
from iseg_tpu_torch.parallel import collectives
from iseg_tpu_torch.parallel.fsdp import fsdp_mesh, is_dtensor, replicated_view
from iseg_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_rank, shard_batch
from iseg_tpu_torch.utils.profiling import StepTimer, profile_trace

# RNG stream tags: a step's generators are seeded from (seed, stream, step),
# so the dropout masks and the augment never share a stream
DROPOUT_STREAM = 0x0D0
AUGMENT_STREAM = 0x0AB6

# "no handler was installed" marker for SIGTERM save/restore — distinct
# from None, which signal.signal() returns for non-Python handlers
_UNSET_HANDLER = object()


def stream_seed(seed: int, stream: int, step: int) -> int:
    """63-bit generator seed of ``(seed, stream, step)`` (numpy's
    ``SeedSequence``: well mixed, the same on every host)."""
    state = np.random.SeedSequence((seed, stream, step)).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


@dataclasses.dataclass
class TrainState:
    """The model (which holds params and BN batch_stats), the optimizer and
    its state, and an optional EMA of the params.

    ``params`` and ``batch_stats`` are flax-path-keyed views of the
    module's own tensors; updates are applied to them in place.
    """

    step: int
    model: nn.Module
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    tx: Any  # an optimizer of core/optimizer.py (init / update)
    opt_state: Any
    ema_params: Optional[dict[str, torch.Tensor]] = None
    ema_decay: Optional[float] = None

    @torch.no_grad()
    def apply_gradients(self, grads: dict[str, torch.Tensor]) -> "TrainState":
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        torch._foreach_add_(list(self.params.values()), list(updates.values()))
        # under gradient accumulation (with_grad_accum) only every k-th
        # micro-step applies a real update, and the EMA decays only then
        # (decay^k per update would shrink its horizon k times): the
        # accumulator's mini_step is back at 0 exactly when it applied one
        if self.ema_params is not None and getattr(self.opt_state, "mini_step", 0) == 0:
            d = self.ema_decay
            for e, p in zip(self.ema_params.values(), self.params.values()):
                e.copy_(e * d + (1.0 - d) * p.to(e.dtype))
        self.step += 1
        return self

    def eval_variables(self) -> dict:
        """Path-keyed variables for evaluation: EMA params when tracked,
        else the raw params, plus the BN running stats."""
        params = self.ema_params if self.ema_params is not None else self.params
        return {"params": params, "batch_stats": self.batch_stats}


def create_train_state(
    model: nn.Module,
    generator: Optional[torch.Generator],
    tx,
    ema_decay: Optional[float] = None,
    initialized: bool = False,
) -> TrainState:
    """Initialize ``model`` from ``generator`` (flax's default init; pass
    ``initialized=True`` for weights already loaded, e.g. with
    :func:`iseg_tpu_torch.convert.load_flax`) and wrap it with ``tx``.

    Dropout draws from a generator on the model's device, seeded from
    ``generator`` (torch's default generator when it is None).
    ``ema_decay`` (e.g. 0.999) tracks an EMA of the params, started at
    their initial values.
    """
    if not initialized:
        if generator is None:
            raise ValueError("create_train_state needs a generator to initialize the model")
        initialize(model, generator)
    params = param_tree(model)
    mesh = fsdp_mesh(model)
    if mesh is not None:  # FSDP: the replicated leaves as DTensor views too
        params = {k: v if is_dtensor(v) else replicated_view(v, mesh) for k, v in params.items()}
    device = next(iter(params.values())).device
    if generator is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        set_dropout_generator(model, torch.Generator(device=device).manual_seed(seed))
    return TrainState(
        step=0,
        model=model,
        params=params,
        batch_stats=batch_stats_tree(model),
        tx=tx,
        opt_state=tx.init(params),
        ema_params=({k: v.detach().clone() for k, v in params.items()}
                    if ema_decay is not None else None),
        ema_decay=ema_decay,
    )


# bytes of one gradient all-reduce: few collectives, and a bounded extra copy
GRAD_BUCKET_BYTES = 32 << 20


def average_gradients(grads: list, group, bucket_bytes: int = GRAD_BUCKET_BYTES) -> list:
    """The ranks' mean of each gradient, as new tensors: consecutive
    gradients of one dtype and device are flattened into buckets of about
    ``bucket_bytes``, in list order, each summed by one all-reduce and
    divided by the rank count. The order and the buckets are the same on
    every rank, and an all-reduce leaves one result on all of them."""
    d = collectives.world_size(group)
    out = list(grads)
    i = 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and (j == i or (
                grads[j].dtype == grads[i].dtype and grads[j].device == grads[i].device
                and size + grads[j].numel() * grads[j].element_size() <= bucket_bytes)):
            size += grads[j].numel() * grads[j].element_size()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        collectives.all_reduce_(flat, group)
        flat.div_(d)
        offset = 0
        for k in range(i, j):
            n = grads[k].numel()
            out[k] = flat[offset:offset + n].view(grads[k].shape)
            offset += n
        i = j
    return out


def _backward_gradients(loss: torch.Tensor, params: list) -> list:
    """``d loss / d params`` from ``.grad`` after a ``backward()``: an FSDP
    model's gradients come through FSDP2's hooks, which only ``backward()``
    runs."""
    for p in params:
        p.grad = None
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for p in params:
        p.grad = None
    return grads


def make_train_step(loss_fn: Callable, compute_dtype: torch.dtype = torch.float32,
                    seed: Optional[int] = None, mesh=None) -> Callable:
    """Build ``train_step(state, batch) -> (state, parts)``.

    ``loss_fn(outputs, labels) -> (total, parts)`` is typically
    ``model.build_loss_fn()``; ``compute_dtype`` is the env's (bf16 runs
    the forward under autocast). ``batch`` holds ``image`` [N, H, W, 3]
    float and ``label`` [N, H, W] int. With ``seed``, every step first
    re-seeds the model's dropout generator (one generator on the batch's
    device, set on the model at the first step) from ``(seed,
    DROPOUT_STREAM, state.step)``; without, dropout draws from the
    generators the model holds.

    With ``mesh`` (a ``DeviceMesh``, ``env.mesh``) ``batch`` is this rank's
    part of the global batch and the step is data parallel over the mesh's
    data axis (see the module note); ``parts`` are then the global batch's
    (the ranks' mean). An FSDP-sharded model needs the mesh.
    """
    dropout = None
    group = axis_group(mesh, DATA_AXIS)

    def train_step(state: TrainState, batch: dict):
        nonlocal dropout
        model = state.model
        model.train()
        image = batch["image"]
        if seed is not None:
            if dropout is None:
                dropout = torch.Generator(device=image.device)
                set_dropout_generator(model, dropout)
            dropout.manual_seed(stream_seed(seed, DROPOUT_STREAM, state.step))
        params = list(state.params.values())
        sharded_over = fsdp_mesh(model)
        if sharded_over is not None:
            if mesh is None:
                raise ValueError("an FSDP-sharded model trains with make_train_step(..., mesh=)")
            # the sharded parameters, as registered between steps (during the
            # forward and backward FSDP2 registers the gathered ones)
            live = list(param_tree(model).values())
        with collectives.data_parallel(mesh):
            with torch.autocast(image.device.type, dtype=compute_dtype,
                                enabled=compute_dtype != torch.float32):
                outputs = model(image)
            loss, parts = loss_fn(outputs, batch["label"])
            if sharded_over is None:
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            else:
                grads = _backward_gradients(loss, live)
        parts = {k: v.detach() for k, v in parts.items()}
        if mesh is not None:
            # FSDP2 averaged the sharded leaves' gradients; the rest here
            plain = [k for k, g in enumerate(grads) if not is_dtensor(g)]
            for k, g in zip(plain, average_gradients([grads[k] for k in plain], group)):
                grads[k] = g if sharded_over is None else replicated_view(g, sharded_over)
            names = sorted(parts)
            mean = collectives.all_reduce_values(
                torch.stack([parts[k].to(torch.float64) for k in names]), "mean", group)
            parts = {k: mean[i].to(parts[k].dtype) for i, k in enumerate(names)}
        state.apply_gradients(dict(zip(state.params, grads)))
        return state, parts

    return train_step


def model_inputs(image: torch.Tensor, label: torch.Tensor, augment_fn: Optional[Callable],
                 generator: Optional[torch.Generator], seed: int, step: int):
    """(image, label) of a step: the augment, its generator seeded from
    ``(seed, AUGMENT_STREAM, step)``; without one, raw 0-255 floats (the
    uint8 storage of shards is a format detail, not an input contract;
    normalization belongs to the augment). Labels become int32, the fused
    loss kernel's type."""
    if augment_fn is not None:
        generator.manual_seed(stream_seed(seed, AUGMENT_STREAM, step))
        image, label = augment_fn(generator, image, label)
    elif not image.is_floating_point():
        image = image.to(torch.float32)
    return image, label.to(torch.int32)


def make_resident_train_step(loss_fn: Callable, images: torch.Tensor, labels: torch.Tensor,
                             augment_fn: Optional[Callable] = None,
                             compute_dtype: torch.dtype = torch.float32,
                             seed: int = 0, mesh=None, row_start: Optional[int] = None
                             ) -> Callable:
    """``step(state, idx) -> (state, parts)`` for device-resident data
    (``iseg_tpu_torch.data.resident.DeviceResidentDataset``): one gather of
    the ``[batch]`` indices from the resident ``images``/``labels``, then
    ``augment_fn(generator, images_u8, labels) -> (image, label)`` (e.g.
    ``make_device_augment(cfg)``), then the train step, all on the
    resident tensors' device. The host ships only the index vector.

    The augment's generator and the dropout are seeded from ``seed`` and
    ``state.step`` as ``CoreTrain``'s separate gather + augment + step
    seeds them, so the two paths compute the same step.

    With ``mesh`` the step is data parallel (:func:`make_train_step`). With
    ``row_start`` too, ``images``/``labels`` are this rank's partition of a
    sample-sharded dataset (``DeviceResidentDataset(mesh=)``), holding the
    global rows from ``row_start`` on, and ``idx`` is the GLOBAL batch's
    index vector: each rank gathers the rows it holds (the others zero), one
    all-reduce of the uint8 batch assembles it on every rank, and each rank
    steps its slice (``shard_batch``). Without ``row_start`` each rank's
    ``idx`` indexes its own data and gives its own slice of the batch."""
    body = make_train_step(loss_fn, compute_dtype, seed=seed, mesh=mesh)
    generator = torch.Generator(device=images.device) if augment_fn is not None else None

    def step(state: TrainState, idx):
        idx = to_device(np.asarray(idx, np.int64), images.device)
        with collectives.data_parallel(mesh):
            if row_start is None:
                image, label = images.index_select(0, idx), labels.index_select(0, idx)
            else:
                image, label = shard_batch(mesh, list(sharded_gather(
                    images, labels, idx, row_start, axis_group(mesh, DATA_AXIS))))
            image, label = model_inputs(image, label, augment_fn, generator, seed, state.step)
        return body(state, {"image": image, "label": label})

    return step


class CoreTrain:
    """Host training loop (reference ``core_train.py:74`` ``.train()``).

    ``dataset_fn(epoch) -> iterable of {"image": [N,H,W,C], "label":
    [N,H,W]}`` host batches (numpy or CPU tensors), sent to ``env.device``
    ``prefetch_to_device`` batches ahead through pinned memory; with
    ``resident_dataset`` it yields ``{"index": [N]}`` instead (see
    ``DeviceResidentDataset.index_dataset_fn``) and the gather, the augment
    and the step run on the device.

    ``model`` is on ``env.device``; it is initialized from ``seed`` unless
    ``initialized`` (weights already loaded, e.g. by
    ``convert.load_flax``). ``profiler_dir`` is where ``use_profiler``
    writes its trace. With ``tx = with_grad_accum(inner, every=k)`` pass
    ``grad_accum_every=k``: a step of this loop is then a micro-step (the
    state's step counts them), the schedule inside ``tx`` counts real
    updates, and the logged learning rate reads ``lr_schedule(step // k)``.

    On a process group (``env.mesh`` set by ``common_env_setup(
    initialize_distributed=True)``) the steps are data parallel: each
    process's ``dataset_fn`` yields its LOCAL batch, this rank's part of the
    global batch, which is taken as it is (the JAX package's rule on several
    processes; ``make_shard_dataset_fn`` partitions by rank by default, and
    the global batch of a step is the ranks' batches in rank order); every
    rank starts from the same seeded weights; ``ModelHelper`` writes from
    rank 0 behind a barrier and every rank restores; a SIGTERM on any rank
    stops every rank after the same step (the ranks agree on it by a
    non-blocking all-reduce issued after each step and read after the next,
    so the host never waits on the card for it: the stop comes one step
    after the signal is seen); rank 0 alone writes the scalar log. A
    resident dataset built with ``mesh=`` serves global index vectors that
    every rank gathers by ``data.resident.sharded_gather``.
    """

    def __init__(
        self,
        env,
        model: nn.Module,
        tx,
        loss_fn: Optional[Callable] = None,
        seed: int = 0,
        checkpoint_manager=None,
        log_every: int = 50,
        callbacks: Optional[list] = None,
        inputs_process: Optional[Callable] = None,
        device_augment: Optional[Callable] = None,
        use_profiler: bool = False,
        profiler_dir: Optional[str] = None,
        profile_steps: int = 5,
        prefetch_to_device: int = 2,
        log_dir: Optional[str] = None,
        lr_schedule: Optional[Callable] = None,
        ema_decay: Optional[float] = None,
        handle_preemption: bool = True,
        grad_accum_every: int = 1,
        initialized: bool = False,
        resident_dataset=None,
    ):
        if use_profiler and profiler_dir is None:
            raise ValueError("use_profiler needs a profiler_dir")
        self.env = env
        self.mesh = getattr(env, "mesh", None)
        self.model = model
        self.seed = seed
        self.loss_fn = loss_fn or model.build_loss_fn()
        self.state = create_train_state(
            model, None if initialized else torch.Generator().manual_seed(seed), tx,
            ema_decay=ema_decay, initialized=initialized)
        # device-resident mode: dataset_fn yields {"index": [B]} batches and
        # the gather + device_augment + step run on the device
        self.resident_dataset = resident_dataset
        if resident_dataset is not None:
            self.train_step = make_resident_train_step(
                self.loss_fn, resident_dataset.images, resident_dataset.labels,
                augment_fn=device_augment, compute_dtype=env.compute_dtype, seed=seed,
                mesh=self.mesh, row_start=getattr(resident_dataset, "row_start", None))
        else:
            self.train_step = make_train_step(self.loss_fn, env.compute_dtype, seed=seed,
                                              mesh=self.mesh)
        self.checkpoint_manager = checkpoint_manager
        self.log_every = log_every
        self.callbacks = list(callbacks or [])
        # per-model host batch hook (reference ``core_train.py:198-205``)
        self.inputs_process = inputs_process
        # on-device augmentation (iseg_tpu_torch.data.device_augment):
        # fn(generator, images, labels) -> (images, labels)
        self.device_augment = device_augment
        self._augment_generator = (torch.Generator(device=env.device)
                                   if device_augment is not None else None)
        # torch.profiler window at 10% of the first epoch (reference
        # core_train.py:121-126 profile_batch policy)
        self.use_profiler = use_profiler
        self.profiler_dir = profiler_dir
        self.profile_steps = profile_steps
        self.prefetch_to_device = prefetch_to_device
        # durable scalar log: TensorBoard event file + CSV under log_dir
        self.scalar_logger = None
        if log_dir is not None and axis_rank(self.mesh, DATA_AXIS) == 0:
            from iseg_tpu_torch.utils.summary import ScalarLogger

            self.scalar_logger = ScalarLogger(log_dir)
        self.lr_schedule = lr_schedule
        # with with_grad_accum(tx, every=k) the schedule inside tx advances
        # once per k micro-steps: the logged LR indexes it by real updates
        self.grad_accum_every = max(1, int(grad_accum_every))
        # graceful preemption: SIGTERM sets a flag, the step loop
        # checkpoints durably at the next step boundary and returns; resume
        # with initial_epoch=-1 skips the already-applied batches
        self.handle_preemption = handle_preemption
        self._preempt_requested = False
        self._preempt_vote = None  # the ranks' agreement in flight (on a group)

    def restore(self) -> int:
        """Resume from the latest checkpoint if one exists (reference
        ``modelhelper.py:113`` ``restore_checkpoint``); returns the step."""
        if self.checkpoint_manager is not None:
            restored = self.checkpoint_manager.restore_latest(self.state)
            if restored is not None:
                self.state = restored
        return int(self.state.step)

    def train(
        self,
        dataset_fn: Callable[[int], Iterable[dict]],
        epochs: int = 1,
        steps_per_epoch: Optional[int] = None,
        initial_epoch: int = 0,
        on_epoch_end: Optional[Callable] = None,
    ):
        """Run the epoch loop (reference ``core_train.py:74-152``); returns
        one history record per epoch.

        ``initial_epoch=-1`` derives the resume epoch from the restored step
        count (reference ``core_train.py:107-116``) and skips the batches of
        that epoch that were already applied; requires ``steps_per_epoch``."""
        resume_skip = 0
        if initial_epoch == -1:
            if not steps_per_epoch:
                raise ValueError("initial_epoch=-1 requires steps_per_epoch")
            initial_epoch = self.state.step // steps_per_epoch
            # mid-epoch checkpoint (preemption save): dataset_fn(epoch) is
            # epoch-seeded, so the skipped prefix is what the preempted
            # process consumed
            resume_skip = self.state.step % steps_per_epoch

        self._preempt_requested = False
        self._preempt_vote = None
        prev_handler = _UNSET_HANDLER
        if self.handle_preemption:
            def _on_preempt(signum, frame):
                self._preempt_requested = True
                print(f"preemption signal {signum} received: checkpointing at the next step "
                      "boundary", flush=True)
            try:
                prev_handler = signal.signal(signal.SIGTERM, _on_preempt)
            except ValueError:
                pass  # not the main thread; flag-only mode

        try:
            history = self._train_loop(dataset_fn, epochs, steps_per_epoch, initial_epoch,
                                       resume_skip, on_epoch_end)
            self._settle_vote()
        finally:
            # None means the previous handler was installed by non-Python
            # code: signal.signal cannot re-install it, and leaving
            # _on_preempt in place would swallow every later SIGTERM, so
            # fall back to the default action
            if prev_handler is None:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
            elif prev_handler is not _UNSET_HANDLER:
                signal.signal(signal.SIGTERM, prev_handler)
        return history

    def _preempt_checkpoint(self) -> None:
        """Durable mid-epoch save in response to a preemption notice."""
        step = self.state.step
        if self.checkpoint_manager is not None:
            if step not in set(self.checkpoint_manager.all_steps()):
                self.checkpoint_manager.save(step, self.state)
            self.checkpoint_manager.wait()
        self._close_logger()
        print(f"preempted: checkpoint durable at step={step}; exiting the train loop",
              flush=True)

    def _close_logger(self) -> None:
        if self.scalar_logger is not None:
            self.scalar_logger.close()
            self.scalar_logger = None  # a closed writer must not be reused

    def _batches(self, data):
        if self.resident_dataset is not None:
            return data  # [B] index vectors; the data are on the device
        # on a group each host batch is this process's local batch, as it is
        return device_prefetch(data, self.env.device, size=self.prefetch_to_device,
                               transform=self.inputs_process)

    def _preempted(self) -> bool:
        """The preemption flag; on a group, true on every rank after the
        same step when any rank had it one step earlier: each step casts
        this rank's flag into a non-blocking all-reduce and reads the vote
        cast after the step before."""
        if self.mesh is None:
            return self._preempt_requested
        previous, self._preempt_vote = self._preempt_vote, collectives.AnyRankVote(
            self._preempt_requested, group=axis_group(self.mesh, DATA_AXIS))
        return previous is not None and previous.result()

    def _settle_vote(self) -> None:
        """Wait for the vote in flight (every rank holds one, cast after the
        same step), so no collective outlives the loop."""
        if self._preempt_vote is not None:
            self._preempt_vote.result()
            self._preempt_vote = None

    def _step(self, batch):
        if self.resident_dataset is not None:
            return self.train_step(self.state, batch["index"])
        with collectives.data_parallel(self.mesh):  # the augment draws the global batch's
            image, label = model_inputs(batch["image"], batch["label"], self.device_augment,
                                        self._augment_generator, self.seed, self.state.step)
        return self.train_step(self.state, {"image": image, "label": label})

    def _train_loop(self, dataset_fn, epochs, steps_per_epoch, initial_epoch, resume_skip,
                    on_epoch_end):
        # profiler window start step: 10% into the first epoch
        profile_start = (max(1, (steps_per_epoch or 10) // 10)
                         if self.use_profiler else None)
        trace = contextlib.ExitStack()
        profiling_from = None  # step_in_epoch at which the open trace started

        history = []
        for epoch in range(initial_epoch, epochs):
            for cb in self.callbacks:
                cb.on_epoch_begin(epoch, self.state)
            t0 = time.time()
            step_in_epoch = 0
            last_parts = {}
            timer = StepTimer()
            data = dataset_fn(epoch)
            if epoch == initial_epoch and resume_skip:
                # exact-step resume from a mid-epoch save: drop the
                # already-applied prefix of this epoch's stream on the host
                data = iter(data)
                for _ in range(resume_skip):
                    next(data, None)
                step_in_epoch = resume_skip
            for batch in self._batches(data):
                if (profile_start is not None and epoch == initial_epoch
                        and step_in_epoch >= profile_start):
                    # >= not ==: a mid-epoch resume can enter past the start
                    trace.enter_context(profile_trace(self.profiler_dir))
                    profiling_from, profile_start = step_in_epoch, None
                self.state, parts = self._step(batch)
                # keys in sorted order, as a jitted JAX step returns its dict
                parts = dict(sorted(parts.items()))
                last_parts = parts
                step_in_epoch += 1
                timer.tick()
                if self._preempted():
                    trace.close()
                    self._preempt_checkpoint()
                    return history
                if (profiling_from is not None
                        and step_in_epoch >= profiling_from + self.profile_steps):
                    trace.close()
                    profiling_from = None
                    print(f"profiler trace written to {self.profiler_dir}", flush=True)
                if self.log_every and step_in_epoch % self.log_every == 0:
                    loss = float(parts["loss"])
                    print(f"epoch {epoch} step {step_in_epoch}: loss={loss:.4f}", flush=True)
                    if self.scalar_logger is not None:
                        scalars = {f"train/{k}": float(v) for k, v in parts.items()}
                        if self.lr_schedule is not None:
                            scalars["train/learning_rate"] = float(
                                self.lr_schedule(self.state.step // self.grad_accum_every))
                        summ = timer.summary()
                        if "mean_s" in summ:
                            scalars["train/step_seconds"] = summ["mean_s"]
                        self.scalar_logger.log(scalars, self.state.step)
                if steps_per_epoch and step_in_epoch >= steps_per_epoch:
                    break
            trace.close()  # a window that spilled past the epoch
            profiling_from = None
            # epoch-end bookkeeping (reference TimeCallback + CheckpointSaver)
            dt = time.time() - t0
            record = {
                "epoch": epoch,
                "steps": step_in_epoch,
                "seconds": dt,
                **{f"step_{k}": v for k, v in timer.summary().items() if k != "steps"},
                **{k: float(v) for k, v in last_parts.items()},
            }
            history.append(record)
            print(f"epoch {epoch} done in {dt:.1f}s: {record}", flush=True)
            if self.scalar_logger is not None:
                self.scalar_logger.log(
                    {f"epoch/{k}": float(v) for k, v in record.items()
                     if isinstance(v, (int, float))}, self.state.step)
            if self.checkpoint_manager is not None:
                self.checkpoint_manager.save(self.state.step, self.state)
            if on_epoch_end is not None:
                on_epoch_end(epoch, self.state)
            for cb in self.callbacks:
                cb.on_epoch_end(epoch, self.state, record)
        for cb in self.callbacks:
            cb.on_train_end(self.state)
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.wait()  # flush an in-flight async save
        self._close_logger()
        return history
