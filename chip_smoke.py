#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``iseg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, bench.py's headline training configuration:
ResNet-50 (output stride 16, deep stem, slim stacks, multi-grid) + ASPP(256),
21 classes, 512x512 input, batch 16, bf16 autocast with fp32 params, SGD
(momentum 0.9, poly decay), with the loss taken by the fused upsample + CE
CUDA kernel. Weights are random, from seed 0. Phases, in order; any
failure raises and the script exits non-zero:

1. device: require CUDA; print the card, its power limit, the torch and
   CUDA versions; build the kernels from ``iseg_tpu_torch/csrc`` in a clean
   build directory and print the build time and ptxas report;
2. kernels vs their plain versions at the main-path shapes
   ([16,32,32,21] logits -> [16,512,512] labels, ~10% ignored), f32 and
   bf16, with median CUDA-event times;
3. train: 2 warm-up + 5 timed fused steps on one fixed synthetic batch;
   losses finite, and the launch counters grew by exactly one forward and
   one backward kernel launch per step;
4. fused vs unfused: one unfused step (upsample_logits=True, plain CE) from
   the same initial weights and dropout draw gives the fused first step's
   loss; then its timed ms/step;
5. serve: single-scale inference in eval mode with the trained weights:
   [16,512,512,21] finite logits, consistent with the fused model's
   low-resolution logits.

The line before the last is a JSON object with one entry per kernel; the
last line is the contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.convert import param_tree
from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
from iseg_tpu_torch.core.model import SegManaged
from iseg_tpu_torch.core.optimizer import get_optimizer
from iseg_tpu_torch.core.train import create_train_state, make_train_step
from iseg_tpu_torch.nn.blocks import Dropout, set_dropout_generator
from iseg_tpu_torch.nn.heads import ASPP
from iseg_tpu_torch.ops.kernels import _build
from iseg_tpu_torch.ops.kernels import upsample_ce as uce
from iseg_tpu_torch.ops.resize import resize_image

BATCH, HW, NUM_CLASS, OS = 16, 512, 21, 16
WARMUP_STEPS, TIMED_STEPS, UNFUSED_TIMED_STEPS = 2, 5, 3
# kernel vs plain: fp32 loss rtol 1e-5; dsrc max error within 1e-4 (f32) or
# 1e-2 (bf16: the kernel's gradient is rounded to bf16) of max |dsrc|
KERNEL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 1e-2)}
# fused vs unfused first-step loss, relative. Both run the same bf16 network
# with the same cuDNN algorithms (the autotuner's choices are cached per
# shape); they differ only in the loss: the unfused path upsamples bf16
# logits and rounds each to bf16 (2^-9 relative), the kernel upsamples in
# fp32, and those roundings average out over the 4M pixels' mean
FUSED_UNFUSED_RTOL = 1e-4
# served logits vs the fused model's low-res logits upsampled by hand: the
# served path upsamples bf16 logits (bf16 keeps 8 bits), relative to max |logit|
SERVE_RTOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3, setup=None) -> float:
    """Median over ``reps`` of the device time of ``fn()``, by CUDA events.
    ``setup()`` runs before each rep, outside the timed window."""
    times = []
    for i in range(warmup + reps):
        arg = setup() if setup is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    log("== phase 1: device and kernel build")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    log(f"nvidia-smi: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    built = uce.build()
    if not built.compiled:
        raise RuntimeError("the kernel library was not compiled from a clean build directory")
    log(f"built {built.path.name} in {built.seconds:.2f} s (nvcc, sm_90a)")
    log(built.log.strip())


def phase_kernels(device) -> list[dict]:
    log("== phase 2: kernels vs plain versions at the main-path shapes")
    rng = np.random.RandomState(0)
    h = HW // OS
    src32 = torch.tensor(rng.randn(BATCH, h, h, NUM_CLASS).astype(np.float32), device=device)
    labels = rng.randint(0, NUM_CLASS, (BATCH, HW, HW))
    labels = np.where(rng.rand(BATCH, HW, HW) < 0.1, 255, labels).astype(np.int32)
    labels = torch.tensor(labels, device=device)
    log(f"src {tuple(src32.shape)}, labels {tuple(labels.shape)}, "
        f"ignored {float((labels == 255).float().mean()):.4f}")

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        src = src32.to(dtype)
        s_k = src.clone().requires_grad_(True)
        loss_k = uce.upsample_cross_entropy(s_k, labels)
        (g_k,) = torch.autograd.grad(loss_k, s_k)
        s_r = src.clone().requires_grad_(True)
        loss_r = uce.upsample_cross_entropy_reference(s_r, labels)
        (g_r,) = torch.autograd.grad(loss_r, s_r)
        torch.cuda.synchronize()
        loss_k, loss_r = float(loss_k.detach()), float(loss_r.detach())
        loss_err = abs(loss_k - loss_r)
        grad_err = float((g_k.float() - g_r.float()).abs().max())
        grad_scale = float(g_r.float().abs().max())
        loss_rtol, grad_rtol = KERNEL_TOL[dtype]
        name = str(dtype).replace("torch.", "")
        log(f"[{name}] loss kernel {loss_k:.7f} plain {loss_r:.7f} "
            f"abs err {loss_err:.3e} (tol rtol {loss_rtol:g}); dsrc max abs err "
            f"{grad_err:.3e} vs max |dsrc| {grad_scale:.3e} (tol {grad_rtol:g} of it)")
        if not (np.isfinite(loss_k) and loss_err <= loss_rtol * abs(loss_r)):
            raise AssertionError(f"[{name}] forward kernel disagrees with the plain version")
        if not grad_err <= grad_rtol * grad_scale:
            raise AssertionError(f"[{name}] backward kernel disagrees with the plain version")

        def fwd_setup():
            return src

        def bwd_setup(fn):
            def make():
                s = src.clone().requires_grad_(True)
                return s, fn(s, labels)
            return make

        def run_bwd(arg):
            s, loss = arg
            torch.autograd.grad(loss, s)

        with torch.no_grad():
            fwd_ms = cuda_median_ms(lambda s: uce.upsample_cross_entropy(s, labels),
                                    setup=fwd_setup)
            fwd_plain_ms = cuda_median_ms(
                lambda s: uce.upsample_cross_entropy_reference(s, labels), setup=fwd_setup)
        bwd_ms = cuda_median_ms(run_bwd, setup=bwd_setup(uce.upsample_cross_entropy))
        bwd_plain_ms = cuda_median_ms(run_bwd,
                                      setup=bwd_setup(uce.upsample_cross_entropy_reference))
        log(f"[{name}] median ms: fwd kernel {fwd_ms:.4f} plain {fwd_plain_ms:.4f}; "
            f"bwd kernel {bwd_ms:.4f} plain {bwd_plain_ms:.4f}")
        rows[dtype] = dict(loss_err=loss_err, grad_err=grad_err, fwd_ms=fwd_ms,
                           fwd_plain_ms=fwd_plain_ms, bwd_ms=bwd_ms,
                           bwd_plain_ms=bwd_plain_ms)

    # the main path feeds the kernels fp32 logits (the model's fp32 cast)
    f32 = rows[torch.float32]
    source = "iseg_tpu_torch/csrc/upsample_ce.cu"
    return [
        {"name": "upsample_ce_fwd", "route": "cuda", "source": source,
         "replaces": "iseg_tpu/ops/pallas/upsample_ce.py:122", "launches": None,
         "max_abs_err": f32["loss_err"], "ms": f32["fwd_ms"], "plain_ms": f32["fwd_plain_ms"]},
        {"name": "upsample_ce_bwd", "route": "cuda", "source": source,
         "replaces": "iseg_tpu/ops/pallas/upsample_ce.py:159", "launches": None,
         "max_abs_err": f32["grad_err"], "ms": f32["bwd_ms"], "plain_ms": f32["bwd_plain_ms"]},
    ]


def build_model(env, fused: bool) -> SegManaged:
    backbone = get_backbone("resnet50", output_stride=OS)
    model = SegManaged(num_class=NUM_CLASS, backbone=backbone,
                       head=ASPP(backbone.out_channels, filters=256),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def dropout_generator(model) -> torch.Generator:
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, Dropout) and m.rate > 0}
    if len(gens) != 1:
        raise RuntimeError(f"expected one dropout generator, found {len(gens)}")
    return next(iter(gens.values()))


def phase_train(env, data):
    log("== phase 3: train (fused upsample + CE kernel)")
    model = build_model(env, fused=True)
    tx, schedule = get_optimizer(param_tree(model), "sgd", learning_rate=0.01,
                                 train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    init_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    init_dropout = dropout_generator(model).get_state()
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    uce.reset_launch_counts()
    losses = []
    t_start = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        state, parts = step_fn(state, data)
        losses.append(parts["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, parts = step_fn(state, data)
        losses.append(parts["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(uce.LAUNCH_COUNTS)
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    log(f"losses: {[round(v, 5) for v in losses]}")
    log(f"warm-up {WARMUP_STEPS} steps took {t0 - t_start:.2f} s (cuDNN autotuning included)")
    log(f"fused: {1000 * dt / TIMED_STEPS:.2f} ms/step, "
        f"{BATCH * TIMED_STEPS / dt:.2f} img/s, peak memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes), lr now {schedule(state.step):.6f}")
    log(f"kernel launches over {steps} steps: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != {"fwd": steps, "bwd": steps}:
        raise AssertionError(f"expected {steps} forward and backward kernel launches, "
                             f"got {launches}")
    return model, init_weights, init_dropout, losses[0], launches


def phase_unfused(env, data, init_weights, init_dropout, fused_first_loss):
    log("== phase 4: fused vs unfused")
    model = build_model(env, fused=False)
    model.load_state_dict(init_weights)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, None, tx, initialized=True)
    gen = torch.Generator(device=env.device)
    gen.set_state(init_dropout)
    set_dropout_generator(model, gen)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    uce.reset_launch_counts()
    state, parts = step_fn(state, data)
    loss = float(parts["loss"])
    rel = abs(loss - fused_first_loss) / abs(fused_first_loss)
    log(f"first-step loss: fused {fused_first_loss:.6f} unfused {loss:.6f} "
        f"rel diff {rel:.3e} (tol {FUSED_UNFUSED_RTOL:g})")
    if uce.LAUNCH_COUNTS != {"fwd": 0, "bwd": 0}:
        raise AssertionError("the unfused path launched the fused kernels")
    if not rel <= FUSED_UNFUSED_RTOL:
        raise AssertionError("fused and unfused first-step losses disagree")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(UNFUSED_TIMED_STEPS):
        state, parts = step_fn(state, data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"unfused: {1000 * dt / UNFUSED_TIMED_STEPS:.2f} ms/step, "
        f"{BATCH * UNFUSED_TIMED_STEPS / dt:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {float(parts['loss']):.5f}")
    return model


def phase_serve(env, data, fused_model, serve_model):
    log("== phase 5: serve (single-scale inference, trained weights)")
    serve_model.load_state_dict(fused_model.state_dict())
    with torch.autocast("cuda", dtype=env.compute_dtype):
        logits = serve_model.inference(data["image"])
        low = fused_model.inference(data["image"])
    pred = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    expect = (BATCH, HW, HW, NUM_CLASS)
    if tuple(logits.shape) != expect or logits.dtype != torch.float32:
        raise AssertionError(f"served logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {expect} float32")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("served logits are not finite")
    up = resize_image(low, (HW, HW), "bilinear")
    err = float((up - logits).abs().max())
    scale = float(logits.abs().max())
    log(f"served logits {tuple(logits.shape)}, prediction {tuple(pred.shape)}, "
        f"classes predicted {int(pred.unique().numel())}, max |served - upsampled low-res| "
        f"{err:.3e} vs max |logit| {scale:.3e} (tol {SERVE_RTOL:g} of it)")
    if not err <= SERVE_RTOL * scale:
        raise AssertionError("served logits disagree with the fused model's logits")


def main() -> int:
    phase_device()
    env = common_env_setup(EnvConfig(random_seed=0, mixed_precision=True, device="cuda"))
    # time cuDNN's conv algorithms once for the fixed training shapes; the
    # choice, and so the bf16 sums after step 1, may differ from run to run
    torch.backends.cudnn.benchmark = True
    log(f"env: {env.describe()}")
    device = env.device
    kernels = phase_kernels(device)

    x = np.random.RandomState(0).rand(BATCH, HW, HW, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, NUM_CLASS, (BATCH, HW, HW)).astype(np.int32)
    data = {"image": torch.tensor(x, device=device), "label": torch.tensor(y, device=device)}

    fused_model, init_weights, init_dropout, first_loss, launches = phase_train(env, data)
    for k in kernels:
        k["launches"] = launches["fwd" if k["name"].endswith("fwd") else "bwd"]
    serve_model = phase_unfused(env, data, init_weights, init_dropout, first_loss)
    phase_serve(env, data, fused_model, serve_model)

    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
