"""Fused bilinear-upsample + ignore-label cross-entropy.

Counterpart of ``iseg_tpu/ops/pallas/upsample_ce.py``. The loss of
bilinearly upsampled logits is computed straight from the output-stride
logits, so the ``[N, H, W, C]`` full-resolution logits and their gradient
never reach device memory. On a CUDA tensor the forward and the backward
are the hand-written kernels of ``iseg_tpu_torch/csrc/upsample_ce.cu``
(their note says what bounds them on the H100); on a CPU tensor the same
sums come from the plain PyTorch version below. A CUDA tensor never falls
back to the plain version: a wrong dtype, shape or layout, or a failed
launch, raises.

``LAUNCH_COUNTS`` counts kernel launches (``"fwd"``, ``"bwd"``): one per
launch of each kernel, nowhere else, so a run can show that it went
through the kernels.

Semantics kept from the TPU kernel: the loss is ``sum(ce * valid) /
max(sum(valid), 1)`` over pixels with ``label != ignore_label`` (over the
global batch under data parallelism: ``losses.base.global_valid_mean``); a label
outside ``[0, C)`` that is not ignored has no true class, so its CE is the
full log-sum-exp; with ``ignore_label == 0`` the classes are NOT shifted
(unlike :func:`cross_entropy_ignore_label`).

Routing by class count, copied from the reference
(``iseg_tpu/ops/pallas/upsample_ce.py:233-236``): above ``MAX_FUSED_CLASSES``
(64) classes, on any device, :func:`upsample_cross_entropy` returns
:func:`upsample_cross_entropy_reference`, the unfused resize +
:func:`cross_entropy_ignore_label` with that function's label rules, and
launches no kernel. This is the reference's dispatch rule, not a fallback:
at 64 classes or fewer a CUDA tensor takes the kernels, and a fault there
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from iseg_tpu_torch.losses.base import global_valid_mean
from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label
from iseg_tpu_torch.ops.resize import resize_image

LAUNCH_COUNTS = {"fwd": 0, "bwd": 0}
MAX_FUSED_CLASSES = 64

SOURCE = "upsample_ce.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DOES_NOT_FIT = -1


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def build():
    """Compile (if needed) and load the CUDA library; returns the
    :class:`~iseg_tpu_torch.ops.kernels._build.Built` record."""
    from iseg_tpu_torch.ops.kernels import _build

    built = _build.load(SOURCE)
    lib = built.lib
    if not getattr(lib, "_iseg_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.upsample_ce_num_partials.argtypes = [ctypes.c_longlong]
        lib.upsample_ce_num_partials.restype = i32
        lib.upsample_ce_fwd.argtypes = [ptr, i32, ptr, ptr, ptr] + [i32] * 7 + [ptr]
        lib.upsample_ce_fwd.restype = i32
        lib.upsample_ce_bwd.argtypes = [ptr, i32, ptr, ptr, ptr] + [i32] * 7 + [ptr]
        lib.upsample_ce_bwd.restype = i32
        lib._iseg_bound = True
    return built


def _check_cuda_inputs(src: torch.Tensor, labels: torch.Tensor) -> None:
    if src.device.type != "cuda" or labels.device != src.device:
        raise ValueError(f"upsample_ce kernel: src on {src.device}, labels on "
                         f"{labels.device}; both must be on the same CUDA device")
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"upsample_ce kernel takes float32 or bfloat16 logits, got {src.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"upsample_ce kernel takes int32 labels, got {labels.dtype}")
    if src.ndim != 4 or labels.ndim != 3 or labels.shape[0] != src.shape[0]:
        raise ValueError(f"upsample_ce kernel: src {tuple(src.shape)} must be [N,h,w,C] "
                         f"and labels {tuple(labels.shape)} [N,H,W]")
    if not (src.is_contiguous() and labels.is_contiguous()):
        raise ValueError("upsample_ce kernel takes contiguous NHWC src and labels")
    if max(src.numel(), labels.numel()) >= 2 ** 31:
        raise ValueError("upsample_ce kernel: tensors of 2**31 or more elements")


def _raise_on(err: int, what: str) -> None:
    if err == _DOES_NOT_FIT:
        raise ValueError(f"upsample_ce {what} kernel: the shape's tiles do not fit a block")
    if err != 0:
        raise RuntimeError(f"upsample_ce {what} kernel launch failed: CUDA error {err}")


def _shape_args(src, labels, ignore_label):
    n, h, w, c = src.shape
    return [n, h, w, c, labels.shape[1], labels.shape[2], int(ignore_label)]


def _launch_fwd(src: torch.Tensor, labels: torch.Tensor, ignore_label: int) -> torch.Tensor:
    """Returns the fp32 pair (sum of CE over valid pixels, valid count)."""
    _check_cuda_inputs(src, labels)
    lib = build().lib
    parts = lib.upsample_ce_num_partials(labels.numel())
    partials = torch.empty(2 * max(parts, 1), dtype=torch.float32, device=src.device)
    out = torch.zeros(2, dtype=torch.float32, device=src.device)
    if labels.numel() == 0:
        return out
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.upsample_ce_fwd(src.data_ptr(), _DTYPE_CODES[src.dtype], labels.data_ptr(),
                              partials.data_ptr(), out.data_ptr(),
                              *_shape_args(src, labels, ignore_label), stream)
    _raise_on(err, "forward")
    LAUNCH_COUNTS["fwd"] += 1
    return out


def _launch_bwd(src: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                ignore_label: int) -> torch.Tensor:
    """d(g * sum CE)/d(src), in src's dtype and shape."""
    _check_cuda_inputs(src, labels)
    g = g.to(device=src.device, dtype=torch.float32).reshape(1).contiguous()
    dsrc = torch.empty_like(src)
    if src.numel() == 0:
        return dsrc
    lib = build().lib
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.upsample_ce_bwd(src.data_ptr(), _DTYPE_CODES[src.dtype], labels.data_ptr(),
                              g.data_ptr(), dsrc.data_ptr(),
                              *_shape_args(src, labels, ignore_label), stream)
    _raise_on(err, "backward")
    LAUNCH_COUNTS["bwd"] += 1
    return dsrc


class _FusedSums(torch.autograd.Function):
    """(sum CE over valid pixels, valid count) with the CUDA kernels."""

    @staticmethod
    def forward(ctx, src, labels, ignore_label):
        ctx.save_for_backward(src, labels)
        ctx.ignore_label = ignore_label
        sums = _launch_fwd(src, labels, ignore_label)
        return sums[0], sums[1]

    @staticmethod
    def backward(ctx, g_loss, g_valid):
        del g_valid  # the valid count has no gradient
        src, labels = ctx.saved_tensors
        return _launch_bwd(src, labels, g_loss, ctx.ignore_label), None, None


def fused_sums_plain(src: torch.Tensor, labels: torch.Tensor, ignore_label: int):
    """Plain PyTorch version of the kernels' sums, with their label
    semantics: upsample in fp32, then per pixel ``lse - logit[label]`` (0
    for a label outside [0, C)) over pixels whose label is not ignored."""
    up = resize_image(src.to(torch.float32), tuple(labels.shape[1:3]), "bilinear")
    lse = torch.logsumexp(up, dim=-1)
    labels = labels.to(torch.int64)
    class_ids = torch.arange(up.shape[-1], device=up.device)
    true_logit = torch.where(class_ids == labels[..., None], up, 0.0).sum(dim=-1)
    valid = (labels != ignore_label).to(torch.float32)
    return ((lse - true_logit) * valid).sum(), valid.sum()


def _squeeze_labels(labels, target_hw):
    if labels.ndim == 4 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    if target_hw is not None and tuple(target_hw) != tuple(labels.shape[1:3]):
        raise ValueError(f"target_hw {tuple(target_hw)} must equal the labels' "
                         f"(H, W) {tuple(labels.shape[1:3])}")
    return labels


def upsample_cross_entropy(
    src_logits: torch.Tensor,
    labels: torch.Tensor,
    target_hw: Optional[tuple[int, int]] = None,
    ignore_label: int = 255,
) -> torch.Tensor:
    """Mean ignore-label CE of bilinearly upsampled logits, fused.

    Args:
      src_logits: [N, h, w, C] logits at the backbone's output stride
        (float32 or bfloat16).
      labels: [N, H, W] (or [N, H, W, 1]) int labels at target resolution.
      target_hw: defaults to the labels' (H, W), and must equal it.

    Above ``MAX_FUSED_CLASSES`` classes this is the unfused
    :func:`upsample_cross_entropy_reference`, as in the JAX package.
    """
    if src_logits.shape[-1] > MAX_FUSED_CLASSES:
        return upsample_cross_entropy_reference(src_logits, labels, target_hw, ignore_label)
    labels = _squeeze_labels(labels, target_hw)
    labels = labels.to(torch.int32)
    if src_logits.device.type == "cpu":
        loss_sum, valid = fused_sums_plain(src_logits, labels, ignore_label)
    elif src_logits.device.type == "cuda":
        loss_sum, valid = _FusedSums.apply(src_logits, labels.contiguous(), int(ignore_label))
    else:
        raise ValueError(f"upsample_cross_entropy: no kernel for device {src_logits.device}")
    return global_valid_mean(loss_sum, valid)


def upsample_cross_entropy_reference(src_logits, labels, target_hw=None,
                                     ignore_label: int = 255):
    """The unfused plain version: bilinear resize to the labels' size, then
    :func:`cross_entropy_ignore_label` (the reference the kernels are held
    against, with its own label semantics)."""
    labels = _squeeze_labels(labels, target_hw)
    up = resize_image(src_logits.to(torch.float32), tuple(labels.shape[1:3]), "bilinear")
    return cross_entropy_ignore_label(up, labels, ignore_label=ignore_label)
