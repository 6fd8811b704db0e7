"""Model tier: SegBase / SegFoundation / SegManaged (counterpart of
``iseg_tpu/core/model.py``).

The model's boundary keeps the JAX package's layouts: images go in as
``[N, H, W, 3]``, logits come out as fp32 ``[N, h, w, C]``, labels are
``[N, H, W]``. Inside, the convs run NCHW on channels_last memory, so both
boundary permutes are views.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.ops.kernels.upsample_ce import upsample_cross_entropy
from iseg_tpu_torch.ops.resize import resize_image


@dataclasses.dataclass
class SegModelInferenceConfig:
    """Inference knobs. Only single-scale inference is ported so far, so
    any field other than its default raises rather than being ignored."""

    scale_rates: Sequence[float] = (1.0,)
    flip: bool = False
    sliding_window_crop_size: Optional[tuple[int, int]] = None
    sliding_window_stride_rate: float = 2.0 / 3.0
    sliding_window_batch: int = 1
    flip_in_batch: bool = False
    use_cpu_cache: bool = False
    bucket_multiple: Optional[int] = None
    bucket_pad_value: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if (tuple(value) if isinstance(value, list) else value) != f.default:
                raise NotImplementedError(
                    f"SegModelInferenceConfig.{f.name}: only single-scale inference "
                    "is ported to iseg_tpu_torch yet")


class SegBase(nn.Module):
    """Base of segmentation models: ``forward(x)`` returns logits
    [N, H, W, num_class] or a list/dict of them (main output first)."""

    @torch.no_grad()
    def inference(self, x: torch.Tensor) -> torch.Tensor:
        """Single-scale inference in eval mode (the training flag is
        restored afterwards)."""
        was_training = self.training
        self.eval()
        try:
            out = self(x)
        finally:
            self.train(was_training)
        if isinstance(out, (list, tuple)):
            out = out[0]
        if isinstance(out, dict):
            out = out["output_0"]
        return out


def normalize_outputs(outputs) -> dict[str, torch.Tensor]:
    """list/tuple/dict/tensor -> {"output_0": ..., "output_1": ...}."""
    if isinstance(outputs, dict):
        return outputs
    if isinstance(outputs, (list, tuple)):
        return {f"output_{i}": o for i, o in enumerate(outputs)}
    return {"output_0": outputs}


class SegFoundation(SegBase):
    """Loss plumbing: aux outputs, loss rates, focal switch, class weights,
    reduction, and the fused upsample + CE kernel."""

    def __init__(
        self,
        num_class: int = 21,
        num_aux_loss: int = 0,
        aux_loss_rate: float = 0.4,
        use_ohem: bool = False,  # OHEM is not ported: True raises
        use_focal_loss: bool = False,
        focal_loss_gamma: float = 2.0,
        focal_loss_alpha: Optional[float] = 0.25,
        class_weights: Optional[Sequence[float]] = None,
        ignore_label: int = 255,
        loss_reduction: str = "valid_mean",
        loss_global_batch_size: Optional[int] = None,
        # fuse the logits upsample into the loss (the CUDA kernel): pair
        # with upsample_logits=False so full-res logits never materialize.
        # Plain CE only (no OHEM/focal/class weights on the fused path).
        fuse_upsample_loss: bool = False,
    ):
        super().__init__()
        self.num_class = num_class
        self.num_aux_loss = num_aux_loss
        self.aux_loss_rate = aux_loss_rate
        self.use_ohem = use_ohem
        self.use_focal_loss = use_focal_loss
        self.focal_loss_gamma = focal_loss_gamma
        self.focal_loss_alpha = focal_loss_alpha
        self.class_weights = class_weights
        self.ignore_label = ignore_label
        self.loss_reduction = loss_reduction
        self.loss_global_batch_size = loss_global_batch_size
        self.fuse_upsample_loss = fuse_upsample_loss

    def custom_losses_weights(self) -> list[float]:
        return [1.0] + [self.aux_loss_rate] * self.num_aux_loss

    def build_loss_fn(self) -> Callable:
        """``loss_fn(outputs, labels) -> (total, parts)`` with parts keyed
        ``output_N_loss`` plus ``loss``."""
        if self.use_ohem:
            raise NotImplementedError("OHEM is not ported to iseg_tpu_torch yet")
        weights = self.custom_losses_weights()
        use_fused = (
            self.fuse_upsample_loss
            and not self.use_ohem
            and not self.use_focal_loss
            and self.class_weights is None
            # the fused kernel computes a valid-pixel mean only
            and self.loss_reduction == "valid_mean"
        )

        def loss_fn(outputs, labels):
            outs = normalize_outputs(outputs)
            total = 0.0
            parts = {}
            for i, (key, logits) in enumerate(outs.items()):
                if use_fused and logits.shape[1] < labels.shape[1]:
                    loss = upsample_cross_entropy(logits, labels, ignore_label=self.ignore_label)
                else:
                    if self.fuse_upsample_loss and logits.shape[1] < labels.shape[1]:
                        # fusion requested but gated out: the model emits
                        # LOW-RES logits, so reproduce the upsample here
                        logits = resize_image(logits.to(torch.float32),
                                              (labels.shape[1], labels.shape[2]), "bilinear")
                    loss = cross_entropy_ignore_label(
                        logits,
                        labels,
                        num_classes=self.num_class,
                        ignore_label=self.ignore_label,
                        class_weights=self.class_weights,
                        use_focal=self.use_focal_loss,
                        focal_gamma=self.focal_loss_gamma,
                        focal_alpha=self.focal_loss_alpha,
                        reduction=self.loss_reduction,
                        global_batch_size=self.loss_global_batch_size,
                    )
                parts[f"{key}_loss"] = loss
                rate = weights[i] if i < len(weights) else 1.0
                total = total + rate * loss
            parts["loss"] = total
            return total, parts

        return loss_fn


class SegManaged(SegFoundation):
    """The assembled model: backbone -> head -> 1x1 logits conv ->
    (optional) bilinear upsample to input size -> fp32 cast.

    ``backbone`` and ``head`` are NCHW modules; the logits conv's input
    width is ``head.out_channels`` (or ``backbone.out_channels`` without a
    head). Aux outputs and label/image routing into the head are not
    ported yet and raise.
    """

    def __init__(
        self,
        num_class: int = 21,
        backbone: Optional[nn.Module] = None,
        head: Optional[nn.Module] = None,
        use_aux_head_endpoints: bool = False,
        upsample_logits: bool = True,
        head_use_label_input: bool = False,
        head_use_image_input: bool = False,
        **foundation_kwargs,
    ):
        super().__init__(num_class=num_class, **foundation_kwargs)
        if (self.num_aux_loss or use_aux_head_endpoints or head_use_label_input
                or head_use_image_input):
            raise NotImplementedError(
                "aux outputs and head input routing are not ported to iseg_tpu_torch yet")
        self.backbone = backbone
        self.head = head
        self.upsample_logits = upsample_logits
        feat = head if head is not None else backbone
        in_ch = feat.out_channels if feat is not None else 3
        self.logits_conv = Conv2d(in_ch, num_class, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs_hw = (x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last memory)
        feats = self.backbone(x) if self.backbone is not None else x
        endpoints = feats if isinstance(feats, (list, tuple)) else [feats]
        h = self.head(endpoints) if self.head is not None else endpoints[-1]
        logits = self.logits_conv(h)
        if self.upsample_logits and tuple(logits.shape[2:]) != inputs_hw:
            logits = F.interpolate(logits, size=inputs_hw, mode="bilinear",
                                   align_corners=False, antialias=False)
        # fp32 output cast, NCHW -> NHWC (a view when logits are channels_last)
        return logits.permute(0, 2, 3, 1).to(torch.float32).contiguous()
