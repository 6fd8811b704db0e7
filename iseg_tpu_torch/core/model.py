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
from torch import nn

from iseg_tpu_torch.core.inference import inference_with_multi_scales
from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label
from iseg_tpu_torch.losses.ohem import get_ohem_fn
from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.ops.kernels.upsample_ce import upsample_cross_entropy
from iseg_tpu_torch.ops.resize import resize_bilinear_matmul, resize_image


@dataclasses.dataclass
class SegModelInferenceConfig:
    """Inference knobs. :meth:`SegBase.inference` honours the scales, flip
    and sliding window; ``use_cpu_cache``, ``bucket_multiple`` and
    ``bucket_pad_value`` are honoured by
    :func:`iseg_tpu_torch.core.evaluation.make_eval_step` and ``evaluate``
    only, as in the JAX package.

    ``sliding_window_batch`` folds that many windows into the batch dim per
    model call; ``flip_in_batch`` folds each scale's (identity, flip) pair
    into one forward at double batch; both leave the results unchanged.
    ``use_cpu_cache`` runs one pass per (scale, flip) and sums the passes'
    fp32 logits in pinned host memory, so the device holds one pass at a
    time. ``bucket_multiple`` pads each eval batch on the host up to the
    next multiple of it (images with ``bucket_pad_value``, in the space the
    dataset yields; labels with the ignore label), so variable-size eval
    sees a bounded set of shapes."""

    scale_rates: Sequence[float] = (1.0,)
    flip: bool = False
    sliding_window_crop_size: Optional[tuple[int, int]] = None
    sliding_window_stride_rate: float = 2.0 / 3.0
    sliding_window_batch: int = 1
    flip_in_batch: bool = False
    use_cpu_cache: bool = False
    bucket_multiple: Optional[int] = None
    bucket_pad_value: float = 0.0


class SegBase(nn.Module):
    """Base of segmentation models: ``forward(x)`` returns logits
    [N, H, W, num_class] or a list/dict of them (main output first)."""

    def _main_output(self, x: torch.Tensor) -> torch.Tensor:
        out = self(x)
        if isinstance(out, (list, tuple)):
            out = out[0]
        if isinstance(out, dict):
            out = out["output_0"]
        return out

    @torch.no_grad()
    def inference(self, x: torch.Tensor,
                  config: Optional[SegModelInferenceConfig] = None) -> torch.Tensor:
        """Inference in eval mode (the training flag is restored
        afterwards): one forward without ``config``; with one, fp32 logits
        at the input's resolution averaged over its scales and flips, each
        pass direct or by sliding window. Multi-scale and sliding-window
        passes need a model whose logits come at its input's resolution
        (``upsample_logits=True``)."""
        was_training = self.training
        self.eval()
        try:
            if config is None:
                return self._main_output(x)
            return inference_with_multi_scales(
                self._main_output, x, scale_rates=config.scale_rates, flip=config.flip,
                flip_in_batch=config.flip_in_batch,
                sliding_window_crop_size=config.sliding_window_crop_size,
                sliding_window_stride_rate=config.sliding_window_stride_rate,
                sliding_window_batch=config.sliding_window_batch)
        finally:
            self.train(was_training)


def normalize_outputs(outputs) -> dict[str, torch.Tensor]:
    """list/tuple/dict/tensor -> {"output_0": ..., "output_1": ...}."""
    if isinstance(outputs, dict):
        return outputs
    if isinstance(outputs, (list, tuple)):
        return {f"output_{i}": o for i, o in enumerate(outputs)}
    return {"output_0": outputs}


class SegFoundation(SegBase):
    """Loss plumbing: aux outputs, loss rates, OHEM, focal switch, class
    weights, reduction, and the fused upsample + CE kernel. OHEM applies to
    the main output only and gates the fused kernel off."""

    def __init__(
        self,
        num_class: int = 21,
        num_aux_loss: int = 0,
        aux_loss_rate: float = 0.4,
        use_ohem: bool = False,
        ohem_thresh: Optional[float] = 0.7,
        ohem_min_kept: int = 100000,
        # the reference's ohem_selector bit for bit, quirks included
        # (losses/ohem.py)
        ohem_ref_exact: bool = False,
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
        self.ohem_thresh = ohem_thresh
        self.ohem_min_kept = ohem_min_kept
        self.ohem_ref_exact = ohem_ref_exact
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

    def custom_metrics(self):
        """The default metric set, one ``MeanIoU`` per output keyed
        ``output_N`` (main output first)."""
        from iseg_tpu_torch.metrics.builder import SegMetricBuilder

        builder = SegMetricBuilder(self.num_class, self.ignore_label)
        for _ in range(1 + self.num_aux_loss):
            builder.add()
        return builder

    def build_loss_fn(self) -> Callable:
        """``loss_fn(outputs, labels) -> (total, parts)`` with parts keyed
        ``output_N_loss`` plus ``loss``."""
        ohem_fn = (get_ohem_fn(self.ohem_thresh, self.ohem_min_kept,
                               ref_exact=self.ohem_ref_exact)
                   if self.use_ohem else None)
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
                        ohem_fn=ohem_fn if i == 0 else None,
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
    """The assembled model: backbone -> head -> one 1x1 logits conv per
    output -> (optional) bilinear upsample to input size -> fp32 cast.

    ``backbone`` and ``head`` are NCHW modules. The main logits conv's
    input width is ``head.out_channels`` (or ``backbone.out_channels``
    without a head); a head that returns several outputs lists their widths
    there. With ``num_aux_loss`` > 0 each aux output gets its own logits
    conv (``logits_conv_1``, ...), and with ``use_aux_head_endpoints`` the
    aux outputs the head does not return come from the backbone's
    endpoints, counted from the end: aux output ``k`` reads
    ``endpoints[-(k + 1)]`` (for HRNet the os32 branch). More than one
    output returns ``{"output_0": main, "output_1": ...}``.

    Input routing: ``x`` may be the image ``[N, H, W, 3]``, a dict
    ``{"image", "label"}`` or an ``(image, label)`` tuple; with
    ``head_use_label_input`` the head is called with ``label=`` (the
    ``[N, H, W]`` map, or None) and with ``head_use_image_input`` with
    ``image=`` (the NCHW view of the input image, before any cast).
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
        self.backbone = backbone
        self.head = head
        self.use_aux_head_endpoints = use_aux_head_endpoints
        self.upsample_logits = upsample_logits
        self.head_use_label_input = head_use_label_input
        self.head_use_image_input = head_use_image_input
        widths = self._output_widths()
        self.logits_conv = Conv2d(widths[0], num_class, 1, bias=True)
        for i, ch in enumerate(widths[1:], start=1):
            self.add_module(f"logits_conv_{i}", Conv2d(ch, num_class, 1, bias=True))
        self.num_outputs = len(widths)

    def _output_widths(self) -> list[int]:
        """Input widths of the logits convs: the head's outputs, then the
        aux outputs taken from the backbone's endpoints."""
        feat = self.head if self.head is not None else self.backbone
        widths = feat.out_channels if feat is not None else 3
        widths = list(widths) if isinstance(widths, (list, tuple)) else [widths]
        while self.use_aux_head_endpoints and len(widths) < 1 + self.num_aux_loss:
            endpoint_channels = getattr(self.backbone, "endpoint_channels", None)
            if endpoint_channels is None or len(widths) + 1 > len(endpoint_channels):
                raise ValueError(f"aux output {len(widths)} reads backbone endpoint "
                                 f"-{len(widths) + 1}, which the backbone does not have")
            widths.append(endpoint_channels[-(len(widths) + 1)])
        return widths[: 1 + self.num_aux_loss]

    def forward(self, x):
        label = None
        if isinstance(x, dict):
            label = x.get("label")
            x = x["image"]
        elif isinstance(x, (tuple, list)):
            x, label = x[0], (x[1] if len(x) > 1 else None)
        inputs_hw = (x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels_last memory)
        feats = self.backbone(x) if self.backbone is not None else x
        endpoints = feats if isinstance(feats, (list, tuple)) else [feats]
        if self.head is not None:
            head_kwargs = {}
            if self.head_use_label_input:
                head_kwargs["label"] = label
            if self.head_use_image_input:
                head_kwargs["image"] = x
            head_out = self.head(endpoints, **head_kwargs)
        else:
            head_out = endpoints[-1]
        head_outs = list(head_out) if isinstance(head_out, (list, tuple)) else [head_out]
        while self.use_aux_head_endpoints and len(head_outs) < 1 + self.num_aux_loss:
            head_outs.append(endpoints[-(len(head_outs) + 1)])

        logits_list = []
        for i, h in enumerate(head_outs[: self.num_outputs]):
            logits = self._modules[f"logits_conv_{i}" if i else "logits_conv"](h)
            # NCHW -> NHWC (a view when logits are channels_last), the
            # half-pixel upsample by interpolation matrices, the fp32 cast
            logits = logits.permute(0, 2, 3, 1)
            if self.upsample_logits:
                logits = resize_bilinear_matmul(logits, inputs_hw, align_corners=False)
            logits_list.append(logits.to(torch.float32).contiguous())
        if len(logits_list) == 1:
            return logits_list[0]
        return {f"output_{i}": v for i, v in enumerate(logits_list)}
