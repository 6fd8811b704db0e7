"""Serving export: a ready-to-run inference artifact (counterpart of
``iseg_tpu/core/export.py``).

:func:`export_inference` traces the model's inference function with
``torch.export`` (weights inside the artifact) and writes a ``.pt2``
archive (``torch.export.save``); :func:`load_exported` loads it
(``torch.export.load``) and returns ``fn(images)``, batch-polymorphic by
default::

    blob = export_inference(model, None, input_hw=(512, 512), path="model.pt2")
    serve_fn = load_exported("model.pt2")  # no model code
    logits = serve_fn(images)  # [N, H, W, 3] -> [N, H, W, C], any N

Covers: logits / softmax probs / argmax labels (int32), multi-scale + flip
averaging, sliding windows, int8 weights and a symbolic batch dimension.

What an artifact needs beside torch is the operators its graph calls that
torch does not have: the serving forwards of the hand-written kernels,
``iseg::window_attention_fwd`` and ``iseg::dense_local_fwd``, registered by
the modules in :data:`SERVING_OP_MODULES` (they import torch alone and build
their CUDA sources on first launch). :func:`load_exported` imports those two
modules and no backbone, head or other model code.

Traps, and what is done about them:

* **autocast**: the live bf16 serve runs the model under
  ``torch.autocast(bfloat16)`` with fp32 weights. ``compute_dtype`` puts the
  same autocast region inside the exported function; ``torch.export``
  records it as a ``wrap_with_autocast`` node around the traced ops, and
  the loaded program enters autocast again when it runs, so every op
  computes in the type the live serve computes it in (fp32 weights cast
  per op, BN and softmax in fp32);
* **the graph's size**: tracing and loading take time in proportion to
  the traced ops (Swin-L's forward is a few thousand), so each scale's flip
  pair runs as one forward at double batch (``flip_in_batch``: half the
  graph, the same logits up to the order of fp32 sums);
* **batch 1 specializes**: a batch-polymorphic artifact is traced at batch
  2 with ``Dim("batch", min=1)`` and serves any batch;
* **caches made during tracing**: the interpolation matrices and Swin's
  shift masks are cached on first use; one eager call before tracing fills
  the caches with real tensors, which the trace takes as constants (a
  cache filled during tracing would hold fake tensors);
* **the kernels**: where no gradient is recorded, window attention and
  dense-local sampling call their operators, whose fake versions give the
  trace shapes and strides; their checks that read addresses run inside.

The model holds its own weights (the port's calling convention), so
``variables`` may be None; a flax tree there is loaded into the model first
(:func:`iseg_tpu_torch.convert.load_flax`), as the JAX function takes its
``variables``. With ``int8_weights`` the artifact holds the JAX package's
``quantize_tree`` of the flax ``params`` (int8 + per-last-flax-axis scales
for every leaf of 4096 values or more, bfloat16 for the rest; the batch
statistics as they are) and dequantizes inside the graph: ``q * scale``
in fp32, then the model's parameter type, so the model computes in its own
types with the rounded weights. fp32 and not bfloat16 for the product, as
the JAX artifact computes it: its ``dequantize_tree`` asks for a bfloat16
product, but XLA keeps the product's excess precision when it fuses it
into the consumers (on the CPU the JAX artifact lies 6.4e-3 of max |logit|
from the JAX model applied to ``dequantize_tree(qparams)`` at the test's
ResNet-9, and 6.5e-7 from the same model with the product in fp32).
"""

from __future__ import annotations

import importlib
import io
import os
from typing import Optional, Sequence, Union

import torch
from torch import nn

SERVING_OP_MODULES = ("iseg_tpu_torch.ops.kernels.window_attention",
                      "iseg_tpu_torch.ops.kernels.deform_local")
OUTPUTS = ("logits", "probs", "label")
_AUTOCAST_DTYPES = (torch.bfloat16, torch.float16)


def _main_output(outputs):
    if isinstance(outputs, (list, tuple)):
        return outputs[0]
    if isinstance(outputs, dict):
        return outputs.get("output_0", next(iter(outputs.values())))
    return outputs


class _Served(nn.Module):
    """The function an artifact holds. The model is not a submodule: its
    weights enter the artifact only as this module's buffers (int8 and
    scales with ``int8_weights``), and each call runs the model on them
    through ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module, output: str, scale_rates, flip: bool,
                 sliding_kwargs: dict, compute_dtype: torch.dtype, int8_weights: bool):
        super().__init__()
        self.__dict__["model"] = model
        self.output, self.flip, self.sliding_kwargs = output, flip, sliding_kwargs
        self.scale_rates = tuple(scale_rates) if scale_rates else None
        self.compute_dtype = compute_dtype
        # (model tensor name, buffer names, rebuild(buffers) -> the model's tensor)
        self.slots: list[tuple[str, tuple[str, ...], object]] = []
        names = {id(t): n for n, t in (*model.named_parameters(), *model.named_buffers())}
        covered = set()
        if int8_weights:
            covered = self._add_int8(model, names)
        for name, t in (*model.named_parameters(), *model.named_buffers()):
            if id(t) not in covered:
                self._add(name, (t.detach(),), lambda parts: parts[0])

    def _add(self, name: str, parts: tuple[torch.Tensor, ...], rebuild) -> None:
        keys = []
        for part in parts:
            keys.append(f"w{len(self._buffers)}")
            self.register_buffer(keys[-1], part)
        self.slots.append((name, tuple(keys), rebuild))

    def _add_int8(self, model: nn.Module, names: dict[int, str]) -> set[int]:
        """The flax ``params`` by ``quantize_tree``'s rule; returns the ids of
        the model's tensors they stand for."""
        from iseg_tpu_torch import convert
        from iseg_tpu_torch.ops.quant import QTensor, dequantize, quantize_tree

        covered = set()
        for col, path, tensor, to_flax, from_flax in convert._leaves(model):
            if col != "params":
                continue
            leaf = quantize_tree(to_flax(tensor.detach()))
            dtype = tensor.dtype
            if isinstance(leaf, QTensor):
                def rebuild(parts, from_flax=from_flax, dtype=dtype):
                    return from_flax(dequantize(parts[0], parts[1], torch.float32)).to(dtype)
                parts = (leaf.q, leaf.scale)
            else:
                def rebuild(parts, from_flax=from_flax, dtype=dtype):
                    return from_flax(parts[0]).to(dtype)
                parts = (leaf.contiguous(),)
            self._add(names[id(tensor)], parts, rebuild)
            covered.add(id(tensor))
        return covered

    def _weights(self) -> dict[str, torch.Tensor]:
        return {name: rebuild([self._buffers[k] for k in keys])
                for name, keys, rebuild in self.slots}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        from iseg_tpu_torch.core.inference import inference_fn, inference_with_multi_scales

        weights = self._weights()

        def apply_fn(x):
            return _main_output(torch.func.functional_call(self.model, weights, (x,)))

        with torch.autocast(images.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype in _AUTOCAST_DTYPES):
            if self.scale_rates or self.flip:
                logits = inference_with_multi_scales(
                    apply_fn, images, scale_rates=self.scale_rates or (1.0,), flip=self.flip,
                    flip_in_batch=True, **self.sliding_kwargs)
            else:
                logits = inference_fn(apply_fn, images, **self.sliding_kwargs)
        if self.output == "probs":
            return torch.softmax(logits.float(), dim=-1)
        if self.output == "label":
            return logits.argmax(dim=-1).to(torch.int32)
        return logits.float()


def export_inference(
    model: nn.Module,
    variables,
    input_hw: Sequence[int],
    *,
    channels: int = 3,
    output: str = "logits",
    batch_polymorphic: bool = True,
    scale_rates: Optional[Sequence[float]] = None,
    flip: bool = False,
    sliding_window_crop_size: Optional[Sequence[int]] = None,
    sliding_window_stride_rate: float = 2.0 / 3.0,
    int8_weights: bool = False,
    input_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.float32,
    path: Optional[Union[str, os.PathLike]] = None,
) -> bytes:
    """Serialize the model's inference function with its weights.

    Args:
      model: a ``SegManaged`` (or any module whose call returns logits, or
        a list or dict whose first entry is the main logits), on the device
        the artifact serves on; put in eval mode.
      variables: None (the model's own weights) or a flax tree to load
        into the model first.
      input_hw: static spatial size the artifact serves.
      output: "logits", "probs", or "label" (argmax int32).
      batch_polymorphic: serve any batch size (else batch 1).
      scale_rates / flip: multi-scale + flip logit averaging inside the
        artifact (:func:`iseg_tpu_torch.core.inference.inference_with_multi_scales`).
      sliding_window_crop_size / sliding_window_stride_rate: each pass by
        sliding window.
      int8_weights: int8 + scales inside the artifact (see the module note).
      compute_dtype: bfloat16 or float16 runs the model under that autocast,
        as the live serve does; float32 runs it as it is.
      path: also write the bytes to this file.

    Returns the bytes of the ``.pt2`` archive.
    """
    from iseg_tpu_torch import convert

    if output not in OUTPUTS:
        raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
    if variables is not None:
        convert.load_flax(model, variables)
    model.eval()
    sliding = {}
    if sliding_window_crop_size is not None:
        sliding = {"sliding_window_crop_size": tuple(sliding_window_crop_size),
                   "sliding_window_stride_rate": sliding_window_stride_rate}
    served = _Served(model, output, scale_rates, flip, sliding, compute_dtype, int8_weights)
    device = next(iter(served.buffers())).device
    h, w = int(input_hw[0]), int(input_hw[1])
    example = torch.zeros((2 if batch_polymorphic else 1, h, w, channels), dtype=input_dtype,
                          device=device)
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if batch_polymorphic else None
    with torch.no_grad():
        served(example)  # fills the model's caches with real tensors (module note)
        exported = torch.export.export(served, (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(blob_or_path: Union[bytes, str, os.PathLike]):
    """Load an artifact; returns ``fn(images) -> output``. Needs no model
    code: it imports the modules that register the kernels' operators
    (:data:`SERVING_OP_MODULES`). ``images`` (a tensor or an array) is moved
    to the artifact's device; the call runs under ``torch.inference_mode()``."""
    for name in SERVING_OP_MODULES:
        importlib.import_module(name)
    source = (blob_or_path if isinstance(blob_or_path, (str, os.PathLike))
              else io.BytesIO(bytes(blob_or_path)))
    exported = torch.export.load(source)
    module = exported.module()
    device = next(iter(exported.state_dict.values())).device

    def serve_fn(images):
        images = torch.as_tensor(images, device=device)
        with torch.inference_mode():
            return module(images)

    serve_fn.exported = exported
    return serve_fn
