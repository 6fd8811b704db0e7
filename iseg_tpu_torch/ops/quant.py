"""int8 quantization and the dense and embedding layers of the Gemma path.

Counterpart of ``iseg_tpu/ops/quant.py``. Two int8 serving schemes, both
on nested ``{name: tensor}`` trees in the flax layout (the port's
counterpart of a flax params tree: :func:`iseg_tpu_torch.convert.flax_tree`
gives one of a module, :func:`iseg_tpu_torch.convert.load_flax` loads one):

* **weight-only** (:func:`quantize_tree`): every leaf with ``ndim >= 2`` and
  ``numel >= min_size`` becomes a :class:`QTensor`, int8 with symmetric
  scales over its last flax axis, the scale rounded to ``dtype`` first so
  that quantizing and dequantizing share it; smaller float leaves are cast
  to ``dtype``. A model loaded with such a tree keeps int8 + scale and
  dequantizes each weight where it is used (``QuantDense`` /
  ``QuantEmbed``), to the layer's ``dtype`` or bfloat16, as
  :func:`dequantize_tree` does: no dense copy of the weights stays resident.
* **W8A8** (:func:`quantize_dense_tree`): int8 ``kernel`` with a
  per-output-channel ``kernel_scale`` and int8 ``embedding`` with a
  per-vocabulary-row ``embedding_scale``; the products take int8
  activations quantized per row on the fly (:func:`dynamic_int8_dot`).

The int8 x int8 -> int32 product of :func:`dynamic_int8_dot` is
``torch._int_mm`` (cuBLASLt's int8 GEMM on CUDA). In the JAX package it is
an XLA ``dot_general`` with ``preferred_element_type=int32``, not a Pallas
kernel, so like the other plain products of the JAX package it is a
library call here. On CUDA ``torch._int_mm`` needs more than 16 rows and
``K``, ``N`` multiples of 8: :func:`padded_int_mm` pads fewer rows with
zero rows and ``K``, ``N`` with zeros up to multiples of 8, and the padded
outputs are dropped; zeros add nothing to the exact int32 sums, so any ``K``
and ``N`` give the JAX function's values bit for bit.

The layers allocate their weights on ``device`` when they are built (a
model of billions of parameters is built on the card): ``"cuda"`` by
default, which raises where there is no card; the CPU only when the caller
names it.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.core.env import resolve_device

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: "self.size(0) needs to be greater than 16"
INT_MM_MULTIPLE = 8  # torch._int_mm on CUDA: K and N multiples of 8


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` by a true division on every device: PyTorch's CUDA
    kernel multiplies by the reciprocal of a Python-scalar divisor, which
    can land an ulp away from the CPU's quotient and the JAX package's, and
    move a rounded int8 value; a tensor divisor divides."""
    return x / x.new_full((), 127.0)


class QTensor(NamedTuple):
    """int8 data + symmetric scales over the last axis (weight-only)."""

    q: torch.Tensor  # int8, the original weight's shape
    scale: torch.Tensor  # the original shape's last axis, in the storage dtype


def _tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)


def quantize_tree(params, min_size: int = 4096, dtype: torch.dtype = torch.bfloat16):
    """Weight-only int8: every leaf with ``ndim >= 2`` and ``numel >=
    min_size`` becomes a :class:`QTensor` with per-last-axis symmetric
    scales; smaller float leaves are cast to ``dtype``, integer ones kept."""

    def quantize(w):
        w = _as_tensor(w)
        if w.ndim >= 2 and w.numel() >= min_size:
            wf = w.float()
            absmax = wf.abs().amax(dim=tuple(range(w.ndim - 1)))
            # the scale is rounded to its storage type FIRST, so quantizing and
            # dequantizing share it (the error stays within half a step)
            scale = _over_127(absmax.clamp_min(1e-8)).to(dtype)
            q = torch.clamp(torch.round(wf / scale.float()), -127, 127)
            return QTensor(q.to(torch.int8), scale)
        return w.to(dtype) if w.is_floating_point() else w

    return _tree_map(quantize, params)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``q * scale`` in ``dtype`` (both cast first), broadcasting the scale."""
    return q.to(dtype) * scale.to(dtype)


def dequantize_tree(params, dtype: torch.dtype = torch.bfloat16):
    """A dense tree from a quantized one (:class:`QTensor` leaves rebuilt in
    ``dtype``, the rest as they are). The JAX function's ``barrier`` keeps
    XLA from hoisting the dequantize out of its decode scan; eager PyTorch
    hoists nothing, and the layers dequantize per use anyway."""

    def rebuild(leaf):
        return dequantize(leaf.q, leaf.scale, dtype) if isinstance(leaf, QTensor) else leaf

    return _tree_map(rebuild, params)


def is_quantized(params) -> bool:
    """Whether the tree holds a :class:`QTensor` leaf."""
    if isinstance(params, QTensor):
        return True
    if isinstance(params, Mapping):
        return any(is_quantized(v) for v in params.values())
    return False


# ---------------------------------------------------------------------------
# W8A8: int8 weights and per-row dynamically quantized activations
# ---------------------------------------------------------------------------

def padded_int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of ``x_q [M, K]`` and ``w_q [K, N]`` padded with
    zeros to what it takes on CUDA: at least 17 rows, ``K`` (``x_q``'s
    columns and ``w_q``'s rows) and ``N`` (``w_q``'s columns) multiples of 8;
    the padded outputs are dropped. The padded terms are zeros in exact int32
    sums, so the ``[M, N]`` result is the unpadded product's. A column-major
    ``w_q`` (the layers pass their ``[N, K]`` weight transposed) stays
    column-major. Runs on any device."""
    m, k = x_q.shape
    n = w_q.shape[1]
    kp = -(-k // INT_MM_MULTIPLE) * INT_MM_MULTIPLE
    np_ = -(-n // INT_MM_MULTIPLE) * INT_MM_MULTIPLE
    if kp != k or m < INT_MM_MIN_ROWS:
        x_q = F.pad(x_q, (0, kp - k, 0, max(0, INT_MM_MIN_ROWS - m)))
    if kp != k or np_ != n:
        if w_q.stride(0) == 1 and w_q.stride(1) != 1:
            w_q = F.pad(w_q.t(), (0, kp - k, 0, np_ - n)).t()
        else:
            w_q = F.pad(w_q, (0, np_ - n, 0, kp - k))
    return torch._int_mm(x_q, w_q)[:m, :n]


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``[M, K] int8 @ [K, N] int8 -> [M, N] int32`` by ``torch._int_mm``,
    through :func:`padded_int_mm` on CUDA (a decode step at batch 8 has 8
    rows, EVA02-L's SwiGLU width is 2730); the sums are exact integers
    either way."""
    if x_q.device.type == "cuda":
        return padded_int_mm(x_q, w_q)
    return torch._int_mm(x_q, w_q)


def dynamic_int8_dot(x2: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` float @ ``[K, N]`` int8 -> ``[M, N]`` float32.

    Per-row dynamic activation scales (``max |x|`` floored at 1e-8, over
    127; round half to even, clip to +-127) and per-column weight scales;
    the product is int8 x int8 -> int32, so the epilogue ``acc * sx *
    w_scale`` (in that order) gives the JAX function's values bit for bit."""
    xf = x2.float()
    sx = _over_127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8))
    x_q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = int8_matmul(x_q, w_q)
    return acc.float() * sx * w_scale.float()[None, :]


def _as_tuple(v) -> tuple[int, ...]:
    return (int(v),) if isinstance(v, int) else tuple(int(i) for i in v)


def _set_int8(module: nn.Module, name: str, q: torch.Tensor, scale_name: str,
              scale: torch.Tensor) -> None:
    """Replace the float weight ``name`` by int8 ``q`` (no gradient) and
    set the scale buffer ``scale_name`` (None drops it)."""
    old = getattr(module, name)
    if tuple(q.shape) != tuple(old.shape):
        raise ValueError(f"int8 {name} {tuple(q.shape)} for a weight of {tuple(old.shape)}")
    setattr(module, name, nn.Parameter(q.to(device=old.device, dtype=torch.int8),
                                       requires_grad=False))
    module.register_buffer(scale_name, None if scale is None else scale.to(old.device))


class QuantDense(nn.Module):
    """``DenseGeneral`` over trailing contraction axes, with the two int8
    paths.

    ``contract`` is the shape of the input's trailing axes that are summed
    over (flax infers it from the input; a torch module needs it up front)
    and ``features`` the shape that replaces them; each an int or a tuple.
    The flax ``kernel`` has shape ``(*contract, *features)``; it is stored
    here as ``weight [prod(features), prod(contract)]``, the layout of
    ``F.linear`` (:mod:`iseg_tpu_torch.convert` reshapes and transposes).

    * float ``weight``: ``kernel_scale`` (ones, shape ``features``) is
      carried and not applied, as in the JAX package;
    * int8 ``weight`` with ``weight_scale`` (weight-only, shape
      ``features[-1:]``: :func:`quantize_tree`'s last flax axis): the weight
      is dequantized to ``dtype`` or bfloat16 for each call, then the float
      path;
    * int8 ``weight`` without it (W8A8): :func:`dynamic_int8_dot` against
      the per-output-channel ``kernel_scale``.

    ``dtype`` is the compute and output type; None computes in the promoted
    type of input and weight and returns the input's type.
    """

    def __init__(self, contract, features, use_bias: bool = False, dtype=None,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.contract = _as_tuple(contract)
        self.features = _as_tuple(features)
        self.dtype = dtype
        device = resolve_device(device)
        k_dim, n_dim = math.prod(self.contract), math.prod(self.features)
        self.weight = nn.Parameter(torch.empty((n_dim, k_dim), dtype=param_dtype, device=device))
        self.register_buffer("kernel_scale",
                             torch.ones(self.features, dtype=torch.float32, device=device))
        self.register_buffer("weight_scale", None)
        self.bias = (nn.Parameter(torch.zeros(self.features, dtype=param_dtype, device=device))
                     if use_bias else None)

    def set_int8(self, q: torch.Tensor, weight_scale: torch.Tensor | None = None) -> None:
        """Hold int8 ``q`` (``weight``'s layout): weight-only with
        ``weight_scale``, else W8A8 with ``kernel_scale``."""
        _set_int8(self, "weight", q, "weight_scale", weight_scale)

    def dense_weight(self) -> torch.Tensor:
        """The float weight: the parameter, or the weight-only int8 weight
        dequantized to ``dtype`` or bfloat16 (made anew on each call)."""
        w = self.weight
        if w.dtype != torch.int8:
            return w
        if self.weight_scale is None:
            raise ValueError("a W8A8 QuantDense has no dense weight")
        wq = w.view(*self.features, w.shape[1])
        return dequantize(wq, self.weight_scale[:, None], self.dtype or torch.bfloat16
                          ).view(w.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_axes = len(self.contract)
        if tuple(x.shape[-n_axes:]) != self.contract:
            raise ValueError(f"QuantDense: input {tuple(x.shape)} does not end in "
                             f"{self.contract}")
        lead = x.shape[:-n_axes]
        x2 = x.reshape(-1, self.weight.shape[1])
        out_dtype = self.dtype or x.dtype
        if self.weight.dtype == torch.int8 and self.weight_scale is None:
            y2 = dynamic_int8_dot(x2, self.weight.t(), self.kernel_scale.reshape(-1))
        else:
            w = self.dense_weight()
            cdtype = self.dtype or torch.promote_types(x.dtype, w.dtype)
            y2 = F.linear(x2.to(cdtype), w.to(cdtype))
        y = y2.reshape(*lead, *self.features).to(out_dtype)
        if self.bias is not None:
            y = y + self.bias.to(out_dtype)
        return y


class QuantEmbed(nn.Module):
    """Tied embedding: ``forward`` looks rows up, ``attend`` is the readout
    against the whole table in fp32.

    ``embedding [V, D]`` plus ``embedding_scale [V]`` (ones, carried and not
    applied on the float path). int8 tables:

    * weight-only (``weight_scale [D]``, per column: :func:`quantize_tree`'s
      last axis): rows and readout dequantize the table through ``dtype`` or
      bfloat16, as the JAX package's ``dequantize_tree`` does, then fp32 for
      the readout, in transient copies that no call keeps (at Gemma's 256000
      x 2048 table that writes 1.05 GB of bf16 and 2.1 GB of fp32 on every
      decode step: the price of holding the table in int8; a kept fp32 copy
      would be a dense table resident beside the int8 one);
    * W8A8 (``embedding_scale`` real, per row): rows are ``q * scale`` in the
      output type, the readout is :func:`dynamic_int8_dot`.

    ``attend`` of a float table multiplies fp32 hidden states by the table
    cast to fp32. With a table stored in another type that cast would write
    a ``[V, D]`` fp32 copy on every call, so, where no gradient is being
    recorded, one fp32 copy is kept and made anew only after the table has
    changed. It gives the numbers of the cast.
    """

    def __init__(self, num_embeddings: int, features: int, dtype=None,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_embeddings, self.features = num_embeddings, features
        self.dtype, self.param_dtype = dtype, param_dtype
        device = resolve_device(device)
        self.embedding = nn.Parameter(
            torch.empty((num_embeddings, features), dtype=param_dtype, device=device))
        self.register_buffer("embedding_scale",
                             torch.ones((num_embeddings,), dtype=torch.float32, device=device))
        self.register_buffer("weight_scale", None)
        self._table_f32: torch.Tensor | None = None
        self._table_f32_of: tuple | None = None

    def set_int8(self, q: torch.Tensor, weight_scale: torch.Tensor | None = None) -> None:
        """Hold an int8 table: weight-only with ``weight_scale`` ``[D]``,
        else W8A8 with ``embedding_scale`` ``[V]``."""
        _set_int8(self, "embedding", q, "weight_scale", weight_scale)
        self._table_f32 = self._table_f32_of = None

    def _dequant_dtype(self) -> torch.dtype:
        return self.dtype or torch.bfloat16

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embedding
        rows = F.embedding(ids, table)
        if table.dtype != torch.int8:
            return rows.to(self.dtype or table.dtype)
        if self.weight_scale is not None:  # the dequantized table's rows
            return dequantize(rows, self.weight_scale, self._dequant_dtype())
        out_dtype = self.dtype or self.param_dtype
        return rows.to(out_dtype) * self.embedding_scale[ids].to(out_dtype)[..., None]

    def _fp32_table(self) -> torch.Tensor:
        table = self.embedding
        if table.dtype == torch.float32:
            return table
        if torch.is_grad_enabled() and table.requires_grad:
            return table.float()  # recorded by autograd: the transient cast
        stamp = (table.data_ptr(), table._version, table.device, table.dtype)
        if self._table_f32_of != stamp:
            # a plain tensor even when called under inference_mode, so that a
            # later call outside it can still use the copy
            with torch.inference_mode(False), torch.no_grad():
                self._table_f32 = table.detach().float()
            self._table_f32_of = stamp
        return self._table_f32

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden ``[..., D]`` -> fp32 logits ``[..., V]`` against the table."""
        lead = hidden.shape[:-1]
        h2 = hidden.reshape(-1, self.features)
        table = self.embedding
        if table.dtype != torch.int8:
            y2 = F.linear(h2.float(), self._fp32_table())
        elif self.weight_scale is None:
            y2 = dynamic_int8_dot(h2, table.t(), self.embedding_scale)
        else:  # transient copies, dropped after the product
            table = dequantize(table, self.weight_scale, self._dequant_dtype())
            y2 = F.linear(h2.float(), table.float())
        return y2.reshape(*lead, self.num_embeddings)

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .half() replace the table: drop the fp32 copy
        self._table_f32 = self._table_f32_of = None
        return super()._apply(fn, *args, **kwargs)


def quantize_dense_tree(params, dtype: torch.dtype = torch.bfloat16):
    """W8A8: every ``kernel`` beside a ``kernel_scale`` becomes int8 with a
    per-output-channel fp32 scale (the max over all contraction axes), every
    ``embedding`` beside an ``embedding_scale`` int8 with a per-row fp32
    scale; every other float leaf is cast to ``dtype``."""

    def quantized(w, reduce_axes, scale_shape):
        wf = _as_tensor(w).float()
        scale = _over_127(wf.abs().amax(dim=reduce_axes).clamp_min(1e-8))
        q = torch.clamp(torch.round(wf / scale.view(scale_shape)), -127, 127)
        return q.to(torch.int8), scale

    def walk(node):
        if isinstance(node, Mapping):
            out = dict(node)
            if "embedding" in node and "embedding_scale" in node:
                out["embedding"], out["embedding_scale"] = quantized(
                    node["embedding"], (-1,), (-1, 1))
                done = ("embedding", "embedding_scale")
            elif "kernel" in node and "kernel_scale" in node:
                w, feats = _as_tensor(node["kernel"]), tuple(node["kernel_scale"].shape)
                out["kernel"], out["kernel_scale"] = quantized(
                    w, tuple(range(w.ndim - len(feats))), feats)
                done = ("kernel", "kernel_scale")
            else:
                done = ()
            return {k: v if k in done else walk(v) for k, v in out.items()}
        node = _as_tensor(node)
        return node.to(dtype) if node.is_floating_point() else node

    return walk(params)
