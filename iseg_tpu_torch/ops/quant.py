"""Dense and embedding layers of the Gemma path, float subset.

Counterparts of ``iseg_tpu/ops/quant.py::QuantDense`` and ``QuantEmbed``.
The JAX layers carry a switchable int8 path (an int8 ``kernel`` or
``embedding`` with real per-channel scales). Only the float path is here:
the scales are kept as buffers of ones, so a flax tree converts whole in
both directions, and the float path does not apply them, as in the JAX
package. An int8 weight raises ``NotImplementedError``: the int8 serving
paths (``QTensor``, ``dynamic_int8_dot``, ``quantize_dense_tree``) are
ROADMAP queue 1 item 26.

Both layers allocate their weights on ``device`` when they are built (a
model of billions of parameters is built on the card): ``"cuda"`` by
default, which raises where there is no card; the CPU only when the caller
names it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.core.env import resolve_device

_INT8_MESSAGE = ("the int8 serving paths of ops/quant.py are not in the port yet "
                 "(ROADMAP queue 1 item 26); pass float weights")


def _as_tuple(v) -> tuple[int, ...]:
    return (int(v),) if isinstance(v, int) else tuple(int(i) for i in v)


class QuantDense(nn.Module):
    """``DenseGeneral`` over trailing contraction axes.

    ``contract`` is the shape of the input's trailing axes that are summed
    over (flax infers it from the input; a torch module needs it up front)
    and ``features`` the shape that replaces them; each an int or a tuple.
    The flax ``kernel`` has shape ``(*contract, *features)``; it is stored
    here as ``weight [prod(features), prod(contract)]``, the layout of
    ``F.linear`` (:mod:`iseg_tpu_torch.convert` reshapes and transposes).
    ``kernel_scale`` (ones, shape ``features``) is carried and not applied.

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
        self.bias = (nn.Parameter(torch.zeros(self.features, dtype=param_dtype, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == torch.int8:
            raise NotImplementedError(_INT8_MESSAGE)
        n_axes = len(self.contract)
        if tuple(x.shape[-n_axes:]) != self.contract:
            raise ValueError(f"QuantDense: input {tuple(x.shape)} does not end in "
                             f"{self.contract}")
        lead = x.shape[:-n_axes]
        cdtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y2 = F.linear(x.reshape(-1, self.weight.shape[1]).to(cdtype), self.weight.to(cdtype))
        out_dtype = self.dtype or x.dtype
        y = y2.reshape(*lead, *self.features).to(out_dtype)
        if self.bias is not None:
            y = y + self.bias.to(out_dtype)
        return y


class QuantEmbed(nn.Module):
    """Tied embedding: ``forward`` looks rows up, ``attend`` is the readout
    against the whole table in fp32.

    ``embedding [V, D]`` plus ``embedding_scale [V]`` (ones, carried and not
    applied on the float path). ``attend`` multiplies fp32 hidden states by
    the table cast to fp32. With a table stored in another type that cast
    would write a ``[V, D]`` fp32 copy on every call (2.1 GB for Gemma's
    256000 x 2048 table, once per decode step), so, where no gradient is
    being recorded, one fp32 copy is kept and made anew only after the
    table has changed. It gives the numbers of the cast.
    """

    def __init__(self, num_embeddings: int, features: int, dtype=None,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_embeddings, self.features = num_embeddings, features
        self.dtype = dtype
        device = resolve_device(device)
        self.embedding = nn.Parameter(
            torch.empty((num_embeddings, features), dtype=param_dtype, device=device))
        self.register_buffer("embedding_scale",
                             torch.ones((num_embeddings,), dtype=torch.float32, device=device))
        self._table_f32: torch.Tensor | None = None
        self._table_f32_of: tuple | None = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.embedding.dtype == torch.int8:
            raise NotImplementedError(_INT8_MESSAGE)
        return F.embedding(ids, self.embedding).to(self.dtype or self.embedding.dtype)

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
        if self.embedding.dtype == torch.int8:
            raise NotImplementedError(_INT8_MESSAGE)
        lead = hidden.shape[:-1]
        h2 = hidden.reshape(-1, self.features).float()
        return F.linear(h2, self._fp32_table()).reshape(*lead, self.num_embeddings)

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .half() replace the table: drop the fp32 copy
        self._table_f32 = self._table_f32_of = None
        return super()._apply(fn, *args, **kwargs)

