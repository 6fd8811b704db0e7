"""Mixture-of-Experts feed-forward with expert parallelism (counterpart of
``iseg_tpu/nn/moe.py``; no model of either package uses it).

The GShard/Switch einsum formulation: routing builds dense ``[tokens,
experts, capacity]`` combine and dispatch tensors, and the experts are
einsums of static shape.

* top-k routing: k = 1 Switch (the raw router probability is the gate, so
  the router gets a task gradient) or k >= 2 GShard (gates renormalized over
  the selected k);
* a fixed capacity per expert, ``ceil(capacity_factor * k * tokens /
  experts)``; tokens past it are dropped (combine weight zero), earlier
  tokens first;
* the Switch load-balance loss ``E * sum_e f_e * P_e``, returned beside the
  output.

Expert parallelism (``expert_axis`` of ``mesh``): each of the axis's ``n``
ranks holds ``E / n`` experts' ``w1`` / ``w2`` and runs them on the tokens
dispatched to its experts; the router is replicated. The partial outputs
meet in one all-reduce over the axis: the sum GSPMD makes of the JAX
package's expert-sharded einsums. The tokens and the combine weights enter
the expert computation through ``copy_to`` (each rank uses its own experts'
share of them), so their gradients, and through them the router's, are
whole on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.parallel import collectives as C
from iseg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

__all__ = ["MoEFeedForward", "topk_dispatch", "shard_experts"]


def topk_dispatch(probs: torch.Tensor, k: int, capacity: int):
    """Combine and dispatch tensors from router probabilities.

    probs ``[G, E]``. Returns ``(combine [G, E, C] float, dispatch [G, E, C]
    bool, aux_loss scalar)``. Ties in the argmax go to the lower expert;
    within an expert, earlier tokens take the capacity slots first."""
    g, e = probs.shape
    # the load-balance loss reads the pre-selection distribution: f_e from
    # the top-1 assignment, P_e the mean router probability (Switch eq. 4)
    top1 = torch.argmax(probs, dim=-1)
    f = F.one_hot(top1, e).to(probs.dtype).mean(dim=0)
    aux = e * torch.sum(f * probs.mean(dim=0))

    remaining = probs
    counts = torch.zeros((e,), dtype=torch.long, device=probs.device)
    gates, idxs, poss = [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)  # [G]; the first maximum
        gate = torch.gather(remaining, 1, idx[:, None])[:, 0]
        mask = F.one_hot(idx, e)  # [G, E]
        # each token's place in its expert's queue
        pos = ((torch.cumsum(mask, dim=0) - 1) * mask).sum(dim=1) + counts[idx]
        counts = counts + mask.sum(dim=0)
        gates.append(gate)
        idxs.append(idx)
        poss.append(pos)
        remaining = remaining * (1 - mask.to(remaining.dtype))

    gate_stack = torch.stack(gates, dim=1)  # [G, k]
    if k > 1:  # GShard: renormalize over the selected k
        gate_stack = gate_stack / torch.clamp(gate_stack.sum(dim=1, keepdim=True), min=1e-9)
    # k == 1 keeps the raw router probability (Switch eq. 2): renormalizing
    # one gate gives the constant 1 and cuts the router's task gradient

    combine = torch.zeros((g, e, capacity), dtype=probs.dtype, device=probs.device)
    for i in range(k):
        keep = (poss[i] < capacity).to(probs.dtype)
        onehot_e = F.one_hot(idxs[i], e).to(probs.dtype)
        # a dropped token's slot index is out of range: its one-hot is zero
        onehot_c = F.one_hot(torch.clamp(poss[i], max=capacity), capacity + 1)[:, :capacity]
        combine = combine + ((gate_stack[:, i] * keep)[:, None, None]
                             * onehot_e[:, :, None] * onehot_c.to(probs.dtype)[:, None, :])
    return combine, combine > 0, aux


class MoEFeedForward(nn.Module):
    """Top-k routed GeLU (tanh) MLP over the last axis: ``[..., D]`` ->
    ``(output [..., D], aux_loss)``.

    Parameters, in the flax layout and names: ``router [D, E]``, ``w1 [E, D,
    d_ff]``, ``w2 [E, d_ff, D]``. With ``expert_axis`` of ``mesh`` this rank
    holds experts ``[r * E / n, (r + 1) * E / n)`` of ``w1`` / ``w2``
    (:func:`shard_experts` cuts full weights). ``dtype`` is the experts'
    compute type (None: the input's); the router runs in fp32. The values
    are left uninitialized: load them (``convert.load_flax``).
    """

    def __init__(self, dim: int, num_experts: int, d_ff: int, k: int = 2,
                 capacity_factor: float = 1.25, expert_axis: Optional[str] = None, mesh=None,
                 dtype=None, param_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_experts, self.d_ff, self.k = num_experts, d_ff, k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        n = axis_size(mesh, expert_axis) if expert_axis is not None else 1
        if num_experts % n:
            raise ValueError(f"{num_experts} experts should be divisible by the "
                             f"{expert_axis!r} axis size {n}")
        self.group = axis_group(mesh, expert_axis) if n > 1 else None
        self.local_experts = num_experts // n
        self.first_expert = (axis_rank(mesh, expert_axis) if n > 1 else 0) * self.local_experts
        device = resolve_device(device)
        kw = dict(dtype=param_dtype, device=device)
        self.router = nn.Parameter(torch.empty((dim, num_experts), **kw))
        self.w1 = nn.Parameter(torch.empty((self.local_experts, dim, d_ff), **kw))
        self.w2 = nn.Parameter(torch.empty((self.local_experts, d_ff, dim), **kw))

    def forward(self, x: torch.Tensor):
        shape = x.shape
        xt = x.reshape(-1, shape[-1])
        g, e = xt.shape[0], self.num_experts
        capacity = max(1, math.ceil(self.capacity_factor * self.k * g / e))
        # the router in fp32: routing decisions are precision-sensitive
        probs = torch.softmax(xt.float() @ self.router.float(), dim=-1)
        combine, dispatch, aux = topk_dispatch(probs, self.k, capacity)
        cdtype = self.dtype or xt.dtype
        lo, hi = self.first_expert, self.first_expert + self.local_experts
        combine = C.copy_to(combine.to(cdtype), self.group)[:, lo:hi]
        xe = torch.einsum("gec,gd->ecd", dispatch[:, lo:hi].to(cdtype),
                          C.copy_to(xt.to(cdtype), self.group))
        h = F.gelu(torch.einsum("ecd,edf->ecf", xe, self.w1.to(cdtype)), approximate="tanh")
        ye = torch.einsum("ecf,efd->ecd", h, self.w2.to(cdtype))
        y = C.reduce_from(torch.einsum("gec,ecd->gd", combine, ye), self.group)
        return y.reshape(shape).to(x.dtype), aux


def shard_experts(params: dict, mesh, expert_axis: str) -> dict:
    """This rank's share of a full MoE params tree (``router``, ``w1``,
    ``w2``): ``w1`` / ``w2`` cut on the expert axis, the router whole."""
    n, r = axis_size(mesh, expert_axis), axis_rank(mesh, expert_axis)
    out = dict(params)
    for name in ("w1", "w2"):
        per = params[name].shape[0] // n
        out[name] = params[name][r * per:(r + 1) * per]
    return out
