"""Attention layers over 2-D feature maps (counterpart of
``iseg_tpu/nn/attention.py``).

The modules take and return NHWC maps ``[N, H, W, C]``, as the JAX ones do:
they work on tokens, with their projections over the last axis.

Global attention is no Pallas kernel in the JAX package
(``jax.nn.dot_product_attention``, XLA). :func:`dot_product_attention` takes
one of five routes (:func:`attention_route`). On the card, a call that
records a gradient takes a hand-written pair whose backward adds in a fixed
order, so two runs of a train step end bit for bit equal, as in the JAX
package (cuDNN's and FlashAttention's backwards do not):

========================================================  ==============================
on the card, recording a gradient                         route
========================================================  ==============================
bf16 (or bf16 autocast) or float32, no mask, no bias or   ``"global"``: the global-
a bias that does not vary with the batch row (``[1, H,    attention kernels
T, S]``, with or without a gradient), a head dim that is  (:func:`global_kernel_attention`;
a multiple of 8 up to 128 (float32 with a bias: up to     ViT-L, EVA02-L, MOAT with or
64)                                                       without its relative bias)
a mask, a bias that varies with the batch row, or a head  ``"kernel"``: the streaming
dim up to 128 the global-attention kernels do not take    window-attention kernels
                                                          (:func:`kernel_attention`)
a head dim above 128, float16, float64                    ``"fixed"``
                                                          (:func:`plain_attention`)
========================================================  ==============================

The global-attention kernels tile queries and keys over blocks and split
the backward with no atomics (dbias, where the bias records a gradient, is
summed over the batch rows in increasing order), in bf16 or, for float32,
in split TF32 at fp32's precision; :func:`kernel_attention` lays the call
out as one window per batch row for the streaming kernels, which are built
with both a bias and a mask (a zero one standing in for a term the call
lacks); :func:`plain_attention` is the plain version in one type, whose
cuBLAS products add in a fixed order too.
A call that records none (serving, ``torch.export``) is
``F.scaled_dot_product_attention``; on the CPU it is the plain version,
:func:`dot_product_attention_reference` (einsum products, softmax in
``promote_types(dtype, float32)``), which the tests hold against the JAX
package. Where the JAX package casts to fp32
(softmax, attention logits, sampling offsets), the port casts to
``promote_types(dtype, float32)``: the same for bf16 and fp32, float64 kept
for float64.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.nn.conv import Conv2d
from iseg_tpu_torch.nn.dcn import _zero_init
from iseg_tpu_torch.ops.deform import bilinear_gather
from iseg_tpu_torch.ops.kernels import global_attention as ga
from iseg_tpu_torch.ops.kernels.window_attention import (_records_grad, forward_route,
                                                         window_attention)
from iseg_tpu_torch.ops.numerics import replace_non_finite


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def flatten_hw(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H*W, C]."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def get_attention(query: torch.Tensor, key: torch.Tensor, apply_scale: bool = False,
                  numeric_stable: bool = False) -> torch.Tensor:
    """Attention matrix ``softmax(Q Kᵀ)`` of ``[B, I, C]`` and ``[B, J, C]``
    (optionally scaled by 1/sqrt(C)); ``numeric_stable`` takes it in
    ``promote_types(dtype, float32)`` and casts back."""
    orig_dtype = query.dtype
    if numeric_stable:
        query = query.to(_compute_dtype(orig_dtype))
        key = key.to(query.dtype)
    logits = torch.einsum("bic,bjc->bij", query, key)
    if apply_scale:
        logits = logits / math.sqrt(query.shape[-1])
    attn = torch.softmax(logits, dim=-1)
    return attn.to(orig_dtype) if numeric_stable else attn


def dot_product_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    mask: Optional[torch.Tensor] = None,
                                    bias: Optional[torch.Tensor] = None,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain global attention, ``jax.nn.dot_product_attention``'s XLA path:
    ``[B, T, H, D]`` q and ``[B, S, H, D]`` k, v; logits and softmax in
    ``promote_types(dtype, float32)``; the logits scaled by ``scale``
    (default 1/sqrt(D)), plus ``bias``, a float broadcastable to ``[B, H,
    T, S]``; ``mask`` a boolean broadcastable to ``[B, H, T, S]`` (False:
    the logit becomes -0.7 of the type's max, so a fully masked row attends
    uniformly)."""
    ct = _compute_dtype(q.dtype)
    logits = torch.einsum("bthd,bshd->bhts", q.to(ct), k.to(ct))
    logits = logits / math.sqrt(q.shape[-1]) if scale is None else logits * scale
    if bias is not None:
        logits = logits + bias.to(ct)
    if mask is not None:
        logits = logits.masked_fill(~mask, -0.7 * torch.finfo(ct).max)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def sdpa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """:func:`dot_product_attention_reference` by one
    ``F.scaled_dot_product_attention`` call (the boolean mask as the same
    additive -0.7 of the type's max, added to ``bias`` in q's type)."""
    attn_mask = None
    if mask is not None:
        attn_mask = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(
            ~mask, -0.7 * torch.finfo(q.dtype).max)
    if bias is not None:
        bias = bias.to(q.dtype)
        attn_mask = bias if attn_mask is None else attn_mask + bias
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=attn_mask, scale=scale)
    return out.transpose(1, 2)


def _as_4d(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((1,) * (4 - t.ndim) + tuple(t.shape))


def _one_dtype(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.dtype:
    """The type q, k and v are attended in: under autocast the autocast
    type (the one SDPA computes in), else their promoted type."""
    if torch.is_autocast_enabled(q.device.type):
        return torch.get_autocast_dtype(q.device.type)
    return torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """:func:`dot_product_attention_reference` with q, k and v in one type
    (:func:`_one_dtype`) and autocast off inside, so that the logits and the
    softmax are in ``promote_types(type, float32)`` and the mask's fill fits
    them; the result is in that one type."""
    ct = _one_dtype(q, k, v)
    with torch.autocast(q.device.type, enabled=False):
        return dot_product_attention_reference(q.to(ct), k.to(ct), v.to(ct), mask, bias, scale)


def kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """:func:`dot_product_attention_reference`'s function through
    :func:`~iseg_tpu_torch.ops.kernels.window_attention.window_attention`
    (the kernels on the card, their plain version on the CPU), laid out as
    one window per batch row: q, k, v ``[B, T, H, D]`` (k, v ``[B, S, H,
    D]``) become ``[B, H, T, D]`` views, in one type (under autocast the
    autocast type, as SDPA computes; else their promoted type). A float
    ``bias`` that records a gradient and does not vary with B (MOAT's ``[1,
    H, S, S]``) is the kernel's ``[H, N, N]`` bias, and takes its gradient;
    any other additive term (a bias that needs none, a boolean ``mask`` as
    the same -0.7 of the type's max that the reference fills) is the
    kernel's ``[nW, N, N]`` mask, nW = B where it varies with the batch row.
    A term that varies by head folds the heads into the window axis (bnw = B
    H, one head); a gradient-taking bias that varies with B folds them into
    the head axis instead (bnw = 1, B H heads, every term in the bias). T
    != S pads the shorter side to N = max(T, S) with zeros, the padded keys
    masked with -inf and the padded query rows dropped. A row that the mask
    masks whole attends uniformly, as the reference's: its query, its bias
    row and its additive terms enter as zeros, so that its logits are 0 and
    nothing takes a gradient there (the reference replaces those logits; an
    additive mask alone would pass a gradient through them, and a row of
    fills alone would overflow the kernels' log2 scaling to -inf, and their
    softmax to NaN)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    ct = _one_dtype(q, k, v)
    lt = _compute_dtype(ct)  # the logits' type: the bias's and the mask's
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    n = max(t, s)
    grad_bias, extra = None, None  # [b or 1, h or 1, T, S] each
    if bias is not None:
        bias4 = _as_4d(bias).to(lt)
        if _records_grad(bias):
            grad_bias = bias4
        else:
            extra = bias4
    if mask is not None:
        m4 = _as_4d(mask)
        fill = torch.zeros(m4.shape, dtype=lt, device=q.device).masked_fill(
            ~m4, -0.7 * torch.finfo(lt).max)
        whole = ~m4.any(-1, keepdim=True)  # [b or 1, h or 1, T, 1]: rows masked whole
        extra = torch.where(whole, 0, fill if extra is None else extra + fill)
        q = q.masked_fill(whole.permute(0, 2, 1, 3), 0)
        if grad_bias is not None:
            grad_bias = torch.where(whole, 0, grad_bias)
    if s < n and extra is None:
        extra = torch.zeros((1, 1, t, s), dtype=lt, device=q.device)
    terms = []
    for term, pad in ((grad_bias, 0.0), (extra, -math.inf)):
        if term is not None:
            term = term.expand(*term.shape[:2], t, s)
            if s < n or t < n:  # padded keys masked, padded query rows zero
                term = F.pad(term, (0, n - s, 0, n - t), value=pad if s < n else 0.0)
        terms.append(term)
    grad_bias, extra = terms

    def heads_first(x, length):
        x = x.to(ct).permute(0, 2, 1, 3)
        if x.stride(-1) != 1:
            x = x.contiguous()
        return F.pad(x, (0, 0, 0, n - length)) if length < n else x

    qh, kh, vh = heads_first(q, t), heads_first(k, s), heads_first(v, s)
    varies_b = [x is not None and x.shape[0] > 1 for x in (grad_bias, extra)]
    varies_h = [x is not None and x.shape[1] > 1 for x in (grad_bias, extra)]
    if grad_bias is not None and (varies_b[0] or (varies_b[1] and varies_h[1])):
        # B H heads of one window: every term in the bias, which takes the gradient
        full = grad_bias if extra is None else grad_bias + extra
        kb = full.expand(b, h, n, n).reshape(b * h, n, n).contiguous()
        qh, kh, vh = (x.reshape(1, b * h, n, d) for x in (qh, kh, vh))
        out = window_attention(qh, kh, vh, kb, None, scale)
    elif grad_bias is None and varies_h[1]:
        # B H windows of one head: the terms as the mask, one a window
        km = extra.expand(b, h, n, n).reshape(b * h, n, n).contiguous()
        qh, kh, vh = (x.reshape(b * h, 1, n, d) for x in (qh, kh, vh))
        out = window_attention(qh, kh, vh, None, km, scale)
    else:
        kb = km = None
        if grad_bias is not None:
            full = grad_bias if extra is None or not varies_h[1] else grad_bias + extra
            kb = full[0].expand(h, n, n).contiguous()
            if varies_h[1]:
                extra = None  # in the bias
        if extra is not None:
            km = extra[:, 0].contiguous()
        out = window_attention(qh, kh, vh, kb, km, scale)
    return out.reshape(b, h, n, d)[:, :, :t].permute(0, 2, 1, 3)


def global_kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """:func:`dot_product_attention_reference`'s function without a mask
    through
    :func:`~iseg_tpu_torch.ops.kernels.global_attention.global_attention`
    (the kernels on the card, their plain version on the CPU): q, k, v
    ``[B, T, H, D]`` (k, v ``[B, S, H, D]``) in one type (:func:`_one_dtype`)
    and their own layout, views of a packed projection taken as they are
    (a copy only where a base or stride is not 16-byte aligned). ``bias``, a
    float that broadcasts to ``[1, H, T, S]`` (MOAT's ``relative_bias(...)
    [None]``), enters as ``[H, T, S]`` in the logits' type (fp32 for bf16; a
    broadcast view made contiguous once) and takes its gradient where it
    records one."""
    if mask is not None:
        raise ValueError("global_kernel_attention takes no mask; kernel_attention does")
    ct = _one_dtype(q, k, v)
    q, k, v = (x.to(ct) for x in (q, k, v))
    _, t, h, _ = q.shape
    s = k.shape[1]
    if bias is not None:
        bias4 = _as_4d(bias)
        if bias4.ndim != 4 or bias4.shape[0] != 1:
            raise ValueError(f"global_kernel_attention takes a bias that does not vary with "
                             f"the batch row, got {tuple(bias.shape)}; kernel_attention does")
        bias = bias4[0].to(_compute_dtype(ct)).expand(h, t, s)  # fp32 on the card
        if not bias.is_contiguous():
            bias = bias.contiguous()
    if q.is_cuda:
        q, k, v = (ga.as_aligned(x) for x in (q, k, v))
    return ga.global_attention(q, k, v, scale, bias)


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> str:
    """The route of :func:`dot_product_attention`. On the card, a call that
    records a gradient (of q, k, v or ``bias``) takes ``"global"``
    (:func:`global_kernel_attention`) where it has no mask, its bias (if
    any) broadcasts to ``[1, H, T, S]`` (does not vary with the batch row),
    and the global-attention kernels are built for its type and shape
    (bfloat16, by autocast or by q, k and v, or float32; ``D % 8 == 0``,
    ``D <= 128``, float32 with a bias ``D <= 64``: ``ga.takes``); else
    ``"kernel"`` (:func:`kernel_attention`) where the
    streaming window-attention kernels are built for its type and head dim
    (float32 or bfloat16, ``D <= 128``); else ``"fixed"``
    (:func:`plain_attention`). One that records none takes ``"sdpa"``
    (:func:`sdpa_attention`). On the CPU ``"plain"``
    (:func:`dot_product_attention_reference`)."""
    if not q.is_cuda:
        return "plain"
    if not _records_grad(q, k, v, bias):
        return "sdpa"
    ct = _one_dtype(q, k, v)
    b, t, h, d = q.shape
    bias_shape = None if bias is None else tuple(bias.shape)
    if mask is None and ga.takes(ct, b, h, t, k.shape[1], d, bias_shape):
        return "global"
    n = max(t, k.shape[1])
    built = forward_route(ct, n, d, False) == "stream"
    return "kernel" if built else "fixed"


_ROUTES = {"global": global_kernel_attention, "kernel": kernel_attention,
           "fixed": plain_attention, "sdpa": sdpa_attention,
           "plain": dot_product_attention_reference}


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          guard_numerics: bool = False,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``[B, N, H, D]`` q, k, v -> ``[B, N, H, D]`` by :func:`attention_route`:
    on the card where a gradient is recorded the global-attention kernels
    (bf16 or fp32, no mask, a bias shared by the batch rows or none), the
    window-attention kernels (or, at a shape
    neither is built for, :func:`plain_attention`), each with a fixed-order
    backward; :func:`sdpa_attention` on the card otherwise;
    :func:`dot_product_attention_reference` on the CPU; ``guard_numerics``
    replaces non-finite outputs."""
    attend = _ROUTES[attention_route(q, k, v, bias, mask)]
    out = attend(q, k, v, mask, bias=bias, scale=scale)
    return replace_non_finite(out) if guard_numerics else out


class MultiHeadSelfAttention2D(nn.Module):
    """MHSA over an NHWC map: flatten HW -> attention -> restore.
    ``in_channels`` is the map's width; ``filters`` the inner width
    (default ``in_channels``), ``out_filters`` the output's."""

    def __init__(self, in_channels: int, num_heads: int = 8, filters: Optional[int] = None,
                 out_filters: Optional[int] = None, use_bias: bool = True,
                 guard_numerics: bool = False):
        super().__init__()
        inner = filters or in_channels
        if inner % num_heads:
            raise ValueError(f"filters {inner} not divisible by heads {num_heads}")
        self.num_heads, self.inner, self.guard_numerics = num_heads, inner, guard_numerics
        self.out_channels = out_filters or in_channels
        self.qkv = nn.Linear(in_channels, 3 * inner, bias=use_bias)
        self.proj = nn.Linear(inner, self.out_channels, bias=use_bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, h, w, c = x.shape
        q, k, v = self.qkv(x.reshape(n, h * w, c)).view(
            n, h * w, 3, self.num_heads, self.inner // self.num_heads).unbind(2)
        out = dot_product_attention(q, k, v, mask=mask, guard_numerics=self.guard_numerics)
        return self.proj(out.reshape(n, h * w, self.inner)).reshape(n, h, w, self.out_channels)


class MultiHeadAxialAttention2D(nn.Module):
    """Axial attention: along H (each column a sequence), then along W
    (each row), each added to the map."""

    def __init__(self, in_channels: int, num_heads: int = 8, filters: Optional[int] = None,
                 guard_numerics: bool = False):
        super().__init__()
        inner = filters or in_channels
        if inner % num_heads:
            raise ValueError(f"filters {inner} not divisible by heads {num_heads}")
        self.num_heads, self.inner, self.guard_numerics = num_heads, inner, guard_numerics
        self.out_channels = in_channels
        for axis in ("h_axis", "w_axis"):
            self.add_module(f"{axis}_qkv", nn.Linear(in_channels, 3 * inner))
            self.add_module(f"{axis}_proj", nn.Linear(inner, in_channels))

    def _axial(self, seq: torch.Tensor, axis: str) -> torch.Tensor:
        b, l, _ = seq.shape
        q, k, v = self._modules[f"{axis}_qkv"](seq).view(
            b, l, 3, self.num_heads, self.inner // self.num_heads).unbind(2)
        out = dot_product_attention(q, k, v, guard_numerics=self.guard_numerics)
        return self._modules[f"{axis}_proj"](out.reshape(b, l, self.inner))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        xh = self._axial(x.transpose(1, 2).reshape(n * w, h, c), "h_axis")
        x = x + xh.reshape(n, w, h, c).transpose(1, 2)
        xw = self._axial(x.reshape(n * h, w, c), "w_axis")
        return x + xw.reshape(n, h, w, c)


class DeformableMultiHeadAttention2D(nn.Module):
    """Deformable-DETR-style sampled attention: each query predicts
    ``num_points`` sampling offsets and softmax weights per head; the
    values are sampled bilinearly there (:func:`bilinear_gather`, heads
    folded into the batch) and weight-summed, then projected and added to
    the map. The offset and weight layers start at zero."""

    def __init__(self, in_channels: int, num_heads: int = 8, num_points: int = 4,
                 filters: Optional[int] = None, offset_scale: float = 1.0):
        super().__init__()
        inner = filters or in_channels
        if inner % num_heads:
            raise ValueError(f"filters {inner} not divisible by heads {num_heads}")
        self.num_heads, self.num_points, self.inner = num_heads, num_points, inner
        self.offset_scale = offset_scale
        self.out_channels = in_channels
        self.value = nn.Linear(in_channels, inner)
        self.offsets = _zero_init(nn.Linear(in_channels, num_heads * num_points * 2))
        self.weights = _zero_init(nn.Linear(in_channels, num_heads * num_points))
        self.proj = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        g, p, d = self.num_heads, self.num_points, self.inner // self.num_heads
        ct = _compute_dtype(x.dtype)
        value = self.value(x)
        weights = torch.softmax(self.weights(x).reshape(n, h, w, g, p).to(ct), dim=-1)
        weights = weights.to(value.dtype)
        offsets = self.offsets(x).reshape(n, h, w, g, p, 2).to(ct) * self.offset_scale
        gy, gx = torch.meshgrid(torch.arange(h, dtype=ct, device=x.device),
                                torch.arange(w, dtype=ct, device=x.device), indexing="ij")
        coords = torch.stack([gy, gx], -1)[None, :, :, None, None, :] + offsets
        vg = value.reshape(n, h, w, g, d).permute(0, 3, 1, 2, 4).reshape(n * g, h, w, d)
        coords = coords.permute(0, 3, 1, 2, 4, 5).reshape(n * g, h * w * p, 2)
        sampled = bilinear_gather(vg, coords).reshape(n, g, h, w, p, d)
        out = torch.einsum("nghwpd,nhwgp->nhwgd", sampled, weights).reshape(n, h, w, g * d)
        return x + self.proj(out)


class SelfAttention2D(nn.Module):
    """Single-head non-local self-attention with 1x1 conv projections
    (``filters`` defaults to ``max(1, C // 8)``) and a learned scalar gate
    ``gamma`` that starts at zero."""

    def __init__(self, in_channels: int, filters: Optional[int] = None):
        super().__init__()
        inner = filters or max(1, in_channels // 8)
        self.inner = inner
        self.out_channels = in_channels
        self.q = Conv2d(in_channels, inner, 1, bias=True)
        self.k = Conv2d(in_channels, inner, 1, bias=True)
        self.v = Conv2d(in_channels, in_channels, 1, bias=True)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        xc = x.permute(0, 3, 1, 2)
        q = self.q(xc).permute(0, 2, 3, 1).reshape(n, h * w, self.inner)
        k = self.k(xc).permute(0, 2, 3, 1).reshape(n, h * w, self.inner)
        v = self.v(xc).permute(0, 2, 3, 1).reshape(n, h * w, c)
        logits = torch.einsum("bic,bjc->bij", q, k).to(_compute_dtype(x.dtype))
        attn = torch.softmax(logits / math.sqrt(self.inner), dim=-1).to(x.dtype)
        out = torch.einsum("bij,bjc->bic", attn, v).reshape(n, h, w, c)
        return x + self.gamma * out
