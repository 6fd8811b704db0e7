"""Gemma backbone: embedding, decoder blocks (RoPE + GQA attention, GeGLU
FFN, RMSNorm), final norm.

Counterpart of ``iseg_tpu/nlp/gemma/model.py``, with its layouts: hidden
states ``[B, T, D]``, heads ``[B, T, H, d]``, and the KV cache as one stack
``[B, L, 2, S, kv_heads, head_dim]`` that threads through the blocks. The
sequence-parallel arguments of the JAX modules (``seq_axis``, ``data_axis``,
``sp_mode``) are not here (ROADMAP queue 1 item 25b).

What differs from the JAX package, which is functional:

* the cache is written **in place**: a block assigns its k/v to
  ``cache[:, layer, 0/1, index]`` and the forward returns the tensor it was
  given;
* the full-sequence branch at ``T >= DPA_MIN_SEQLEN`` is
  ``F.scaled_dot_product_attention`` (in the JAX package it is
  ``jax.nn.dot_product_attention``, a library call too);
* attention logits and value sums that the JAX einsums ask for in fp32 from
  bf16 operands (``preferred_element_type``) come from ``torch.bmm(...,
  out_dtype=torch.float32)`` on CUDA, which reads the bf16 cache as it is
  and writes fp32; on the CPU the operands are cast (small test shapes);
* the rotary tables and the masks of a forward are computed once in the
  backbone and handed to the blocks (XLA shares them between the layers by
  itself; eager PyTorch would recompute them per layer).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.nlp.gemma.config import GemmaConfig
from iseg_tpu_torch.nn.norm import RMSNorm
from iseg_tpu_torch.ops.quant import QuantDense, QuantEmbed

# Sequence length from which the attention of a forward switches from the
# grouped matrix products to ``F.scaled_dot_product_attention``. The value is
# the JAX package's; it is read at call time, so tests pin it to drive both
# branches.
DPA_MIN_SEQLEN = 2048

_MASK_FILL = -1e9  # not -inf: a fully masked row stays finite


def rope_tables(positions: torch.Tensor, head_dim: int,
                max_wavelength: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(sin, cos)``, each ``[B, T, 1, head_dim // 2]``."""
    half = head_dim // 2
    freq = torch.exp(-math.log(max_wavelength)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq  # [B, T, half]
    return torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_1d(x: torch.Tensor, positions: torch.Tensor,
                  max_wavelength: float = 10000.0) -> torch.Tensor:
    """RoPE over sequence positions: x ``[B, T, H, D]``, positions ``[B, T]``.
    The halves of D are rotated against each other (not neighbouring
    pairs); the angles are fp32."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], max_wavelength))


def causal_mask(t: int, positions: torch.Tensor, kv_len: Optional[int] = None) -> torch.Tensor:
    """``[B, 1, T, S]`` boolean mask: slot ``s`` is seen from a query at
    position ``p`` when ``s <= p``."""
    if kv_len is None:
        kv_len = t
    kv_pos = torch.arange(kv_len, device=positions.device)[None, None, None, :]
    return kv_pos <= positions[:, None, :, None]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [N, M, K] @ b [N, K, P]`` with an fp32 result, without an fp32
    copy of a low-precision operand on the card."""
    if a.dtype != b.dtype:
        common = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(common), b.to(common)
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _heads_first(kv: torch.Tensor) -> torch.Tensor:
    """``[B, S, kvh, d]`` (a cache row, strided) -> ``[B * kvh, S, d]``; a
    view when ``kvh == 1``, so a multi-query cache is never copied."""
    b, s, kvh, d = kv.shape
    return kv.permute(0, 2, 1, 3).reshape(b * kvh, s, d)


@torch.no_grad()
def context_masks(positions: torch.Tensor, context: Sequence, active_len: int,
                  cache_offset: int) -> list[torch.Tensor]:
    """Masks of a context-segment decode, one ``[B', grp, S_j]`` per segment
    (slots strictly below the query position) and last the active cache's
    ``[B, S_a]`` (slots up to the query position)."""
    pos_q = positions[:, 0]
    b = pos_q.shape[0]
    masks = []
    for seg, off in context:
        bp, sj = seg.shape[0], seg.shape[3]
        kv_pos = off + torch.arange(sj, device=positions.device)
        masks.append(kv_pos[None, None] < pos_q.reshape(bp, b // bp)[..., None])
    kv_pos_a = cache_offset + torch.arange(active_len, device=positions.device)
    masks.append(kv_pos_a[None] <= pos_q[:, None])
    return masks


class GemmaAttention(nn.Module):
    """Grouped-query attention with RoPE and an optional KV cache. K and V
    are contracted at ``kv_heads`` heads, never repeated to ``num_heads``."""

    def __init__(self, config: GemmaConfig, dtype=None, param_dtype=torch.float32,
                 layer_index: int = 0, device="cuda"):
        super().__init__()
        self.config = config
        self.layer_index = layer_index
        h, kvh, d, dim = config.num_heads, config.num_kv_heads, config.head_dim, config.hidden_dim
        kw = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
        self.query = QuantDense(dim, (h, d), **kw)
        self.key = QuantDense(dim, (kvh, d), **kw)
        self.value = QuantDense(dim, (kvh, d), **kw)
        self.attention_output = QuantDense((h, d), dim, **kw)

    def forward(self, x, rope, mask=None, cache=None, cache_index=None, context=None,
                cache_offset=0, segment_masks=None):
        """``rope`` is :func:`rope_tables` of the positions. Returns
        ``(out, cache)``; ``cache`` is the tensor passed in, written in
        place, or None."""
        cfg = self.config
        b, t, _ = x.shape
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        q = _rotate(self.query(x), *rope)
        k = _rotate(self.key(x), *rope)
        v = self.value(x)
        q = q * (d ** -0.5)  # after RoPE, as in the JAX package

        if context:
            out = self._context_decode(q, k, v, cache, cache_index, context, cache_offset,
                                       segment_masks)
        else:
            if cache is not None:
                # write this layer's k/v at cache_index in place, then attend
                # over the layer's whole cache row (views, no copy)
                li = self.layer_index
                cache[:, li, 0, cache_index:cache_index + t] = k.to(cache.dtype)
                cache[:, li, 1, cache_index:cache_index + t] = v.to(cache.dtype)
                k, v = cache[:, li, 0], cache[:, li, 1]
            if t >= DPA_MIN_SEQLEN:
                out = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.to(q.dtype).transpose(1, 2),
                    v.to(q.dtype).transpose(1, 2), attn_mask=mask, scale=1.0,
                    enable_gqa=kvh != h).transpose(1, 2)
            else:
                g, s = h // kvh, k.shape[1]
                qm = q.reshape(b, t, kvh, g, d).permute(0, 2, 3, 1, 4).reshape(b * kvh, g * t, d)
                logits = _bmm_f32(qm, _heads_first(k).transpose(1, 2)).view(b, kvh, g, t, s)
                if mask is not None:
                    logits = torch.where(mask[:, :, None], logits, _MASK_FILL)
                probs = torch.softmax(logits, dim=-1).to(v.dtype)
                out = torch.bmm(probs.view(b * kvh, g * t, s), _heads_first(v))
                out = out.view(b, kvh, g, t, d).permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
        return self.attention_output(out), cache

    def _context_decode(self, q, k, v, cache, cache_index, context, cache_offset,
                        segment_masks):
        """Single-token decode against segmented KV storage.

        ``context`` is a tuple of ``(segment, offset)`` pairs: read-only
        stacked caches ``[B', L, 2, S_j, kvh, d]`` whose slot ``s`` holds
        position ``offset + s``. A segment with ``B' < B`` is shared by
        ``B // B'`` consecutive query rows (the beams of one sample share
        their prompt; contrastive candidates share their whole history) and
        is read once per sample. Context slots are masked strictly below the
        query position; the query's own k/v goes into the active ``cache``
        ``[B, L, 2, S_a, kvh, d]`` (positions ``cache_offset + s``), written
        in place at ``cache_index - cache_offset`` and masked ``<=
        position``: together the attended set is the monolithic path's.
        Softmax runs in fp32 over the concatenated per-segment logits; the
        value sums are per-segment partial sums in fp32."""
        cfg = self.config
        b, t = q.shape[0], q.shape[1]
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = h // kvh
        if t != 1:
            raise ValueError(f"context-segment decode is single-token (got T={t}); "
                             "prefills run through the monolithic cache path")
        li = self.layer_index
        local = cache_index - cache_offset
        cache[:, li, 0, local:local + 1] = k.to(cache.dtype)
        cache[:, li, 1, local:local + 1] = v.to(cache.dtype)
        k_act, v_act = cache[:, li, 0], cache[:, li, 1]  # [B, S_a, kvh, d]

        qq = q[:, 0].reshape(b, kvh, g, d)
        logit_parts, value_parts = [], []
        for (seg, _), m in zip(context, segment_masks[:-1]):
            ks, vs = seg[:, li, 0], seg[:, li, 1]
            bp, sj = ks.shape[0], ks.shape[1]
            grp = b // bp
            qr = qq.reshape(bp, grp, kvh, g, d).permute(0, 2, 1, 3, 4).reshape(bp * kvh, grp * g, d)
            lg = _bmm_f32(qr, _heads_first(ks).transpose(1, 2))
            lg = lg.view(bp, kvh, grp, g, sj).permute(0, 2, 1, 3, 4)  # [bp, grp, kvh, g, sj]
            lg = torch.where(m[:, :, None, None], lg, _MASK_FILL)
            logit_parts.append(lg.reshape(b, kvh, g, sj))
            value_parts.append((vs, bp, grp))

        sa = k_act.shape[1]
        lga = _bmm_f32(qq.reshape(b * kvh, g, d), _heads_first(k_act).transpose(1, 2))
        lga = torch.where(segment_masks[-1][:, None, None], lga.view(b, kvh, g, sa), _MASK_FILL)
        logit_parts.append(lga)

        probs = torch.softmax(torch.cat(logit_parts, dim=-1), dim=-1)
        out, s0 = None, 0
        for vs, bp, grp in value_parts:
            sj = vs.shape[1]
            pj = probs[..., s0:s0 + sj].to(vs.dtype)
            pj = pj.reshape(bp, grp, kvh, g, sj).permute(0, 2, 1, 3, 4).reshape(bp * kvh, grp * g, sj)
            oj = _bmm_f32(pj, _heads_first(vs)).view(bp, kvh, grp, g, d)
            oj = oj.permute(0, 2, 1, 3, 4).reshape(b, kvh, g, d)
            out = oj if out is None else out + oj
            s0 += sj
        pa = probs[..., s0:].to(v_act.dtype).reshape(b * kvh, g, sa)
        oa = _bmm_f32(pa, _heads_first(v_act)).view(b, kvh, g, d)
        out = oa if out is None else out + oa
        return out.reshape(b, 1, h, d).to(q.dtype)


class GemmaDecoderBlock(nn.Module):
    """Pre-norm attention + pre-norm GeGLU FFN (GELU in its tanh form)."""

    def __init__(self, config: GemmaConfig, dtype=None, param_dtype=torch.float32,
                 layer_index: int = 0, device="cuda"):
        super().__init__()
        dim, ffn = config.hidden_dim, config.intermediate_dim
        norm = dict(epsilon=config.layer_norm_epsilon, param_dtype=param_dtype, device=device)
        dense = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
        self.pre_attention_norm = RMSNorm(dim, **norm)
        self.attention = GemmaAttention(config, dtype=dtype, param_dtype=param_dtype,
                                        layer_index=layer_index, device=device)
        self.pre_ffw_norm = RMSNorm(dim, **norm)
        self.gating_ffw = QuantDense(dim, ffn, **dense)
        self.gating_ffw_2 = QuantDense(dim, ffn, **dense)
        self.ffw_linear = QuantDense(ffn, dim, **dense)

    def forward(self, x, rope, mask=None, cache=None, cache_index=None, context=None,
                cache_offset=0, segment_masks=None):
        attn, cache = self.attention(
            self.pre_attention_norm(x), rope, mask=mask, cache=cache, cache_index=cache_index,
            context=context, cache_offset=cache_offset, segment_masks=segment_masks)
        x = x + attn
        h = self.pre_ffw_norm(x)
        ffw = F.gelu(self.gating_ffw(h), approximate="tanh") * self.gating_ffw_2(h)
        return x + self.ffw_linear(ffw), cache


class GemmaBackbone(nn.Module):
    """Embedding -> blocks -> final norm. Logits come from the tied
    embedding (:meth:`logits`). Parameters are allocated on ``device``: the
    card by default (it raises where there is none), the CPU only when the
    caller names it."""

    def __init__(self, config: GemmaConfig, dtype=None, param_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.token_embedding = QuantEmbed(config.vocab_size, config.hidden_dim, dtype=dtype,
                                          param_dtype=param_dtype, device=device)
        # registered as layer_0, layer_1, ...: the names of the flax tree
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", GemmaDecoderBlock(
                config, dtype=dtype, param_dtype=param_dtype, layer_index=i, device=device))
        self.final_normalization = RMSNorm(config.hidden_dim, epsilon=config.layer_norm_epsilon,
                                           param_dtype=param_dtype, device=device)

    @property
    def blocks(self) -> list[GemmaDecoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_layers)]

    def forward(self, token_ids, positions=None, mask=None, caches=None, cache_index=None,
                context=None, cache_offset=0):
        """token_ids ``[B, T]`` -> hidden ``[B, T, D]``, or ``(hidden,
        caches)`` with a cache (written in place; the same tensor comes
        back). ``context`` and ``cache_offset`` (decode only): read-only KV
        segments attended alongside the active ``caches``, see
        :meth:`GemmaAttention._context_decode`."""
        cfg = self.config
        b, t = token_ids.shape
        if positions is None:
            if caches is not None:
                # arange(t) against a cache would rotate the tokens at
                # position 0.. and mask away the whole cache: refuse
                raise ValueError(
                    "positions must be passed explicitly when decoding against a KV cache "
                    "(arange(t) would mis-position the query tokens)")
            positions = torch.arange(t, device=token_ids.device)[None].expand(b, t)
        x = self.token_embedding(token_ids)
        # the scale is rounded to the activation type before the product
        x = x * float(torch.tensor(cfg.hidden_dim ** 0.5).to(x.dtype))

        rope = rope_tables(positions, cfg.head_dim, cfg.rope_max_wavelength)
        segment_masks = None
        if context:
            segment_masks = context_masks(positions, context, caches.shape[3], cache_offset)
        elif mask is None:
            kv_len = caches.shape[3] if caches is not None else t
            mask = causal_mask(t, positions, kv_len=kv_len)

        for block in self.blocks:
            x, caches = block(x, rope, mask=mask, cache=caches, cache_index=cache_index,
                              context=context, cache_offset=cache_offset,
                              segment_masks=segment_masks)
        x = self.final_normalization(x)
        if caches is not None:
            return x, caches
        return x

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding readout, fp32 against the whole table."""
        return self.token_embedding.attend(hidden.float())
