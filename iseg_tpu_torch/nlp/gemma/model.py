"""Gemma backbone: embedding, decoder blocks (RoPE + GQA attention, GeGLU
FFN, RMSNorm), final norm.

Counterpart of ``iseg_tpu/nlp/gemma/model.py``, with its layouts: hidden
states ``[B, T, D]``, heads ``[B, T, H, d]``, and the KV cache as one stack
``[B, L, 2, S, kv_heads, head_dim]`` that threads through the blocks.

Distribution (:class:`GemmaParallel`), with the collectives GSPMD inserts for
the JAX package issued by hand (``parallel/collectives.py``):

* **tensor parallelism** over a mesh axis (``model_axis``; the JAX package
  gets it by placing the weights with ``layout.shard_gemma_params``): each
  rank holds its share of the query/key/value heads, of the attention
  output's input heads, of the GeGLU's hidden units and of the vocabulary.
  The row-parallel products (attention output, ``ffw_linear``) end in one
  all-reduce; the embedding looks up this rank's vocabulary range, zeros the
  rest and all-reduces; the tied readout computes this rank's logits and
  all-gathers them, so every rank sees whole rows. The KV cache holds the
  local KV heads;
* **sequence parallelism** for the full-sequence forwards (``seq_axis``,
  ``data_axis``, ``sp_mode``): each rank holds its slice of the sequence
  (and of the batch, over ``data_axis``). ``"allgather"`` gathers the whole
  K/V for the local queries, once a layer; ``"ring"`` rotates K/V blocks
  around the axis (``parallel/ring.py``). Decode ignores both; without a
  mesh both are the dense path with its mask.

What differs from the JAX package, which is functional:

* the cache is written **in place**: a block assigns its k/v to
  ``cache[:, layer, 0/1, index]`` and the forward returns the tensor it was
  given;
* the full-sequence branch at ``T >= DPA_MIN_SEQLEN`` is
  ``F.scaled_dot_product_attention`` (in the JAX package it is
  ``jax.nn.dot_product_attention``, a library call too) where no gradient is
  recorded. A call on the card that records one (a train step) takes the
  grouped products of the short branch instead, whose sums run in a fixed
  order, so two runs of a step end bit for bit equal as in the JAX package
  (SDPA's cuDNN and flash backwards do not);
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
from iseg_tpu_torch.ops.kernels.window_attention import _records_grad
from iseg_tpu_torch.ops.quant import QuantDense, QuantEmbed
from iseg_tpu_torch.parallel import collectives as C
from iseg_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

# Sequence length from which the attention of a forward switches from the
# grouped matrix products to ``F.scaled_dot_product_attention``. The value is
# the JAX package's; it is read at call time, so tests pin it to drive both
# branches.
DPA_MIN_SEQLEN = 2048

_MASK_FILL = -1e9  # not -inf: a fully masked row stays finite
SP_MODES = ("allgather", "ring")


class GemmaParallel:
    """The groups, sizes and coordinates of a Gemma model's distribution on
    ``mesh`` (None: one rank, every axis of size 1).

    ``model_axis``: tensor parallelism over that axis. ``seq_axis`` /
    ``data_axis`` / ``sp_mode``: sequence parallelism of the full-sequence
    forwards, as in the JAX modules. An axis of one rank is no parallelism;
    an axis the mesh does not have raises."""

    def __init__(self, mesh=None, model_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None, data_axis: Optional[str] = None,
                 sp_mode: str = "allgather"):
        if sp_mode not in SP_MODES:
            raise ValueError(f"sp_mode must be one of {SP_MODES}, got {sp_mode!r}")
        if model_axis is not None and model_axis == seq_axis:
            raise ValueError(f"model_axis and seq_axis are both {model_axis!r}")
        self.mesh, self.sp_mode = mesh, sp_mode
        self.model_axis, self.seq_axis, self.data_axis = model_axis, seq_axis, data_axis

        def axis(name):
            n = axis_size(mesh, name) if name is not None else 1
            if n == 1:
                return None, 1, 0
            return axis_group(mesh, name), n, axis_rank(mesh, name)

        self.model_group, self.mp, self.model_rank = axis(model_axis)
        self.seq_group, self.sp, self.seq_rank = axis(seq_axis)
        self.data_group, self.dp, self.data_rank = axis(data_axis)

    def local(self, n: int, what: str) -> int:
        """``n`` split over the model axis; raises where it does not divide
        (where ``jax.device_put`` of the layout raises)."""
        if n % self.mp:
            raise ValueError(f"{what} ({n}) should be divisible by the model axis size "
                             f"{self.mp}: tensor parallelism splits it over the ranks")
        return n // self.mp

    def sp_active(self, cache) -> bool:
        """Sequence parallelism runs: a mesh axis of several ranks and a
        full-sequence forward (decode ignores it)."""
        return self.seq_group is not None and cache is None


def _full_scale(module, name: str, shape) -> None:
    """Keep an int8 scale buffer at its full (unsharded) shape: the layout
    rules of the JAX package leave those leaves replicated."""
    buf = getattr(module, name)
    module.register_buffer(name, torch.ones(shape, dtype=buf.dtype, device=buf.device))


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
    copy of a low-precision operand on the card where no gradient is
    recorded (``out_dtype`` has no derivative: a train step takes the
    copies)."""
    if a.dtype != b.dtype:
        common = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(common), b.to(common)
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda" and not _records_grad(a, b):
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
                 layer_index: int = 0, device="cuda", parallel: Optional[GemmaParallel] = None):
        super().__init__()
        self.config = config
        self.layer_index = layer_index
        self.parallel = parallel = parallel or GemmaParallel()
        h, kvh, d, dim = config.num_heads, config.num_kv_heads, config.head_dim, config.hidden_dim
        # this rank's heads under tensor parallelism (all of them otherwise)
        self.heads = parallel.local(h, "query heads")
        self.kv_heads = parallel.local(kvh, "KV heads")
        kw = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
        self.query = QuantDense(dim, (self.heads, d), **kw)
        self.key = QuantDense(dim, (self.kv_heads, d), **kw)
        self.value = QuantDense(dim, (self.kv_heads, d), **kw)
        self.attention_output = QuantDense((self.heads, d), dim, **kw)
        if parallel.mp > 1:
            for m, heads in ((self.query, h), (self.key, kvh), (self.value, kvh)):
                _full_scale(m, "kernel_scale", (heads, d))

    def forward(self, x, rope, mask=None, cache=None, cache_index=None, context=None,
                cache_offset=0, segment_masks=None, positions=None):
        """``rope`` is :func:`rope_tables` of the positions (``positions``
        themselves, global, are read by the ring). Returns ``(out, cache)``;
        ``cache`` is the tensor passed in, written in place, or None."""
        cfg, par = self.config, self.parallel
        b, t, _ = x.shape
        h, kvh, d = self.heads, self.kv_heads, cfg.head_dim
        x = C.copy_to(x, par.model_group)

        q = _rotate(self.query(x), *rope)
        k = _rotate(self.key(x), *rope)
        v = self.value(x)
        q = q * (d ** -0.5)  # after RoPE, as in the JAX package

        sp = par.sp_active(cache)
        if sp and par.sp_mode == "ring":
            from iseg_tpu_torch.parallel.ring import ring_attention_local

            if mask is not None:
                raise ValueError("sp_mode='ring' derives its causal mask from positions; pass "
                                 "mask=None (custom masks need sp_mode='allgather')")
            # GQA K/V rotate at kv heads; the shared output projection below
            # closes the branch
            out = ring_attention_local(q, k, v, positions, par.seq_group, causal=True)
        elif context:
            out = self._context_decode(q, k, v, cache, cache_index, context, cache_offset,
                                       segment_masks)
        else:
            if sp:
                # the local queries attend the whole sequence: gather K/V
                # over the axis, once a layer (each rank's queries use them
                # differently, so the backward reduce-scatters)
                k = C.gather_from(k, par.seq_group, dim=1, grad="reduce_scatter")
                v = C.gather_from(v, par.seq_group, dim=1, grad="reduce_scatter")
            if cache is not None:
                # write this layer's k/v at cache_index in place, then attend
                # over the layer's whole cache row (views, no copy)
                li = self.layer_index
                cache[:, li, 0, cache_index:cache_index + t] = k.to(cache.dtype)
                cache[:, li, 1, cache_index:cache_index + t] = v.to(cache.dtype)
                k, v = cache[:, li, 0], cache[:, li, 1]
            # the branch follows the global sequence length, as in the JAX
            # package (whose traced shapes are global)
            full = t * (par.sp if sp else 1) >= DPA_MIN_SEQLEN
            # a train step on the card takes the grouped products: SDPA's
            # backward does not add in a fixed order
            fixed_order = q.is_cuda and _records_grad(q, k, v)
            if full and not fixed_order:
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
        # row-parallel: the heads' partial sums meet in one all-reduce
        return C.reduce_from(self.attention_output(out), par.model_group), cache

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
        b, t = q.shape[0], q.shape[1]
        h, kvh, d = self.heads, self.kv_heads, self.config.head_dim
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
                 layer_index: int = 0, device="cuda", parallel: Optional[GemmaParallel] = None):
        super().__init__()
        self.parallel = parallel = parallel or GemmaParallel()
        dim, ffn = config.hidden_dim, config.intermediate_dim
        ffn_local = parallel.local(ffn, "the GeGLU's hidden units")
        norm = dict(epsilon=config.layer_norm_epsilon, param_dtype=param_dtype, device=device)
        dense = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
        self.pre_attention_norm = RMSNorm(dim, **norm)
        self.attention = GemmaAttention(config, dtype=dtype, param_dtype=param_dtype,
                                        layer_index=layer_index, device=device,
                                        parallel=parallel)
        self.pre_ffw_norm = RMSNorm(dim, **norm)
        self.gating_ffw = QuantDense(dim, ffn_local, **dense)
        self.gating_ffw_2 = QuantDense(dim, ffn_local, **dense)
        self.ffw_linear = QuantDense(ffn_local, dim, **dense)
        if parallel.mp > 1:
            for m in (self.gating_ffw, self.gating_ffw_2):
                _full_scale(m, "kernel_scale", (ffn,))

    def forward(self, x, rope, mask=None, cache=None, cache_index=None, context=None,
                cache_offset=0, segment_masks=None, positions=None):
        group = self.parallel.model_group
        attn, cache = self.attention(
            self.pre_attention_norm(x), rope, mask=mask, cache=cache, cache_index=cache_index,
            context=context, cache_offset=cache_offset, segment_masks=segment_masks,
            positions=positions)
        x = x + attn
        h = C.copy_to(self.pre_ffw_norm(x), group)
        ffw = F.gelu(self.gating_ffw(h), approximate="tanh") * self.gating_ffw_2(h)
        return x + C.reduce_from(self.ffw_linear(ffw), group), cache


class GemmaBackbone(nn.Module):
    """Embedding -> blocks -> final norm. Logits come from the tied
    embedding (:meth:`logits`). Parameters are allocated on ``device``: the
    card by default (it raises where there is none), the CPU only when the
    caller names it."""

    def __init__(self, config: GemmaConfig, dtype=None, param_dtype=torch.float32,
                 device="cuda", parallel: Optional[GemmaParallel] = None):
        super().__init__()
        self.config = config
        self.parallel = parallel = parallel or GemmaParallel()
        device = resolve_device(device)
        # under tensor parallelism this rank's rows [start, start + V / mp)
        self.vocab_local = parallel.local(config.vocab_size, "the vocabulary")
        self.vocab_start = parallel.model_rank * self.vocab_local
        self.token_embedding = QuantEmbed(self.vocab_local, config.hidden_dim, dtype=dtype,
                                          param_dtype=param_dtype, device=device)
        if parallel.mp > 1:
            _full_scale(self.token_embedding, "embedding_scale", (config.vocab_size,))
        # registered as layer_0, layer_1, ...: the names of the flax tree
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", GemmaDecoderBlock(
                config, dtype=dtype, param_dtype=param_dtype, layer_index=i, device=device,
                parallel=parallel))
        self.final_normalization = RMSNorm(config.hidden_dim, epsilon=config.layer_norm_epsilon,
                                           param_dtype=param_dtype, device=device)

    @property
    def blocks(self) -> list[GemmaDecoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_layers)]

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Rows of the table; under tensor parallelism each rank looks up
        its vocabulary range, zeros the other tokens, and the ranks' rows
        meet in one all-reduce."""
        par = self.parallel
        if par.mp == 1:
            return self.token_embedding(token_ids)
        local = token_ids - self.vocab_start
        mine = (local >= 0) & (local < self.vocab_local)
        rows = self.token_embedding(torch.where(mine, local, 0))
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
        return C.reduce_from(rows, par.model_group)

    def forward(self, token_ids, positions=None, mask=None, caches=None, cache_index=None,
                context=None, cache_offset=0):
        """token_ids ``[B, T]`` -> hidden ``[B, T, D]``, or ``(hidden,
        caches)`` with a cache (written in place; the same tensor comes
        back). ``context`` and ``cache_offset`` (decode only): read-only KV
        segments attended alongside the active ``caches``, see
        :meth:`GemmaAttention._context_decode`.

        Under sequence parallelism (a full-sequence forward) ``token_ids``
        is this rank's slice of the sequence, and the default positions are
        its global ones."""
        cfg, par = self.config, self.parallel
        b, t = token_ids.shape
        sp = par.sp_active(caches)
        if positions is None:
            if caches is not None:
                # arange(t) against a cache would rotate the tokens at
                # position 0.. and mask away the whole cache: refuse
                raise ValueError(
                    "positions must be passed explicitly when decoding against a KV cache "
                    "(arange(t) would mis-position the query tokens)")
            start = par.seq_rank * t if sp else 0
            positions = torch.arange(start, start + t, device=token_ids.device)[None].expand(b, t)
        x = self.embed(token_ids)
        # the scale is rounded to the activation type before the product
        x = x * float(torch.tensor(cfg.hidden_dim ** 0.5).to(x.dtype))

        rope = rope_tables(positions, cfg.head_dim, cfg.rope_max_wavelength)
        segment_masks = None
        if context:
            segment_masks = context_masks(positions, context, caches.shape[3], cache_offset)
        elif mask is None and not (sp and par.sp_mode == "ring"):
            # the ring derives its causal mask from positions; allgather's
            # local queries see the whole gathered sequence
            kv_len = caches.shape[3] if caches is not None else t * (par.sp if sp else 1)
            mask = causal_mask(t, positions, kv_len=kv_len)

        for block in self.blocks:
            x, caches = block(x, rope, mask=mask, cache=caches, cache_index=cache_index,
                              context=context, cache_offset=cache_offset,
                              segment_masks=segment_masks, positions=positions)
        x = self.final_normalization(x)
        if caches is not None:
            return x, caches
        return x

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding readout, fp32 against the whole table. Under
        tensor parallelism each rank computes its vocabulary's logits and
        the ranks all-gather them: every rank holds whole rows, so every
        sampler picks the same tokens on every rank."""
        group = self.parallel.model_group
        logits = self.token_embedding.attend(C.copy_to(hidden.float(), group))
        return C.gather_from(logits, group, dim=logits.ndim - 1)
