"""Gemma causal LM: cached generation and scoring.

Counterpart of ``iseg_tpu/nlp/gemma/causal_lm.py``. The model is an
``nn.Module`` that holds its own parameters on an explicit device.
``generate`` runs one of four programs (flat samplers; beam search with a
segmented or a monolithic cache; contrastive search), each a prefill of
the prompt followed by a decode loop of single-token forwards against the
KV cache, under ``torch.inference_mode()``.

The JAX package compiles each program into one ``lax.scan``; here the loop
is a Python loop of eager calls, so what it does per step is kept small:

* the cache is written in place (``model.py``), never copied;
* the loop counter, ``start`` and the longest prompt are host integers,
  read once before the loop; ``parent``, ``done`` and the tokens stay on the
  device, and nothing in a step waits for the device;
* work that the compiled scan does on every step but that cannot change the
  result is skipped when the host knows so: the forced-prompt rows after
  the longest prompt has ended, the finished-beam rows when there is no end
  token;
* the segmented beam search keeps **two** active caches per segment and
  swaps them every step: the reorder ``out[b, i] = active[b, parent[b, i]]``
  cannot run in place (a parent may appear twice), and on CUDA it is the
  hand-written kernel behind :func:`beam_cache_gather`, every step, with no
  switch. The monolithic beam search keeps the plain gather, as the JAX
  package does: it is the cross-check.

The order inside a beam step is the JAX package's: pick parents, reorder
the token histories, gather the active cache, then run the forward that
writes slot ``i``.

int8 serving is transparent, as in the JAX package: a model loaded with a
weight-only tree (``ops.quant.quantize_tree``) holds int8 + scales and
dequantizes each weight, to ``dtype`` or bfloat16, in the layer that uses it,
for the prefill and every decode step (the JAX package's
``_dense_variables`` behind an optimization barrier); one loaded with a
W8A8 tree (``quantize_dense_tree``) runs its products in int8. No dense
copy of the weights stays resident between steps.

Distributed (``model.GemmaParallel``): under tensor parallelism every rank
runs the same program on its heads; the logits are all-gathered, so the
ranks pick the same tokens (greedy and beam are deterministic, the random
samplers draw from generators seeded alike), and each rank's beam reorder
gathers its own local KV cache through the same kernel. Under sequence
parallelism the full-sequence forwards (``forward``, :meth:`score`,
:meth:`next_token_loss`) take this rank's slice of the sequence
(:meth:`shard_tokens`); decode ignores it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.nlp.gemma import samplers as S
from iseg_tpu_torch.nlp.gemma.config import GemmaConfig
from iseg_tpu_torch.nlp.gemma.model import GemmaBackbone, GemmaParallel
from iseg_tpu_torch.nn.initializers import initialize
from iseg_tpu_torch.ops.kernels.cache_gather import beam_cache_gather
from iseg_tpu_torch.parallel import collectives as C

_NEG_INF = -1e9  # a dead beam's score and a masked continuation's log-prob


def masked_nll_sums(logits: torch.Tensor, targets: torch.Tensor,
                    weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of weights * -log p(target), sum of weights)`` of logits ``[B,
    T, V]`` against targets and weights ``[B, T]``, in fp32: the two sums of
    the masked next-token loss (:meth:`GemmaCausalLM.next_token_loss`, the
    pipeline's loss)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, 2, targets[..., None].long())[..., 0]
    w = weights.float()
    return (nll * w).sum(), w.sum()


class GemmaCausalLM(nn.Module):
    """A :class:`GemmaBackbone` with the generation programs.

    ``param_dtype`` is the parameters' type, ``dtype`` the compute type
    (None: the promoted type of input and weight) and the KV cache's type
    (None: float32). Parameters are allocated on ``device``, the card by
    default: without a card the constructor raises, and the model runs on the
    CPU only when the caller passes ``device="cpu"``. They are not
    initialized: fill them with :meth:`init` (random, from a generator) or
    :func:`iseg_tpu_torch.convert.load_flax`.

    ``mesh`` with ``model_axis``: tensor parallelism over that axis (load
    this rank's shard of full weights, ``layout.shard_gemma_params``).
    ``seq_axis`` / ``data_axis`` / ``sp_mode``: sequence parallelism of the
    full-sequence forwards, as in the JAX package (``"allgather"`` or
    ``"ring"``).
    """

    def __init__(self, config: GemmaConfig, dtype=None, param_dtype=torch.float32,
                 device="cuda", mesh=None, model_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None, data_axis: Optional[str] = None,
                 sp_mode: str = "allgather"):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.parallel = GemmaParallel(mesh, model_axis=model_axis, seq_axis=seq_axis,
                                      data_axis=data_axis, sp_mode=sp_mode)
        self.backbone = GemmaBackbone(config, dtype=dtype, param_dtype=param_dtype,
                                      device=resolve_device(device), parallel=self.parallel)

    # -- setup ------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.backbone.token_embedding.embedding.device

    def init(self, generator: torch.Generator) -> "GemmaCausalLM":
        """Random weights the way flax draws them, from ``generator``; the
        values are drawn on the generator's device. A tensor-parallel model
        takes its shard of full weights instead (``layout.shard_gemma_params``):
        drawn at the local shapes, the fan-ins would be the shards'."""
        if self.parallel.mp > 1:
            raise ValueError("a tensor-parallel GemmaCausalLM loads its shard of full weights "
                             "(layout.shard_gemma_params + convert.load_flax)")
        initialize(self, generator)
        return self

    @property
    def kv_heads(self) -> int:
        """KV heads this rank holds (all of them without tensor parallelism)."""
        return self.backbone.layer_0.attention.kv_heads

    def build_cache(self, batch: int, max_length: int) -> torch.Tensor:
        """Zeros ``[B, layers, 2, max_len, kv_heads, head_dim]`` (this rank's
        KV heads under tensor parallelism)."""
        cfg = self.config
        return torch.zeros(
            (batch, cfg.num_layers, 2, max_length, self.kv_heads, cfg.head_dim),
            dtype=self.dtype or torch.float32, device=self.device)

    # -- forward ----------------------------------------------------------
    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.backbone.logits(self.backbone(token_ids))

    def call_with_cache(self, token_ids, caches, cache_index, positions, context=None,
                        cache_offset=0):
        """One forward that writes k/v at ``cache_index`` (in place) and
        attends over the whole cache with position-aware masking.
        ``context`` / ``cache_offset``: read-only KV segments attended
        alongside ``caches`` (``GemmaAttention._context_decode``)."""
        logits, caches, _ = self._forward_with_cache(
            token_ids, caches, cache_index, positions, context=context,
            cache_offset=cache_offset)
        return logits, caches

    def _forward_with_cache(self, token_ids, caches, cache_index, positions, context=None,
                            cache_offset=0):
        """``call_with_cache`` plus the final hidden states (the contrastive
        sampler's degeneration penalty needs them)."""
        hidden, caches = self.backbone(
            token_ids, positions=positions, caches=caches, cache_index=cache_index,
            context=context, cache_offset=cache_offset)
        return self.backbone.logits(hidden), caches, hidden

    def _decode(self, tok, caches, i, context=None, cache_offset=0):
        """Single-token forward for position ``i``: ``(logits [B, V], hidden
        [B, D])``; writes slot ``i`` of ``caches``."""
        positions = torch.full((tok.shape[0], 1), i, dtype=torch.long, device=tok.device)
        hidden, _ = self.backbone(tok[:, None], positions=positions, caches=caches,
                                  cache_index=i, context=context, cache_offset=cache_offset)
        hidden = hidden[:, 0]
        return self.backbone.logits(hidden), hidden

    def _prefill(self, prompt_ids, prompt_lengths, caches):
        """The whole prompt in one forward, k/v cached at ``[0, P)``;
        returns the logits after each row's last real prompt token, and all
        hidden states. (Only those rows go through the readout: the logits
        of the other prompt positions are never used.)"""
        b, p = prompt_ids.shape
        positions = torch.arange(p, device=prompt_ids.device)[None].expand(b, p)
        hidden, _ = self.backbone(prompt_ids, positions=positions, caches=caches, cache_index=0)
        last_idx = torch.clamp(prompt_lengths - 1, 0, p - 1)
        rows = torch.arange(b, device=prompt_ids.device)
        return self.backbone.logits(hidden[rows, last_idx]), hidden

    # -- generation -------------------------------------------------------
    def generate(
        self,
        prompt_ids,  # [B, P] integers (left-aligned, 0-padded)
        prompt_lengths,  # [B]
        max_length: int,
        temperature: float = 0.0,  # 0 = greedy (shorthand)
        top_k: Optional[int] = None,  # restrict sampling to the k best
        top_p: Optional[float] = None,  # nucleus sampling mass
        sampler=None,  # Sampler instance or name ("greedy"/"top_k"/...)
        generator: Optional[torch.Generator] = None,
        end_token_id: Optional[int] = None,
        cache_policy: str = "segmented",  # "segmented" | "monolithic"
        segment_len: int = 256,  # beam: active-cache growth granularity
    ) -> torch.Tensor:
        """Returns ``[B, max_length]`` int32 ids on the model's device
        (prompt included).

        ``sampler`` is a :mod:`samplers` instance or name; the
        ``temperature`` / ``top_k`` / ``top_p`` arguments are shorthand that
        resolve to the matching sampler. ``BeamSampler`` and
        ``ContrastiveSampler`` run their own programs; everything else the
        flat decode loop. ``generator`` feeds the random samplers (default:
        one on the model's device with seed 0)."""
        if sampler is None:
            if top_p is not None:
                sampler = S.TopPSampler(p=top_p, k=top_k,
                                        temperature=temperature if temperature > 0 else 1.0)
            elif temperature == 0.0:
                sampler = S.GreedySampler()
            elif top_k is not None:
                sampler = S.TopKSampler(k=top_k, temperature=temperature)
            else:
                sampler = S.RandomSampler(temperature=temperature)
        elif isinstance(sampler, str):
            # a named sampler picks up the matching shorthand arguments
            # (dropping them would sample the wrong distribution)
            defaults: dict = {}
            if sampler in ("top_k", "top_p", "random") and temperature > 0:
                defaults["temperature"] = temperature
            if sampler == "top_k" and top_k is not None:
                defaults["k"] = top_k
            if sampler == "top_p":
                if top_p is not None:
                    defaults["p"] = top_p
                if top_k is not None:
                    defaults["k"] = top_k
            sampler = S.get_sampler(sampler, **defaults)
        else:
            sampler = S.get_sampler(sampler)

        device = self.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)

        # Decode starts at the SHORTEST prompt's length, not the padded
        # buffer width: rows shorter than the buffer get their pad gap
        # [length, P) filled with generated tokens; rows still inside their
        # prompt re-forward the prompt token (an idempotent cache write)
        # until generation reaches them. The lengths are read on the host
        # once, here.
        if isinstance(prompt_lengths, torch.Tensor):
            lengths_host = prompt_lengths.detach().cpu().numpy()
        else:
            lengths_host = np.asarray(prompt_lengths)
        prompt_ids = torch.as_tensor(prompt_ids).to(device=device, dtype=torch.long)
        prompt_lengths = torch.as_tensor(lengths_host).to(device=device, dtype=torch.long)
        p_width = int(prompt_ids.shape[1])
        start = max(1, min(int(lengths_host.min()), p_width))
        longest = int(lengths_host.max())

        kw: dict = dict(max_length=max_length, sampler=sampler, end_token_id=end_token_id,
                        start=start, longest=longest)
        if isinstance(sampler, S.BeamSampler):
            if cache_policy == "segmented":
                impl = self._generate_beam_impl
                kw["segment_len"] = segment_len
            else:
                impl = self._generate_beam_monolithic
        elif isinstance(sampler, S.ContrastiveSampler):
            impl = self._generate_contrastive_impl
            kw["shared_context"] = cache_policy == "segmented"
        else:
            impl = self._generate_impl
            kw["generator"] = generator
        with torch.inference_mode():
            return impl(prompt_ids, prompt_lengths, **kw).to(torch.int32)

    def _generate_impl(self, prompt_ids, prompt_lengths, *, max_length, sampler,
                       end_token_id, start, longest, generator):
        del longest
        b, p = prompt_ids.shape
        caches = self.build_cache(b, max_length)
        # the position-aware causal mask hides the not-yet-written cache tail
        next_logits, _ = self._prefill(prompt_ids, prompt_lengths, caches)

        tokens = torch.zeros((b, max_length), dtype=torch.long, device=prompt_ids.device)
        tokens[:, :p] = prompt_ids
        done = torch.zeros((b,), dtype=torch.bool, device=prompt_ids.device)

        for i in range(start, max_length):
            new_tok = sampler.sample(next_logits, generator)
            # only write into positions >= the prompt length
            in_gen = (prompt_lengths <= i) & ~done
            tok = torch.where(in_gen, new_tok, tokens[:, i])
            tokens[:, i] = tok
            if end_token_id is not None:
                done = done | (in_gen & (tok == end_token_id))
            next_logits, _ = self._decode(tok, caches, i)
        return tokens

    # -- beam search ------------------------------------------------------
    def _beam_setup(self, prompt_ids, nb, max_length, next_logits):
        b, p = prompt_ids.shape
        device = prompt_ids.device
        tokens = torch.zeros((b, nb, max_length), dtype=torch.long, device=device)
        tokens[:, :, :p] = prompt_ids[:, None]
        # beam 0 live, the rest dead, so the first step picks nb distinct tokens
        scores = torch.full((b, nb), _NEG_INF, dtype=torch.float32, device=device)
        scores[:, 0] = 0.0
        done = torch.zeros((b, nb), dtype=torch.bool, device=device)
        vocab = next_logits.shape[-1]
        # a finished beam continues with token 0 only, at log-prob 0
        pad_row = torch.full((vocab,), _NEG_INF, dtype=torch.float32, device=device)
        pad_row[0] = 0.0
        return tokens, scores, done, next_logits.repeat_interleave(nb, dim=0), pad_row

    @staticmethod
    def _beam_select(next_logits, tokens, scores, done, pad_row, prompt_lengths, i, *,
                     end_token_id, longest):
        """One re-ranking over the ``nb * V`` continuations: ``(tokens,
        scores, done, parent [B, nb], tok [B, nb])`` with the histories
        already reordered by parent and slot ``i`` written."""
        b, nb, _ = tokens.shape
        vocab = next_logits.shape[-1]
        log_probs = torch.log_softmax(next_logits.float(), dim=-1).view(b, nb, vocab)
        if end_token_id is not None:  # otherwise no beam is ever finished
            log_probs = torch.where(done[..., None], pad_row, log_probs)
        forced = prompt_lengths > i  # [B]
        if i < longest:  # otherwise no row is inside its prompt
            # rows still inside their prompt: only the prompt token, at
            # log-prob 0, so the beams stay on the prompt with frozen scores
            forced_row = torch.full_like(log_probs, _NEG_INF)
            forced_row.scatter_(2, tokens[:, :, i, None], 0.0)
            log_probs = torch.where(forced[:, None, None], forced_row, log_probs)

        total = (scores[..., None] + log_probs).view(b, nb * vocab)
        scores, flat_idx = S.top_k(total, nb)  # [B, nb]
        parent = flat_idx // vocab
        tok = flat_idx % vocab

        done = torch.gather(done, 1, parent)
        if end_token_id is not None:
            # an end id INSIDE a prompt must not finish the beam
            done = done | (~forced[:, None] & (tok == end_token_id))
        tokens = torch.gather(tokens, 1, parent[..., None].expand_as(tokens))
        tokens[:, :, i] = tok
        return tokens, scores, done, parent, tok

    @staticmethod
    def _best_beam(tokens, scores):
        best = torch.argmax(scores, dim=1)
        return tokens[torch.arange(tokens.shape[0], device=tokens.device), best]

    def _generate_beam_impl(self, prompt_ids, prompt_lengths, *, max_length, sampler,
                            end_token_id, start, longest, segment_len=256):
        """Beam search with segmented KV storage.

        The same search as :meth:`_generate_beam_monolithic`, with the cache
        split so that the per-step reorder moves few bytes:

        - the prompt slots ``[0, start)`` are identical across beams (one
          shared prefill), so they live in a read-only ``[B]``-row context
          segment: never reordered, and read once per sample instead of once
          per beam;
        - generated slots live in an ACTIVE cache ``[B * nb, L, 2, W, kvh,
          d]`` that starts ``segment_len`` wide and grows by segments, so
          each step's parent gather copies the slots of the current width,
          not ``max_length``. Two buffers of that shape are swapped every
          step; both are re-made when a segment grows.

        The logits are the monolithic path's; only the order of the value
        sums differs (per-segment partial sums in fp32)."""
        nb = sampler.num_beams
        b, p = prompt_ids.shape
        cfg = self.config

        # prefill at B rows into a width-p cache (slots [0, p))
        caches_p = self.build_cache(b, p)
        next_logits, _ = self._prefill(prompt_ids, prompt_lengths, caches_p)
        # shared read-only prompt segment [B, L, 2, start, kvh, d] (a view)
        context = ((caches_p[:, :, :, :start], 0),)
        tokens, scores, done, next_logits, pad_row = self._beam_setup(
            prompt_ids, nb, max_length, next_logits)

        # active-cache segment boundaries: the first segment must hold the
        # whole prompt tail; later ones grow by segment_len
        ends = []
        e = max(start + segment_len, p)
        while e < max_length:
            ends.append(e)
            e += segment_len
        ends.append(max_length)

        def buffers(width, old=None):
            shape = (b, nb, cfg.num_layers, 2, width, self.kv_heads, cfg.head_dim)
            active = torch.zeros(shape, dtype=caches_p.dtype, device=caches_p.device)
            if old is not None:
                active[:, :, :, :, :old.shape[4]] = old
            return active, torch.empty_like(active)

        active, spare = buffers(ends[0] - start)
        if p > start:
            # the prompt tail [start, p) is per beam: ragged prompts re-forward
            # and OVERWRITE these slots during decode, so they must be active
            active[:, :, :, :, :p - start] = caches_p[:, None, :, :, start:]

        prev = start
        for end in ends:
            if active.shape[4] < end - start:
                active, spare = buffers(end - start, old=active)
            for i in range(prev, end):
                tokens, scores, done, parent, tok = self._beam_select(
                    next_logits, tokens, scores, done, pad_row, prompt_lengths, i,
                    end_token_id=end_token_id, longest=longest)
                # reorder ONLY the active cache by parent beam, into the idle
                # buffer; the shared prompt segment never moves
                beam_cache_gather(active, parent, out=spare)
                active, spare = spare, active
                next_logits, _ = self._decode(
                    tok.reshape(b * nb), active.view(b * nb, *active.shape[2:]), i,
                    context=context, cache_offset=start)
            prev = end
        return self._best_beam(tokens, scores)

    def _generate_beam_monolithic(self, prompt_ids, prompt_lengths, *, max_length, sampler,
                                  end_token_id, start, longest):
        """Beam search on one full-length cache.

        The batch is beam-expanded to ``B * nb`` rows after a B-row prefill;
        each step re-ranks (score + log-prob) over ``nb * V`` continuations,
        gathers the KV cache by parent beam (a plain gather of the whole
        cache, not the kernel), and the best-scoring beam per sample is
        returned at the end. Finished beams continue with token 0 at
        log-prob 0, so their scores freeze. Rows whose prompt extends past
        the current step are forced to their prompt token at log-prob 0."""
        nb = sampler.num_beams
        b, _ = prompt_ids.shape
        caches = self.build_cache(b, max_length)
        next_logits, _ = self._prefill(prompt_ids, prompt_lengths, caches)
        # rows [b0, b0, ..., b1, b1, ...]: matches a [B, nb, ...] view
        caches = caches.repeat_interleave(nb, dim=0)
        tokens, scores, done, next_logits, pad_row = self._beam_setup(
            prompt_ids, nb, max_length, next_logits)
        rows = torch.arange(b, device=prompt_ids.device)[:, None]

        for i in range(start, max_length):
            tokens, scores, done, parent, tok = self._beam_select(
                next_logits, tokens, scores, done, pad_row, prompt_lengths, i,
                end_token_id=end_token_id, longest=longest)
            caches = caches.view(b, nb, *caches.shape[1:])[rows, parent]
            caches = caches.view(b * nb, *caches.shape[2:])
            next_logits, _ = self._decode(tok.reshape(b * nb), caches, i)
        return self._best_beam(tokens, scores)

    # -- contrastive search -----------------------------------------------
    def _generate_contrastive_impl(self, prompt_ids, prompt_lengths, *, max_length, sampler,
                                   end_token_id, start, longest, shared_context=True):
        """Contrastive search: at each step the ``k`` most probable
        candidates each take one batched cache forward; the winner maximizes
        ``(1 - alpha) * p - alpha * max cos-sim(h_cand, hidden history)``.

        ``shared_context=True``: candidates share their ENTIRE history and
        differ only in the current token, so the candidate forward attends
        the ``[B]``-row cache as a read-only context segment plus a
        per-candidate 1-slot active cache (its own k/v); only the winner's
        ``[B, L, 2, 1, kvh, d]`` slot is written back. ``False`` keeps the
        monolithic formulation: the cache repeated to ``B * k`` rows each
        step, the winner's row kept."""
        del longest
        kc, alpha = sampler.k, sampler.alpha
        cfg = self.config
        b, p = prompt_ids.shape
        device = prompt_ids.device
        caches = self.build_cache(b, max_length)
        next_logits, hidden_p = self._prefill(prompt_ids, prompt_lengths, caches)
        dim = hidden_p.shape[-1]

        # hidden-state history: prompt states fill [0, P); every slot below
        # the current step is real by the time it is read (each former pad
        # slot is overwritten with its generated token's state when the
        # sweep passes it)
        history = torch.zeros((b, max_length, dim), dtype=torch.float32, device=device)
        history[:, :p] = hidden_p.float()
        tokens = torch.zeros((b, max_length), dtype=torch.long, device=device)
        tokens[:, :p] = prompt_ids
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        rows = torch.arange(b, device=device)
        slot_pos = torch.arange(max_length, device=device)
        if shared_context:
            # every element is written by the candidate forward (slot 0)
            slot = torch.empty((b * kc, cfg.num_layers, 2, 1, self.kv_heads, cfg.head_dim),
                               dtype=caches.dtype, device=device)

        for i in range(start, max_length):
            probs = torch.softmax(next_logits.float(), dim=-1)
            cand_p, cand_ids = S.top_k(probs, kc)  # [B, k]
            # rows still inside their prompt: every candidate IS the prompt
            # token, so the kept cache/history row holds the prompt token's
            # k/v and hidden, not a speculated candidate's
            forced = prompt_lengths > i
            cand_ids = torch.where(forced[:, None], tokens[:, i, None], cand_ids)

            # one batched forward for all candidates
            if shared_context:
                logits_k, hidden_k = self._decode(cand_ids.reshape(b * kc), slot, i,
                                                  context=((caches, 0),), cache_offset=i)
            else:
                caches_k = caches.repeat_interleave(kc, dim=0)
                logits_k, hidden_k = self._decode(cand_ids.reshape(b * kc), caches_k, i)
            h_cand = hidden_k.view(b, kc, dim).float()

            # degeneration penalty: max cosine similarity against every
            # prior hidden state
            h_norm = h_cand / (torch.linalg.vector_norm(h_cand, dim=-1, keepdim=True) + 1e-8)
            hist_norm = history / (torch.linalg.vector_norm(history, dim=-1, keepdim=True) + 1e-8)
            sim = torch.bmm(h_norm, hist_norm.transpose(1, 2))  # [B, k, T]
            sim = torch.where((slot_pos < i)[None, None], sim, -1.0)
            penalty = sim.max(dim=-1).values
            score = (1.0 - alpha) * cand_p - alpha * penalty
            best = torch.argmax(score, dim=-1)  # [B]

            new_tok = cand_ids[rows, best]
            in_gen = (prompt_lengths <= i) & ~done
            tok = torch.where(in_gen, new_tok, tokens[:, i])
            tokens[:, i] = tok
            if end_token_id is not None:
                done = done | (in_gen & (tok == end_token_id))

            # keep the winning candidate's cache / hidden / logits
            if shared_context:
                caches[:, :, :, i:i + 1] = slot.view(b, kc, *slot.shape[1:])[rows, best]
            else:
                caches = caches_k.view(b, kc, *caches.shape[1:])[rows, best]
            history[:, i] = h_cand[rows, best]
            next_logits = logits_k.view(b, kc, -1)[rows, best]
        return tokens

    # -- full-sequence forwards under sequence parallelism ----------------
    def shard_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global ``[B, T, ...]`` array under sequence
        parallelism: rows over ``data_axis``, positions over ``seq_axis``
        (the array itself without it)."""
        par = self.parallel
        if par.dp > 1:
            n = x.shape[0] // par.dp
            x = x[par.data_rank * n:(par.data_rank + 1) * n]
        if par.sp > 1:
            if x.shape[1] % par.sp:
                raise ValueError(f"sequence length {x.shape[1]} is not divisible by the "
                                 f"{par.seq_axis}-axis size {par.sp}")
            n = x.shape[1] // par.sp
            x = x[:, par.seq_rank * n:(par.seq_rank + 1) * n]
        return x

    def _targets(self, token_ids: torch.Tensor) -> torch.Tensor:
        """The next token of each position of this rank's slice; under
        sequence parallelism the last one is the next rank's first token
        (the last rank's last position has none: its column is junk)."""
        nxt = token_ids[:, :1]
        if self.parallel.sp > 1:
            nxt = C.ppermute_shift(nxt.contiguous(), self.parallel.seq_group, shift=-1)
        return torch.cat([token_ids[:, 1:], nxt], dim=1).long()

    def _has_last_position(self) -> bool:
        par = self.parallel
        return par.sp == 1 or par.seq_rank == par.sp - 1

    def score(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Per-token log-likelihood of ``token_ids``: ``[B, T - 1]``. Under
        sequence parallelism ``token_ids`` is this rank's slice, and the
        ranks' results concatenated in rank order are the whole ``[B, T -
        1]`` (the last rank's slice is one shorter)."""
        log_probs = torch.log_softmax(self(token_ids), dim=-1)
        ll = torch.gather(log_probs, 2, self._targets(token_ids)[..., None])[..., 0]
        return ll[:, :-1] if self._has_last_position() else ll

    def next_token_loss(self, token_ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """Mean next-token negative log-likelihood over the positions whose
        TARGET has a nonzero weight (``weights[:, 1:]``), the loss of the
        JAX package's SP and PP tests. Under sequence parallelism both are
        this rank's slices and the loss is the global one on every rank (its
        gradient with respect to the replicated parameters is this rank's
        share: sum them over the axes with :meth:`reduce_gradients`)."""
        par = self.parallel
        logits, targets = self(token_ids), self._targets(token_ids)
        w = torch.cat([weights[:, 1:], weights[:, :1]], dim=1).float()
        if par.sp > 1:
            w[:, -1:] = C.ppermute_shift(weights[:, :1].float().contiguous(), par.seq_group,
                                         shift=-1)
        if self._has_last_position():
            w[:, -1] = 0.0  # no next token
        total, count = masked_nll_sums(logits, targets, w)
        for group in (par.seq_group, par.data_group):
            if group is not None:
                total = C.reduce_from(total, group)
                count = C.all_reduce_values(count, group=group)
        return total / torch.clamp(count, min=1.0)

    def reduce_gradients(self) -> None:
        """Sum the parameters' gradients over the sequence and data axes
        (each rank's backward of :meth:`next_token_loss` holds its share)."""
        params = [p for p in self.parameters() if p.grad is not None]
        for group in (self.parallel.seq_group, self.parallel.data_group):
            C.all_reduce_grads(params, group)
