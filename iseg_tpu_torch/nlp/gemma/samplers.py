"""Pluggable sampling strategies for causal-LM generation.

Counterpart of ``iseg_tpu/nlp/gemma/samplers.py``, with the same seven
classes and :func:`get_sampler`. Samplers are frozen dataclasses. Flat
samplers implement ``sample(logits [B, V], generator) -> tokens [B]``
(int64) and drop into the decode loop unchanged; randomness comes from an
explicit ``torch.Generator`` on the logits' device (it cannot reproduce
``jax.random`` draw for draw: the two agree in their support and at
temperature 0). ``BeamSampler`` and ``ContrastiveSampler`` are structural:
``generate`` in ``causal_lm.py`` runs its own program for them.

**Ties.** :func:`top_k` is the one place where the k best are picked (beam
search over ``nb * V`` continuations, contrastive candidates, top-k and
top-p sampling). ``jax.lax.top_k`` returns the lower index first among equal
values. On the CPU :func:`top_k` follows that rule (a stable descending
sort), so tokens equal the JAX package's even where dead beams tie exactly
at ``-1e9``. On CUDA it is ``torch.topk``, which promises no order among
equal values: there an exact tie is broken by the library's choice. In beam
search exact ties arise only among continuations of dead beams (score
``-1e9``), which never reach the returned sequence; ``argmax`` takes the
first maximum on both devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis, descending, as ``(values,
    indices)``; see the module docstring for the tie rule."""
    if values.device.type == "cpu":
        vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    return torch.topk(values, k, dim=-1)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``softmax(logits)``."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base: subclasses override ``sample``."""

    def sample(self, logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GreedySampler(Sampler):
    """argmax decoding (sampler name ``"greedy"``)."""

    def sample(self, logits, generator=None):
        return torch.argmax(logits, dim=-1)


def _maybe_temperature(logits, temperature: float):
    if temperature == 1.0:
        return logits
    return logits / temperature


@dataclasses.dataclass(frozen=True)
class RandomSampler(Sampler):
    """Sample the full softmax (``"random"``); temperature 0 is greedy."""

    temperature: float = 1.0

    def sample(self, logits, generator=None):
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        return _categorical(_maybe_temperature(logits, self.temperature), generator)


@dataclasses.dataclass(frozen=True)
class TopKSampler(Sampler):
    """Sample among the k most probable tokens (``"top_k"``)."""

    k: int = 5
    temperature: float = 1.0

    def sample(self, logits, generator=None):
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        vals, idx = top_k(_maybe_temperature(logits, self.temperature), self.k)
        choice = _categorical(vals, generator)
        return torch.gather(idx, 1, choice[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class TopPSampler(Sampler):
    """Nucleus sampling (``"top_p"``): sample within the smallest set of
    tokens whose cumulative probability exceeds ``p``. ``k`` optionally
    truncates to the k best before the cumulative filter."""

    p: float = 0.9
    k: Optional[int] = None
    temperature: float = 1.0

    def sample(self, logits, generator=None):
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = _maybe_temperature(logits, self.temperature)
        vals, idx = top_k(logits, self.k or logits.shape[-1])  # descending
        probs = torch.softmax(vals.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass *before* them is < p (the first
        # token always survives; the one crossing p is included)
        keep = (cum - probs) < self.p
        vals = torch.where(keep, vals, float("-inf"))
        choice = _categorical(vals, generator)
        return torch.gather(idx, 1, choice[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class ContrastiveSampler(Sampler):
    """Contrastive search. Structural: ``generate`` re-scores the
    ``k`` most probable candidates by ``(1 - alpha) * p(candidate) - alpha *
    max cosine-similarity`` against the hidden-state history, which takes
    one batched model step over the candidates per decode step."""

    k: int = 5
    alpha: float = 0.6

    def sample(self, logits, generator=None):
        raise TypeError("ContrastiveSampler is handled by generate()")


@dataclasses.dataclass(frozen=True)
class BeamSampler(Sampler):
    """Beam search. Structural: handled by ``generate``
    (beam-expanded batch, per-step KV-cache reordering, best beam at the
    end)."""

    num_beams: int = 2

    def sample(self, logits, generator=None):
        raise TypeError("BeamSampler is handled by generate(), not per-step")


_NAMED = {
    "greedy": GreedySampler,
    "random": RandomSampler,
    "top_k": TopKSampler,
    "top_p": TopPSampler,
    "beam": BeamSampler,
    "contrastive": ContrastiveSampler,
}


def get_sampler(sampler: Union[str, Sampler, None], **defaults) -> Sampler:
    """Resolve a sampler name or instance; None is greedy."""
    if sampler is None:
        return GreedySampler()
    if isinstance(sampler, Sampler):
        return sampler
    if isinstance(sampler, str):
        cls = _NAMED.get(sampler)
        if cls is None:
            raise ValueError(f"unknown sampler {sampler!r}; one of {sorted(_NAMED)}")
        return cls(**defaults)
    raise TypeError(f"sampler must be a name or Sampler, got {type(sampler)}")
