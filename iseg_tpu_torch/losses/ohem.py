"""Online hard example mining (counterpart of ``iseg_tpu/losses/ohem.py``).

Two selectors:

* the default (``ref_exact=False``): keep pixels whose true-class
  probability is below ``thresh``; if fewer than ``min_kept`` qualify,
  keep the ``min_kept`` hardest (highest-loss) valid pixels as well, the
  mmseg-style semantics. Among equal losses the lower flat index is the
  harder one, as ``jax.lax.top_k`` ranks them: the hardest ``k`` come from
  a stable descending sort (``torch.topk`` ranks ties in no fixed order on
  CUDA, so a loss tie at the ``k``-th value could keep other pixels).
* ``ref_exact=True``: the reference's ``ohem_selector`` reproduced with its
  quirks: it sorts the true-class probabilities descending, takes the value
  at rank ``min(min_kept * batch, n_valid - 1)`` as a floor for the
  threshold, and keeps pixels with a probability strictly below
  ``max(that, thresh)``, so ``min_kept * batch`` acts as the number of
  easiest pixels dropped, not a minimum kept. With ``thresh=None`` it keeps
  the pixels whose loss is strictly above the loss at rank
  ``min(min_kept * batch, n - 1)``.

Under an active data-parallel group both select over the global batch
(:func:`_over_global_batch`), as the JAX package's selector over a
GSPMD-sharded batch does.

The keep map is built from comparisons under ``torch.no_grad()``: no
gradient flows through the selection. Nothing here reads a value back to
the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from iseg_tpu_torch.parallel.collectives import active_group, all_gather, rank, world_size


def _hardest_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``values``, ties to the lower index."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def get_ohem_fn(thresh: float | None = 0.7, min_kept: int = 100000,
                ref_exact: bool = False) -> Callable:
    """Returns ``ohem(losses, probs, mask) -> keep weights``, applied after
    the per-pixel loss. ``losses``/``probs``/``mask`` are [N, H, W]; the
    result is a 0/1 map of the losses' shape and dtype."""

    @torch.no_grad()
    def ohem_ref(losses: torch.Tensor, true_probs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        batch = losses.shape[0]
        valid = mask > 0
        # the reference's selector receives the sample-weighted loss (0 on
        # ignored pixels)
        flat_loss = (losses.detach() * valid).reshape(-1)
        bmk = min(min_kept * batch, flat_loss.numel() - 1)
        if thresh is not None:
            # true-class probability, 0 on ignored pixels
            seg_prob = (true_probs.detach() * valid).reshape(-1)
            non_zeros = (seg_prob != 0).sum()
            rank = torch.clamp(torch.clamp(non_zeros - 1, max=bmk), min=0)
            sorted_desc = torch.sort(seg_prob, descending=True).values
            min_threshold = torch.where(non_zeros > 0, sorted_desc[rank],
                                        torch.zeros((), dtype=seg_prob.dtype,
                                                    device=seg_prob.device))
            threshold = torch.clamp(min_threshold, min=thresh)
            kept = seg_prob < threshold
        else:
            threshold = torch.sort(flat_loss, descending=True).values[bmk]
            kept = flat_loss > threshold
        return kept.to(losses.dtype).reshape(losses.shape)

    @torch.no_grad()
    def ohem(losses: torch.Tensor, true_probs: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        flat_loss = losses.detach().reshape(-1)
        flat_prob = true_probs.detach().reshape(-1)
        flat_mask = mask.reshape(-1) > 0

        hard = flat_mask & (flat_prob < thresh)
        n_hard = hard.sum()

        k = min(min_kept, flat_loss.numel())
        # hardest k among valid pixels (invalid ones pushed to -inf)
        cand = torch.where(flat_mask, flat_loss, float("-inf"))
        topk_mask = torch.zeros_like(flat_mask)
        topk_mask[_hardest_k(cand, k)] = True
        topk_mask &= flat_mask

        kept = torch.where(n_hard >= k, hard, hard | topk_mask)
        return kept.to(losses.dtype).reshape(losses.shape)

    return _over_global_batch(ohem_ref if ref_exact else ohem)


def _over_global_batch(select: Callable) -> Callable:
    """``select`` over the global batch under an active data-parallel group:
    every rank all-gathers the ranks' losses, probabilities and masks (rank
    order is the global batch's order, so a flat index is the JAX package's
    global one and ties go to the lower global index), selects over all of
    them and keeps its own rows. Without a group, ``select`` itself."""
    @torch.no_grad()
    def over_global(losses: torch.Tensor, true_probs: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        group = active_group()
        if world_size(group) == 1:
            return select(losses, true_probs, mask)
        n = losses.shape[0]
        kept = select(all_gather(losses.detach(), group), all_gather(true_probs.detach(), group),
                      all_gather(mask, group))
        r = rank(group)
        return kept[r * n:(r + 1) * n]

    return over_global
