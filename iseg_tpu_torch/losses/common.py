"""Smooth-L1 and pixel contrastive losses (counterpart of
``iseg_tpu/losses/common.py``). NHWC features, ``[N, H, W]`` labels."""

from __future__ import annotations

import torch

from iseg_tpu_torch.ops.numerics import l2_normalize


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1, mean over every element."""
    diff = (_float(pred) - _float(target)).abs()
    return torch.where(diff < delta, 0.5 * diff * diff / delta, diff - 0.5 * delta).mean()


def pixel_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                           temperature: float = 0.1, ignore_label: int = 255,
                           max_samples: int = 1024) -> torch.Tensor:
    """InfoNCE-style loss over pixel embeddings: pixels of one label attract,
    others repel, within each image. Pixels are taken at a fixed stride,
    the ceiling of ``H*W / max_samples`` (a floor would keep only the first
    ``max_samples`` pixels, the top of the image, whenever ``H*W`` is not
    near a multiple), so the similarity matrix has at most
    ``max_samples``² entries."""
    n, h, w, c = features.shape
    feats = _float(features).reshape(n, h * w, c)
    labs = labels.reshape(n, h * w)
    total = h * w
    stride = max(1, -(-total // max_samples))
    idx = torch.arange(0, total, stride, device=features.device)[:max_samples]
    feats = l2_normalize(feats[:, idx], dim=-1)
    labs = labs[:, idx]
    sim = torch.einsum("bic,bjc->bij", feats, feats) / temperature

    same = (labs[:, :, None] == labs[:, None, :]).to(sim.dtype)
    valid = (labs != ignore_label).to(sim.dtype)
    pair_valid = valid[:, :, None] * valid[:, None, :]
    eye = torch.eye(sim.shape[-1], dtype=sim.dtype, device=sim.device)[None]
    pos = same * pair_valid * (1.0 - eye)
    neg_mask = pair_valid * (1.0 - eye)

    sim = torch.where(neg_mask > 0, sim, torch.full_like(sim, -1e9))
    log_prob = sim - torch.logsumexp(sim, dim=-1, keepdim=True)
    pos_sum = pos.sum(dim=-1)
    loss_i = -(pos * log_prob).sum(dim=-1) / pos_sum.clamp(min=1.0)
    has_pos = (pos_sum > 0).to(sim.dtype)
    return (loss_i * has_pos).sum() / has_pos.sum().clamp(min=1.0)
