"""Connected-components labeling (counterpart of ``iseg_tpu/ops/ccl.py``).

Min-label propagation: every foreground pixel starts with its own linear
index, and each iteration takes the minimum label over the pixel's 4- or
8-neighbourhood (shifted minima, background held at a large value) until
nothing changes. Each component ends with its smallest linear index; the
labels are that index plus 1, background 0, int32, the JAX package's
labels exactly. The loop converges in O(component diameter) iterations.

On a CUDA tensor, testing whether an iteration changed anything reads a
flag back to the host, which waits for the device. The fixpoint is
idempotent, so the loop tests once every ``CHECK_EVERY`` iterations and
runs at most ``CHECK_EVERY - 1`` iterations past it, which change nothing.
``relabel_sequential`` compacts the labels to 1..K with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 2 ** 30
CHECK_EVERY = 16  # iterations between two tests for the fixpoint

_OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_OFFSETS_8 = _OFFSETS_4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _neighbor_min(labels: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min over the 4- or 8-neighbourhood of ``labels`` [N, H, W] (no
    self), ``_BIG`` where a neighbour falls outside."""
    h, w = labels.shape[-2:]
    out = torch.full_like(labels, _BIG)
    for dy, dx in _OFFSETS_8 if connectivity == 8 else _OFFSETS_4:
        # out[i, j] = min(out[i, j], labels[i - dy, j - dx]) where that is inside
        oy, ox = slice(max(dy, 0), h + min(dy, 0)), slice(max(dx, 0), w + min(dx, 0))
        iy, ix = slice(max(-dy, 0), h + min(-dy, 0)), slice(max(-dx, 0), w + min(-dx, 0))
        view = out[:, oy, ox]
        torch.minimum(view, labels[:, iy, ix], out=view)
    return out


def label_components(mask: torch.Tensor, connectivity: int = 4,
                     return_iterations: bool = False):
    """Label connected foreground components.

    Args:
      mask: [H, W] or [N, H, W] bool/int foreground mask.
      connectivity: 4 or 8.
      return_iterations: also return the iterations run (a multiple of
        ``CHECK_EVERY``).
    Returns int32 labels on ``mask``'s device, 0 for background, a
    component's smallest linear index plus 1 elsewhere (with
    ``return_iterations``, ``(labels, iterations)``).
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    squeeze = mask.ndim == 2
    if squeeze:
        mask = mask[None]
    mask = mask.to(torch.bool)
    n, h, w = mask.shape
    if h * w >= _BIG:
        raise ValueError(f"a {h}x{w} map has more pixels than the labels can index")
    big = torch.tensor(_BIG, dtype=torch.int32, device=mask.device)
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(1, h, w)
    labels = torch.where(mask, idx, big)
    iterations = 0
    while True:
        before = labels
        for _ in range(CHECK_EVERY):
            labels = torch.minimum(labels, torch.where(mask, _neighbor_min(labels, connectivity),
                                                       big))
        iterations += CHECK_EVERY
        if torch.equal(labels, before):
            break
    out = torch.where(mask, labels + 1, torch.zeros_like(labels))
    out = out[0] if squeeze else out
    return (out, iterations) if return_iterations else out


def relabel_sequential(labels: np.ndarray) -> np.ndarray:
    """Host-side compaction of arbitrary component ids to 1..K."""
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    uniq = uniq[uniq != 0]
    out = np.zeros_like(labels)
    for new_id, old in enumerate(uniq, start=1):
        out[labels == old] = new_id
    return out
