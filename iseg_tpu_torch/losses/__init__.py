"""Segmentation losses."""

from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label
from iseg_tpu_torch.losses.ohem import get_ohem_fn

__all__ = ["cross_entropy_ignore_label", "get_ohem_fn"]
