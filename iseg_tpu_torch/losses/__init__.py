"""Segmentation losses."""

from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label

__all__ = ["cross_entropy_ignore_label"]
