"""Segmentation losses."""

from iseg_tpu_torch.losses.common import pixel_contrastive_loss, smooth_l1_loss
from iseg_tpu_torch.losses.cross_entropy import cross_entropy_ignore_label
from iseg_tpu_torch.losses.dice import dice_loss, mask_loss
from iseg_tpu_torch.losses.ohem import get_ohem_fn

__all__ = ["cross_entropy_ignore_label", "dice_loss", "get_ohem_fn", "mask_loss",
           "pixel_contrastive_loss", "smooth_l1_loss"]
