"""Segmentation heads."""

from iseg_tpu_torch.nn.heads.aspp import ASPP, AtrousSpatialPyramidPooling

__all__ = ["ASPP", "AtrousSpatialPyramidPooling"]
