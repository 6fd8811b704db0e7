"""Segmentation heads."""

from iseg_tpu_torch.nn.heads.aspp import ASPP, AtrousSpatialPyramidPooling
from iseg_tpu_torch.nn.heads.fpn import (
    FeaturePyramidNetwork,
    SemanticFPN,
    SemanticPyramidNetworkBlockV1,
    SemanticPyramidNetworkBlockV2,
)
from iseg_tpu_torch.nn.heads.simpledecoder import SimpleDecoder

__all__ = [
    "ASPP",
    "AtrousSpatialPyramidPooling",
    "FeaturePyramidNetwork",
    "SemanticFPN",
    "SemanticPyramidNetworkBlockV1",
    "SemanticPyramidNetworkBlockV2",
    "SimpleDecoder",
]
