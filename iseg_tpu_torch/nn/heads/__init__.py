"""Segmentation heads."""

from iseg_tpu_torch.nn.heads.aspp import ASPP, AtrousSpatialPyramidPooling
from iseg_tpu_torch.nn.heads.fpn import (
    FeaturePyramidNetwork,
    SemanticFPN,
    SemanticPyramidNetworkBlockV1,
    SemanticPyramidNetworkBlockV2,
)
from iseg_tpu_torch.nn.heads.jpu import JPU, JointPyramidUpsampling
from iseg_tpu_torch.nn.heads.simpledecoder import SimpleDecoder

__all__ = [
    "ASPP",
    "AtrousSpatialPyramidPooling",
    "FeaturePyramidNetwork",
    "JPU",
    "JointPyramidUpsampling",
    "SemanticFPN",
    "SemanticPyramidNetworkBlockV1",
    "SemanticPyramidNetworkBlockV2",
    "SimpleDecoder",
]
