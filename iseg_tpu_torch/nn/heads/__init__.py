"""Segmentation heads."""

from iseg_tpu_torch.nn.heads.aspp import ASPP, AtrousSpatialPyramidPooling
from iseg_tpu_torch.nn.heads.fapn import (
    FAPN,
    FeatureAlignedPyramidNet,
    FeatureAlignment,
    FeatureSelectionModule,
)
from iseg_tpu_torch.nn.heads.fpn import (
    FeaturePyramidNetwork,
    SemanticFPN,
    SemanticPyramidNetworkBlockV1,
    SemanticPyramidNetworkBlockV2,
)
from iseg_tpu_torch.nn.heads.jpu import JPU, JointPyramidUpsampling
from iseg_tpu_torch.nn.heads.nasfpn import NASFPN
from iseg_tpu_torch.nn.heads.simpledecoder import SimpleDecoder

__all__ = [
    "ASPP",
    "AtrousSpatialPyramidPooling",
    "FAPN",
    "FeatureAlignedPyramidNet",
    "FeatureAlignment",
    "FeatureSelectionModule",
    "FeaturePyramidNetwork",
    "JPU",
    "JointPyramidUpsampling",
    "NASFPN",
    "SemanticFPN",
    "SemanticPyramidNetworkBlockV1",
    "SemanticPyramidNetworkBlockV2",
    "SimpleDecoder",
]
