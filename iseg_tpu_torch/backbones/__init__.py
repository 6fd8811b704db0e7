"""Backbone zoo by name: the JAX package's 13 families (MobileNetV2, ResNet,
Xception, EfficientNet, HRNet, ConvNeXt, Swin, ViT, MLP-Mixer, MOAT, EVA02,
InternImage and the placeholder)."""

from iseg_tpu_torch.backbones.registry import get_backbone, list_backbones, register_backbone

__all__ = ["get_backbone", "list_backbones", "register_backbone"]
