"""Backbone zoo (ResNet family so far), by name."""

from iseg_tpu_torch.backbones.registry import get_backbone, list_backbones, register_backbone

__all__ = ["get_backbone", "list_backbones", "register_backbone"]
