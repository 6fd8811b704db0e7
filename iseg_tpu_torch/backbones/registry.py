"""Backbone name registry + dispatch (counterpart of
``iseg_tpu/backbones/registry.py``). Only the ResNet family is ported."""

from __future__ import annotations

from typing import Callable, Optional

_REGISTRY: dict[str, Callable] = {}

_BUILTIN_MODULES = ("resnet",)


def register_backbone(name: str, constructor: Optional[Callable] = None):
    """Register a backbone constructor; usable as a decorator."""

    def _register(ctor):
        if name in _REGISTRY:
            raise ValueError(f"backbone {name!r} already registered")
        _REGISTRY[name] = ctor
        return ctor

    if constructor is not None:
        return _register(constructor)
    return _register


def _ensure_builtins() -> None:
    # import-time registration of the built-in zoo (lazy to avoid cycles)
    for mod in _BUILTIN_MODULES:
        __import__(f"iseg_tpu_torch.backbones.{mod}")


def list_backbones() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def get_backbone(name: str, output_stride: int = 32, return_endpoints: bool = True, **kwargs):
    """Name -> constructed backbone module."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unknown backbone {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](output_stride=output_stride, return_endpoints=return_endpoints,
                           **kwargs)
