"""Backbone name registry + dispatch (counterpart of
``iseg_tpu/backbones/registry.py``), with the JAX package's 13 built-in
families. A built-in module that fails to import is recorded, and
:func:`get_backbone` names the failure in its ``KeyError``."""

from __future__ import annotations

from typing import Callable, Optional

_REGISTRY: dict[str, Callable] = {}

_BUILTIN_MODULES = ("mobilenetv2", "resnet", "xception", "efficientnet", "hrnet", "convnext",
                    "swin", "vit", "mlp_mixer", "moat", "eva", "intern_image", "placeholder")
_BUILTIN_IMPORT_ERRORS: dict[str, str] = {}


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
    # import-time registration of the built-in zoo (lazy to avoid cycles);
    # a failure is recorded, so get_backbone can say why a name is missing
    for mod in _BUILTIN_MODULES:
        try:
            __import__(f"iseg_tpu_torch.backbones.{mod}")
            _BUILTIN_IMPORT_ERRORS.pop(mod, None)
        except ImportError as e:
            _BUILTIN_IMPORT_ERRORS[mod] = repr(e)


def list_backbones() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def get_backbone(name: str, output_stride: int = 32, return_endpoints: bool = True, **kwargs):
    """Name -> constructed backbone module."""
    _ensure_builtins()
    if name not in _REGISTRY:
        extra = (f"; built-in modules that FAILED to import: {_BUILTIN_IMPORT_ERRORS}"
                 if _BUILTIN_IMPORT_ERRORS else "")
        raise KeyError(f"unknown backbone {name!r}; registered: {sorted(_REGISTRY)}{extra}")
    return _REGISTRY[name](output_stride=output_stride, return_endpoints=return_endpoints,
                           **kwargs)
