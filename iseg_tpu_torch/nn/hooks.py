"""Feature taps (counterpart of ``iseg_tpu/nn/hooks.py``): capture
intermediate activations from any module.

:class:`HookPoint` is an identity module. Inside :func:`capture_intermediates`
each call records its input into a nested dict shaped like flax's
``intermediates`` collection: the module's path, then ``"tap"``, holding a
tuple of the tensors of every call. :func:`get_taps` flattens it to
``{path: tensor}`` with the keys the JAX package's ``get_taps`` gives::

    with capture_intermediates(model) as collections:
        out = model(x)
    taps = get_taps(collections)   # {"backbone_out/tap": tensor, ...}

Outside a capture nothing is recorded and nothing is kept.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

import torch
from torch import nn


class HookPoint(nn.Module):
    """Identity layer that records its input while a capture is on."""

    def __init__(self):
        super().__init__()
        self._store: Optional[dict] = None
        self._path: tuple[str, ...] = ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._store is not None:
            node = self._store
            for key in self._path:
                node = node.setdefault(key, {})
            node["tap"] = node.get("tap", ()) + (x,)
        return x


@contextlib.contextmanager
def capture_intermediates(model: nn.Module) -> Iterator[dict[str, Any]]:
    """Record every :class:`HookPoint` of ``model`` while the block runs;
    yields ``{"intermediates": {...}}``, filled as the model runs."""
    collections: dict[str, Any] = {"intermediates": {}}
    points = [(name, m) for name, m in model.named_modules() if isinstance(m, HookPoint)]
    for name, m in points:
        m._store, m._path = collections["intermediates"], tuple(name.split(".")) if name else ()
    try:
        yield collections
    finally:
        for _, m in points:
            m._store, m._path = None, ()


def get_taps(mutated_collections: dict) -> dict[str, Any]:
    """Flatten the ``intermediates`` collection into {path: tensor}; a tap
    recorded once is the tensor, more than once the tuple."""
    out = {}
    inter = mutated_collections.get("intermediates", {})

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = tree[0] if isinstance(tree, tuple) and len(tree) == 1 else tree

    walk(inter, "")
    return out
