"""Pretrained backbone loading: construct + ingest + DCN auto-calibration
(counterpart of ``iseg_tpu/backbones/pretrained.py``).

:func:`load_pretrained_backbone` builds a backbone, fills it from a
published checkpoint by its family's name map
(:mod:`iseg_tpu_torch.core.weight_maps`), and, when the checkpoint holds
DCNv3 offset heads, :func:`auto_calibrate_dcn` measures each layer's largest
effective offset on a sample forward and pins a per-block sampling mode:
the dense-local kernels with the smallest exact clamp r, or the exact
gather path when trained offsets are too large for any clamp up to
``max_dense_r``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from iseg_tpu_torch.backbones.registry import get_backbone
from iseg_tpu_torch.convert import flatten, load_flax, to_flax, unflatten
from iseg_tpu_torch.core.env import resolve_device
from iseg_tpu_torch.nn.initializers import initialize

# family -> weight_maps builder, matched by longest name prefix
_FAMILY_MAPS: dict[str, str] = {
    "resnet": "keras_resnet_name_map",
    "mobilenetv2": "keras_mobilenetv2_name_map",
    "efficientnet": "efficientnet_name_map",
    "xception": "xception_name_map",
    "convnext": "convnext_name_map",
    "swin": "swin_name_map",
    "vit": "vit_name_map",
    "mlp_mixer": "mlp_mixer_name_map",
    "eva": "eva_name_map",
    "hrnet": "hrnet_name_map",
    "intern_image": "intern_image_name_map",
    "moat": "moat_name_map",
}


def name_map_for(backbone_name: str) -> Optional[Callable]:
    """The weight-name map builder for a backbone family (None when the
    heuristic matcher in ``h5_ingest`` should be used instead)."""
    from iseg_tpu_torch.core import weight_maps

    best = None
    for prefix, fn_name in _FAMILY_MAPS.items():
        if backbone_name.startswith(prefix) and (
            best is None or len(prefix) > len(best[0])
        ):
            best = (prefix, fn_name)
    return getattr(weight_maps, best[1]) if best else None


def auto_calibrate_dcn(model, sample_input: torch.Tensor, max_dense_r: int = 6,
                       margin: float = 0.5):
    """Measure trained DCN offsets and pin per-block sampling modes.

    Returns ``(model, report)``: ``model`` is rebuilt by its ``clone`` with
    ``dcn_overrides`` (the same weights, device and drop-path generators)
    when it has that field and any DCN layer was found; ``report`` is
    :func:`~iseg_tpu_torch.nn.dcn.calibrate_dcn_sampling`'s per-layer table
    (empty for DCN-free models). ``sample_input`` is an NCHW batch on the
    model's device."""
    from iseg_tpu_torch.nn.dcn import calibrate_dcn_sampling

    report = calibrate_dcn_sampling(model, sample_input, max_dense_r=max_dense_r,
                                    margin=margin)
    if report and hasattr(model, "dcn_overrides"):
        overrides = {}
        for layer_path, rec in report.items():
            block = layer_path.split("/")[0]
            overrides[block] = (
                rec["recommended_sampling"],
                max(int(rec["recommended_r"]), 1),
            )
        model = model.clone(dcn_overrides=overrides)
    return model, report


def _wrap_key(k: str) -> str:
    segs = k.split("/")
    if len(segs) > 1 and segs[1] == "backbone":
        return k  # already wrapped (family maps build from wrapped)
    return "/".join([segs[0], "backbone", *segs[1:]])


def _unwrap_key(k: str) -> str:
    segs = k.split("/")
    if len(segs) > 1 and segs[1] == "backbone":
        return "/".join([segs[0], *segs[2:]])
    return k


def load_pretrained_backbone(
    name: str,
    weights: Union[str, Mapping[str, np.ndarray], None] = None,
    *,
    input_size: tuple[int, int] = (64, 64),
    name_map: Union[str, Mapping, Callable, None] = "auto",
    calibrate_dcn: bool = True,
    calibration_input: Optional[torch.Tensor] = None,
    strict: bool = False,
    seed: int = 0,
    device=None,
    **kwargs,
):
    """Build a backbone, ingest pretrained weights, auto-calibrate DCN.

    Returns ``(model, report)``: the backbone on ``device`` (``"cuda"`` by
    default; raises without a card unless ``device="cpu"``), initialized
    from ``seed`` and then filled from ``weights``, in train mode as built
    (the calibration forward runs in eval mode), and a report holding the
    ingest summary (``"weights"``) and the DCN calibration table
    (``"dcn_calibration"``) when applicable.

    ``weights`` is a ``.h5`` / ``.keras`` / TF-checkpoint path or a flat
    ``{name: array}`` mapping (the form to use where h5py is absent).
    ``name_map="auto"`` resolves the family's published-checkpoint name
    table (:mod:`iseg_tpu_torch.core.weight_maps`); pass an explicit mapping
    or callable for custom files, or ``None`` for the heuristic matcher.
    Family maps address paths below a ``backbone`` segment (the
    ``SegManaged`` layout); a user's mapping or ``str -> str`` resolver
    addresses the backbone's own paths (``params/stem/...``).

    ``calibration_input`` (NCHW) should be a real preprocessed sample batch
    when available: trained offset heads are input-dependent, so
    representative data gives the tightest safe clamp. The default is a
    seeded uniform batch in [-1, 1) of 2 images at ``input_size``, drawn from
    a ``torch.Generator`` seeded with ``seed + 1``. An MLP-Mixer is built
    for ``input_size`` (its token MLPs fix the size)."""
    device = resolve_device("cuda" if device is None else device)
    if name.startswith("mlp_mixer"):
        kwargs.setdefault("input_size", tuple(input_size))
    model = initialize(get_backbone(name, **kwargs),
                       torch.Generator().manual_seed(seed)).to(device)
    report: dict = {}

    if weights is not None:
        from iseg_tpu_torch.core.h5_ingest import load_h5_weights_by_name

        variables = to_flax(model)
        wrapped = {coll: {"backbone": tree} for coll, tree in variables.items() if tree}

        mapping = name_map
        if name_map == "auto":
            map_fn = name_map_for(name)
            mapping = map_fn(wrapped) if map_fn else None
        elif callable(name_map):
            # a family-style builder returns a dict from the variables;
            # anything else is h5_ingest's str -> str resolver contract.
            # Only the signature-mismatch errors a str -> str resolver
            # would raise on a tree are probed: a bug inside a dict builder
            # (e.g. KeyError) must propagate
            try:
                built = name_map(wrapped)
            except (TypeError, AttributeError):
                built = None
            if isinstance(built, dict):
                mapping = built
            else:
                mapping = lambda p, _fn=name_map: _fn(_unwrap_key(p))  # noqa: E731
        if isinstance(mapping, dict):
            mapping = {_wrap_key(k): v for k, v in mapping.items()}
        filled, load_report = load_h5_weights_by_name(wrapped, weights, name_map=mapping,
                                                      strict=strict)
        load_flax(model, unflatten({_unwrap_key(k): v for k, v in flatten(filled).items()}))
        report["weights"] = load_report

    if calibrate_dcn:
        if calibration_input is None:
            # random probe in normalized-image range: activates the
            # input-dependent part of the offset heads, unlike zeros
            gen = torch.Generator().manual_seed(seed + 1)
            calibration_input = 2.0 * torch.rand((2, 3, *input_size), generator=gen) - 1.0
        model, calib = auto_calibrate_dcn(model, calibration_input.to(device))
        if calib:
            report["dcn_calibration"] = calib
    return model, report
