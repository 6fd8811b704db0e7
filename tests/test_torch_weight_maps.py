"""The port's twelve weight-name maps (``iseg_tpu_torch/core/weight_maps.py``)
and its name-based ingest against the JAX package's.

* parity, one case per family (ConvNeXt V1 and V2 apart, for V2's GRN
  transform) at a small variant: the JAX map over the JAX backbone's own
  variable paths (``jax.eval_shape`` of its init: no compile) and the
  port's map over the port backbone's ``to_flax`` paths give the same
  paths and the same stored names; the same seeded flat dict, built from
  the JAX map's specs, ingested by each package gives equal reports (as
  sets) and parameters equal bit for bit (the JAX result loaded into the
  port by ``convert.load_flax``);
* coverage, one case per inventory of ``tests/data/ref_weights`` (the
  reference's published names and shapes), with the port backbone at full
  width (torch only): every parameter resolves and every published weight
  is consumed. The counterpart of ``tests/test_ref_name_maps.py``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from iseg_tpu.backbones import get_backbone as j_get_backbone
from iseg_tpu.backbones.intern_image import InternImage as JInternImage
from iseg_tpu.core import weight_maps as jmaps
from iseg_tpu.core.h5_ingest import load_h5_weights_by_name as j_load
from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones.intern_image import InternImage
from iseg_tpu_torch.convert import (_leaves, batch_stats_tree, flatten, load_flax, param_tree,
                                    to_flax)
from iseg_tpu_torch.core import weight_maps as tmaps
from iseg_tpu_torch.core.h5_ingest import (canonical_ref_name, load_h5_weights_by_name,
                                           resolve_ref_name)

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "ref_weights")
SMALL_INTERN = dict(channels=16, depths=(1, 1, 1, 1), groups=(2, 2, 4, 4), layer_scale=1.0)

# (case, map name, backbone name or None for SMALL_INTERN, kwargs, input side)
FAMILIES = [
    ("resnet", "keras_resnet_name_map", "resnet9", {}, 32),
    ("mobilenetv2", "keras_mobilenetv2_name_map", "mobilenetv2",
     dict(width_multiplier=0.35), 32),
    ("efficientnet", "efficientnet_name_map", "efficientnetb0", {}, 32),
    ("xception", "xception_name_map", "xception65", {}, 32),
    ("convnext", "convnext_name_map", "convnext_tiny", {}, 32),
    ("convnext_v2", "convnext_name_map", "convnext_v2_atto", {}, 32),
    ("swin", "swin_name_map", "swin_tiny", {}, 224),
    ("vit", "vit_name_map", "vit_small_patch16", {}, 32),
    ("mlp_mixer", "mlp_mixer_name_map", "mlp_mixer_b16", dict(input_size=32), 32),
    ("eva", "eva_name_map", "eva02_tiny", {}, 56),
    ("hrnet", "hrnet_name_map", "hrnet_w32", dict(stage_modules=(1, 1, 1, 1)), 32),
    ("intern_image", "intern_image_name_map", None, {}, 32),
    ("moat", "moat_name_map", "moat0", {}, 32),
]


class Holder(nn.Module):
    """A backbone under the ``backbone`` segment the family maps address
    (``SegManaged``'s layout)."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _jax_tree(name, kwargs, hw):
    if name is None:
        jm = JInternImage(**SMALL_INTERN, return_endpoints=False)
    else:
        jkw = {k: v for k, v in kwargs.items() if k != "input_size"}
        jm = j_get_backbone(name, **jkw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return {col: {"backbone": tree[col]} for col in ("params", "batch_stats") if col in tree}


def _port_holder(name, kwargs):
    """The port backbone under ``backbone``, its tensors zero (as the JAX
    side's), built without drawing its initialization."""
    with torch.device("meta"):
        bb = InternImage(**SMALL_INTERN) if name is None else get_backbone(name, **kwargs)
    holder = Holder(bb).to_empty(device="cpu")
    with torch.no_grad():
        for t in (*holder.parameters(), *holder.buffers()):
            t.zero_()
    return holder


def stored_arrays(mapping, leaves, seed=0) -> dict:
    """{stored name: array} from a map's specs, each drawn from ``seed`` in
    the stored layout whose transform gives its leaf's shape (one draw per
    name where several leaves share it: fused qkv, fused fc1)."""
    rng = np.random.default_rng(seed)
    stored: dict[str, np.ndarray] = {}

    def put(name, shape):
        if name not in stored:
            stored[name] = rng.standard_normal(shape, dtype=np.float32)
        assert stored[name].shape == tuple(shape), (name, stored[name].shape, shape)

    for path in sorted(mapping):
        spec, fn = mapping[path] if isinstance(mapping[path], tuple) else (mapping[path], None)
        shape = tuple(leaves[path].shape)
        q = getattr(fn, "__qualname__", "")
        if fn is None:
            put(spec, shape)
        elif q == "depthwise_to_flax":
            put(spec, (shape[0], shape[1], shape[3], shape[2]))
        elif q == "_squeeze_grn":
            put(spec, (1, 1, 1, shape[0]))
        elif q == "_merge_qkv_heads":
            for s in spec:
                put(s, (shape[0], 1, shape[1] // 3))
        elif q == "_merge_qkv_biases":
            for s in spec:
                put(s, (1, shape[0] // 3))
        elif q == "_flatten_in_heads":
            put(spec, (1, *shape))
        elif q == "_flatten_out_heads":
            put(spec, (shape[0], 1, shape[1]))
        elif "make_slice" in q:
            put(spec, (shape[0], 3 * shape[1]))
        elif "make_half" in q:
            put(spec, (*shape[:-1], 2 * shape[-1]))
        elif "<lambda>" in q:
            put(spec, (1, shape[0]))
        else:
            raise AssertionError(f"unknown transform {q} for {path}")
    return stored


def _spec_names(spec):
    spec = spec[0] if isinstance(spec, tuple) else spec
    return spec if isinstance(spec, tuple) else (spec,)


@pytest.mark.parametrize("case,map_name,name,kwargs,hw", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_torch_weight_map_ingest_equals_jax(case, map_name, name, kwargs, hw):
    jwrapped = _jax_tree(name, kwargs, hw)
    holder = _port_holder(name, kwargs)
    twrapped = to_flax(holder)
    jpaths, tpaths = flatten(jwrapped), flatten(twrapped)
    assert sorted(jpaths) == sorted(tpaths)
    assert all(jpaths[p].shape == tpaths[p].shape for p in jpaths)

    jmap = getattr(jmaps, map_name)(jwrapped)
    tmap = getattr(tmaps, map_name)(twrapped)
    assert sorted(jmap) == sorted(tmap)
    assert len(jmap) > 0.9 * len(jpaths), f"{case}: the map covers too few paths"
    for path in jmap:
        assert _spec_names(jmap[path]) == _spec_names(tmap[path]), path

    stored = stored_arrays(jmap, jpaths)
    jvars, jreport = j_load(jwrapped, stored, name_map=jmap)
    _, treport = load_h5_weights_by_name(holder, stored, name_map=tmap)
    for key in ("loaded", "missing", "heuristic_fallback"):
        assert set(jreport[key]) == set(treport[key]), key
    assert len(treport["loaded"]) >= len(jmap)

    from_jax = load_flax(_port_holder(name, kwargs),
                         jax.tree_util.tree_map(np.asarray, jvars))
    for mine, theirs in ((param_tree(holder), param_tree(from_jax)),
                         (batch_stats_tree(holder), batch_stats_tree(from_jax))):
        assert mine.keys() == theirs.keys()
        for path in mine:
            assert torch.equal(mine[path], theirs[path]), path


# (backbone, inventory, map, kwargs): the families' published checkpoints
INVENTORIES = [
    ("resnet50", "resnet50", "keras_resnet_name_map", {}),
    ("resnet101", "resnet101", "keras_resnet_name_map", {}),
    ("mobilenetv2", "mobilenetv2", "keras_mobilenetv2_name_map", {}),
    ("swin_tiny", "swin_tiny_224", "swin_name_map", {}),
    ("convnext_tiny", "convnext_tiny", "convnext_name_map", {}),
    ("convnext_v2_tiny", "convnext_v2_tiny", "convnext_name_map", {}),
    ("xception65", "xception65", "xception_name_map", {}),
    ("efficientnetb0", "efficientnetb0", "efficientnet_name_map", {}),
    ("vit_base_patch16", "vit_base", "vit_name_map", {}),
    ("mlp_mixer_b16", "mlp_mixer_b16", "mlp_mixer_name_map", dict(input_size=224)),
    ("eva02_tiny", "eva02_tiny", "eva_name_map", {}),
    ("hrnet_w48", "hrnet_w48", "hrnet_name_map", {}),
    ("intern_image_tiny", "intern_image_tiny", "intern_image_name_map", {}),
    ("moat0", "moat0", "moat_name_map", {}),
]


def load_inventory(family) -> dict:
    inv = {}
    with open(os.path.join(DATA, family + ".txt")) as f:
        for line in f:
            name, shape = line.rsplit(" ", 1)
            inv[canonical_ref_name(name, drop_root=True)] = tuple(
                int(d) for d in shape.strip().split(","))
    return inv


@pytest.mark.parametrize("name,inventory,map_name,kwargs", INVENTORIES,
                         ids=[i[0] for i in INVENTORIES])
def test_torch_weight_map_covers_published_inventory(name, inventory, map_name, kwargs):
    inv = load_inventory(inventory)
    with torch.device("meta"):  # the full-width model's paths and shapes, without numbers
        holder = Holder(get_backbone(name, **kwargs))
    shapes = {f"{col}/{path}": tuple(to_flax_fn(t).shape)
              for col, path, t, to_flax_fn, _ in _leaves(holder)}
    mapping = getattr(tmaps, map_name)(list(shapes))

    weights = {k: np.zeros(v, np.float32) for k, v in inv.items()}
    canon_index = {canonical_ref_name(k): k for k in weights}
    missing, used = [], set()
    for path, spec in mapping.items():
        fn = spec[1] if isinstance(spec, tuple) else None
        arrays = []
        for s in _spec_names(spec):
            orig = resolve_ref_name(s, canon_index)
            if orig is not None:
                used.add(orig)
                arrays.append(weights[orig])
        if len(arrays) != len(_spec_names(spec)):
            missing.append(path)
            continue
        value = fn(*arrays) if fn is not None else arrays[0]
        if tuple(value.shape) != shapes[path]:
            missing.append(path)
    unmapped = sorted(set(shapes) - set(mapping))
    assert not unmapped, f"{name}: {len(unmapped)} params outside the map, e.g. {unmapped[:8]}"
    assert not missing, f"{name}: {len(missing)} params did not resolve, e.g. {missing[:8]}"
    unused = sorted(set(weights) - used)
    assert not unused, f"{name}: {len(unused)} published weights unconsumed, e.g. {unused[:8]}"
