"""Name-based pretrained-weight ingest (counterpart of
``iseg_tpu/core/h5_ingest.py``).

A flat ``{name: array}`` view of a Keras ``.h5`` / ``.keras`` file or a TF
checkpoint, and a matcher from the model's flax paths to those names. The
port's modules are addressed through :mod:`iseg_tpu_torch.convert`: a
module's weights are its :func:`~iseg_tpu_torch.convert.to_flax` tree, whose
paths (``params/backbone/stem/conv/kernel``, ``batch_stats/.../mean``) and
layouts (HWIO conv kernels, ``[in, out]`` dense kernels) are the JAX
package's, so the same names, maps and transforms apply, and the filled tree
goes back into the module by :func:`~iseg_tpu_torch.convert.load_flax`.

The readers import ``h5py`` or ``tensorflow`` when they are called. Where
neither is installed, pass the flat ``{name: array}`` mapping itself.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
from torch import nn

from iseg_tpu_torch.convert import load_flax, to_flax, unflatten


def read_h5_weights(path) -> dict[str, np.ndarray]:
    """Flatten a Keras .h5 weight file into {slash-name: array}.

    Handles both Keras-2 ``layer_names``/``weight_names`` attr layouts and
    plain nested groups (Keras-3 ``.weights.h5``). ``path`` may be a file
    path or an open file-like object (e.g. a ``.keras`` archive member)."""
    import h5py

    out: dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    return {normalize_weight_name(k): v for k, v in out.items()}


def read_keras_archive_weights(path: str) -> dict[str, np.ndarray]:
    """Flatten a Keras-3 ``.keras`` zip archive's weight store."""
    import io
    import zipfile

    with zipfile.ZipFile(path) as z:
        member = next(
            (n for n in z.namelist() if n.endswith("model.weights.h5")), None)
        if member is None:
            raise ValueError(f"{path}: no model.weights.h5 inside archive")
        data = io.BytesIO(z.read(member))
    return read_h5_weights(data)


def read_tf_checkpoint_weights(path: str) -> dict[str, np.ndarray]:
    """Flatten a TF checkpoint into {name: array}. Strips the
    ``.ATTRIBUTES/VARIABLE_VALUE`` suffix and object-path prefixes that
    ``tf.train.Checkpoint`` adds. Needs TensorFlow, imported here."""
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover
        raise ImportError(".ckpt ingest requires tensorflow") from e

    reader = tf.train.load_checkpoint(path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if "OPTIMIZER" in name.upper() or name.startswith("save_counter"):
            continue
        clean = name.replace("/.ATTRIBUTES/VARIABLE_VALUE", "")
        clean = clean.replace(".ATTRIBUTES/VARIABLE_VALUE", "")
        out[clean] = np.asarray(reader.get_tensor(name))
    return out


def read_pretrained_weights(path: str) -> dict[str, np.ndarray]:
    """Format dispatch by filename: ``.h5``/``.weights.h5`` -> Keras h5,
    ``.keras`` -> zip archive, otherwise a TF checkpoint prefix."""
    if path.endswith(".keras"):
        return read_keras_archive_weights(path)
    if path.endswith(".h5") or path.endswith(".hdf5"):
        return read_h5_weights(path)
    return read_tf_checkpoint_weights(path)


def normalize_weight_name(name: str) -> str:
    """Strip ``:0`` suffixes, collapse duplicate path segments, normalize
    separators."""
    name = name.split(":")[0]
    parts = [p for p in name.split("/") if p]
    # keras2 files repeat the layer name (layer/layer/kernel); purely
    # numeric repeats are real nesting (HRNet fuse chains: .../1/1/gamma),
    # never a keras2 layer-name echo — keep those
    dedup = []
    for p in parts:
        if not dedup or dedup[-1] != p or p.isdigit():
            dedup.append(p)
    return "/".join(dedup)


def canonical_ref_name(name: str, drop_root: bool = False) -> str:
    """Canonicalize a reference/Keras weight name.

    Keras-3 paths repeat the parent chain inside each segment
    (``layers.0/layers.0.blocks.1/layers.0.blocks.1.attn.qkv/kernel``);
    Keras-2 h5 names use plain scopes. Both reduce to the same canonical
    form by (a) stripping ``:0``, (b) dropping the root model-name segment,
    (c) removing each segment's dot-joined parent prefix, and (d) mapping
    the reference's keras3 slash substitution ``.`` back where it was a
    separator. Result: ``layers.0/blocks.1/attn/qkv/kernel``."""
    name = normalize_weight_name(name)
    parts = [p for p in name.split("/") if p]
    ctx: list[str] = []
    if drop_root and len(parts) > 1:
        ctx = parts[0].split(".")
        parts = parts[1:]
    out = []
    for seg in parts:
        stripped = seg
        # remove the longest dot-joined tail of the context from the front
        for k in range(len(ctx), 0, -1):
            prefix = ".".join(ctx[-k:]) + "."
            if seg.startswith(prefix):
                stripped = seg[len(prefix):]
                break
        out.append(stripped)
        ctx = ctx + stripped.split(".")
    return "/".join(out)


# flax param leaf -> keras weight vocabulary
_LEAF_SYNONYMS = {
    "kernel": ("kernel", "depthwise_kernel"),
    "bias": ("bias",),
    "scale": ("gamma",),
    "mean": ("moving_mean",),
    "var": ("moving_variance",),
    "embedding": ("embeddings", "embedding"),
}


def resolve_ref_name(target: str, canon_index: Mapping[str, str]) -> Optional[str]:
    """Resolve a canonical target name against a {canonical: original} index
    by exact match, then by unique ``.../target`` suffix (h5 files may keep
    extra root/group prefixes)."""
    if target in canon_index:
        return canon_index[target]
    # exact match after dropping a single root (model-name) segment — an
    # ambiguous tail suffix (e.g. HRNet's stem "conv1/kernel" vs
    # "layer1/0/conv1/kernel") still resolves this way
    root_stripped = [orig for canon, orig in canon_index.items()
                     if "/" in canon and canon.split("/", 1)[1] == target]
    if len(root_stripped) == 1:
        return root_stripped[0]
    suffix = "/" + target
    hits = [orig for canon, orig in canon_index.items() if canon.endswith(suffix)]
    if len(hits) == 1:
        return hits[0]
    return None


def _sorted_leaves(tree: Mapping, prefix: str = ""):
    """(path, leaf) of a nested tree in the JAX package's order: keys sorted
    at every level, as a flattened pytree lists them."""
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            yield from _sorted_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def load_h5_weights_by_name(
    target,
    h5_path: str | Mapping[str, np.ndarray],
    name_map: Optional[Mapping[str, object] | Callable[[str], Optional[str]]] = None,
    strict: bool = False,
):
    """Assign stored weights into a module (or a flax variables tree) by name.

    Args:
      target: an ``nn.Module`` (its :func:`~iseg_tpu_torch.convert.to_flax`
        tree is matched and the result loaded back by
        :func:`~iseg_tpu_torch.convert.load_flax`), or a nested
        ``{"params": ..., "batch_stats": ...}`` tree of arrays.
      h5_path: an .h5 / .keras / TF-checkpoint path, or an already-flat
        {name: array} mapping (the form to use where h5py is absent).
      name_map: optional mapping {flax_path: spec} or a callable returning
        the stored name for a flax path (None = use heuristics). A spec is a
        canonical reference name (str), an ``(h5_name, transform)`` tuple
        whose transform maps the stored array to the flax layout
        (slice/reshape/transpose), or ``((name1, name2, ...), transform)``
        where the transform combines several stored arrays (fused qkv,
        packed biases).
      strict: raise when a parameter finds no stored counterpart.
    Returns ``(module or new tree, report)``; the report lists the flax
    paths ``loaded`` and ``missing``, and under ``heuristic_fallback`` the
    paths an explicit map did not cover, each in the JAX package's order.
    """
    if isinstance(h5_path, str):
        # full format dispatch (.h5/.keras/TF-ckpt), not h5-only
        weights = read_pretrained_weights(h5_path)
    else:
        weights = {normalize_weight_name(k): np.asarray(v)
                   for k, v in h5_path.items()}
    norm_index: dict[str, str] = {}
    for k in weights:
        norm_index[k.lower()] = k
    canon_index: dict[str, str] = {}
    for k in weights:
        canon_index[canonical_ref_name(k)] = k

    loaded, missing = [], []
    heuristic_fallback = []  # mapped ingests: paths the map did NOT cover

    def lookup(path_str: str, leaf: np.ndarray) -> Optional[np.ndarray]:
        if callable(name_map):
            target_name = name_map(path_str)
            if target_name is not None and target_name in weights:
                return weights[target_name]
        elif name_map and path_str in name_map:
            spec = name_map[path_str]
            transform = None
            if isinstance(spec, tuple):
                spec, transform = spec
            if isinstance(spec, tuple):  # multi-source: ((n1, n2), fn)
                arrays = []
                for s in spec:
                    orig = resolve_ref_name(s, canon_index)
                    if orig is None:
                        return None
                    arrays.append(weights[orig])
                return np.asarray(transform(*arrays))
            orig = resolve_ref_name(spec, canon_index)
            if orig is None:
                return None
            w = weights[orig]
            return np.asarray(transform(w)) if transform is not None else w

        # heuristic: match by tail leaf synonym + module path tokens + shape
        if isinstance(name_map, dict) and name_map:
            # an explicit map was given but did not cover this path —
            # record it so a silently-heuristic assignment is auditable
            heuristic_fallback.append(path_str)
        segs = path_str.lower().split("/")
        leaf_name = segs[-1]
        synonyms = (leaf_name,) + _LEAF_SYNONYMS.get(leaf_name, ())
        prefix = [s for s in segs[:-1] if s not in ("params", "batch_stats")]
        candidates = []
        for norm, orig in norm_index.items():
            nsegs = norm.split("/")
            if nsegs[-1] not in synonyms:
                continue
            if weights[orig].shape != leaf.shape:
                continue
            score = sum(1 for p in prefix if p in norm)
            candidates.append((score, orig))
        if not candidates:
            return None
        candidates.sort(key=lambda t: -t[0])
        best_score, best = candidates[0]
        ties = [c for s, c in candidates if s == best_score]
        if len(ties) > 1:
            # ambiguous at ANY score: picking dict order would silently
            # hand one layer another layer's weights (same shape, same
            # token overlap — e.g. bn1 vs bn2 under one block)
            return None
        return weights[best]

    module = target if isinstance(target, nn.Module) else None
    filled = {}
    for p, leaf in _sorted_leaves(to_flax(module) if module is not None else target):
        leaf = np.asarray(leaf)
        w = lookup(p, leaf)
        if w is None or w.shape != leaf.shape:
            missing.append(p)
            filled[p] = leaf
            continue
        loaded.append(p)
        filled[p] = np.asarray(w, leaf.dtype)
    if strict and missing:
        raise ValueError(f"unmatched parameters: {missing[:10]} (+{len(missing)-10 if len(missing)>10 else 0})")
    report = {"loaded": loaded, "missing": missing, "heuristic_fallback": heuristic_fallback}
    tree = unflatten(filled)
    return (tree if module is None else load_flax(module, tree)), report


def save_h5_weights(source, h5_path: str) -> None:
    """Write a module's :func:`~iseg_tpu_torch.convert.to_flax` tree (or a
    flax variables tree) to a flat .h5 file keyed by flax path, the format
    the JAX package's ``save_h5_weights`` writes and :func:`read_h5_weights`
    reads."""
    import h5py

    if isinstance(source, nn.Module):
        source = to_flax(source)
    with h5py.File(h5_path, "w") as f:
        for path, leaf in _sorted_leaves(source):
            f.create_dataset(path, data=np.asarray(leaf))


__all__ = [
    "canonical_ref_name", "load_h5_weights_by_name", "normalize_weight_name",
    "read_h5_weights", "read_keras_archive_weights", "read_pretrained_weights",
    "read_tf_checkpoint_weights", "resolve_ref_name", "save_h5_weights",
]
