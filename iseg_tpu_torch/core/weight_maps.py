"""Explicit weight-name maps: published Keras checkpoints -> the port's
flax paths (counterpart of ``iseg_tpu/core/weight_maps.py``).

The reference loads its published backbone weights by Keras layer name.
Drop-in compatibility needs exact name tables per family; the heuristic
matcher in :mod:`iseg_tpu_torch.core.h5_ingest` covers same-vocabulary
files, these maps cover the Keras-applications naming schemes.

Each map function takes a model's :func:`~iseg_tpu_torch.convert.to_flax`
tree (or its flattened list of ``collection/...`` paths) and returns
{flax_path: spec} for ``load_h5_weights_by_name(..., name_map=...)``. The
port's module names are the flax tree's, so the paths, and every transform
here, are in the JAX package's flax layout (HWIO conv kernels, ``[in, out]``
dense kernels); :mod:`iseg_tpu_torch.convert` owns the change to torch
layouts.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from iseg_tpu_torch.convert import flatten

_LEAF_TO_KERAS_CONV = {"kernel": "kernel", "bias": "bias"}
_LEAF_TO_KERAS_BN = {
    "scale": "gamma",
    "bias": "beta",
    "mean": "moving_mean",
    "var": "moving_variance",
}


def depthwise_to_flax(w):
    """Keras depthwise kernel [H, W, C, mult] -> flax grouped-conv kernel
    [H, W, mult, C]."""
    return w.transpose(0, 1, 3, 2)


def _paths(variables) -> list[str]:
    """``collection/...`` paths of a nested variables tree; a list of paths
    passes through."""
    return list(flatten(variables)) if isinstance(variables, Mapping) else list(variables)


def keras_resnet_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, str]:
    """Map the port's ResNet params to keras.applications ResNet50/101/152
    names (``conv1_conv``, ``conv{s}_block{b}_{i}_conv`` / ``_bn``,
    shortcut = ``_0_conv``/``_0_bn``)."""
    mapping: dict[str, str] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        i = segs.index(backbone_prefix)
        rel = segs[i + 1 :]
        leaf = rel[-1]

        if rel[0] == "stem":
            # stem/conv/kernel or stem/norm/{scale,...}
            if rel[1] == "conv":
                name = f"conv1_conv/{_LEAF_TO_KERAS_CONV.get(leaf)}"
            else:
                name = f"conv1_bn/{_LEAF_TO_KERAS_BN.get(leaf)}"
            mapping[path] = name
            continue

        if rel[0].startswith("stem"):
            # deep stem: stem{i} -> conv1_{i+1}_conv / conv1_{i+1}_bn
            # (reference build_3x3_resnet, resnet_common.py:246-276)
            i_stem = int(rel[0][4:]) + 1
            if rel[1] == "conv":
                name = f"conv1_{i_stem}_conv/{_LEAF_TO_KERAS_CONV.get(leaf)}"
            else:
                name = f"conv1_{i_stem}_bn/{_LEAF_TO_KERAS_BN.get(leaf)}"
            mapping[path] = name
            continue

        if rel[0].startswith("stage"):
            # stage{s}_block{b}/{conv1|conv2|conv3|shortcut}/{conv|norm}/leaf
            stage_block = rel[0]
            s = int(stage_block[5 : stage_block.index("_")])
            b = int(stage_block.split("block")[1])
            part = rel[1]
            kind = rel[2]  # conv | norm
            idx = {"conv1": "1", "conv2": "2", "conv3": "3", "shortcut": "0"}.get(part)
            if idx is None:
                continue
            base = f"conv{s + 2}_block{b + 1}_{idx}"
            if kind == "conv":
                name = f"{base}_conv/{_LEAF_TO_KERAS_CONV.get(leaf)}"
            else:
                name = f"{base}_bn/{_LEAF_TO_KERAS_BN.get(leaf)}"
            mapping[path] = name
    return mapping


def keras_mobilenetv2_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, str]:
    """Map the port's MobileNetV2 params to keras.applications MobileNetV2
    names (``Conv1``, ``expanded_conv_*``, ``block_{n}_{expand|depthwise|
    project}`` + ``_BN``)."""
    mapping: dict[str, str] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        i = segs.index(backbone_prefix)
        rel = segs[i + 1 :]
        leaf = rel[-1]

        def conv_or_bn(base_conv, base_bn, kind, depthwise=False):
            if kind == "conv":
                name = f"{base_conv}/{_LEAF_TO_KERAS_CONV.get(leaf)}"
                if depthwise and leaf == "kernel":
                    return (name, depthwise_to_flax)
                return name
            return f"{base_bn}/{_LEAF_TO_KERAS_BN.get(leaf)}"

        if rel[0] == "stem":
            mapping[path] = conv_or_bn("Conv1", "bn_Conv1", rel[1])
            continue
        if rel[0].startswith("block_"):
            n = int(rel[0].split("_")[1])
            part = rel[1]  # expand | depthwise | project
            kind = rel[2]
            if n == 0:
                # keras block 0 is "expanded_conv_*" with no expand stage
                base = {"depthwise": ("expanded_conv_depthwise",
                                      "expanded_conv_depthwise_BN"),
                        "project": ("expanded_conv_project",
                                    "expanded_conv_project_BN")}.get(part)
            else:
                base = {"expand": (f"block_{n}_expand", f"block_{n}_expand_BN"),
                        "depthwise": (f"block_{n}_depthwise",
                                      f"block_{n}_depthwise_BN"),
                        "project": (f"block_{n}_project",
                                    f"block_{n}_project_BN")}.get(part)
            if base is None:
                continue
            mapping[path] = conv_or_bn(base[0], base[1], kind,
                                       depthwise=(part == "depthwise"))
            continue
        if rel[0] == "top_conv":
            mapping[path] = conv_or_bn("Conv_1", "Conv_1_bn", rel[1])
    return mapping


_LEAF_TO_KERAS_LN = {"scale": "gamma", "bias": "beta"}


def _squeeze_grn(w):
    return w.reshape(-1)


def efficientnet_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's EfficientNet params to the reference's keras-applications
    naming (``backbones/efficientnet.py``: ``stem_conv/bn``,
    ``block{stage}{letter}_{expand_conv,expand_bn,dwconv,bn,se_reduce,
    se_expand,project_conv,project_bn}``, ``top_conv/bn``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]

        def conv(name):
            return f"{name}/{_LEAF_TO_KERAS_CONV.get(leaf)}"

        def bn(name):
            return f"{name}/{_LEAF_TO_KERAS_BN.get(leaf)}"

        if rel[0] == "stem":
            mapping[path] = conv("stem_conv") if rel[1] == "conv" else bn("stem_bn")
        elif rel[0] == "top_conv":
            mapping[path] = conv("top_conv") if rel[1] == "conv" else bn("top_bn")
        elif rel[0].startswith("block_"):
            _, s, i = rel[0].split("_")
            tag = f"block{int(s) + 1}{chr(ord('a') + int(i))}"
            part = rel[1]
            if part == "expand":
                mapping[path] = (conv(f"{tag}_expand_conv") if rel[2] == "conv"
                                 else bn(f"{tag}_expand_bn"))
            elif part == "depthwise":
                if rel[2] == "conv":
                    mapping[path] = (f"{tag}_dwconv/kernel", depthwise_to_flax)
                else:
                    mapping[path] = bn(f"{tag}_bn")
            elif part == "se":
                sub = "se_reduce" if rel[2] == "reduce" else "se_expand"
                mapping[path] = conv(f"{tag}_{sub}")
            elif part == "project":
                mapping[path] = (conv(f"{tag}_project_conv") if rel[2] == "conv"
                                 else bn(f"{tag}_project_bn"))
    return mapping


def xception_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's Xception-65 params to the reference's DeepLab naming
    (``backbones/xception_common.py``: ``block1_conv{1,2}``, entry blocks
    2-4, middle 5-20, exit 21 + 22's separable convs; weight names
    ``block{N}_separable_conv{M}_{depthwise,pointwise}(_BN)`` and
    ``block{N}_shortcut(_BN)``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]

        def block_num(mod):
            if mod.startswith("entry_block"):
                return int(mod[len("entry_block"):]) + 1
            if mod.startswith("middle_block"):
                return int(mod[len("middle_block"):]) + 5
            if mod == "exit_block":
                return 21
            if mod.startswith("exit_sepconv"):
                return 22
            return None

        mod = rel[0]
        if mod in ("stem0", "stem1"):
            base = "block1_conv1" if mod == "stem0" else "block1_conv2"
            if rel[1] == "conv":
                mapping[path] = f"{base}/{_LEAF_TO_KERAS_CONV.get(leaf)}"
            else:
                mapping[path] = f"{base}_BN/{_LEAF_TO_KERAS_BN.get(leaf)}"
            continue
        n = block_num(mod)
        if n is None:
            continue
        if mod.startswith("exit_sepconv"):
            m = int(mod[len("exit_sepconv"):]) + 1
            part, sub = rel[1], rel[1]
        else:
            sub = rel[1]
            m = int(sub[len("sepconv"):]) + 1 if sub.startswith("sepconv") else None
            part = rel[2] if len(rel) > 2 else None

        if mod.startswith("exit_sepconv"):
            sep = f"block22_separable_conv{m}"
            if rel[1] == "depthwise":
                mapping[path] = (f"{sep}_depthwise/kernel", depthwise_to_flax)
            elif rel[1] == "depthwise_norm":
                mapping[path] = f"{sep}_depthwise_BN/{_LEAF_TO_KERAS_BN.get(leaf)}"
            elif rel[1] == "pointwise":
                if rel[2] == "conv":
                    mapping[path] = f"{sep}_pointwise/kernel"
                else:
                    mapping[path] = f"{sep}_pointwise_BN/{_LEAF_TO_KERAS_BN.get(leaf)}"
            continue

        if sub == "shortcut":
            if rel[2] == "conv":
                mapping[path] = f"block{n}_shortcut/kernel"
            else:
                mapping[path] = f"block{n}_shortcut_BN/{_LEAF_TO_KERAS_BN.get(leaf)}"
        elif sub.startswith("sepconv"):
            sep = f"block{n}_separable_conv{m}"
            if part == "depthwise":
                mapping[path] = (f"{sep}_depthwise/kernel", depthwise_to_flax)
            elif part == "depthwise_norm":
                mapping[path] = f"{sep}_depthwise_BN/{_LEAF_TO_KERAS_BN.get(leaf)}"
            elif part == "pointwise":
                if rel[3] == "conv":
                    mapping[path] = f"{sep}_pointwise/kernel"
                else:
                    mapping[path] = f"{sep}_pointwise_BN/{_LEAF_TO_KERAS_BN.get(leaf)}"
    return mapping


def convnext_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's ConvNeXt/V2 params to the reference's naming
    (``backbones/convnext.py`` / ``convnext_v2.py``: ``downsample_layers.{k}``
    with stem at k=0, ``stages.{s}/{b}/{gamma,dwconv,norm,pwconv1,pwconv2,
    grn}``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        if rel[0] == "stem_conv":
            mapping[path] = f"downsample_layers.0/0/{leaf}"
        elif rel[0] == "stem_norm":
            mapping[path] = f"downsample_layers.0/1/{ln}"
        elif rel[0].startswith("downsample_norm"):
            k = int(rel[0][len("downsample_norm"):])
            mapping[path] = f"downsample_layers.{k}/0/{ln}"
        elif rel[0].startswith("downsample_conv"):
            k = int(rel[0][len("downsample_conv"):])
            mapping[path] = f"downsample_layers.{k}/1/{leaf}"
        elif rel[0].startswith("stage"):
            s = int(rel[0][5:rel[0].index("_")])
            b = int(rel[0].split("block")[1])
            base = f"stages.{s}/{b}"
            if rel[1] == "gamma":  # layer scale
                mapping[path] = f"{base}/gamma"
            elif rel[1] == "dwconv":
                name = f"{base}/dwconv/{leaf}"
                mapping[path] = (name, depthwise_to_flax) if leaf == "kernel" else name
            elif rel[1] == "norm":
                mapping[path] = f"{base}/norm/{ln}"
            elif rel[1] in ("pwconv1", "pwconv2"):
                mapping[path] = f"{base}/{rel[1]}/{leaf}"
            elif rel[1] == "grn":
                # reference GRN params are [1,1,1,C]
                mapping[path] = (f"{base}/grn/{ln}", _squeeze_grn)
    return mapping


def swin_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's Swin params to the reference's Swin naming
    (``backbones/swin.py``: ``patch_embed/proj``, ``layers.{s}/blocks.{b}/
    {norm1,attn,norm2,mlp}``, ``layers.{s}/downsample``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        if rel[0] == "patch_embed":
            mapping[path] = f"patch_embed/proj/{leaf}"
        elif rel[0] == "patch_norm":
            mapping[path] = f"patch_embed/norm/{ln}"
        elif rel[0].startswith("merge"):
            s = int(rel[0][5:]) - 1  # merge{k} follows stage k-1
            sub = rel[1]  # norm | reduction
            mapping[path] = (
                f"layers.{s}/downsample/norm/{ln}" if sub == "norm"
                else f"layers.{s}/downsample/reduction/{leaf}")
        elif rel[0].startswith("stage"):
            s = int(rel[0][5:rel[0].index("_")])
            b = int(rel[0].split("block")[1])
            base = f"layers.{s}/blocks.{b}"
            part = rel[1]
            if part in ("norm1", "norm2"):
                mapping[path] = f"{base}/{part}/{ln}"
            elif part == "attn":
                sub = rel[2]
                if sub == "relative_position_bias_table":
                    mapping[path] = f"{base}/attn/relative_position_bias_table"
                else:  # qkv | proj
                    mapping[path] = f"{base}/attn/{sub}/{leaf}"
            elif part in ("mlp_fc1", "mlp_fc2"):
                mapping[path] = f"{base}/mlp/fc{part[-1]}/{leaf}"
    return mapping


def _merge_qkv_heads(q, k, v):
    """Three per-head kernels [C, H, D] -> one fused qkv kernel [C, 3C]."""
    c = q.shape[0]
    return np.concatenate(
        [q.reshape(c, -1), k.reshape(c, -1), v.reshape(c, -1)], axis=1)


def _merge_qkv_biases(q, k, v):
    return np.concatenate([q.reshape(-1), k.reshape(-1), v.reshape(-1)])


def _flatten_in_heads(w):
    """Attention-output kernel [H, D, C] -> [C_in, C_out] = [H*D, C]."""
    return w.reshape(-1, w.shape[-1])


def _flatten_out_heads(w):
    """Per-head kernel [C, H, D] -> [C, H*D]."""
    return w.reshape(w.shape[0], -1)


def vit_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's ViT params to the reference's naming
    (``backbones/vit.py``: ``class_token``/``pos_embed`` weights,
    ``patch_embed/projection``, per-block ``layers.{i}/{ln1,attn,ln2,ffn}``
    with keras MultiHeadAttention per-head query/key/value/attention_output
    kernels)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        if rel[0] == "cls_token":
            mapping[path] = "class_token"
        elif rel[0] == "pos_embed":
            mapping[path] = "pos_embed"
        elif rel[0] == "patch_embed":
            mapping[path] = f"patch_embed/projection/{leaf}"
        elif rel[0].startswith("block"):
            i = int(rel[0][5:])
            base = f"layers.{i}"
            part = rel[1]
            if part == "norm1":
                mapping[path] = f"{base}/ln1/{ln}"
            elif part == "norm2":
                mapping[path] = f"{base}/ln2/{ln}"
            elif part == "qkv":
                names = tuple(f"{base}/attn/{p}/{leaf}"
                              for p in ("query", "key", "value"))
                merge = (_merge_qkv_heads if leaf == "kernel"
                         else _merge_qkv_biases)
                mapping[path] = (names, merge)
            elif part == "proj":
                if leaf == "kernel":
                    mapping[path] = (f"{base}/attn/attention_output/kernel",
                                     _flatten_in_heads)
                else:
                    mapping[path] = f"{base}/attn/attention_output/bias"
            elif part in ("mlp_fc1", "mlp_fc2"):
                d = int(part[-1]) - 1
                mapping[path] = f"{base}/ffn/dense{d}/{leaf}"
    return mapping


def mlp_mixer_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's MLP-Mixer params to the reference's naming
    (``backbones/mlp_mixer.py``: ``stem``, per-block ``mixer_block(_{i})``
    containers with globally-countered ``layer_normalization(_{n})`` names,
    ``token_mixing``/``channel_mixing`` dense0/dense1, and the final
    ``pre_head_layer_norm``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        if rel[0] == "patch_embed":
            mapping[path] = f"stem/{leaf}"
        elif rel[0] == "norm":
            mapping[path] = f"pre_head_layer_norm/{ln}"
        elif rel[0].startswith("block"):
            i = int(rel[0][5:])
            blk = "mixer_block" if i == 0 else f"mixer_block_{i}"
            part = rel[1]
            if part in ("norm1", "norm2"):
                n = 2 * i + (0 if part == "norm1" else 1)
                ln_name = ("layer_normalization" if n == 0
                           else f"layer_normalization_{n}")
                mapping[path] = f"{blk}/{ln_name}/{ln}"
            elif part in ("token_fc1", "token_fc2"):
                d = int(part[-1]) - 1
                mapping[path] = f"{blk}/token_mixing/dense{d}/{leaf}"
            elif part in ("channel_fc1", "channel_fc2"):
                d = int(part[-1]) - 1
                mapping[path] = f"{blk}/channel_mixing/dense{d}/{leaf}"
    return mapping


def _slice_cols(lo, hi):
    def f(w):
        return w[:, lo:hi]
    return f


def eva_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's EVA02 params to the reference's naming
    (``backbones/eva/``: ``class_token``/``pos_embed``,
    ``patch_embed/projection``, per-block ``blocks.{i}`` with fused
    ``attn/qkv`` laid out [3, heads, dim] on the output axis
    (``attention.py:124``) and explicit ``q_bias``/``v_bias``; the
    tiny/small GluMlp fuses fc1 as [x | gate] columns
    (``glumlp.py:101-105``, gate_last), large SwiGLU keeps fc1_g/fc1_x/norm
    separate)."""
    mapping: dict[str, object] = {}
    paths = _paths(variables)
    for path in paths:
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        if rel[0] == "cls_token":
            mapping[path] = "class_token"
        elif rel[0] == "pos_embed":
            mapping[path] = "pos_embed"
        elif rel[0] == "patch_embed":
            mapping[path] = f"patch_embed/projection/{leaf}"
        elif rel[0].startswith("block"):
            i = int(rel[0][5:])
            base = f"blocks.{i}"
            part = rel[1]
            if part in ("norm1", "norm2"):
                mapping[path] = f"{base}/{part}/{ln}"
            elif part in ("q_proj", "k_proj", "v_proj"):
                which = part[0]
                if leaf == "kernel":
                    idx = {"q": 0, "k": 1, "v": 2}[which]
                    def make_slice(idx):
                        def f(w):
                            c = w.shape[0]
                            return w[:, idx * c:(idx + 1) * c]
                        return f
                    mapping[path] = (f"{base}/attn/qkv/kernel", make_slice(idx))
                else:
                    mapping[path] = f"{base}/attn/{which}_bias"
            elif part == "proj":
                mapping[path] = f"{base}/attn/proj/{leaf}"
            elif part == "mlp":
                sub = rel[2]
                if sub == "norm":
                    mapping[path] = f"{base}/mlp/norm/{ln}"
                elif sub == "fc2":
                    mapping[path] = f"{base}/mlp/fc2/{leaf}"
                elif sub in ("fc1_g", "fc1_x"):
                    # SwiGLU variants store fc1_g/fc1_x separately; GluMlp
                    # variants store one fused fc1 = [x | gate] — prefer the
                    # separate name, fall back to a fused-slice spec.
                    # We emit the fused spec only when the model has no
                    # mlp/norm (GluMlp structure).
                    has_norm = any(
                        p.endswith(f"{rel[0]}/mlp/norm/scale") for p in paths)
                    if has_norm:
                        mapping[path] = f"{base}/mlp/{sub}/{leaf}"
                    else:
                        half = 0 if sub == "fc1_x" else 1
                        if leaf == "kernel":
                            def make_half(half):
                                def f(w):
                                    h = w.shape[1] // 2
                                    return w[:, half * h:(half + 1) * h]
                                return f
                        else:
                            def make_half(half):
                                def f(w):
                                    h = w.shape[0] // 2
                                    return w[half * h:(half + 1) * h]
                                return f
                        mapping[path] = (f"{base}/mlp/fc1/{leaf}",
                                         make_half(half))
    return mapping


def hrnet_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's HRNet params to the reference's naming
    (``backbones/hrnet.py``: stem ``conv1/bn1``+``conv2/bn2``, bottleneck
    ``layer1/{b}`` with ``downsample/{0,1}`` shortcut, per-stage
    ``stage{s}/transition/{t}`` (new branches nested ``/{t}/0/{0,1}``),
    modules ``stage{s}/{m}/branches.{i}/{k}/conv{1,2}+bn{1,2}`` and
    ``fuse_layers/{i}.{j}`` — up: ``/{0,1}``, down chains:
    ``/{step}/{0,1}``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]

        def conv_or_bn(conv_name, bn_name, kind):
            if kind == "conv":
                return f"{conv_name}/{_LEAF_TO_KERAS_CONV.get(leaf)}"
            return f"{bn_name}/{_LEAF_TO_KERAS_BN.get(leaf)}"

        mod = rel[0]
        if mod in ("stem0", "stem1"):
            n = 1 if mod == "stem0" else 2
            mapping[path] = conv_or_bn(f"conv{n}", f"bn{n}", rel[1])
        elif mod.startswith("stage1_block"):
            b = int(mod.split("block")[1])
            part = rel[1]
            if part == "shortcut":
                mapping[path] = conv_or_bn(
                    f"layer1/{b}/downsample/0", f"layer1/{b}/downsample/1",
                    rel[2])
            else:  # conv1|conv2|conv3
                n = part[-1]
                mapping[path] = conv_or_bn(
                    f"layer1/{b}/conv{n}", f"layer1/{b}/bn{n}", rel[2])
        elif mod.startswith("transition"):
            # transition{prev_stage}_{branch} -> stage{prev+1}/transition/...
            s, t = mod[len("transition"):].split("_")
            s, t = int(s), int(t)
            base = f"stage{s + 1}/transition/{t}"
            if t == 0:
                # existing-branch conv (only stage2 has one)
                mapping[path] = conv_or_bn(f"{base}/0", f"{base}/1", rel[1])
            else:
                # new coarsest branch: nested one-step sequence
                mapping[path] = conv_or_bn(f"{base}/0/0", f"{base}/0/1", rel[1])
        elif mod.startswith("stage"):
            s = int(mod[5:mod.index("_")])
            m = int(mod.split("module")[1])
            base = f"stage{s}/{m}"
            part = rel[1]
            if part.startswith("branch"):
                i = int(part[6:part.index("_")])
                k = int(part.split("block")[1])
                n = rel[2][-1]  # conv1|conv2
                mapping[path] = conv_or_bn(
                    f"{base}/branches.{i}/{k}/conv{n}",
                    f"{base}/branches.{i}/{k}/bn{n}", rel[3])
            elif part == "fuse":
                sub = rel[2]
                if sub.startswith("up"):
                    j, i = (int(v) for v in sub[2:].split("_"))
                    fbase = f"{base}/fuse_layers/{i}.{j}"
                    mapping[path] = conv_or_bn(f"{fbase}/0", f"{fbase}/1",
                                               rel[3])
                else:  # down{j}_{i}_{k}
                    j, i, k = (int(v) for v in sub[4:].split("_"))
                    fbase = f"{base}/fuse_layers/{i}.{j}/{k}"
                    mapping[path] = conv_or_bn(f"{fbase}/0", f"{fbase}/1",
                                               rel[3])
    return mapping


def intern_image_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's InternImage params to the reference's naming
    (``backbones/intern_image/``: ``patch_embed/conv{1,2}+norm{1,2}``,
    per-stage ``block.{s}`` containing ``layer.{i}`` blocks
    (norm1/norm2/gamma1/gamma2, ``dcn/{dw_conv,dw_conv_norm,offset,mask,
    input_proj,output_proj}``, ``mlp/fc{1,2}``), trailing ``block.{s}/norm``
    and ``block.{s}/downsample``)."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        mod = rel[0]
        if mod.startswith("stem_conv"):
            n = mod[-1]
            mapping[path] = f"patch_embed/conv{n}/{leaf}"
        elif mod.startswith("stem_norm"):
            n = mod[-1]
            mapping[path] = f"patch_embed/norm{n}/{ln}"
        elif mod.startswith("downsample_norm"):
            s = int(mod[len("downsample_norm"):]) - 1
            mapping[path] = f"block.{s}/downsample/norm/{ln}"
        elif mod.startswith("downsample"):
            s = int(mod[len("downsample"):]) - 1
            mapping[path] = f"block.{s}/downsample/conv/{leaf}"
        elif mod.endswith("_norm") and mod.startswith("stage"):
            s = int(mod[5:mod.index("_")])
            mapping[path] = f"block.{s}/norm/{ln}"
        elif mod.startswith("stage"):
            s = int(mod[5:mod.index("_")])
            i = int(mod.split("block")[1])
            base = f"block.{s}/layer.{i}"
            part = rel[1]
            if part in ("norm1", "norm2"):
                mapping[path] = f"{base}/{part}/{ln}"
            elif part in ("gamma1", "gamma2"):
                mapping[path] = f"{base}/{part}"
            elif part in ("mlp_fc1", "mlp_fc2"):
                mapping[path] = f"{base}/mlp/fc{part[-1]}/{leaf}"
            elif part == "dcn":
                sub = rel[2]
                ref_sub = {
                    "dw_conv": "dw_conv",
                    "offset_norm": "dw_conv_norm",
                    "offset_head": "offset",
                    "mask_head": "mask",
                    "value_proj": "input_proj",
                    "output_proj": "output_proj",
                }.get(sub)
                if ref_sub is None:
                    continue
                if sub == "offset_norm":
                    mapping[path] = f"{base}/dcn/{ref_sub}/{ln}"
                elif sub == "dw_conv" and leaf == "kernel":
                    mapping[path] = (f"{base}/dcn/dw_conv/kernel",
                                     depthwise_to_flax)
                else:
                    mapping[path] = f"{base}/dcn/{ref_sub}/{leaf}"
    return mapping


def moat_name_map(variables, backbone_prefix: str = "backbone") -> Mapping[str, object]:
    """Map the port's MOAT params to the reference's naming
    (``backbones/moat/``: ``stem/conv_{i}``+``norm_{i}``,
    ``block_{ss}_{bb}/{shortcut_conv,pre_norm,expand_conv,expand_norm,
    depthwise_conv,depthwise_norm,se.reduce_conv2d,se.expand_conv2d,
    shrink_conv,attention_norm,attention.{q,k,v,o}}`` with per-head
    TrailDense weights [C, H, D] / output [H, D, C]
    (``attention.py:123-214``))."""
    mapping: dict[str, object] = {}
    for path in _paths(variables):
        segs = path.split("/")
        if backbone_prefix not in segs:
            continue
        rel = segs[segs.index(backbone_prefix) + 1:]
        leaf = rel[-1]
        ln = _LEAF_TO_KERAS_LN.get(leaf, leaf)

        def bn(name):
            return f"{name}/{_LEAF_TO_KERAS_BN.get(leaf)}"

        mod = rel[0]
        if mod.startswith("stem"):
            i = int(mod[4:mod.index("_")])
            if mod.endswith("_conv"):
                mapping[path] = f"stem/conv_{i}/{leaf}"
            else:
                mapping[path] = bn(f"stem/norm_{i}")
            continue
        if not mod.startswith("stage"):
            continue
        s = int(mod[5:mod.index("_")])
        b = int(mod.split("block")[1])
        base = f"block_{s:02d}_{b:02d}"
        part = rel[1]
        if part == "shortcut":
            mapping[path] = f"{base}/shortcut_conv/{leaf}"
        elif part == "pre_norm":
            mapping[path] = bn(f"{base}/pre_norm")
        elif part == "expand_conv":
            mapping[path] = f"{base}/expand_conv/{leaf}"
        elif part == "expand_norm":
            mapping[path] = bn(f"{base}/expand_norm")
        elif part == "depthwise_conv":
            mapping[path] = (f"{base}/depthwise_conv/kernel",
                             depthwise_to_flax)
        elif part == "depthwise_norm":
            mapping[path] = bn(f"{base}/depthwise_norm")
        elif part == "se":
            sub = "reduce_conv2d" if rel[2] == "reduce" else "expand_conv2d"
            mapping[path] = f"{base}/se/{sub}/{leaf}"
        elif part == "shrink_conv":
            mapping[path] = f"{base}/shrink_conv/{leaf}"
        elif part == "attn_norm":
            mapping[path] = f"{base}/attention_norm/{ln}"
        elif part == "attn":
            sub = rel[2]  # q_proj|k_proj|v_proj|o_proj|rel_pos_embed
            if sub == "rel_pos_embed":
                mapping[path] = f"{base}/attention/relative_position_embedding"
                continue
            which = sub[0]
            if which in ("q", "k", "v"):
                if leaf == "kernel":
                    mapping[path] = (f"{base}/attention/{which}/weight",
                                     _flatten_out_heads)
                else:
                    mapping[path] = (f"{base}/attention/{which}/bias",
                                     lambda w: w.reshape(-1))
            else:  # o
                if leaf == "kernel":
                    mapping[path] = (f"{base}/attention/o/weight",
                                     _flatten_in_heads)
                else:
                    mapping[path] = f"{base}/attention/o/bias"
    return mapping
