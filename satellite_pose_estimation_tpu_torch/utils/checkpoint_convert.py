"""Carry weights of the JAX DETR keypoint model over to the port.

``flax_detr_to_state_dict(params, batch_stats)`` takes the JAX model's
``params`` and ``batch_stats`` trees as nested dicts of numpy arrays (no
JAX types) and returns a ``state_dict`` (CPU tensors of the arrays' float
dtype) for
``models.detr.DETRKeypointModel``. The port's modules carry the JAX module
names, so each leaf maps by its path; only the layouts change:

* convolution kernels HWIO -> OIHW;
* dense kernels (in, out) -> (out, in);
* attention projections: ``mha_query/key/value`` kernels (d, H, Dh) ->
  (H*Dh, d) with biases (H, Dh) -> (H*Dh,), and ``mha_out`` kernels
  (H, Dh, d) -> (d, H*Dh);
* FrozenBatchNorm / BatchNorm / GroupNorm / LayerNorm ``scale`` and
  ``nn.Embed`` ``embedding`` -> ``weight``; ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``, and for a ``bn`` / ``sync_bn``
  backbone (``nn.BatchNorm2d``) a ``num_batches_tracked`` of 0, which JAX
  does not count.

``flax_rtdetr_to_state_dict(params, batch_stats, freeze_norm)`` does the
same for ``models.rtdetr.RTDETR``: PResNet's norms are ``FrozenBatchNorm``
(``freeze_norm``) or ``nn.BatchNorm2d``, the encoder's and decoder's are
``nn.BatchNorm2d``; the fused RepVgg convs (``conv_fused``, deploy) carry a
bias; a trained model's learnt query table (``tgt_embed``) and CDN label
table (``denoising_class_embed``) come as embeddings and its trainable
BatchNorm statistics as ``batch_stats``. ``flax_realnvp_to_state_dict``
carries a ``models.real_nvp.RealNVP``'s parameters and
``flax_classification_to_state_dict`` a ``models.classification.
Classification``'s.

``flax_quant_to_port(quant)`` takes the JAX ``quant`` collection of a
calibrated int8 model (nested dicts of numpy scalars) and returns the
port's calibration dict (``utils.calibrate.calibrate_act_scales``'s
format), so both packages can run on the same static scales.

The reference's own R1 ``.pth`` files load without the JAX package:
``load_torch_checkpoint`` reads one, ``r1_state_dict_to_port`` renames an
R1 DETR state dict onto the port's modules (the counterpart of JAX's
``convert_r1_detr`` followed by ``flax_detr_to_state_dict``), and
``surgery_detr_pretrained`` takes the public DETR-R50 checkpoint with the
reference's surgery semantics through ``map_static_dicts``.

R2 ``.pth`` files load the same way: ``r2_state_dict_to_port`` renames a
reference RT-DETR state dict (PResNet, MobileNetV3 or GhostNetV2 backbone)
onto the port's modules (the counterpart of JAX's ``convert_r2_rtdetr``
followed by ``flax_rtdetr_to_state_dict``), ``presnet_pretrained_to_port``
and ``torchvision_resnet_to_port`` take ImageNet-pretrained trunks, and
``port_to_r2_state_dict`` / ``port_to_torchvision_resnet`` go back (JAX's
``convert_rtdetr_to_torch`` / ``convert_resnet_to_torchvision``).
"""
from __future__ import annotations

import argparse
import re

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert_param(path, x):
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    if leaf == "kernel":
        if parent.startswith("mha_"):
            if parent == "mha_out":  # (H, Dh, d) -> (d, H*Dh)
                return "weight", x.reshape(-1, x.shape[-1]).T
            return "weight", x.reshape(x.shape[0], -1).T  # (d, H, Dh) -> (H*Dh, d)
        if x.ndim == 4:  # HWIO -> OIHW
            return "weight", x.transpose(3, 2, 0, 1)
        if x.ndim == 2:  # (in, out) -> (out, in)
            return "weight", x.T
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {x.shape}")
    if leaf == "bias":
        return "bias", x.reshape(-1) if parent.startswith("mha_") else x
    if leaf in ("scale", "embedding"):
        return "weight", x
    return leaf, x  # query_embed


def flax_detr_to_state_dict(params: dict, batch_stats: dict | None = None,
                            bn: str = "frozen_bn") -> dict:
    """JAX DETR ``params`` / ``batch_stats`` (nested dicts of numpy arrays)
    -> the port's ``state_dict`` (CPU tensors, each of its array's dtype:
    float32 for the JAX model's parameters, float64 for a float64 tree).
    ``bn`` is the model's ``DETRConfig.bn``."""
    state = {}
    for path, x in _leaves(params):
        name, y = _convert_param(path, x)
        state[".".join(path[:-1] + (name,))] = torch.tensor(y)
    for path, x in _leaves(batch_stats or {}):
        name = _STAT_NAMES[path[-1]]
        state[".".join(path[:-1] + (name,))] = torch.tensor(x)
        if bn in ("bn", "sync_bn") and name == "running_mean":
            state[".".join(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return state


def flax_rtdetr_to_state_dict(params: dict, batch_stats: dict | None = None,
                              freeze_norm: bool = True) -> dict:
    """JAX RT-DETR ``params`` / ``batch_stats`` (nested dicts of numpy
    arrays) -> the port's ``state_dict`` (CPU tensors of the arrays'
    dtypes). ``freeze_norm`` is the model's ``RTDETRConfig.freeze_norm``,
    which only a PResNet backbone reads: the MobileNetV3 and GhostNetV2
    trunks (depthwise kernels (kh, kw, 1, C) -> (C, 1, kh, kw), as any
    HWIO kernel) always train their BatchNorms."""
    state = flax_detr_to_state_dict(params, batch_stats)
    return _count_batchnorms(state, freeze_norm and _presnet_backbone(state))


def _presnet_backbone(state: dict) -> bool:
    return not any(k.startswith(("backbone.bneck_", "backbone.conv_stem.")) for k in state)


def _count_batchnorms(state: dict, frozen_backbone: bool) -> dict:
    """``state`` with a ``num_batches_tracked`` of 0 beside every running
    mean of an ``nn.BatchNorm2d`` (JAX counts no batches): every norm but a
    frozen backbone's."""
    for key in list(state):
        if key.endswith(".running_mean") and not (frozen_backbone and key.startswith("backbone.")):
            state[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def flax_realnvp_to_state_dict(params: dict) -> dict:
    """JAX RealNVP ``params`` (``s_{i}`` / ``t_{i}``, each ``fc1..fc3``) ->
    the port's ``state_dict``."""
    return flax_detr_to_state_dict(params)


def flax_classification_to_state_dict(params: dict, batch_stats: dict | None = None) -> dict:
    """JAX ``Classification`` ``params`` / ``batch_stats`` -> the port's
    ``models.classification.Classification`` ``state_dict``: convolution
    kernels HWIO -> OIHW, the ``fc`` kernel (in, out) -> (out, in), every
    norm a ``bn`` (``nn.BatchNorm2d``) with ``scale`` / ``bias`` / ``mean``
    / ``var`` and no batches counted."""
    return flax_detr_to_state_dict(params, batch_stats, bn="bn")


def flax_quant_to_port(quant: dict) -> dict:
    """JAX ``quant`` collection -> {"<path joined by dots>": float32 scalar
    tensor}, e.g. ``backbone.body.conv1.act_amax``."""
    return {".".join(path): torch.tensor(x, dtype=torch.float32)
            for path, x in _leaves(quant)}


# -- R1 .pth files -----------------------------------------------------------

def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth`` file's state dict (its ``model`` entry where it has one) as
    CPU tensors. The file is read with ``weights_only`` unpickling; the
    reference's checkpoints also hold their argparse ``Namespace``, which is
    allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(v) for k, v in sd.items()}


_TRUNK_RULES = (
    (r"^layer(\d+)\.(\d+)\.downsample\.0\.", r"layer\1_\2.downsample_conv."),
    (r"^layer(\d+)\.(\d+)\.downsample\.1\.", r"layer\1_\2.downsample_bn."),
    (r"^layer(\d+)\.(\d+)\.", r"layer\1_\2."),
)
_UNIT_BN_VAR = 1.0 - 1e-5  # float32(var + eps) == 1: a norm of eps 1e-5 that is the identity


def _torch_name(key: str, bn: str):
    """The port's name of an R1 DETR key outside the attention blocks, or
    None for a key the port drops."""
    if key.endswith("num_batches_tracked") and bn not in ("bn", "sync_bn"):
        return None
    if key.startswith("backbone.0.body."):
        name = key[len("backbone.0.body."):]
        if name.startswith("fc."):
            return None
        for pat, rep in _TRUNK_RULES:
            name = re.sub(pat, rep, name)
        return "backbone.body." + name
    if key.startswith("backbone.0."):
        return "backbone." + key[len("backbone.0."):]
    if key.startswith("backbone.1."):
        return None  # the sine position embedding: no parameters
    if key == "query_embed.weight":
        return "query_embed"
    if key.startswith("input_proj."):
        return key
    if key.startswith(("cls_embed.", "class_embed.")):
        return "cls_embed." + key.split(".", 1)[1]
    m = re.match(r"point_embed\.layers\.(\d+)\.(\w+)$", key)
    if m:
        return f"point_embed.layers_{m.group(1)}.{m.group(2)}"
    m = re.match(r"transformer\.(encoder|decoder)\.layers\.(\d+)\.((?:linear|norm)\d\.\w+)$", key)
    if m:
        return f"transformer.{m.group(1)}_layer_{m.group(2)}.{m.group(3)}"
    m = re.match(r"transformer\.(encoder|decoder)\.norm\.(\w+)$", key)
    if m:
        return f"transformer.{m.group(1)}_norm.{m.group(2)}"
    raise ValueError(f"unhandled R1 DETR key {key!r}")


def r1_state_dict_to_port(state_dict: dict, bn: str = "frozen_bn") -> dict:
    """An R1 DETR keypoint model's state dict (R1/models/detr_speed.py:32-57:
    a torchvision trunk under ``backbone.0.body``, the Backbone8s fusion
    convs ``backbone.0.{s8_latern,s16_latern,output_conv}``, ``input_proj``,
    ``query_embed``, ``cls_embed``, the ``point_embed`` MLP and
    ``transformer.{encoder,decoder}.layers.N`` with torch's packed
    multi-head attention modules) -> the port's ``DETRKeypointModel`` state
    dict (CPU tensors). Both sides are torch, so this renames keys and
    splits each packed ``in_proj_weight`` / ``in_proj_bias`` (3h, h) into
    ``mha_query`` / ``mha_key`` / ``mha_value``; the decoder's
    ``multihead_attn`` is the port's ``cross_attn``.

    A trunk of the fusion backbone sits under ``backbone.body``, any other
    directly under ``backbone`` (``surgery_detr_pretrained`` re-scopes it).
    torchvision's resnet18/34 ``layer1.0`` has no downsample branch where the
    port's (JAX's) has one; it is filled with the identity (a 1x1 identity
    convolution and a norm of unit scale, zero mean and variance 1 - eps),
    which reproduces torchvision's block for ``frozen_bn`` and ``bn``.
    ``bn`` is the model's ``DETRConfig.bn``: ``bn`` / ``sync_bn`` keep the
    ``num_batches_tracked`` counters, the others drop them."""
    out = {}
    s8 = any(k.startswith("backbone.0.output_conv.") for k in state_dict)
    for key, val in state_dict.items():
        val = torch.as_tensor(val)
        m = re.match(r"transformer\.(encoder|decoder)\.layers\.(\d+)\."
                     r"(self_attn|multihead_attn)\.(.+)$", key)
        if m:
            base = (f"transformer.{m.group(1)}_layer_{m.group(2)}."
                    f"{'cross_attn' if m.group(3) == 'multihead_attn' else 'self_attn'}")
            leaf = m.group(4)
            if leaf.startswith("in_proj_"):
                kind = leaf[len("in_proj_"):]
                for name, part in zip(("mha_query", "mha_key", "mha_value"), val.chunk(3)):
                    out[f"{base}.{name}.{kind}"] = part.clone()
            elif leaf.startswith("out_proj."):
                out[f"{base}.mha_out.{leaf[len('out_proj.'):]}"] = val.clone()
            else:
                raise ValueError(f"unhandled R1 DETR key {key!r}")
            continue
        name = _torch_name(key, bn)
        if name is not None:
            out[name] = val.clone()
    if not s8:  # a plain trunk: not under the fusion backbone's ``body``
        out = {("backbone." + k[len("backbone.body."):] if k.startswith("backbone.body.") else k): v
               for k, v in out.items()}
    trunk = "backbone.body." if s8 else "backbone."
    if (trunk + "conv1.weight" in out and trunk + "layer1_0.conv3.weight" not in out
            and trunk + "layer1_0.downsample_conv.weight" not in out):
        out.update(_identity_downsample(trunk + "layer1_0.", out[trunk + "conv1.weight"].dtype,
                                        bn in ("bn", "sync_bn")))
    return out


def _identity_downsample(prefix: str, dtype, counted: bool) -> dict:
    """torchvision's identity shortcut as the port's 64 -> 64 downsample
    branch: a 1x1 identity convolution and a unit norm."""
    n = 64
    fill = {prefix + "downsample_conv.weight": torch.eye(n, dtype=dtype).reshape(n, n, 1, 1),
            prefix + "downsample_bn.weight": torch.ones(n, dtype=dtype),
            prefix + "downsample_bn.bias": torch.zeros(n, dtype=dtype),
            prefix + "downsample_bn.running_mean": torch.zeros(n, dtype=dtype),
            prefix + "downsample_bn.running_var": torch.full((n,), _UNIT_BN_VAR, dtype=dtype)}
    if counted:
        fill[prefix + "downsample_bn.num_batches_tracked"] = torch.tensor(0)
    return fill


def map_static_dicts(src: dict, dst: dict):
    """Shape-adapting partial load (R1/main.py:20-87): every key of ``dst``
    takes ``src``'s tensor where the shapes agree, the overlapping leading
    slice where only the sizes differ, and keeps its own value otherwise.
    Returns (the merged state dict, a report {"copied", "sliced", "kept",
    "dropped"} of key lists, "dropped" the ``src`` keys ``dst`` lacks)."""
    out = {}
    report = {"copied": [], "sliced": [], "kept": [],
              "dropped": sorted(k for k in src if k not in dst)}
    for k, d in dst.items():
        s = src.get(k)
        if s is None or s.ndim != d.ndim:
            out[k] = d
            report["kept"].append(k)
        elif s.shape == d.shape:
            out[k] = s.to(device=d.device, dtype=d.dtype)
            report["copied"].append(k)
        else:
            slices = tuple(slice(0, min(a, b)) for a, b in zip(s.shape, d.shape))
            merged = d.clone()
            merged[slices] = s[slices].to(device=d.device, dtype=d.dtype)
            out[k] = merged
            report["sliced"].append(k)
    print(f"map_static_dicts: {len(report['copied'])} copied, {len(report['sliced'])} "
          f"slice-adapted, {len(report['kept'])} kept, {len(report['dropped'])} dropped")
    return out, report


_SURGERY_SECTIONS = ("backbone.", "transformer.", "input_proj.", "query_embed.")


def surgery_detr_pretrained(state_dict: dict, dst_state: dict):
    """The public DETR-R50 checkpoint (``detr-r50-e632da11.pth``'s ``model``
    dict) merged into ``dst_state``, a port DETR's state dict, with the
    reference's surgery semantics (R1/main.py:20-87): only the backbone /
    transformer / input_proj / query_embed sections are taken (the COCO
    heads ``class_embed`` / ``bbox_embed`` are dropped), ``input_proj``'s
    in-channels and ``query_embed``'s rows slice-adapt, and what the
    destination lacks (layer4 under Backbone8s, layers past its depth)
    falls away. The public trunk is re-scoped under ``backbone.body`` for a
    fusion-backbone destination. Returns (merged state dict, report as
    ``map_static_dicts``'s, with the heads among "dropped")."""
    keep = {k: v for k, v in state_dict.items() if k.startswith(_SURGERY_SECTIONS)}
    heads = [k for k in state_dict if k not in keep]
    src = r1_state_dict_to_port(keep)
    if (any(k.startswith("backbone.body.") for k in dst_state)
            and not any(k.startswith("backbone.body.") for k in src)):
        src = {("backbone.body." + k[len("backbone."):] if k.startswith("backbone.") else k): v
               for k, v in src.items()}
    merged, report = map_static_dicts(src, dst_state)
    report["dropped"] = sorted(report["dropped"] + heads)
    return merged, report


# -- R2 .pth files -----------------------------------------------------------

# Keys of the reference composite that no port module holds: an unused
# parameter (R2/src/zoo/rtdetr/rtdetr.py:34), a module never called
# (hybrid_encoder.py), and the decoder's eval-size buffers, which the port
# makes anew.
_R2_RTDETR_SKIP = ("temper_param", "encoder.encoder_fusion_input", "decoder.anchors",
                   "decoder.valid_mask")

# Module-path rewrites, reference -> port, per section (JAX
# utils/checkpoint_convert.py's rules: the port's modules carry the JAX
# names).
_R2_MOBILENET_RULES = (
    (r"^bneck\.(\d+)\.", r"bneck_\1."),
    (r"\bse\.se\.(\d)\.", r"se.se_\1."),
    (r"\bskip\.(\d)\.", r"skip_\1."),
)
_R2_MOBILENET_DEAD = ("backbone.linear3.", "backbone.bn3.")  # the classifier tail
_R2_GHOSTNET_RULES = (
    (r"^blocks\.9\.0\.conv\.", "blocks_9_0_conv."),
    (r"^blocks\.9\.0\.bn1\.", "blocks_9_0_bn1."),
    (r"^blocks\.(\d+)\.(\d+)\.", r"blocks_\1_\2."),
    (r"\b(ghost\d)\.primary_conv\.0\.", r"\1.primary_conv."),
    (r"\b(ghost\d)\.primary_conv\.1\.", r"\1.primary_bn."),
    (r"\b(ghost\d)\.cheap_operation\.0\.", r"\1.cheap_conv."),
    (r"\b(ghost\d)\.cheap_operation\.1\.", r"\1.cheap_bn."),
    (r"\bghost1\.short_conv\.0\.", "ghost1.short_conv."),
    (r"\bghost1\.short_conv\.1\.", "ghost1.short_bn."),
    (r"\bghost1\.short_conv\.2\.", "ghost1.dfc_h."),
    (r"\bghost1\.short_conv\.3\.", "ghost1.dfc_h_bn."),
    (r"\bghost1\.short_conv\.4\.", "ghost1.dfc_v."),
    (r"\bghost1\.short_conv\.5\.", "ghost1.dfc_v_bn."),
    (r"\bconv_dw\.", "dw_conv."),
    (r"\bbn_dw\.", "dw_bn."),
    (r"\bse\.conv_reduce\.", "se_reduce."),
    (r"\bse\.conv_expand\.", "se_expand."),
    (r"\bshortcut\.0\.", "short_dw."),
    (r"\bshortcut\.1\.", "short_dw_bn."),
    (r"\bshortcut\.2\.", "short_pw."),
    (r"\bshortcut\.3\.", "short_pw_bn."),
)
_R2_GHOSTNET_DEAD = ("backbone.conv_head.", "backbone.classifier.")
_R2_PRESNET_RULES = (
    (r"^conv1\.", ""),
    (r"^res_layers\.(\d+)\.blocks\.(\d+)\.", lambda m: f"res{int(m.group(1)) + 2}_{m.group(2)}."),
    (r"\bshort\.conv\.(conv|norm)\.", r"short_conv.\1."),
    (r"\bshort\.(conv|norm)\.", r"short_conv.\1."),
)
_R2_ENCODER_RULES = (
    (r"^input_proj\.(\d+)\.0\.", r"input_proj_\1_conv."),
    (r"^input_proj\.(\d+)\.1\.", r"input_proj_\1_norm."),
    (r"^encoder\.(\d+)\.layers\.(\d+)\.", r"encoder_\1_layer_\2."),
    (r"^(lateral_convs|fpn_blocks|pan_blocks|downsample_convs)\.(\d+)\.", r"\1_\2."),
    (r"\bbottlenecks\.(\d+)\.", r"bottlenecks_\1."),
)
_R2_DECODER_RULES = (
    (r"^input_proj\.(\d+)\.(conv|norm)\.", r"input_proj_\1_\2."),
    (r"^decoder\.layers\.(\d+)\.", r"decoder_layer_\1."),
    (r"^decoder\.sigma_embed\.(\d+)\.", r"sigma_embed_\1."),
    (r"^(dec_bbox_head|dec_score_head)\.(\d+)\.", r"\1_\2."),
    (r"^enc_output\.(\d+)\.", r"enc_output_\1."),
    (r"\blayers\.(\d+)\.", r"layers_\1."),
)


def _rewrite(rules, dotted: str) -> str:
    for pat, rep in rules:
        dotted = re.sub(pat, rep, dotted)
    return dotted


def r2_state_dict_to_port(state_dict: dict, nhead: int = 8, freeze_norm: bool = True) -> dict:
    """A reference R2 RT-DETR state dict (R2/src/zoo/rtdetr/rtdetr.py:28-32:
    ``backbone.`` a PResNet, MobileNetV3 or GhostNetV2, told apart by its
    keys; ``encoder.`` the HybridEncoder; ``decoder.`` the
    RTDETRTransformer) -> the port's ``RTDETR`` state dict (CPU tensors).
    Both sides are torch, so this renames keys by JAX ``convert_r2_rtdetr``'s
    rules, drops its skip list and the dead classifier tails, and splits
    each of torch's packed multi-head attention modules' ``in_proj_weight`` /
    ``in_proj_bias`` (3h, h) into ``mha_query`` / ``mha_key`` /
    ``mha_value`` (torch packs the heads head-major, so the thirds are the
    port's projections as they are; ``nhead`` must divide h).
    ``num_batches_tracked`` counters are dropped, as JAX drops them, and
    every ``nn.BatchNorm2d`` gets one of 0 (all but a PResNet's norms under
    ``freeze_norm``, the model's ``RTDETRConfig.freeze_norm``)."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    mobilenet = any(k.startswith("backbone.bneck.") for k in sd)
    ghostnet = any(k.startswith("backbone.conv_stem.") for k in sd)
    rules = {"backbone": (_R2_MOBILENET_RULES if mobilenet else
                          _R2_GHOSTNET_RULES if ghostnet else _R2_PRESNET_RULES),
             "encoder": _R2_ENCODER_RULES, "decoder": _R2_DECODER_RULES}
    dead = _R2_MOBILENET_DEAD if mobilenet else _R2_GHOSTNET_DEAD if ghostnet else ()
    out = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked") or (dead and key.startswith(dead)):
            continue
        if any(key == s or key.startswith(s + ".") for s in _R2_RTDETR_SKIP):
            continue
        section, rest = key.split(".", 1)
        attn = re.match(r"(.+)\.self_attn\.(.+)$", rest)
        mod, leaf = (attn.group(1), attn.group(2)) if attn else rest.rsplit(".", 1)
        port_mod = f"{section}.{_rewrite(rules[section], mod + '.').rstrip('.')}"
        if not attn:
            out[f"{port_mod}.{leaf}"] = val.clone()
        elif leaf.startswith("in_proj_"):
            if val.shape[0] % 3 or (val.shape[0] // 3) % nhead:
                raise ValueError(f"{key}: {tuple(val.shape)} does not split into 3 x {nhead} heads")
            for name, part in zip(("mha_query", "mha_key", "mha_value"), val.chunk(3)):
                out[f"{port_mod}.self_attn.{name}.{leaf[len('in_proj_'):]}"] = part.clone()
        elif leaf.startswith("out_proj."):
            out[f"{port_mod}.self_attn.mha_out.{leaf[len('out_proj.'):]}"] = val.clone()
        else:
            raise ValueError(f"unhandled R2 RT-DETR key {key!r}")
    return _count_batchnorms(out, freeze_norm and not (mobilenet or ghostnet))


def presnet_pretrained_to_port(state_dict: dict, freeze_norm: bool = True) -> dict:
    """A paddle-converted PResNet-vd pretrained file
    (ResNet{18,34,50,101}_vd_*_pretrained_from_paddle.pth, the PResNet
    module's own state dict, R2/nn/backbone/presnet.py:26-31) -> the port's
    ``PResNet`` state dict (the counterpart of JAX's
    ``convert_presnet_pretrained``): ``r2_state_dict_to_port``'s backbone
    section without its ``backbone.`` prefix."""
    port = r2_state_dict_to_port({f"backbone.{k}": v for k, v in state_dict.items()},
                                 freeze_norm=freeze_norm)
    return {k[len("backbone."):]: v for k, v in port.items()}


def torchvision_resnet_to_port(state_dict: dict, bn: str = "frozen_bn") -> dict:
    """A torchvision ResNet state dict -> the port's ``models.resnet.ResNet``
    state dict (the counterpart of JAX's ``convert_torchvision_resnet``):
    ``layer{n}.{m}`` -> ``layer{n}_{m}``, the downsample pair ->
    ``downsample_conv`` / ``downsample_bn``, ``fc`` dropped. As in JAX, the
    file's ``num_batches_tracked`` counters are dropped and a ``bn`` /
    ``sync_bn`` trunk counts 0 batches; resnet18/34's ``layer1_0`` keeps no
    downsample (``r1_state_dict_to_port`` fills the identity there)."""
    out = {}
    for key, val in state_dict.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        out[_rewrite(_TRUNK_RULES, key)] = torch.as_tensor(val).clone()
    if bn in ("bn", "sync_bn"):
        out = _count_batchnorms(out, frozen_backbone=False)
    return out


def port_to_torchvision_resnet(state_dict: dict) -> dict:
    """The inverse of ``torchvision_resnet_to_port`` (JAX's
    ``convert_resnet_to_torchvision``): a port ``ResNet`` state dict -> a
    torchvision-naming one, every norm with a ``num_batches_tracked`` of 0
    (int64)."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        name = re.sub(r"^layer(\d+)_(\d+)\.downsample_conv\.", r"layer\1.\2.downsample.0.", key)
        name = re.sub(r"^layer(\d+)_(\d+)\.downsample_bn\.", r"layer\1.\2.downsample.1.", name)
        name = re.sub(r"^layer(\d+)_(\d+)\.", r"layer\1.\2.", name)
        out[name] = val.clone()
        if name.endswith(".running_mean"):
            out[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


_R2_GHOSTNET_INVERSE = (
    (r"^blocks_9_0_conv\.", "blocks.9.0.conv."),
    (r"^blocks_9_0_bn1\.", "blocks.9.0.bn1."),
    (r"^blocks_(\d+)_(\d+)\.", r"blocks.\1.\2."),
    (r"\.(ghost\d)\.primary_conv\.", r".\1.primary_conv.0."),
    (r"\.(ghost\d)\.primary_bn\.", r".\1.primary_conv.1."),
    (r"\.(ghost\d)\.cheap_conv\.", r".\1.cheap_operation.0."),
    (r"\.(ghost\d)\.cheap_bn\.", r".\1.cheap_operation.1."),
    (r"\.ghost1\.short_conv\.", ".ghost1.short_conv.0."),
    (r"\.ghost1\.short_bn\.", ".ghost1.short_conv.1."),
    (r"\.ghost1\.dfc_h\.", ".ghost1.short_conv.2."),
    (r"\.ghost1\.dfc_h_bn\.", ".ghost1.short_conv.3."),
    (r"\.ghost1\.dfc_v\.", ".ghost1.short_conv.4."),
    (r"\.ghost1\.dfc_v_bn\.", ".ghost1.short_conv.5."),
    (r"\.dw_conv\.", ".conv_dw."),
    (r"\.dw_bn\.", ".bn_dw."),
    (r"\.se_reduce\.", ".se.conv_reduce."),
    (r"\.se_expand\.", ".se.conv_expand."),
    (r"\.short_dw\.", ".shortcut.0."),
    (r"\.short_dw_bn\.", ".shortcut.1."),
    (r"\.short_pw\.", ".shortcut.2."),
    (r"\.short_pw_bn\.", ".shortcut.3."),
)


def _r2_module_path(section: str, mod: str) -> str:
    """The reference's module path of the port module ``mod`` (relative to
    ``section``): JAX ``convert_rtdetr_to_torch``'s inverse rules."""
    dotted = mod + "."
    if section == "backbone" and mod.startswith(("blocks_", "conv_stem")):
        dotted = _rewrite(_R2_GHOSTNET_INVERSE, dotted)
    elif section == "backbone" and mod.startswith("bneck_"):
        dotted = re.sub(r"^bneck_(\d+)\.", r"bneck.\1.", dotted)
        dotted = re.sub(r"\.se\.se_(\d)\.", r".se.se.\1.", dotted)
        dotted = re.sub(r"\.skip_(\d)\.", r".skip.\1.", dotted)
    elif section == "backbone":
        dotted = re.sub(r"^res(\d+)_(\d+)\.",
                        lambda m: f"res_layers.{int(m.group(1)) - 2}.blocks.{m.group(2)}.", dotted)
        # the vd variant: only res2's stride-1 shortcut is a plain ConvNormLayer
        if ".short_conv." in dotted:
            plain = dotted.startswith("res_layers.0.")
            dotted = dotted.replace(".short_conv.", ".short." if plain else ".short.conv.")
        dotted = re.sub(r"^(conv1_\d)\.", r"conv1.\1.", dotted)
    elif section == "encoder":
        dotted = re.sub(r"^input_proj_(\d+)_conv\.", r"input_proj.\1.0.", dotted)
        dotted = re.sub(r"^input_proj_(\d+)_norm\.", r"input_proj.\1.1.", dotted)
        dotted = re.sub(r"^encoder_(\d+)_layer_(\d+)\.", r"encoder.\1.layers.\2.", dotted)
        dotted = re.sub(r"^(lateral_convs|fpn_blocks|pan_blocks|downsample_convs)_(\d+)\.",
                        r"\1.\2.", dotted)
        dotted = re.sub(r"\.bottlenecks_(\d+)\.", r".bottlenecks.\1.", dotted)
    else:
        dotted = re.sub(r"^input_proj_(\d+)_(conv|norm)\.", r"input_proj.\1.\2.", dotted)
        dotted = re.sub(r"^decoder_layer_(\d+)\.", r"decoder.layers.\1.", dotted)
        dotted = re.sub(r"^sigma_embed_(\d+)\.", r"decoder.sigma_embed.\1.", dotted)
        dotted = re.sub(r"^(dec_bbox_head|dec_score_head)_(\d+)\.", r"\1.\2.", dotted)
        dotted = re.sub(r"^enc_output_(\d+)\.", r"enc_output.\1.", dotted)
        dotted = re.sub(r"\.layers_(\d+)\.", r".layers.\1.", dotted)
    return f"{section}.{dotted.rstrip('.')}"


def port_to_r2_state_dict(state_dict: dict) -> dict:
    """The inverse of ``r2_state_dict_to_port`` (JAX's
    ``convert_rtdetr_to_torch``): a port ``RTDETR`` state dict -> a
    reference-naming one that the reference composite loads with
    ``strict=False`` (its unused ``temper_param`` / ``encoder_fusion_input``
    and the ``num_batches_tracked`` counters are not emitted); each
    attention's ``mha_query/key/value`` are packed into ``in_proj_weight`` /
    ``in_proj_bias``."""
    out, mha = {}, {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        section, rest = key.split(".", 1)
        m = re.match(r"(.+)\.self_attn\.(mha_\w+)\.(weight|bias)$", rest)
        if m:
            mod = _r2_module_path(section, m.group(1)) + ".self_attn"
            mha.setdefault(mod, {})[(m.group(2), m.group(3))] = val
            continue
        mod, leaf = rest.rsplit(".", 1)
        out[f"{_r2_module_path(section, mod)}.{leaf}"] = val.clone()
    for mod, group in mha.items():
        for leaf in ("weight", "bias"):
            out[f"{mod}.in_proj_{leaf}"] = torch.cat(
                [group[(n, leaf)] for n in ("mha_query", "mha_key", "mha_value")])
            out[f"{mod}.out_proj.{leaf}"] = group[("mha_out", leaf)].clone()
    return out
